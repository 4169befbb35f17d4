"""The Disney lobes' kernels (take_tpu_torch/csrc/disney.cu).

From the CPU: the route a CPU tensor takes, the source's constants and
input layout against the package's, the wrappers' plumbing with a stand-in
library (fields read in place through pointers and row strides, refusals),
and the autograd Function's backward against plain autograd (the graph's
launch bookkeeping is tests/test_torch_kernel_runtime.py's). On the card (marked `cuda`, skipped without one): each
tag's sample, eval and pdf against the plain version at 2^20 lanes, the
Function's gradients, and an ibl pass graph's launches. This file imports
neither JAX nor take_tpu, so its card part runs where only PyTorch is:
    python -m pytest --noconftest tests/test_torch_disney_kernel.py -q
"""

import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import (DISNEY_BIT_SHARE, DISNEY_COLUMNS, DISNEY_ULP_LANES, DISNEY_ZERO_FLIPS, IBL_CHROME,
                        IBL_COMPOSITE, agreement, disney_dir_out, disney_lanes)
from take_tpu_torch.geometry import _build, _launch
from take_tpu_torch.materials import bsdf, disney
from take_tpu_torch.scene import types as ST

ROOT = os.path.join(os.path.dirname(__file__), "..")
SOURCE = os.path.join(ROOT, "take_tpu_torch", "csrc", "disney.cu")
ENTRIES = ("sample", "eval", "pdf")
TAG_NAMES = {ST.MAT_DISNEY_METAL: "metal", ST.MAT_DISNEY_GLASS: "glass", ST.MAT_DISNEY_CLEARCOAT: "clearcoat",
             ST.MAT_DISNEY_SHEEN: "sheen", ST.MAT_DISNEY_BSDF: "disneybsdf"}


def _on_cpu(entry, tag, sp, dir_in, *rest):
    """A stand-in for disney._launch: the plain lobes, off the tape."""
    with torch.no_grad():
        return disney._PLAIN[entry](tag, sp, dir_in, *rest)


# -- From the CPU --


def test_cpu_lobes_take_the_plain_route():
    _launch.reset_launches()
    for tag in TAG_NAMES:
        sp, dir_in, *u = disney_lanes(tag, 256, 1, "cpu")
        d, p = disney.sample(tag, sp, dir_in, *u)
        d_p, p_p = disney._sample_plain(tag, sp, dir_in, *u)
        assert torch.equal(d, d_p) and torch.equal(p, p_p)
        assert torch.equal(disney.eval(tag, sp, dir_in, d), disney._eval_plain(tag, sp, dir_in, d))
        assert torch.equal(disney.pdf(tag, sp, dir_in, d), disney._pdf_plain(tag, sp, dir_in, d))
    n = len(TAG_NAMES)
    assert disney.LAUNCHES == {"sample": 0, "eval": 0, "pdf": 0, "sample_plain": n, "eval_plain": n, "pdf_plain": n}
    d, _ = disney.sample(ST.MAT_DISNEY_BSDF, sp, dir_in, u[0], u[1], u[2])  # u3 defaults to u_lobe
    assert torch.equal(d, disney._sample_plain(ST.MAT_DISNEY_BSDF, sp, dir_in, u[0], u[1], u[2], u[0])[0])


def test_kernel_constants_and_layout_equal_the_package():
    """disney.cu's tags are scene/types.py's, its constants core/math.py's
    expressions, and its Inputs struct is disney._Inputs field for field."""
    text = open(SOURCE).read()
    tags = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert {int(tags[k]) for k in ("kMetal", "kGlass", "kClearcoat", "kSheen", "kBsdf")} == set(TAG_NAMES)
    assert [int(tags[k]) for k in ("kMetal", "kGlass", "kClearcoat", "kSheen", "kBsdf")] == list(disney.TAGS)
    assert "constexpr double kPiD = 3.14159265358979323846;" in text
    assert DISNEY_COLUMNS == {name: getattr(ST, f"MATTR_{name.upper()}") for name in DISNEY_COLUMNS}
    body = re.search(r"struct Inputs \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"(\w+)(?=[,;])", re.sub(r"Field[FIB]", "", body))
    assert names == [name for name, _ in disney._Inputs._fields_]


def test_source_builds_without_contraction_or_fast_math():
    flags = (*_build.NVCC_FLAGS, *_launch.SOURCES["disney"].flags)
    assert "--fmad=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    assert "--fmad=false" not in _build.NVCC_FLAGS  # the other sources keep their flags (and their hashes)


WRAPPER_PROBE = """
import ctypes, sys, types, torch
from take_tpu_torch.materials import disney
from take_tpu_torch.scene import types as ST
from chip_smoke import disney_lanes
calls = []
class Lib:
    def __getattr__(self, name):
        def fn(ins, tag, *out_and_stream):
            got, out = ins._obj, out_and_stream[:-1]
            calls.append((name, tag, {f: (getattr(got, f).p, getattr(got, f).s) for f, _ in got._fields_ if f != "n"},
                          got.n, out))
            return 0
        return fn
disney._lib = Lib
torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(cuda_stream=0)
sp, dir_in, *u = disney_lanes(ST.MAT_DISNEY_BSDF, 40, 3, "cpu")
d, p = disney._launch("sample", ST.MAT_DISNEY_BSDF, sp, dir_in, *u)
f = disney._launch("eval", ST.MAT_DISNEY_METAL, sp, dir_in, d)
q = disney._launch("pdf", ST.MAT_DISNEY_SHEEN, sp, dir_in, d[::1])
rows = sp.roughness._base if sp.roughness._base is not None else sp.roughness
base = sp.refl.data_ptr() - 4 * ST.MATTR_TEX_VALUE
ok = []
for name, tag, fields, n, out in calls:
    ok.append(n == 40)
    for k in disney._SCALARS:
        ok.append(fields[k] == (base + 4 * getattr(ST, "MATTR_" + k.upper()), ST.MATTR_DIM))
    ok.append(fields["refl"] == (base + 4 * ST.MATTR_TEX_VALUE, ST.MATTR_DIM))
    ok.append(fields["tag"] == (sp.tag.data_ptr(), 1) and fields["front"] == (sp.front.data_ptr(), 1))
    ok.append(fields["dir_in"] == (dir_in.data_ptr(), 3) and fields["geo_n"] == (sp.geo_n.data_ptr(), 3))
print(all(ok))
print([(name, tag, fields["dir_out"][0] is None, fields["u3"][0] is None, len(out)) for name, tag, fields, _, out in calls])
print([tuple(d.shape), tuple(p.shape), tuple(f.shape), tuple(q.shape), calls[1][4][0] == f.data_ptr()])
print("sympy" in sys.modules)
"""


def test_kernel_wrappers_read_in_place_and_launch():
    """The CUDA wrappers' plumbing, on CPU tensors with a stand-in library:
    each scalar of the shade point is handed over as a pointer into the
    gathered [N, 24] rows with row stride 24 (no copy), refl as the rows'
    columns 7-9, the vectors with row stride 3; sample gets the uniforms
    and no dir_out, eval and pdf a dir_out and no uniforms; the outputs'
    shapes; and no import of sympy (seconds of a fresh process's set-up)."""
    out = subprocess.run([sys.executable, "-c", WRAPPER_PROBE], capture_output=True, text=True, check=True,
                         cwd=ROOT).stdout.splitlines()
    assert out[0] == "True"
    assert out[1] == ("[('tt_disney_sample', 11, True, False, 2), ('tt_disney_eval', 7, False, True, 1), "
                      "('tt_disney_pdf', 10, False, True, 1)]")
    assert out[2] == "[(40, 3), (40,), (40, 3), (40,), True]"
    assert out[3] == "False"


def test_wrapper_refuses_what_the_kernel_cannot_read():
    sp, dir_in, *u = disney_lanes(ST.MAT_DISNEY_METAL, 32, 2, "cpu")
    x = _launch.field("refl", sp.refl, 32, torch.float32, 3, dir_in.device)
    assert (x.p, x.s) == (sp.refl.data_ptr(), ST.MATTR_DIM)
    s = _launch.field("u1", u[1].expand(32) if u[1].dim() == 0 else u[1][:1].expand(32), 32, torch.float32, 1,
                      dir_in.device)
    assert s.s == 0  # a broadcast scalar is read in place too
    column_major = dir_in.t().contiguous().t()
    bad = {"dtype": ("u1", u[1].double(), 1), "shape": ("u1", u[1][:31], 1), "width": ("dir_in", dir_in[:, :2], 3),
           "last axis": ("dir_in", column_major, 3), "device": ("u1", torch.empty(32, device="meta"), 1),
           "tag dtype": ("tag", sp.tag.long(), 1)}
    for what, (name, t, width) in bad.items():
        dtype = torch.int32 if name == "tag" else torch.float32
        with pytest.raises(ValueError, match=name):
            _launch.field(name, t, 32, dtype, width, dir_in.device)
    with pytest.raises(ValueError, match="front"):
        disney._inputs(sp._replace(front=sp.front.float()), dir_in, dir_in, ())


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("tag", list(TAG_NAMES), ids=list(TAG_NAMES.values()))
def test_function_backward_equals_plain_autograd(entry, tag):
    """The autograd Function with the plain lobes standing in for the
    kernel: its gradients with respect to the material rows, dir_in and
    dir_out equal plain autograd's through the same lobes."""
    sp0, dir_in0, *u = disney_lanes(tag, 512, 5, "cpu", params=None)
    dir_out0 = disney_dir_out(tag, sp0, dir_in0, u, 5)
    rows = torch.stack([getattr(sp0, name) for name in DISNEY_COLUMNS], 1).double().requires_grad_(True)
    refl0 = sp0.refl.double().requires_grad_(True)

    def run(route):
        sp = sp0._replace(refl=refl0, **{name: rows[:, k] for k, name in enumerate(DISNEY_COLUMNS)})
        dir_in = dir_in0.double().requires_grad_(True)
        rest = [x.double() for x in u] if entry == "sample" else [dir_out0.double().requires_grad_(True)]
        out = route(sp, dir_in, rest)
        out = out if isinstance(out, tuple) else (out,)
        w = torch.Generator().manual_seed(7)
        loss = sum((o * torch.rand(o.shape, generator=w, dtype=o.dtype)).sum() for o in out)
        leaves = [rows, refl0, dir_in] + [x for x in rest if x.requires_grad]
        if not loss.requires_grad:  # a lobe that reads none of them (sheen's sample)
            return [None] * len(leaves)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    fn = disney._FUNCTIONS[entry]
    with mock.patch.object(disney, "_launch", _on_cpu):
        got = run(lambda sp, dir_in, rest: fn.apply(tag, type(sp), *sp, dir_in, *rest))
    want = run(lambda sp, dir_in, rest: disney._PLAIN[entry](tag, sp, dir_in, *rest))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, equal_nan=True)


# -- On the card --


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def kernel_and_plain(entry, tag, sp, dir_in, u, dir_out):
    rest = u if entry == "sample" else [dir_out]
    _launch.reset_launches()
    got = disney._route(entry, tag, sp, dir_in, *rest)
    assert disney.LAUNCHES[entry] == 1 and disney.LAUNCHES[f"{entry}_plain"] == 0
    return got, disney._PLAIN[entry](tag, sp, dir_in, *rest)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("case", ["metal", "glass", "clearcoat", "sheen", "disneybsdf", "ibl_disneybsdf", "ibl_chrome"])
def test_disney_kernel_equals_plain_on_card(card, entry, case):
    """take_disney_<entry> against the plain version on the card at 2^20
    lanes: both sides, grazing and below-horizon directions, glass at
    specTrans > 0, the composite at random parameters and at ibl's, ibl's
    chrome; lanes of other tags read 0. Bit for bit on at least DISNEY_BIT_SHARE of
    the lanes, within 4 ulps on all but DISNEY_ULP_LANES, and the pdf's zero or
    non-zero decisions the same on all but DISNEY_ZERO_FLIPS."""
    tag = {name: t for t, name in TAG_NAMES.items()} | {"ibl_disneybsdf": ST.MAT_DISNEY_BSDF,
                                                        "ibl_chrome": ST.MAT_DISNEY_METAL}
    tag = tag[case]
    params = {"ibl_disneybsdf": IBL_COMPOSITE, "ibl_chrome": IBL_CHROME}.get(case)
    sp, dir_in, *u = disney_lanes(tag, 1 << 20, 20 + tag, "cuda", params)
    dir_out = disney_dir_out(tag, sp, dir_in, u, 20 + tag)
    got, want = kernel_and_plain(entry, tag, sp, dir_in, u, dir_out)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    other = sp.tag != tag
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert not bool((g[other] != 0).any())
        share, _, far = agreement(g[~other], w[~other])
        assert share >= DISNEY_BIT_SHARE and far <= DISNEY_ULP_LANES * g.shape[0], (share, far)
    pdf_got, pdf_want = (got[1], want[1]) if entry == "sample" else (got[0], want[0]) if entry == "pdf" else (None, None)
    if pdf_got is not None:
        flips = ((pdf_got[~other] > 0) != (pdf_want[~other] > 0)).sum()
        assert int(flips) <= DISNEY_ZERO_FLIPS * pdf_got.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_disney_function_gradients_equal_plain_on_card(card, entry):
    """Under autograd the kernel runs through its Function, whose gradients
    equal plain autograd's on the card (the backward is the plain lobes')."""
    tag = ST.MAT_DISNEY_BSDF
    sp0, dir_in0, *u = disney_lanes(tag, 1 << 14, 9, "cuda")
    dir_out0 = disney_dir_out(tag, sp0, dir_in0, u, 9)

    def run(route):
        refl = sp0.refl.clone().requires_grad_(True)
        rough = sp0.roughness.clone().requires_grad_(True)
        dir_in = dir_in0.clone().requires_grad_(True)
        sp = sp0._replace(refl=refl, roughness=rough)
        rest = u if entry == "sample" else [dir_out0]
        out = route(sp, dir_in, rest)
        out = out if isinstance(out, tuple) else (out,)
        loss = sum(torch.nan_to_num(o, 0.0, 0.0, 0.0).sum() for o in out)
        return torch.autograd.grad(loss, [refl, rough, dir_in], allow_unused=True)

    _launch.reset_launches()
    got = run(lambda sp, dir_in, rest: disney._route(entry, tag, sp, dir_in, *rest))
    assert disney.LAUNCHES[entry] == 1
    want = run(lambda sp, dir_in, rest: disney._PLAIN[entry](tag, sp, dir_in, *rest))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.cuda
def test_ibl_pass_graph_launches_the_disney_kernels(card):
    """An ibl pass through a captured graph launches the kernels for every
    Disney dispatch (sample, eval, pdf; no plain call), counted at the
    capture's warm-up and at each replay, and its image is finite and close
    to the same pass with the plain lobes."""
    import importlib

    from chip_smoke import with_res
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    render = importlib.import_module("take_tpu_torch.render")
    scene = with_res(parse_scene_file(os.path.join(ROOT, "scenes", "ibl", "ibl.xml"), device="cuda"), 64)
    opts = RenderOptions(spp=1, max_depth=6, seed=11)
    render.clear_cache()
    _launch.reset_launches()
    img = render.render_image(scene, opts)
    first = dict(disney.LAUNCHES)
    img2 = render.render_image(scene, opts)
    per_replay = {k: disney.LAUNCHES[k] - first[k] for k in first}
    render.clear_cache()
    with mock.patch.object(disney, "_route", lambda entry, tag, sp, dir_in, *rest: disney._PLAIN[entry](
            tag, sp, dir_in, *rest)):
        plain = render.render_image(scene, opts)
    render.clear_cache()
    assert np.array_equal(img, img2) and np.isfinite(img).all()
    assert first == {k: 2 * v for k, v in per_replay.items()}  # the key's warm-up and its first replay
    assert not any(disney.LAUNCHES[f"{k}_plain"] for k in ENTRIES)
    # 2 Disney tags x (NEE eval + pdf, sample, the sample's eval) a bounce, over d6's 7 trips
    assert per_replay == {"sample": 14, "eval": 28, "pdf": 14, "sample_plain": 0, "eval_plain": 0, "pdf_plain": 0}
    rel = np.abs(img.reshape(-1, 3).mean(0) - plain.reshape(-1, 3).mean(0)) / plain.reshape(-1, 3).mean(0)
    assert (rel < 1e-3).all(), rel
