"""The BSDF dispatch's kernels (take_tpu_torch/csrc/bsdf.cu).

From the CPU: the route a CPU tensor takes, the source's constants and input
layout against the package's, its flags, the wrappers' plumbing with a
stand-in library (fields read in place through pointers and row strides, a
null sample pdf, no sympy), the Disney tags' selects over the kernel's
result, the glossy phase of the card's route, the routing between kernel and
autograd Function, the Function's backward against plain autograd, and the
runtime's registry. On the card (marked `cuda`, skipped without one): each
kernel against the plain dispatch at 2^20 lanes of every non-Disney tag, at
random parameters and at mis's exponents, a mixed batch with Disney lanes
through the whole dispatch, the Function's gradients, a cbox and a mis pass
graph's launches and a cbox replay gradient through the kernels. This file
imports neither JAX nor take_tpu, so its card part runs where only PyTorch
is:
    python -m pytest --noconftest tests/test_torch_bsdf_kernel.py -q
"""

import inspect
import os
import re
import subprocess
import sys
import types
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import BSDF_BIT_SHARE, BSDF_CASES, BSDF_TAGS, BSDF_ZERO_FLIPS, agreement, bsdf_args, bsdf_dir_out, \
    bsdf_lanes
from take_tpu_torch import tracing
from take_tpu_torch.geometry import _build, _launch
from take_tpu_torch.materials import bsdf, disney
from take_tpu_torch.scene import types as ST

ROOT = os.path.join(os.path.dirname(__file__), "..")
SOURCE = os.path.join(ROOT, "take_tpu_torch", "csrc", "bsdf.cu")
ENTRIES = ("sample", "eval", "pdf")
KEYS = tuple(f"bsdf_{entry}" for entry in ENTRIES)
CPU_CASES = ("diffuse", "plastic", "blinn_microfacet_mis", "mixed")


def _scene(tags):
    return types.SimpleNamespace(meta=types.SimpleNamespace(used_material_tags=tags))


def _on_cpu(entry, *xs):
    """A stand-in for bsdf._launch: the plain dispatch of every tag but the
    Disney ones, off the tape (Disney lanes 0, as the kernel writes them)."""
    with torch.no_grad():
        return bsdf._plain_of(entry, tuple(BSDF_TAGS.values()), xs)


def _public(entry, scene, lanes, dir_out):
    _, sp, dir_in, u_lobe, u1, u2, u3, sample_pdf = lanes
    if entry == "sample":
        return bsdf.bsdf_sample(scene, sp, dir_in, u_lobe, u1, u2, u3)
    if entry == "eval":
        return bsdf.bsdf_eval(scene, sp, dir_in, dir_out, sample_pdf)
    return bsdf.bsdf_pdf(scene, sp, dir_in, dir_out)


def _plain(entry, tags, lanes, dir_out):
    _, sp, dir_in, u_lobe, u1, u2, u3, sample_pdf = lanes
    rest = {"sample": (u_lobe, u1, u2, u3), "eval": (dir_out, sample_pdf), "pdf": (dir_out,)}[entry]
    return bsdf._PLAIN[entry](tags, sp, dir_in, *rest)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _same(a, b):
    """Equal element for element, NaN to NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _card_route():
    """The dispatch's card route on CPU tensors: tensors taken for CUDA ones,
    the kernel by its stand-in."""
    return (mock.patch.object(bsdf, "_launch", _on_cpu),
            mock.patch.object(torch.Tensor, "is_cuda", property(lambda self: True)))


# -- From the CPU --


@pytest.mark.parametrize("case", CPU_CASES)
def test_cpu_dispatch_takes_the_plain_route(case):
    """On CPU tensors each entry is the plain dispatch of the scene's used
    tags, counted once as a plain call, and launches nothing."""
    lanes = bsdf_lanes(case, 600, 3, "cpu")
    dir_out = bsdf_dir_out(lanes[0], lanes[1], lanes[2], lanes[3:6], 3)
    scene = _scene(lanes[0])
    _launch.reset_launches()
    for entry in ENTRIES:
        got, want = _public(entry, scene, lanes, dir_out), _plain(entry, lanes[0], lanes, dir_out)
        assert all(_same(a, b) for a, b in zip(_as_tuple(got), _as_tuple(want)))
    assert bsdf.LAUNCHES == {**dict.fromkeys(KEYS, 0), **{f"{k}_plain": 1 for k in KEYS}}
    # NEE's eval (no sample pdf) reads 0 for Plastic's flag
    _, sp, dir_in = lanes[:3]
    assert _same(bsdf.bsdf_eval(scene, sp, dir_in, dir_out),
                 bsdf._eval_plain(lanes[0], sp, dir_in, dir_out, torch.zeros_like(lanes[7])))


def test_kernel_constants_and_layout_equal_the_package():
    """bsdf.cu's tags are scene/types.py's (its Disney range disney.TAGS),
    its constants core/math.py's and bsdf.py's expressions (the G fit's
    coefficients, the clamps and epsilons), and its Inputs struct is
    bsdf._Inputs field for field."""
    text = open(SOURCE).read()
    ints = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    names = {"kDiffuse": "MAT_DIFFUSE", "kMirror": "MAT_MIRROR", "kPlastic": "MAT_PLASTIC", "kPhong": "MAT_PHONG",
             "kBlinnPhong": "MAT_BLINN_PHONG", "kMicrofacet": "MAT_BLINN_PHONG_MICROFACET",
             "kDisneyDiffuse": "MAT_DISNEY_DIFFUSE"}
    assert {k: ints[k] for k in names} == {k: getattr(ST, v) for k, v in names.items()}
    assert tuple(range(ints["kDisneyMetal"], ints["kDisneyBsdf"] + 1)) == disney.TAGS
    assert sorted(BSDF_TAGS.values()) == sorted(ints[k] for k in names)
    assert "constexpr double kPiD = 3.14159265358979323846;" in text
    consts = dict(re.findall(r"constexpr float (k\w+) = static_cast<float>\(([^;]+)\);", text))
    assert consts == {"kInvPi": "1.0 / kPiD", "kTwoPi": "2.0 * kPiD", "kInvTwoPi": "1.0 / (2.0 * kPiD)",
                      "kSingular": "-1.0 + 1e-6", "kHalfEps": "1e-12", "kPowFloor": "1e-30", "kG1": "3.535",
                      "kG2": "2.181", "kG3": "2.276", "kG4": "2.577", "kGMax": "1.6"}
    g_hat = inspect.getsource(bsdf._blinn_phong_G_hat)
    for k in ("kG1", "kG2", "kG3", "kG4"):
        assert f"{consts[k]} * a" in g_hat
    assert "a < 1.6" in g_hat and "min=1e-12" in g_hat
    assert "min=1e-30" in inspect.getsource(bsdf._powz)
    assert "eps=1e-12" in inspect.getsource(bsdf._bp_micro_eval)
    body = re.search(r"struct Inputs \{(.*?)\};", text, re.S).group(1)
    fields = re.findall(r"(\w+)(?=[,;])", re.sub(r"Field[FI]|int64_t", "", body))
    assert fields == [name for name, _ in bsdf._Inputs._fields_]
    assert set(bsdf._FIELDS) == {name for args in bsdf._ARGS.values() for name in args}


def test_source_builds_without_contraction_or_fast_math():
    flags = (*_build.NVCC_FLAGS, *_launch.SOURCES["bsdf"].flags)
    assert "--fmad=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    assert "--fmad=false" not in _build.NVCC_FLAGS  # the other sources keep their flags (and their hashes)


def test_registry_holds_the_keys_in_no_other_counter():
    """Each key of bsdf.LAUNCHES is registered to it alone (Disney's counter
    holds `sample`, `eval` and `pdf`), and a second declaration of one is
    refused."""
    assert set(bsdf.LAUNCHES) == {*KEYS, *(f"{k}_plain" for k in KEYS)}
    assert all(_launch.COUNTED[key] is bsdf.LAUNCHES for key in bsdf.LAUNCHES)
    assert not set(bsdf.LAUNCHES) & set(disney.LAUNCHES)
    assert [name for name, source in _launch.SOURCES.items() if source.lib is bsdf._lib] == ["bsdf"]
    with pytest.raises(ValueError, match="counted elsewhere"):
        _launch.declare("bsdf_again", {}, launches={"bsdf_eval": 0})


WRAPPER_PROBE = """
import ctypes, sys, types, torch
from take_tpu_torch.materials import bsdf
from take_tpu_torch.scene import types as ST
from chip_smoke import bsdf_args, bsdf_dir_out, bsdf_lanes
calls = []
class Lib:
    def __getattr__(self, name):
        def fn(ins, *out_and_stream):
            got = ins._obj
            calls.append((name, {f: (getattr(got, f).p, getattr(got, f).s) for f in bsdf._FIELDS}, got.n,
                          out_and_stream[:-1]))
            return 0
        return fn
bsdf._lib = Lib
torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(cuda_stream=0)
lanes = bsdf_lanes("mixed", 40, 3, "cpu")
dir_out = bsdf_dir_out(lanes[0], lanes[1], lanes[2], lanes[3:6], 3)
outs = {e: bsdf._launch(e, *bsdf_args(e, lanes, dir_out)[1]) for e in ("sample", "eval", "pdf")}
nee = list(bsdf_args("eval", lanes, dir_out)[1])
nee[-1] = None
bsdf._launch("eval", *nee)
sp = lanes[1]
base = sp.refl.data_ptr() - 4 * ST.MATTR_TEX_VALUE
ok = []
for (name, fields, n, out), entry in zip(calls, ("sample", "eval", "pdf", "eval")):
    ok.append(n == 40)
    for k in ("eta", "exponent", "roughness", "subsurface"):
        want = (base + 4 * getattr(ST, "MATTR_" + k.upper()), ST.MATTR_DIM) if k in bsdf._ARGS[entry] else (None, 0)
        ok.append(fields[k] == want)
    ok.append(fields["refl"] == ((base + 4 * ST.MATTR_TEX_VALUE, ST.MATTR_DIM) if entry == "eval" else (None, 0)))
    ok.append(fields["tag"] == (sp.tag.data_ptr(), 1) and fields["geo_n"] == (sp.geo_n.data_ptr(), 3))
    ok.append(fields["dir_in"] == (lanes[2].data_ptr(), 3))
print(all(ok))
print([(name, sum(p is not None for p, _ in fields.values()), fields["sample_pdf"][0] is None, len(out))
       for name, fields, _, out in calls])
print([tuple(o.shape) for e in ("sample", "eval", "pdf") for o in (outs[e] if isinstance(outs[e], tuple) else (outs[e],))])
print(calls[0][3][0] == outs["sample"][0].data_ptr(), "sympy" in sys.modules)
"""


def test_kernel_wrappers_read_in_place_and_launch():
    """The CUDA wrappers' plumbing, on CPU tensors with a stand-in library:
    each scalar of the shade point an entry reads is handed over as a
    pointer into the gathered [N, 24] rows with row stride 24 (no copy),
    refl as the rows' columns 7-9 (eval alone), the vectors with row stride
    3; the fields an entry does not read, and NEE's absent sample pdf, are
    left null; the outputs' pointers and shapes; and no import of sympy
    (seconds of a fresh process's set-up)."""
    out = subprocess.run([sys.executable, "-c", WRAPPER_PROBE], capture_output=True, text=True, check=True,
                         cwd=ROOT).stdout.splitlines()
    assert out[0] == "True"
    assert out[1] == ("[('tt_bsdf_sample', 9, True, 2), ('tt_bsdf_eval', 10, False, 1), ('tt_bsdf_pdf', 7, True, 1), "
                      "('tt_bsdf_eval', 9, True, 1)]")
    assert out[2] == "[(40, 3), (40,), (40, 3), (40,)]"
    assert out[3] == "True False"


def test_wrapper_refuses_what_the_kernel_cannot_read():
    lanes = bsdf_lanes("diffuse", 32, 2, "cpu")
    sp, dir_in = lanes[1], lanes[2]
    x = _launch.field("refl", sp.refl, 32, torch.float32, 3, dir_in.device)
    assert (x.p, x.s) == (sp.refl.data_ptr(), ST.MATTR_DIM)
    column_major = dir_in.t().contiguous().t()
    u1 = lanes[4]
    bad = {"dtype": ("u1", u1.double(), 1), "shape": ("u1", u1[:31], 1), "width": ("dir_in", dir_in[:, :2], 3),
           "last axis": ("dir_in", column_major, 3), "device": ("u1", torch.empty(32, device="meta"), 1),
           "tag dtype": ("tag", sp.tag.long(), 1)}
    for what, (name, t, width) in bad.items():
        dtype = torch.int32 if name == "tag" else torch.float32
        with pytest.raises(ValueError, match=name):
            _launch.field(name, t, 32, dtype, width, dir_in.device)
    args = list(bsdf_args("pdf", lanes, dir_in)[1])
    args[0] = sp.tag.long()
    with pytest.raises(ValueError, match="tag"):
        bsdf._launch("pdf", *args)


@pytest.mark.parametrize("case", CPU_CASES)
def test_card_route_selects_the_disney_tags_over_the_kernel(case):
    """The whole dispatch on the card's route (the kernel by its stand-in,
    which writes 0 on Disney lanes): each used Disney tag's lobes selected
    over the kernel's result give the plain dispatch of every used tag; one
    launch an entry, no plain call of the dispatch."""
    lanes = bsdf_lanes(case, 600, 4, "cpu")
    dir_out = bsdf_dir_out(lanes[0], lanes[1], lanes[2], lanes[3:6], 4)
    scene = _scene(lanes[0])
    want = {entry: _plain(entry, lanes[0], lanes, dir_out) for entry in ENTRIES}
    _launch.reset_launches()
    patches = _card_route()
    with patches[0], patches[1], mock.patch.object(disney, "_route", lambda entry, tag, sp, dir_in, *rest:
                                                   disney._PLAIN[entry](tag, sp, dir_in, *rest)):
        got = {entry: _public(entry, scene, lanes, dir_out) for entry in ENTRIES}
    for entry in ENTRIES:
        assert all(_same(a, b) for a, b in zip(_as_tuple(got[entry]), _as_tuple(want[entry])))
    assert bsdf.LAUNCHES == {**dict.fromkeys(KEYS, 1), **{f"{k}_plain": 0 for k in KEYS}}
    assert any(t in disney.TAGS for t in lanes[0])


@pytest.mark.parametrize("tags", [(0,), (0, 5), (0, 3, 7)], ids=["diffuse", "mis", "phong_metal"])
def test_card_route_marks_glossy_around_each_launch(tags):
    """With tracing on, the card's route wraps each kernel launch in phase
    glossy where the used tags hold a Phong, Blinn-Phong or microfacet tag,
    and in no phase of its own elsewhere; the Disney tags' lobes mark
    disney after it."""
    lanes = bsdf_lanes("diffuse", 64, 5, "cpu")
    lanes = (tags, lanes[1]._replace(tag=torch.full_like(lanes[1].tag, tags[-1])), *lanes[2:])
    scene = _scene(tags)

    def quiet(entry, *xs):  # a stand-in that marks nothing of its own
        n = xs[0].shape[0]
        return (torch.zeros(n, 3), torch.zeros(n)) if entry == "sample" else torch.zeros((n, 3) if entry == "eval" else n)

    patches = (mock.patch.object(bsdf, "_launch", quiet), _card_route()[1])
    tracing.enable()
    tracing.reset()
    try:
        with patches[0], patches[1], mock.patch.object(disney, "_route", lambda entry, tag, sp, dir_in, *rest:
                                                       disney._PLAIN[entry](tag, sp, dir_in, *rest)):
            tracing.mark("bsdf")
            for entry in ENTRIES:
                _public(entry, scene, lanes, lanes[2])
        marks = [p for _, p in tracing.marks()]
    finally:
        tracing.disable()
        tracing.reset()
    glossy = any(t in bsdf.GLOSSY for t in tags)
    per_entry = (["glossy", "bsdf"] if glossy else []) + (["disney", "bsdf"] if 7 in tags else [])
    assert marks == ["bsdf"] + per_entry * 3


@pytest.mark.parametrize("tags", [(0,), (0, 5)], ids=["diffuse", "mis"])
def test_routing_takes_the_function_only_under_autograd(tags):
    """With the lanes taken for card tensors and a stand-in launcher: the
    kernel without autograd, under no_grad and with no input that the used
    tags' lobes read requiring grad (a field no entry reads, or the
    exponent on a scene with no glossy tag, may); the autograd Function
    where grad is enabled and such an input requires it (the Function's
    forward launches once); each counted as a launch."""
    lanes = bsdf_lanes("mixed", 64, 6, "cpu")
    sp, dir_in = lanes[1:3]
    launched = []

    def stand_in(entry, *xs):
        launched.append((entry, torch.is_grad_enabled()))
        return _on_cpu(entry, *xs)

    def run(entry, field):
        s = sp._replace(**{field: getattr(sp, field).clone().requires_grad_(True)}) if field else sp
        rest = {"sample": lanes[3:6], "eval": (dir_in, lanes[7]), "pdf": (dir_in,)}[entry]
        launched.clear()
        with mock.patch.object(bsdf, "_launch", stand_in), \
                mock.patch.object(torch.Tensor, "is_cuda", property(lambda self: True)):
            out = bsdf._route(entry, tags, s, dir_in, *rest)
        return _as_tuple(out), list(launched)

    def function(out):
        return out[0].grad_fn is not None and type(out[0].grad_fn).__name__ == "_DispatchBackward"

    _launch.reset_launches()
    for entry in ENTRIES:
        for field in (None, "metallic"):  # no field, a field no entry reads
            out, calls = run(entry, field)
            assert calls == [(entry, True)] and not any(o.requires_grad for o in out)
        with torch.no_grad():
            out, calls = run(entry, "sh_n")
        assert calls == [(entry, False)] and not any(o.requires_grad for o in out)
        out, calls = run(entry, "sh_n")
        assert calls == [(entry, False)] and function(out)  # the Function's forward runs without grad
        out, calls = run(entry, "exponent")
        assert function(out) == (5 in tags) and calls == [(entry, 5 not in tags)]
    out, calls = run("eval", "refl")
    assert calls == [("eval", False)] and function(out)
    out, calls = run("sample", "refl")
    assert calls == [("sample", True)] and not function(out)
    assert bsdf.LAUNCHES == {"bsdf_sample": 6, "bsdf_eval": 6, "bsdf_pdf": 5, **{f"{k}_plain": 0 for k in KEYS}}


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("case", ["plastic", "phong", "blinnphong_mis", "blinn_microfacet_mis", "disneydiffuse",
                                  "mixed"])
def test_function_backward_equals_plain_autograd(entry, case):
    """The autograd Function with the plain dispatch standing in for the
    kernel: its gradients with respect to the material rows, the normals,
    dir_in, dir_out and the sample's pdf equal plain autograd's through the
    plain dispatch of the same tags, in float64."""
    lanes = bsdf_lanes(case, 512, 7, "cpu")
    tags = tuple(t for t in lanes[0] if t not in disney.TAGS)
    sp0, dir_in0 = lanes[1], lanes[2]
    dir_out0 = bsdf_dir_out(tags, sp0, dir_in0, lanes[3:6], 7)
    finite = torch.isfinite(dir_in0).all(1) & torch.isfinite(dir_out0).all(1) & (sp0.geo_n.abs().sum(1) > 0)
    sp0 = sp0._replace(tag=torch.where(finite, sp0.tag, 0))

    def run(route):
        rows = torch.stack([sp0.eta, sp0.exponent, sp0.roughness, sp0.subsurface], 1).double().requires_grad_(True)
        refl = sp0.refl.double().requires_grad_(True)
        geo_n, sh_n = sp0.geo_n.double().requires_grad_(True), sp0.sh_n.double().requires_grad_(True)
        sp = sp0._replace(refl=refl, geo_n=geo_n, sh_n=sh_n, eta=rows[:, 0], exponent=rows[:, 1],
                          roughness=rows[:, 2], subsurface=rows[:, 3])
        dir_in = torch.where(finite[:, None], dir_in0, 1.0).double().requires_grad_(True)
        dir_out = torch.where(finite[:, None], dir_out0, 1.0).double().requires_grad_(True)
        sample_pdf = lanes[7].double().requires_grad_(True)
        rest = {"sample": tuple(x.double() for x in lanes[3:6]), "eval": (dir_out, sample_pdf),
                "pdf": (dir_out,)}[entry]
        out = _as_tuple(route(sp, dir_in, rest))
        w = torch.Generator().manual_seed(7)
        loss = sum((torch.nan_to_num(o, 0.0, 0.0, 0.0) * torch.rand(o.shape, generator=w, dtype=o.dtype)).sum()
                   for o in out)
        leaves = [rows, refl, geo_n, sh_n, dir_in] + [x for x in rest if x.requires_grad]
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    def through_function(sp, dir_in, rest):
        return bsdf._Dispatch.apply(entry, tags, *bsdf._arguments(entry, sp, dir_in, *rest))

    with mock.patch.object(bsdf, "_launch", lambda e, *xs: _on_cpu(e, *xs)):
        got = run(through_function)
    want = run(lambda sp, dir_in, rest: bsdf._PLAIN[entry](tags, sp, dir_in, *rest))
    assert any(a is not None for a in want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, equal_nan=True)


# -- On the card --


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("case", BSDF_CASES)
def test_bsdf_kernel_equals_plain_on_card(card, entry, case):
    """take_bsdf_<entry> against the plain dispatch of the same tags (but
    the Disney ones) on the card at 2^20 lanes of `case`
    (chip_smoke.bsdf_lanes: each non-Disney tag at random parameters, the
    glossy tags at mis's exponents, every tag mixed; grazing, below-horizon,
    backface, pole, dead and zero-direction lanes; Plastic's flag): every
    output bit for bit on at least BSDF_BIT_SHARE of the lanes, the pdf's
    zero decisions flipped on at most BSDF_ZERO_FLIPS, Disney lanes 0, and
    one launch counted."""
    lanes = bsdf_lanes(case, 1 << 20, 30 + len(case), "cuda")
    dir_out = bsdf_dir_out(lanes[0], lanes[1], lanes[2], lanes[3:6], 30 + len(case))
    tags, kargs, pargs = bsdf_args(entry, lanes, dir_out)
    _launch.reset_launches()
    got = _as_tuple(bsdf._route(entry, tags, *pargs))
    assert bsdf.LAUNCHES[f"bsdf_{entry}"] == 1 and bsdf.LAUNCHES[f"bsdf_{entry}_plain"] == 0
    want = _as_tuple(bsdf._PLAIN[entry](tags, *pargs))
    dis = torch.isin(lanes[1].tag, torch.tensor(disney.TAGS, device="cuda"))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert not bool((g[dis] != 0).any())
        share, most, far = agreement(g, w)
        assert share >= BSDF_BIT_SHARE, (share, most, far)
    if entry != "eval":
        assert int(((got[-1] > 0) != (want[-1] > 0)).sum()) <= BSDF_ZERO_FLIPS * got[-1].shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_mixed_dispatch_equals_plain_on_card(card, entry):
    """The whole dispatch on the card (the kernel, then each used Disney
    tag's kernel selected in) against the plain dispatch of every used tag
    at 2^20 lanes of every tag mixed: bit for bit on at least
    BSDF_BIT_SHARE of the lanes."""
    lanes = bsdf_lanes("mixed", 1 << 20, 44, "cuda")
    dir_out = bsdf_dir_out(lanes[0], lanes[1], lanes[2], lanes[3:6], 44)
    _launch.reset_launches()
    got = _as_tuple(_public(entry, _scene(lanes[0]), lanes, dir_out))
    assert bsdf.LAUNCHES[f"bsdf_{entry}"] == 1 and disney.LAUNCHES[entry] == len(disney.TAGS)
    want = _as_tuple(_plain(entry, lanes[0], lanes, dir_out))
    for g, w in zip(got, want):
        share, most, far = agreement(g, w)
        assert share >= BSDF_BIT_SHARE, (share, most, far)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_bsdf_function_gradients_equal_plain_on_card(card, entry):
    """Under autograd the kernel runs through its Function, whose gradients
    equal plain autograd's on the card (the backward is the plain
    dispatch's)."""
    lanes = bsdf_lanes("mixed", 1 << 14, 9, "cuda")
    tags = tuple(t for t in lanes[0] if t not in disney.TAGS)
    sp0, dir_in0 = lanes[1], lanes[2]
    dir_out0 = bsdf_dir_out(tags, sp0, dir_in0, lanes[3:6], 9)

    def run(route):
        refl = sp0.refl.clone().requires_grad_(True)
        expo = sp0.exponent.clone().requires_grad_(True)
        sh_n = sp0.sh_n.clone().requires_grad_(True)
        dir_in = dir_in0.clone().requires_grad_(True)
        sp = sp0._replace(refl=refl, exponent=expo, sh_n=sh_n)
        rest = {"sample": lanes[3:6], "eval": (dir_out0, lanes[7]), "pdf": (dir_out0,)}[entry]
        out = _as_tuple(route(sp, dir_in, rest))
        loss = sum(torch.nan_to_num(o, 0.0, 0.0, 0.0).sum() for o in out)
        return torch.autograd.grad(loss, [refl, expo, sh_n, dir_in], allow_unused=True)

    _launch.reset_launches()
    got = run(lambda sp, dir_in, rest: bsdf._route(entry, tags, sp, dir_in, *rest))
    assert bsdf.LAUNCHES[f"bsdf_{entry}"] == 1
    want = run(lambda sp, dir_in, rest: bsdf._PLAIN[entry](tags, sp, dir_in, *rest))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def _all_plain():
    """bsdf._route patched to the plain dispatch of the same tags."""
    return mock.patch.object(bsdf, "_route", lambda entry, tags, sp, dir_in, *rest: bsdf._PLAIN[entry](
        tuple(t for t in tags if t not in disney.TAGS), sp, dir_in, *rest))


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name,depth", [("cbox", 4), ("mis", 6)])
def test_pass_graph_launches_the_bsdf_kernels(card, scene_name, depth):
    """A cbox d4 pass and a mis d6 pass through a captured graph launch the
    dispatch's kernels 4 times a trip (NEE's eval and pdf, the sample and
    its eval; no plain call), counted at the capture's warm-up and at each
    replay, and each image is finite and close to the same pass with the
    plain dispatch."""
    import importlib

    from chip_smoke import with_res
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    render = importlib.import_module("take_tpu_torch.render")
    scene = with_res(parse_scene_file(os.path.join(ROOT, "scenes", scene_name, f"{scene_name}.xml"), device="cuda"),
                     64)
    opts = RenderOptions(spp=1, max_depth=depth, seed=11)
    render.clear_cache()
    _launch.reset_launches()
    img = render.render_image(scene, opts)
    first = dict(bsdf.LAUNCHES)
    img2 = render.render_image(scene, opts)
    per_replay = {k: bsdf.LAUNCHES[k] - first[k] for k in first}
    render.clear_cache()
    with _all_plain():
        plain = render.render_image(scene, opts)
    render.clear_cache()
    assert np.array_equal(img, img2) and np.isfinite(img).all()
    assert first == {k: 2 * v for k, v in per_replay.items()}  # the key's warm-up and its first replay
    trips = depth + 1
    assert per_replay == {"bsdf_sample": trips, "bsdf_eval": 2 * trips, "bsdf_pdf": trips,
                          **{f"{k}_plain": 0 for k in KEYS}}
    np.testing.assert_array_equal(img, plain)


@pytest.mark.cuda
def test_cbox_replay_gradient_through_the_kernels(card):
    """cbox's replay gradient (the benchmark's grad cell at 64x64: the
    forward and pass 1 through the kernels, pass 2 through the Function)
    equals the all-plain one within grad_gap's limit (3e-3 of the larger
    norm, portbench/limits) on every table, and is the same from run to
    run."""
    import importlib

    from chip_smoke import SCENE, with_res
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions, float_tables

    grad = importlib.import_module("take_tpu_torch.grad")
    scene = with_res(parse_scene_file(str(SCENE), device="cuda"), 64)
    W = 64
    pix = torch.arange(W * W, device="cuda")
    target = torch.full((W * W, 3), 0.2, device="cuda")
    opts = RenderOptions(spp=1, max_depth=4, seed=5, grad_mode="replay")

    def run():
        _launch.reset_launches()
        loss, g = grad.render_loss_grad(scene, opts, pix, target, 1)
        return float(loss), {k: v.detach().clone() for k, v in float_tables(g).items() if v is not None}

    render = importlib.import_module("take_tpu_torch.render")
    render.clear_cache()
    loss, got = run()
    assert all(bsdf.LAUNCHES[k] > 0 for k in KEYS) and not any(bsdf.LAUNCHES[f"{k}_plain"] for k in KEYS)
    loss2, again = run()
    render.clear_cache()  # the graphs hold the kernels' route
    with _all_plain():
        loss_p, want = run()
    render.clear_cache()
    assert loss == loss2 and all(torch.equal(got[k], again[k]) for k in got)
    assert abs(loss - loss_p) <= 1e-6 * abs(loss_p)
    assert got.keys() == want.keys()
    for k in got:
        scale = max(float(want[k].norm()), float(got[k].norm()), 1e-30)
        assert float((got[k] - want[k]).norm()) <= 3e-3 * scale, k
