"""The light phase's kernels (take_tpu_torch/csrc/light.cu).

From the CPU: the route a CPU tensor takes, the source's constants and
struct layouts against the package's, its flags, the wrappers' plumbing
with a stand-in library (fields read in place through pointers and row
strides, a broadcast background, no sympy), the routing between kernel and
autograd Function, and the Function's backward against plain autograd. On
the card (marked `cuda`, skipped without one): each kernel against the
plain version at 2^20 lanes of every kind of light slot, the Function's
gradients, a cbox pass graph's launches and a cbox replay gradient through
the kernels. This file imports neither JAX nor take_tpu, so its card part
runs where only PyTorch is:
    python -m pytest --noconftest tests/test_torch_light_kernel.py -q
"""

import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import LIGHT_BIT_SHARE, LIGHT_CASES, agreement, light_args, light_lanes
from take_tpu_torch.geometry import _build, _launch
from take_tpu_torch.integrator import light
from take_tpu_torch.scene import types as ST

ROOT = os.path.join(os.path.dirname(__file__), "..")
SOURCE = os.path.join(ROOT, "take_tpu_torch", "csrc", "light.cu")
ENTRIES = ("sample", "nee", "arrival")
KEYS = tuple(f"light_{entry}" for entry in ENTRIES)


def _on_cpu(entry, scene, *xs):
    """A stand-in for light._launch: the plain version, off the tape."""
    with torch.no_grad():
        out = light._PLAIN[entry](scene, *xs)
    return out if isinstance(out, tuple) else (out,)


# -- From the CPU --


@pytest.mark.parametrize("case", LIGHT_CASES)
def test_cpu_light_takes_the_plain_route(case):
    lanes = light_lanes(case, 512, 3, "cpu")
    scene = lanes[0]
    _launch.reset_launches()
    ls = light.sample(scene, *lanes[1])
    assert all(torch.equal(a, b) for a, b in zip(ls, light._sample_plain(scene, *lanes[1])))
    c1 = light.nee(scene, ls, *lanes[2])
    assert torch.equal(c1, light._nee_plain(scene, *light_args("nee", lanes)))
    prev, dir_out, fg, bpdf, spec, ok, active, valid, light_id, pos, geo_n, geom, emit, bg, env_pdf = lanes[3]
    hit = ST.Hit(valid, None, pos, geo_n, None, None, None, light_id, emit=emit, light_geom=geom)
    got = light.arrival(scene, prev, dir_out, fg, bpdf, spec, ok, active, hit, bg[:1].reshape(3) if bg.stride(0) == 0
                        else bg, env_pdf)
    want = light._arrival_plain(scene, *lanes[3])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert light.LAUNCHES == {**dict.fromkeys(KEYS, 0), **{f"{k}_plain": 1 for k in KEYS}}


def test_kernel_constants_and_layout_equal_the_package():
    """light.cu's light table columns, tags and shapes are scene/types.py's,
    its clamps and constants the plain version's Python floats rounded to
    float32, and its Inputs and Outputs structs are light._Inputs and
    light._Outputs field for field."""
    text = open(SOURCE).read()
    ints = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    columns = {"kAttrDim": "LATTR_DIM", "kTag": "LATTR_TAG", "kKind": "LATTR_KIND", "kInvArea": "LATTR_INV_AREA",
               "kIntensity": "LATTR_INTENSITY", "kPos": "LATTR_POS", "kRadius": "LATTR_RADIUS", "kV0": "LATTR_V0",
               "kE1": "LATTR_E1", "kE2": "LATTR_E2", "kN0": "LATTR_N0", "kN1": "LATTR_N1", "kN2": "LATTR_N2"}
    assert {k: ints[k] for k in columns} == {k: getattr(ST, name) for k, name in columns.items()}
    floats = {k: float(v) for k, v in re.findall(r"constexpr float (k\w+) = ([\d.]+)f;", text)}
    assert floats == {"kLightPoint": ST.LIGHT_POINT, "kLightArea": ST.LIGHT_AREA, "kShapeSphere": ST.SHAPE_SPHERE}
    clamps = dict(re.findall(r"constexpr float (k\w+) = static_cast<float>\(([^;]+)\);", text))
    assert clamps == {"kTwoPi": "2.0 * kPiD", "kSingular": "-1.0 + 1e-6", "kShadowScale": "1.0 - 1e-3",
                      "kMinDist": "1e-30", "kMinCos": "1e-12", "kMinCapDist": "1e-6", "kMaxPdf": "1e18"}
    assert "constexpr double kPiD = 3.14159265358979323846;" in text
    plain = open(light.__file__).read() + open(os.path.join(ROOT, "take_tpu_torch", "lights", "lights.py")).read()
    for value in ("1.0 - 1e-3", "min=1e-30", "min=1e-12", "max=1e18", "min=1e-6"):
        assert value in plain
    for struct, fields in (("Inputs", light._Inputs._fields_), ("Outputs", light._Outputs._fields_)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", text, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        names = re.findall(r"(\w+)(?=[,;])", re.sub(r"(Field[FIB]|const float\*|float\*|uint8_t\*|int32_t\*|"
                                                     r"int64_t|int32_t)", "", body))
        assert names == [name for name, _ in fields]


def test_source_builds_without_contraction_or_fast_math():
    flags = (*_build.NVCC_FLAGS, *_launch.SOURCES["light"].flags)
    assert "--fmad=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    assert "--fmad=false" not in _build.NVCC_FLAGS  # the other sources keep their flags (and their hashes)
    assert all(_launch.COUNTED[key] is light.LAUNCHES for key in light.LAUNCHES)


WRAPPER_PROBE = """
import ctypes, sys, types, torch
from take_tpu_torch.integrator import light
from chip_smoke import light_args, light_lanes
calls = []
class Lib:
    def __getattr__(self, name):
        def fn(ins, outs, stream):
            got, out = ins._obj, outs._obj
            calls.append((name, {f: (getattr(got, f).p, getattr(got, f).s) for f in light._FIELDS},
                          {f: getattr(got, f) for f in ("lights", "n", *light._META)},
                          {f: getattr(out, f) for f, _ in out._fields_}))
            return 0
        return fn
light._lib = Lib
torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(cuda_stream=0)
lanes = light_lanes("mixed", 40, 3, "cpu")
scene = lanes[0]
every = {e: light_args(e, lanes) for e in ("sample", "nee", "arrival")}
outs = {e: light._launch(e, scene, *args) for e, args in every.items()}
flat = light_lanes("triangle", 40, 3, "cpu")
light._launch("arrival", flat[0], *light_args("arrival", flat))
ok = []
for (name, fields, ints, out), entry in zip(calls, ("sample", "nee", "arrival")):
    args = every[entry]
    ok.append(ints["n"] == 40 and ints["lights"] == (None if entry == "arrival" else scene.lights.attr.data_ptr()))
    ok.append([ints[k] for k in light._META] == [4, 5, 1, 1, 1, 1])
    for (field, _, _), x in zip(light._ARGS[entry], args):
        if field != "lights":
            ok.append(fields[field] == ((x.data_ptr(), x.stride(0)) if x is not None else (None, 0)))
    mine = [f for f, _, _ in light._OUTS[entry]]
    ok.append([out[f] for f in mine] == [o.data_ptr() for o in outs[entry]])
    ok.append(all(out[f] is None for f in out if f not in mine))
print(all(ok))
print([(name, sum(p is not None for p, _ in fields.values())) for name, fields, _, _ in calls])
print([[tuple(o.shape) for o in outs[e]] for e in ("sample", "nee", "arrival")])
print(calls[2][1]["background"][1], calls[3][1]["background"][1], calls[3][1]["env_pdf"][0],
      [calls[3][2][k] for k in light._META], "sympy" in sys.modules)
"""


def test_kernel_wrappers_read_in_place_and_launch():
    """The CUDA wrappers' plumbing, on CPU tensors with a stand-in library:
    each argument handed over as a pointer and a row stride (no copy), a
    flat background at stride 0, the light table (sample and nee) and the
    scene's meta, fields another kernel reads left null, the outputs' pointers and
    shapes; and no import of sympy (seconds of a fresh process's set-up)."""
    out = subprocess.run([sys.executable, "-c", WRAPPER_PROBE], capture_output=True, text=True, check=True,
                         cwd=ROOT).stdout.splitlines()
    assert out[0] == "True"
    assert out[1] == ("[('tt_light_sample', 6), ('tt_light_nee', 13), ('tt_light_arrival', 15), "
                      "('tt_light_arrival', 14)]")
    assert out[2] == ("[[(40, 3), (40,), (40,), (40,), (40,), (40,), (40,), (40,), (40,)], [(40, 3)], "
                      "[(40, 3), (40, 3), (40, 3)]]")
    # mixed has an environment map: a [N, 3] background; triangle's flat one is read at stride 0, no env_pdf
    assert out[3] == "3 0 None [2, 2, 0, 0, 1, 0] False"


def test_wrapper_refuses_what_the_kernel_cannot_read():
    lanes = light_lanes("triangle", 32, 2, "cpu")
    pos = lanes[1][3]
    x = _launch.field("pos", pos[::2], 16, torch.float32, 3, pos.device)
    assert (x.p, x.s) == (pos.data_ptr(), 6)  # a strided view is read in place
    column_major = pos.t().contiguous().t()
    bad = {"dtype": ("u1", lanes[1][1].double(), torch.float32, 1), "shape": ("u1", lanes[1][1][:31], torch.float32, 1),
           "width": ("pos", pos[:, :2], torch.float32, 3), "last axis": ("pos", column_major, torch.float32, 3),
           "device": ("u1", torch.empty(32, device="meta"), torch.float32, 1),
           "flag dtype": ("spec", lanes[2][3].to(torch.uint8), torch.bool, 1)}
    for what, (name, t, dtype, width) in bad.items():
        with pytest.raises(ValueError, match=name):
            _launch.field(name, t, 32, dtype, width, pos.device)
    with pytest.raises(ValueError, match="lights"):
        light._table(lanes[0].lights.attr[:, :16], pos.device)
    with pytest.raises(ValueError, match="lights"):
        light._table(lanes[0].lights.attr.double(), pos.device)


def test_routing_takes_the_function_only_under_autograd():
    """With the lanes taken for card tensors and a stand-in launcher: the
    kernel without autograd, under no_grad and with no input that requires
    grad; the autograd Function where grad is enabled and an input requires
    it (the Function's forward launches once); each counted as a launch."""
    lanes = light_lanes("mixed", 64, 4, "cpu")
    scene = lanes[0]
    launched = []

    def stand_in(entry, scene, *xs):
        launched.append((entry, torch.is_grad_enabled()))
        return _on_cpu(entry, scene, *xs)

    def run(entry, grad_input):
        args = list(light_args(entry, lanes))
        if grad_input:
            k = {"sample": 5, "nee": 7, "arrival": 2}[entry]  # env_dir, FG, FG
            args[k] = args[k].clone().requires_grad_(True)
        launched.clear()
        with mock.patch.object(light, "_launch", stand_in), \
                mock.patch.object(torch.Tensor, "is_cuda", property(lambda self: True)):
            out = light._route(entry, scene, *args)
        return out, list(launched)

    _launch.reset_launches()
    for entry in ENTRIES:
        out, calls = run(entry, False)
        assert calls == [(entry, True)] and not any(o.requires_grad for o in out)
        with torch.no_grad():
            out, calls = run(entry, True)
        assert calls == [(entry, False)] and not any(o.requires_grad for o in out)
        out, calls = run(entry, True)
        assert calls == [(entry, False)]  # the Function's forward runs without grad
        assert out[0].grad_fn is not None and type(out[0].grad_fn).__name__ == "_LightBackward"
    assert light.LAUNCHES == {**{k: 3 for k in KEYS}, **{f"{k}_plain": 0 for k in KEYS}}


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("case", ["mixed", "env"])
def test_function_backward_equals_plain_autograd(entry, case):
    """The autograd Function with the plain version standing in for the
    kernel: its gradients with respect to every differentiable input (the
    light table's intensity, FG, bp and bpdf, the environment's radiance,
    direction and pdf, the emission and the background) equal plain
    autograd's through the same code, in float64."""
    lanes = light_lanes(case, 512, 6, "cpu")
    scene = lanes[0]
    scene.lights.attr = scene.lights.attr.double()
    args0 = [x.double() if x is not None and x.is_floating_point() else x for x in light_args(entry, lanes)]
    wants = {"sample": ("env_dir",), "nee": ("lights", "fg", "bp", "li_env", "env_pdf"),
             "arrival": ("fg", "bpdf", "emit", "background", "env_pdf")}[entry]

    def run(route):
        args = [x.clone().requires_grad_(True) if x is not None and f in wants else x
                for (f, _, _), x in zip(light._ARGS[entry], args0)]
        out = route(args)
        out = out if isinstance(out, tuple) else (out,)
        w = torch.Generator().manual_seed(7)
        loss = sum((o * torch.rand(o.shape, generator=w, dtype=o.dtype)).sum() for o in out if o.is_floating_point())
        leaves = [x for x in args if x is not None and x.requires_grad]
        if not loss.requires_grad:  # env's sample reads env_dir only where the scene has an environment map
            return [None] * len(leaves)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    with mock.patch.object(light, "_launch", _on_cpu):
        got = run(lambda args: light._Light.apply(entry, scene, *args))
    want = run(lambda args: light._PLAIN[entry](scene, *args))
    assert len(got) == len(want) and any(a is not None for a in want)
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
@pytest.mark.parametrize("case", LIGHT_CASES)
def test_light_kernel_equals_plain_on_card(card, entry, case):
    """take_light_<entry> against the plain version on the card at 2^20
    lanes of `case` (chip_smoke.light_lanes: triangle lights with and
    without corner normals, a sphere light, a point light, the environment
    slot alone and every kind mixed with it; hit points at a light's sampled
    point and at the point light (d = 0), in a light's plane (grazing) and
    behind it; specular and dead lanes, bp = 0 and at its clamp, bpdf above
    its clamp, misses and emitter hits): every output bit for bit on at
    least LIGHT_BIT_SHARE of the lanes, and one launch counted."""
    lanes = light_lanes(case, 1 << 20, 30 + len(case), "cuda")
    args = light_args(entry, lanes)
    _launch.reset_launches()
    got = light._route(entry, lanes[0], *args)
    assert light.LAUNCHES[f"light_{entry}"] == 1 and light.LAUNCHES[f"light_{entry}_plain"] == 0
    want = light._PLAIN[entry](lanes[0], *args)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        share, most, _ = agreement(g.float(), w.float())
        assert share >= LIGHT_BIT_SHARE, (share, most)


@pytest.mark.cuda
def test_sphere_sample_equals_plain_at_every_u2_on_card(card):
    """take_light_sample on a sphere light at every 24-bit u2 the counter
    RNG draws (2^24 lanes in 16 calls), bit for bit the plain version on
    every lane: the kernel's sine and cosine of 2 pi u2 (libdevice's,
    written out) are torch.sin's and torch.cos's over the whole range."""
    lanes = light_lanes("sphere", 1 << 20, 12, "cuda")
    u_sel, u1, _, pos, rd, env_dir = lanes[1]
    for k in range(16):
        u2 = (torch.arange(1 << 20, device="cuda", dtype=torch.float64) + (k << 20)) / (1 << 24)
        args = (u_sel, u1, u2.float(), pos, rd, env_dir)
        got, want = light._launch("sample", lanes[0], *args), light._PLAIN["sample"](lanes[0], *args)
        for g, w in zip(got, want):
            assert agreement(g.float(), w.float())[0] == 1.0, k


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ENTRIES)
def test_light_function_gradients_equal_plain_on_card(card, entry):
    """Under autograd the kernel runs through its Function, whose gradients
    equal plain autograd's on the card (the backward is the plain
    version's)."""
    lanes = light_lanes("mixed", 1 << 14, 9, "cuda")
    args0 = light_args(entry, lanes)
    wants = {"sample": ("env_dir",), "nee": ("lights", "fg", "bp", "li_env", "env_pdf"),
             "arrival": ("fg", "bpdf", "emit", "background", "env_pdf")}[entry]

    def run(route):
        args = [x.clone().requires_grad_(True) if x is not None and f in wants else x
                for (f, _, _), x in zip(light._ARGS[entry], args0)]
        out = route(args)
        loss = sum(torch.nan_to_num(o, 0.0, 0.0, 0.0).sum() for o in out if o.is_floating_point())
        return torch.autograd.grad(loss, [x for x in args if x is not None and x.requires_grad], allow_unused=True)

    _launch.reset_launches()
    got = run(lambda args: light._route(entry, lanes[0], *args))
    assert light.LAUNCHES[f"light_{entry}"] == 1
    want = run(lambda args: _as_tuple(light._PLAIN[entry](lanes[0], *args)))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _cbox(width):
    from chip_smoke import SCENE, with_res
    from take_tpu_torch.scene.parse_xml import parse_scene_file

    return with_res(parse_scene_file(str(SCENE), device="cuda"), width)


def _all_plain():
    """light._route patched to the plain versions."""
    return mock.patch.object(light, "_route", lambda entry, scene, *xs: _as_tuple(light._PLAIN[entry](scene, *xs)))


@pytest.mark.cuda
def test_cbox_pass_graph_launches_the_light_kernels(card):
    """A cbox d4 pass through a captured graph launches the three kernels on
    each of its 5 trips (15 a replay; no plain call), counted at the
    capture's warm-up and at each replay, and its image is finite and close
    to the same pass with the plain light phase."""
    import importlib

    from take_tpu_torch.scene.types import RenderOptions

    render = importlib.import_module("take_tpu_torch.render")
    scene = _cbox(64)
    opts = RenderOptions(spp=1, max_depth=4, seed=11)
    render.clear_cache()
    _launch.reset_launches()
    img = render.render_image(scene, opts)
    first = dict(light.LAUNCHES)
    img2 = render.render_image(scene, opts)
    per_replay = {k: light.LAUNCHES[k] - first[k] for k in first}
    render.clear_cache()
    with _all_plain():
        plain = render.render_image(scene, opts)
    render.clear_cache()
    assert np.array_equal(img, img2) and np.isfinite(img).all()
    assert first == {k: 2 * v for k, v in per_replay.items()}  # the key's warm-up and its first replay
    assert per_replay == {**dict.fromkeys(KEYS, 5), **{f"{k}_plain": 0 for k in KEYS}}
    rel = np.abs(img.reshape(-1, 3).mean(0) - plain.reshape(-1, 3).mean(0)) / plain.reshape(-1, 3).mean(0)
    assert (rel < 1e-5).all(), rel


@pytest.mark.cuda
def test_cbox_replay_gradient_through_the_kernels(card):
    """cbox's replay gradient (the benchmark's grad cell at 64x64: the
    forward and pass 1 through the kernels, pass 2 through the Function)
    equals the all-plain one within grad_gap's limit (3e-3 of the larger
    norm, portbench/limits) on every table, and is the same from run to
    run."""
    import importlib

    from take_tpu_torch.scene.types import RenderOptions, float_tables

    grad = importlib.import_module("take_tpu_torch.grad")
    scene = _cbox(64)
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
    assert all(light.LAUNCHES[k] > 0 for k in KEYS) and not any(light.LAUNCHES[f"{k}_plain"] for k in KEYS)
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
