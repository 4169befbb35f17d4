"""take_tpu_torch/tracing.py on the CPU: off, it records nothing and changes
no result; its span table; the phase marks a pass body emits, forward and
in the replay backward; the graph keys that hold the tracing flag; and the
mark kernels' order in csrc/mark.cu; the `disney` and `envmap` phases that
interrupt another phase and resume it, on ibl and nowhere else; the
`glossy` phase on mis, and a mis pass's operations, the same with tracing
off as on."""

import dataclasses
import importlib
import os
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from take_tpu_torch import grad, load_scene, tracing
from take_tpu_torch.core.camera import Camera
from take_tpu_torch.materials import disney
from take_tpu_torch.scene import edit
from take_tpu_torch.scene.types import RenderOptions
from tests.torch_parity import CBOX, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
render = importlib.import_module("take_tpu_torch.render")  # the package's `render` is a function

OPTS = RenderOptions(spp=1, max_depth=2, seed=7)
BOUNCE = ["shade", "light", "occlusion", "bsdf", "light", "bsdf", "intersect", "hit", "light", "step"]
CAMERA = ["camera", "intersect", "hit", "camera"]


@pytest.fixture(autouse=True)
def tracing_off():
    """Each test starts and ends with tracing off and its tables empty."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def cbox():
    scene = load_scene(CBOX, device="cpu")
    cam = scene.meta.camera
    new = Camera(8, 8, cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(scene, meta=dataclasses.replace(scene.meta, camera=new))


def replay_grad(scene):
    """The replay gradient of an L2 loss at the light's scale (an edit)."""
    s = edit.with_light_intensity_scale(scene, torch.tensor(0.8, requires_grad=True))
    opts = dataclasses.replace(OPTS, grad_mode="replay")
    return grad.render_loss_grad(s, opts, torch.arange(64, dtype=torch.int32), torch.full((64, 3), 0.25), 1)


def test_off_records_nothing_and_on_changes_no_result(cbox):
    img = render.render_image(cbox, OPTS)
    loss, g = replay_grad(cbox)
    assert tracing.totals() == {} and tracing.marks() == []
    tracing.enable()
    np.testing.assert_array_equal(render.render_image(cbox, OPTS), img)
    loss_on, g_on = replay_grad(cbox)
    assert torch.equal(loss_on, loss)
    for name in ("materials", "lights", "geometry"):
        for f in dataclasses.fields(getattr(g, name)):
            a, b = getattr(getattr(g, name), f.name), getattr(getattr(g_on, name), f.name)
            assert (a is None and b is None) or torch.equal(a, b), f.name
    assert {"take.render.image", "take.grad.loss_grad", "take.edit"} <= set(tracing.totals())
    assert tracing.marks()


def test_totals_of_nested_spans():
    tracing.enable()
    with tracing.span("a"):
        for _ in range(2):
            with tracing.span("b"):
                time.sleep(0.01)
                with tracing.span("c"):
                    time.sleep(0.005)
    with tracing.span("c"):
        pass
    t = tracing.totals()
    assert {k: (v["count"], v["parent"]) for k, v in t.items()} == {"a": (1, None), "b": (2, "a"), "c": (3, "b")}
    assert t["a"]["self_s"] == pytest.approx(t["a"]["total_s"] - t["b"]["total_s"])
    assert t["b"]["self_s"] == pytest.approx(t["b"]["total_s"] - (t["c"]["total_s"] - 0.0), abs=1e-3)
    assert 0.02 <= t["b"]["total_s"] <= t["a"]["total_s"] and t["b"]["self_s"] >= 0.02
    tracing.reset()
    assert tracing.totals() == {}
    with pytest.raises(ValueError):
        tracing.stage("sideways")
    with pytest.raises(ValueError):
        tracing.mark("nowhere")


def test_a_pass_marks_its_phases(cbox):
    """An eager CPU pass at max_depth 2 emits the documented sequence: the
    camera vertex, each of the 3 bounces, the end. A replay gradient pass
    emits its forward the same way (the loop stops early once every lane
    is dead), its loss, and under stage backward the vjp, the replayed
    camera vertex and bounces, each replayed bounce followed by its vjp."""
    tracing.enable()
    render.render_image(cbox, OPTS)
    fwd = [("forward", p) for p in CAMERA + BOUNCE * 3 + ["end"]]
    assert tracing.marks() == fwd
    tracing.reset()
    replay_grad(cbox)
    m = tracing.marks()
    assert m[:4] == [("forward", p) for p in CAMERA] and m[-1] == ("forward", "end")
    i = m.index(("forward", "loss"))
    n = (i - 4) // len(BOUNCE)
    assert m[4:i] == [("forward", p) for p in BOUNCE * n] and 1 <= n <= 3
    back = m[i + 1 : -1]
    assert {s for s, _ in back} == {"backward"}
    assert [p for _, p in back[:6]] == ["vjp", "camera", "intersect", "hit", "camera", "vjp"]
    assert [p for _, p in back].count("shade") == 2 * n  # pass 1 and pass 2 replay each bounce
    assert [p for _, p in back].count("vjp") == 2 + n


def test_keys_hold_the_tracing_flag(cbox):
    pix = torch.arange(16, dtype=torch.int32)
    off = render.pass_key(cbox, OPTS, pix, 8, 1), grad.grad_key(cbox, OPTS, "replay", 1, "l2", pix, torch.zeros(16, 3))
    tracing.enable()
    on = render.pass_key(cbox, OPTS, pix, 8, 1), grad.grad_key(cbox, OPTS, "replay", 1, "l2", pix, torch.zeros(16, 3))
    assert off[0] != on[0] and off[1] != on[1]
    assert off[0][:-1] == on[0][:-1] and off[1][:-1] == on[1][:-1]


def test_mark_kernels_follow_the_module_order():
    """csrc/mark.cu defines take_mark_<stage>_<phase> for every stage and
    phase, and lists them in tracing.STAGES x tracing.PHASES order, the
    indices tt_mark takes."""
    src = (Path(tracing.__file__).parent / "csrc" / "mark.cu").read_text()
    listed = re.search(r"#define TT_PHASES\(X, stage\)(.*?)\n\n", src, re.S).group(1)
    assert tuple(re.findall(r"X\(stage, (\w+)\)", listed)) == tracing.PHASES
    table = re.search(r"kMarks\[\]\)\(\) = \{(.*?)\};", src).group(1)
    assert re.findall(r"TT_PHASES\(TT_ENTRY, (\w+)\)", table) == list(tracing.STAGES)
    assert "kStages = 2" in src and len(tracing.STAGES) == 2


SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def _small(path, size=8):
    scene = load_scene(path, device="cpu")
    cam = scene.meta.camera
    new = Camera(size, size, cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(scene, meta=dataclasses.replace(scene.meta, camera=new))


@pytest.mark.parametrize("name", ["cbox", "room"])
def test_passes_without_disney_or_envmap_mark_as_before(name):
    """cbox (brute force) and room (BVH) have no Disney material and no
    environment map: a pass emits the sequence it emitted before the
    `disney` and `envmap` phases existed."""
    tracing.enable()
    render.render_image(_small(os.path.join(SCENES, name, f"{name}.xml")), OPTS)
    assert tracing.marks() == [("forward", p) for p in CAMERA + BOUNCE * 3 + ["end"]]


def test_ibl_pass_marks_disney_and_envmap():
    """An ibl pass marks `envmap` at the camera vertex's escape and at each
    bounce's environment sample, lookup, pdf and escape, and `disney` in
    each BSDF dispatch for each Disney material (disneymetal, disneybsdf);
    each such mark is followed by a mark back to the phase it interrupted,
    and without them the sequence is cbox's."""
    scene = _small(os.path.join(SCENES, "ibl", "ibl.xml"))
    tracing.enable()
    render.render_image(scene, OPTS)
    m = [p for _, p in tracing.marks()]
    assert {s for s, _ in tracing.marks()} == {"forward"}
    nested = [i for i, p in enumerate(m) if p in ("disney", "envmap")]
    for i in nested:
        assert m[i + 1] == m[i - 1] and m[i + 1] not in ("disney", "envmap")
    drop = set(nested) | {i + 1 for i in nested}
    assert [p for i, p in enumerate(m) if i not in drop] == CAMERA + BOUNCE * 3 + ["end"]
    n_disney = sum(t in disney.TAGS for t in scene.meta.used_material_tags)
    assert n_disney == 2
    assert m.count("envmap") == 1 + 4 * 3  # the camera's escape; per bounce sample, eval, pdf, escape
    assert m.count("disney") == 4 * 3 * n_disney  # per bounce NEE's eval and pdf, the sample and its eval


def test_phase_resumes_what_it_interrupted():
    """tracing.phase marks its phase and then the one it interrupted, in the
    current stage; with none begun it resumes `end` (unmarked); off, it
    marks nothing."""
    with tracing.phase("disney"):
        pass
    assert tracing.marks() == []
    tracing.enable()
    with tracing.phase("envmap"):
        pass
    tracing.mark("light")
    with tracing.phase("envmap"):
        tracing.mark("occlusion")
    with tracing.stage("backward"):
        tracing.mark("vjp")
        with tracing.phase("disney"):
            pass
    assert tracing.marks() == [("forward", "envmap"), ("forward", "end"), ("forward", "light"),
                               ("forward", "envmap"), ("forward", "occlusion"), ("forward", "light"),
                               ("backward", "vjp"), ("backward", "disney"), ("backward", "vjp")]


def test_mis_pass_marks_glossy():
    """A mis pass marks `glossy` in each BSDF dispatch for its one glossy
    material tag (blinn_microfacet): per bounce NEE's eval and pdf, the
    sample and its eval; each such mark is followed by a mark back to the
    phase it interrupted, and without them the sequence is cbox's."""
    scene = _small(os.path.join(SCENES, "mis", "mis.xml"))
    tracing.enable()
    render.render_image(scene, OPTS)
    m = [p for _, p in tracing.marks()]
    nested = [i for i, p in enumerate(m) if p == "glossy"]
    assert all(m[i + 1] == m[i - 1] != "glossy" for i in nested)
    drop = set(nested) | {i + 1 for i in nested}
    assert [p for i, p in enumerate(m) if i not in drop] == CAMERA + BOUNCE * 3 + ["end"]
    assert len(nested) == 4 * 3 and "disney" not in m and "envmap" not in m


def test_tracing_off_adds_no_op_to_a_mis_pass():
    """The operations a mis pass runs, in order, are the same with tracing
    off as with it on (where on the CPU a mark launches nothing; the host
    spans' record_function ranges, which no graph holds, aside): the
    `glossy` phase blocks add no torch operation, so a graph captured with
    tracing off holds the nodes it held before the phase existed, and the
    marks, which only a capture with tracing on launches, are its only
    difference; off, no mark is recorded."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not str(func).startswith("profiler."):  # the host spans' record_function ranges
                self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    scene = _small(os.path.join(SCENES, "mis", "mis.xml"), size=4)
    runs = {}
    for on in (False, True):
        tracing.enable() if on else tracing.disable()
        tracing.reset()
        with Ops() as ops:
            img = render.render_image(scene, OPTS)
        runs[on] = (ops.names, img, [p for _, p in tracing.marks()])
    assert runs[False][2] == [] and runs[True][2].count("glossy") == 4 * 3
    assert runs[False][0] == runs[True][0] and len(runs[False][0]) > 1000
    np.testing.assert_array_equal(runs[False][1], runs[True][1])
