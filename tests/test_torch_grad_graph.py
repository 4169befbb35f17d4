"""The gradient pass as one captured graph per key, on the CPU.

take_tpu jits its gradient (take_tpu/grad.py::render_loss_grad, a jax.jit
of value_and_grad with `options` and `n_samples` static) and the three
while_loops of its path replay stop once no lane is active. The port captures
one CUDA graph per pass key holding the pass's forward and backward
(take_tpu_torch/grad.py, take_tpu_torch/_graph.py), and under a capture the
replay loops run every trip (integrator/path_tracer.py::_running). Here,
without a card: that the gradient body makes no host sync (what a capture
cannot hold), that the fixed-trip replay equals the early exit on a scene
where the exit fires and matches take_tpu's jitted gradient, the graph path
against the eager one on a recorder of torch ops standing in for CUDA
graphs (test_torch_pass_graph.py's fake_cuda), and the key.
tests/test_torch_cuda.py holds real graphs against eager passes on the card.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.grad import render_loss_grad as j_loss_grad
from take_tpu.scene.types import RenderOptions as JOptions
from chip_smoke import loop_trips
from take_tpu_torch import _graph, grad, inverse_demo
from take_tpu_torch.core.math import gather_rows
from take_tpu_torch.geometry import _launch, brute, cluster, packet, sweep, traverse
from take_tpu_torch.integrator import path_tracer
from take_tpu_torch.scene import edit
from take_tpu_torch.scene.types import RenderOptions, float_tables
from tests.scenes import cornell_box, sphere_furnace
from tests.test_torch_pass_graph import SCENES, _HostSyncs, fake_cuda, tiny  # noqa: F401 (a fixture)
from tests.torch_parity import one_torch_thread, port_scene, tables  # noqa: F401 (a fixture)

render = importlib.import_module("take_tpu_torch.render")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def close_tables(got, want, rel):
    """Every float table of two gradient Scenes within `rel` of the wanted
    table's largest magnitude."""
    g, w = float_tables(got), float_tables(want)
    assert set(g) == set(w)
    for key, x in w.items():
        torch.testing.assert_close(g[key], x, rtol=0, atol=rel * max(float(x.abs().max()), 1e-30), msg=key)


# -- (a) the body makes no host sync ----------------------------------------------


@pytest.mark.parametrize("name, flag", [("cbox/cbox.xml", None), ("mis/mis.xml", None), ("ibl/ibl.xml", None),
                                        ("textured/textured.xml", None), ("textured/textured.xml", "FORCE_SWEEP"),
                                        ("textured/textured.xml", "FORCE_CLUSTER")])
def test_gradient_pass_makes_no_host_sync(name, flag, monkeypatch):
    """Forward and torch.autograd.grad of one gradient pass (grad._pass_grad,
    the captured body), with the replay loops running every trip as under a
    capture, in modes "ad" and "replay", with and without Russian roulette,
    on cbox (K1/K2 and K1's autograd Function), mis (spheres), ibl (the
    envmap, Disney lobes) and textured (K3's route, then K6's and K4/K5's),
    makes no op that a capture cannot hold, and gives finite gradients."""
    scene = tiny(f"{SCENES}/{name}", 6)
    probe = _HostSyncs()
    for module in (brute, packet, cluster, sweep):
        for fn in ("closest", "occluded"):
            monkeypatch.setattr(module, fn, probe.kernel(getattr(module, fn)))
    if flag:
        monkeypatch.setattr(traverse, flag, True)
    monkeypatch.setattr(path_tracer, "_capturing", lambda: True)
    tabs = float_tables(scene)
    keys = tuple(tabs)
    pix, tgt = torch.arange(5, 29, dtype=torch.int32), torch.full((24, 3), 0.1)
    s0, denom = torch.tensor(3, dtype=torch.int32), torch.tensor(72.0)
    for mode in ("ad", "replay"):
        for rr_depth in (-1, 1):
            opts = RenderOptions(spp=1, max_depth=1, seed=1, rr_depth=rr_depth)
            leaves = [t.detach().requires_grad_(True) for t in tabs.values()]
            with probe:
                part, *grads = grad._pass_grad(scene, opts, keys, 2, mode, "l2", pix, tgt, s0, denom, *leaves)
            assert probe.found == set(), (mode, rr_depth)
            grads = [g for g in grads if g is not None]  # None: a table that gets no gradient
            assert torch.isfinite(part) and all(torch.isfinite(g).all() for g in grads), (mode, rr_depth)
            assert any(g.abs().max() > 0 for g in grads), (mode, rr_depth)
            assert all(x.grad is None for x in leaves)


@pytest.mark.parametrize("rows", [8, 256, 9000])
def test_gather_rows_adds_its_backward_in_float64(rows):
    """gather_rows' backward (every table gather of a gradient pass, by
    core.math.add_rows) adds the rows' cotangents in float64 and rounds
    once, so the atomics' order on the card does not show: the gradient is
    the float64 sum rounded to float32 (within one rounding; a small table
    spreads its lanes over copies of itself, a large one does not), within
    float32 rounding of index_select's own backward, and the forward is
    index_select's bit for bit."""
    rng = np.random.default_rng(7)
    table = torch.as_tensor(rng.normal(size=(rows, 3)).astype(np.float32)).requires_grad_(True)
    idx = torch.as_tensor(rng.integers(0, rows, 20000))
    g = torch.as_tensor(rng.normal(size=(20000, 3)).astype(np.float32))
    out = gather_rows(table, idx)
    assert torch.equal(out, torch.index_select(table.detach(), 0, idx))
    (got,) = torch.autograd.grad(out, table, g)
    want = torch.zeros(rows, 3, dtype=torch.float64).index_add_(0, idx, g.double()).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2.0**-23, atol=0.0)
    (plain,) = torch.autograd.grad(torch.index_select(table, 0, idx), table, g)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert gather_rows(table, idx).grad_fn is None


# -- (b) fixed trips against the early exit, and against take_tpu -----------------


@pytest.fixture(scope="module")
def furnace():
    """sphere_furnace at 12x12 in both packages: an open scene in which
    every path leaves the sphere after its first bounce, so at d8 every
    lane is dead long before the last trip."""
    js = sphere_furnace(albedo=0.6, width=12, height=12).build()
    target = np.random.default_rng(3).uniform(0.0, 0.8, (144, 3)).astype(np.float32)
    return js, port_scene(js), target


def test_fixed_trips_equal_the_early_exit_and_take_tpu(furnace, monkeypatch):
    """On the furnace at d8 (replay, 2 samples a pixel), the early exit
    fires in all three replay loops (the forward, pass 1, pass 2). Running
    every trip, as a capture does, gives the same primal bit for bit, the
    same loss, and every table within 1e-6 of its largest magnitude; and the
    fixed-trip loss and gradients match take_tpu's jitted render_loss_grad
    (loss rtol 1e-5, tables within 1e-3 of scale, test_torch_grad.py's)."""
    js, scene, target = furnace
    D = 9
    opts = RenderOptions(spp=1, max_depth=D - 1, seed=4, grad_mode="replay")
    pix, tgt = torch.arange(144, dtype=torch.int32), torch.as_tensor(target)
    record, running = [], path_tracer._running

    def spy(active):
        record.append(running(active))
        return record[-1]

    monkeypatch.setattr(path_tracer, "_running", spy)
    with torch.no_grad():
        img_e = grad.render_radiance(scene, opts, pix, 0, 2)
    loss_e, g_e = grad.render_loss_grad(scene, opts, pix, tgt, 2)
    early = loop_trips(record, D)
    assert len(early) == 4 and max(early) < D, early  # the primal's loop, then the gradient's three
    record.clear()
    monkeypatch.setattr(path_tracer, "_capturing", lambda: True)
    with torch.no_grad():
        img_f = grad.render_radiance(scene, opts, pix, 0, 2)
    loss_f, g_f = grad.render_loss_grad(scene, opts, pix, tgt, 2)
    assert loop_trips(record, D) == [D] * 4
    assert torch.equal(img_f, img_e) and torch.equal(loss_f, loss_e)
    close_tables(g_f, g_e, 1e-6)

    j_loss, j_g = j_loss_grad(js, JOptions(spp=1, max_depth=D - 1, seed=4, grad_mode="replay"),
                              jnp.arange(144, dtype=jnp.int32), jnp.asarray(target), 2)
    np.testing.assert_allclose(float(loss_f), float(j_loss), rtol=1e-5)
    ours = float_tables(g_f)
    j_tables = {k: v for k, v in tables(j_g).items() if np.issubdtype(v.dtype, np.floating)}
    assert set(ours) == set(j_tables)
    for key, jg in j_tables.items():
        np.testing.assert_allclose(ours[key].numpy(), jg, rtol=0, atol=1e-3 * max(np.abs(jg).max(), 1e-30),
                                   err_msg=key)
    assert np.abs(j_tables["materials.attr"]).max() > 0 and np.abs(j_tables["background"]).max() > 0


# -- (c) the graph path against the eager path, on fake_cuda ----------------------


def grad_counts(fn):
    """(fn(), the launches and gradient passes it counted)."""
    _launch.reset_launches()
    passes = dict(grad.PASSES)
    out = fn()
    return out, {k: v for k, v in _launch.LAUNCHES.items() if v}, {k: grad.PASSES[k] - passes[k] for k in passes}


@pytest.mark.parametrize("mode", ["ad", "replay"])
def test_graph_gradient_equals_eager(fake_cuda, mode):
    """render_loss_grad through captured gradient passes equals it op by op
    (render.eager()) on cbox at 8x8, 2 samples a pixel, d3, in passes of 24,
    24 and 16 pixels (two keys): the loss bit for bit, every table within
    1e-6 of its scale, the launches of a replayed call those of the eager
    call, and no `.grad` left on a graph's leaves. Then the red wall's
    reflectance and the light scale change (scene/edit.py, as an Adam step
    does): the same two graphs replay, with no new capture, and give the
    new values' loss and gradients, not the old ones."""
    scene = port_scene(cornell_box(8, 8).build())
    opts = RenderOptions(spp=1, max_depth=3, seed=2, grad_mode=mode, max_rays_per_pass=48)
    pix = torch.arange(64, dtype=torch.int32)
    target = torch.as_tensor(np.random.default_rng(1).uniform(0.0, 0.5, (64, 3)).astype(np.float32))

    def loss_grad(s):
        return grad.render_loss_grad(s, opts, pix, target, 2)

    with render.eager():
        (want_loss, want), eager_launches, eager_passes = grad_counts(lambda: loss_grad(scene))
    assert eager_passes == {"graph": 0, "eager": 3}
    (loss1, g1), _, passes = grad_counts(lambda: loss_grad(scene))
    assert passes == {"graph": 3, "eager": 0} and len(fake_cuda) == 2 and [g.replays for g in fake_cuda] == [2, 1]
    (loss2, g2), launches, _ = grad_counts(lambda: loss_grad(scene))
    for loss, g in ((loss1, g1), (loss2, g2)):
        assert torch.equal(loss, want_loss)
        close_tables(g, want, 1e-6)
    assert launches == eager_launches and set(launches) == {"closest_plain", "anyhit_plain"}
    assert all(x.grad is None for e in _graph.captured() for x in e.inputs)

    edited = edit.with_light_intensity_scale(edit.with_material_reflectance(scene, 1, (0.2, 0.6, 0.3)), 1.7)
    with render.eager():
        want_loss_e, want_e = loss_grad(edited)
    loss3, g3 = loss_grad(edited)
    assert len(fake_cuda) == 2 and [g.replays for g in fake_cuda] == [6, 3]
    assert torch.equal(loss3, want_loss_e) and not torch.equal(loss3, want_loss)
    close_tables(g3, want_e, 1e-6)
    assert not torch.equal(float_tables(g3)["materials.attr"], float_tables(want)["materials.attr"])


def test_graph_gradient_carries_to_raw_parameters(fake_cuda):
    """An Adam step's chain (grad.backward from the Scene-shaped gradient
    into raw parameters that scene/edit.py maps into the scene) through a
    captured gradient equals it op by op: three steps of changed
    parameters, one capture."""
    base = port_scene(cornell_box(6, 6).build())
    opts = RenderOptions(spp=1, max_depth=2, seed=5, grad_mode="ad")
    pix = torch.arange(36, dtype=torch.int32)
    target = torch.full((36, 3), 0.3)
    raw = {"wall": torch.tensor([0.1, -0.4, 0.2]), "light": torch.tensor(0.3)}

    def step(params):
        s = edit.with_light_intensity_scale(edit.with_material_reflectance(base, 1, torch.sigmoid(params["wall"])),
                                            torch.exp(params["light"]))
        loss, g = grad.render_loss_grad(s, opts, pix, target, 2, sample0=4)
        grad.backward(s, g)
        return loss

    for i in range(3):
        params = {k: (v + 0.1 * i).requires_grad_(True) for k, v in raw.items()}
        with render.eager():
            want = {k: (v + 0.1 * i).requires_grad_(True) for k, v in raw.items()}
            want_loss = step(want)
        loss = step(params)
        assert torch.equal(loss, want_loss)
        for k in raw:
            torch.testing.assert_close(params[k].grad, want[k].grad, rtol=1e-6, atol=1e-9)
            assert params[k].grad.abs().max() > 0
    assert len(fake_cuda) == 1 and fake_cuda[0].replays == 3


def test_inverse_step_through_a_graph_equals_its_op_by_op_step(fake_cuda):
    """inverse_demo's step: through a captured gradient (render_loss_grad's
    graph, every float table a parameter, carried into the raw parameters
    by grad.backward) and op by op (autograd through the tables the raw
    parameters reach alone) give the same loss bit for bit and the same
    raw parameters' gradients; two steps, one capture."""
    base = inverse_demo.cornell_box(6, 6).build(device="cpu")
    pix = torch.arange(36, dtype=torch.int32)
    target = inverse_demo.target_image(base, pix, 8)
    for step in range(2):
        got, want = ({k: v.requires_grad_(True) for k, v in inverse_demo.raw(inverse_demo.INIT, "cpu").items()}
                     for _ in range(2))
        with render.eager():
            want_loss = inverse_demo.loss_grad(base, want, pix, target, 4 * step, 4)
        loss = inverse_demo.loss_grad(base, got, pix, target, 4 * step, 4)
        assert torch.equal(loss, want_loss)
        for k in got:
            torch.testing.assert_close(got[k].grad, want[k].grad, rtol=1e-6, atol=1e-9)
            assert got[k].grad.abs().max() > 0
    assert len(fake_cuda) == 1 and fake_cuda[0].replays == 2


def test_cpu_gradient_never_touches_cuda(monkeypatch):
    """A gradient on the CPU runs every pass op by op and calls none of
    torch.cuda's graph or stream entry points."""

    def refuse(*a, **k):
        raise AssertionError("torch.cuda was called")

    for name in ("CUDAGraph", "graph", "graph_pool_handle", "Stream", "current_stream", "stream", "device",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    scene = port_scene(cornell_box(4, 4).build())
    _, _, passes = grad_counts(lambda: grad.render_loss_grad(
        scene, RenderOptions(spp=1, max_depth=2, grad_mode="replay", max_rays_per_pass=16), torch.arange(16, dtype=torch.int32),
        torch.zeros(16, 3), 2))
    assert passes == {"graph": 0, "eager": 2}


# -- (d) the key ---------------------------------------------------------------------

KEY_BASE = dict(spp=1, max_depth=1, seed=0, grad_mode="ad")
KEY_CHANGES = [  # (a change of render_loss_grad's arguments, whether the port's key changes)
    (dict(spp=16, max_rays_per_pass=64), False),
    (dict(seed=3), True),
    (dict(max_depth=2), True),
    (dict(rr_depth=0), True),
    (dict(grad_mode="replay"), True),
    (dict(n_samples=2), True),
    (dict(pixels=8), True),
]


@pytest.fixture(scope="module")
def key_scenes():
    """cornell_box at 4x4 in both packages (the port's on take_tpu's tables)."""
    js = cornell_box(4, 4).build()
    return js, port_scene(js)


def jax_call(js, change):
    change = dict(change)
    n_samples, n_pix = change.pop("n_samples", 1), change.pop("pixels", 16)
    return j_loss_grad(js, JOptions(**{**KEY_BASE, **change}), jnp.arange(n_pix, dtype=jnp.int32),
                       jnp.zeros((n_pix, 3)), n_samples)


def port_key(scene, change, loss="l2"):
    change = dict(change)
    n_samples, n_pix = change.pop("n_samples", 1), change.pop("pixels", 16)
    opts = RenderOptions(**{**KEY_BASE, **change})
    return grad.grad_key(scene, opts, grad.resolve_mode(opts, n_pix * n_samples), n_samples, loss,
                         torch.arange(n_pix, dtype=torch.int32), torch.zeros(n_pix, 3))


@pytest.mark.parametrize("change, new_key", KEY_CHANGES)
def test_grad_keys_against_take_tpu(key_scenes, change, new_key):
    """take_tpu's jitted gradient takes `options` and `n_samples` as static
    arguments and retraces for a new pixel batch shape: a change of what it
    reads (seed, depth, RR, mode, samples, the batch's shape) makes a new
    key here. spp and max_rays_per_pass are normalized, as render.pass_key
    normalizes them: take_tpu's jit compiles anew for them (its options are
    static whole) but gives the same loss and gradient bit for bit, since
    it reads neither; the port's passes read max_rays_per_pass on the host,
    where the pass shape, which the key holds, carries it."""
    js, ps = key_scenes
    assert (port_key(ps, change) != port_key(ps, {})) == new_key
    if not new_key:
        j_loss_grad.clear_cache()
        base_loss, base_g = jax_call(js, {})
        j_loss, j_g = jax_call(js, change)
        assert j_loss_grad._cache_size() == 2
        assert float(j_loss) == float(base_loss)
        for key, x in tables(j_g).items():
            np.testing.assert_array_equal(x, tables(base_g)[key], err_msg=key)


def test_grad_key_holds_no_parameter_values(key_scenes, monkeypatch):
    """The float tables are the graph's parameters: an Adam step's new
    values, every scene/edit.py edit (reflectance, a material parameter,
    the light scale, a texture image, the environment map) and a float table
    written in place keep the key. An integer table replaced or written in
    place, a derived field replaced (tri_rows), the route (FORCE_SWEEP,
    FORCE_CLUSTER, a kernel function patched), the loss and the target's
    shape each make a new key."""
    _, ps = key_scenes
    k0 = port_key(ps, {})
    wall = torch.zeros(3, requires_grad=True)
    for value in (0.0, 0.4):
        s = edit.with_material_reflectance(ps, 1, torch.sigmoid(wall + value))
        s = edit.with_light_intensity_scale(s, torch.exp(torch.tensor(value)))
        assert port_key(s, {}) == k0
    assert port_key(edit.with_material_param(ps, 0, "roughness", 0.3), {}) == k0
    written = dataclasses.replace(ps, materials=dataclasses.replace(ps.materials, attr=ps.materials.attr.clone()))
    written.materials.attr.add_(1.0)
    assert port_key(written, {}) == k0

    ibl = tiny(f"{SCENES}/ibl/ibl.xml", 4)
    k_ibl = port_key(ibl, {})
    assert port_key(edit.with_envmap_data(ibl, ibl.envmap.data * 0.5), {}) == k_ibl
    tex = tiny(f"{SCENES}/textured/textured.xml", 4)
    k_tex = port_key(tex, {})
    assert port_key(edit.with_texture_image(tex, 0, tex.textures.data[0, :4, :4] * 0.5), {}) == k_tex

    g = ps.geometry
    tagged = dataclasses.replace(ps, materials=dataclasses.replace(ps.materials, tag=ps.materials.tag.clone()))
    assert port_key(tagged, {}) != k0
    bumped = dataclasses.replace(ps, geometry=dataclasses.replace(g, tri_mat=g.tri_mat.clone()))
    k_b = port_key(bumped, {})
    bumped.geometry.tri_mat.add_(0)  # written in place: a new version
    assert port_key(bumped, {}) != k_b
    assert port_key(dataclasses.replace(ps, geometry=dataclasses.replace(g, tri_rows=g.tri_rows.clone())), {}) != k0
    for flag in ("FORCE_SWEEP", "FORCE_CLUSTER"):
        with monkeypatch.context() as mp:
            mp.setattr(traverse, flag, True)
            assert port_key(ps, {}) != k0
    with monkeypatch.context() as mp:
        mp.setattr(brute, "closest", brute.closest_plain)
        assert port_key(ps, {}) != k0
    assert port_key(ps, {}) == k0
    assert port_key(ps, {}, loss="linear") != k0
    opts = RenderOptions(**KEY_BASE)
    pix = torch.arange(16, dtype=torch.int32)
    assert grad.grad_key(ps, opts, "ad", 1, "l2", pix, torch.zeros(16, 3, dtype=torch.float64)) != k0
