"""The render pass as one captured graph per compile key, on the CPU.

take_tpu jits its pass (take_tpu/render.py::_render_pass_jit) and forms
the compile key in render_pass; the port captures one CUDA graph per key
(take_tpu_torch/render.py, take_tpu_torch/_graph.py). Here, without a card:
the port's keys against take_tpu's executable cache, the key's scene and
route parts, the pass body against the pass as it was and against
take_tpu's, that the body makes no host sync (what a capture cannot hold),
and capture and replay on a recorder of torch ops standing in for CUDA
graphs: images, launch counts and pass counts. tests/test_torch_cuda.py
holds real graphs against eager passes on the card.
"""

import contextlib
import dataclasses
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from take_tpu.core.camera import Camera as JCamera
from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch import _graph, grad
from take_tpu_torch.core import rng
from take_tpu_torch.core.camera import Camera, generate_rays
from take_tpu_torch.core.math import constant
from take_tpu_torch.geometry import _launch, brute, cluster, packet, sweep, traverse
from take_tpu_torch.integrator import path_tracer
from take_tpu_torch.scene.parse_xml import parse_scene_file
from take_tpu_torch.scene.types import RenderOptions
from tests.scenes import cornell_box
from tests.torch_parity import CBOX, one_torch_thread, port_scene, with_res  # noqa: F401 (a fixture)

render = importlib.import_module("take_tpu_torch.render")  # each package's `render` is a function
jrender = importlib.import_module("take_tpu.render")
SCENES = CBOX.rsplit("/cbox/", 1)[0]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def tiny(path, res, device="cpu"):
    scene = parse_scene_file(path, device=device)
    cam = scene.meta.camera
    camera = Camera(res, res, cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(scene, meta=dataclasses.replace(scene.meta, camera=camera))


# -- the key -----------------------------------------------------------------

BASE = dict(spp=1, max_depth=1, seed=0)
CHANGES = [  # (a change of the pass's arguments, whether it is a new key)
    (dict(spp=16), False),
    (dict(max_rays_per_pass=64), False),
    (dict(spp=4096, max_rays_per_pass=1 << 12), False),
    (dict(seed=3), True),
    (dict(max_depth=2), True),
    (dict(integrator="raw"), True),
    (dict(rr_depth=0), True),
    (dict(width=2), True),
    (dict(n_samples=2), True),
    (dict(pixels=8), True),
]


@pytest.fixture(scope="module")
def key_scenes():
    """cornell_box at 4x4 in both packages (the port's on take_tpu's tables),
    and take_tpu's pass compiled once at BASE."""
    js = cornell_box(4, 4).build()
    jrender._render_pass_jit.clear_cache()
    jrender.render_pass(js, JOptions(**BASE), jnp.arange(16, dtype=jnp.int32), 0, 4, 1).block_until_ready()
    return js, port_scene(js)


@pytest.mark.parametrize("change, new_key", CHANGES)
def test_keys_agree_with_take_tpu(key_scenes, change, new_key):
    """A change makes take_tpu compile a new executable exactly when it
    makes the port's key change: spp and max_rays_per_pass are normalized
    (a 1-spp warm-up and a 4096-spp render share one), the rest is static."""
    js, ps = key_scenes
    change = dict(change)
    width, n_samples, n_pix = change.pop("width", 4), change.pop("n_samples", 1), change.pop("pixels", 16)
    before = jrender._render_pass_jit._cache_size()
    jrender.render_pass(js, JOptions(**{**BASE, **change}), jnp.arange(n_pix, dtype=jnp.int32), 5, width,
                        n_samples).block_until_ready()
    compiled = jrender._render_pass_jit._cache_size() - before
    key = render.pass_key(ps, RenderOptions(**BASE), torch.arange(16, dtype=torch.int32), 4, 1)
    key2 = render.pass_key(ps, RenderOptions(**{**BASE, **change}), torch.arange(n_pix, dtype=torch.int32), width,
                           n_samples)
    assert compiled == int(new_key)
    assert (key2 != key) == new_key


def test_key_follows_the_route_and_the_tables(key_scenes):
    """The route a query takes now and the scene's tables are in the key:
    FORCE_SWEEP or FORCE_CLUSTER flipped, a kernel function patched, a table
    replaced or written in place each make another key; a new Scene object
    over the same tables and camera keeps it."""
    _, ps = key_scenes
    opts, pix = RenderOptions(**BASE), torch.arange(16, dtype=torch.int32)

    def key(scene=ps):
        return render.pass_key(scene, opts, pix, 4, 1)

    k0 = key()
    assert key() == k0 and key(dataclasses.replace(ps)) == k0
    for flag in ("FORCE_SWEEP", "FORCE_CLUSTER"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(traverse, flag, True)
            assert key() != k0
    for module in (brute, packet, cluster, sweep):
        for name in ("closest", "occluded"):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(module, name, lambda *a: None)
                assert key() != k0, (module.__name__, name)
    assert key() == k0
    g = ps.geometry
    assert key(dataclasses.replace(ps, geometry=dataclasses.replace(g, tri_attr=g.tri_attr.clone()))) != k0
    assert key(dataclasses.replace(ps, background=ps.background.clone())) != k0
    edited = dataclasses.replace(ps, materials=dataclasses.replace(ps.materials))
    edited.materials.attr.add_(0.0)  # written in place: same address, a new version
    assert key(edited) != k0
    assert render.pass_key(ps, opts, pix.to(torch.int64), 4, 1) != k0


# -- the body ------------------------------------------------------------------


def parent_pass(scene, options, pixel_idx, sample0, width, n_samples):
    """render_pass's body before graphs: `sample0` a Python int."""
    trace = render._trace_fn(scene, options)
    P = pixel_idx.shape[0]
    pix = pixel_idx[:, None].expand(P, n_samples).reshape(P * n_samples)
    samp = sample0 + torch.arange(n_samples, dtype=torch.int32, device=pix.device)
    samp = samp[None, :].expand(P, n_samples).reshape(P * n_samples)
    px = (pix % width).to(torch.float32)
    py = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    streams = rng.make_stream(options.seed, pix, samp)
    jx = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
    jy = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
    ro, rd = generate_rays(scene.meta.camera, px, py, jx, jy)
    return trace(scene, options, ro, rd, streams).reshape(P, n_samples, 3).sum(dim=1)


def test_constants_made_by_fills_equal_host_tensors():
    """core.math.constant (the camera's frame, to_world's singular branch,
    the Disney frames, the dead-lane direction) rounds each float as
    torch.tensor does, so those values keep their bits."""
    rs = np.random.default_rng(0)
    for values in [(1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (278.0, 273.0, -800.0), (0.1, 1e-8, 3.3333333),
                   tuple(rs.normal(size=7) * 10.0 ** rs.integers(-30, 30, 7))]:
        for dtype in (torch.float32, torch.float64):
            assert torch.equal(constant(values, dtype, "cpu"), torch.tensor(values, dtype=dtype))


@pytest.mark.parametrize("integrator", ["mis", "one_sample_mis", "raw"])
def test_pass_body_equals_the_parent_pass(integrator):
    """render._pass with a 0-d tensor sample0 equals the parent's body with a
    Python int bit for bit on the CPU, on a band that does not start at
    pixel 0, and render_pass equals both."""
    scene = tiny(f"{SCENES}/mis/mis.xml", 12)
    opts = RenderOptions(spp=8, max_depth=3, seed=4, integrator=integrator, rr_depth=1)
    pix = torch.arange(24, 24 + 60, dtype=torch.int32)
    want = parent_pass(scene, opts, pix, 5, 12, 3)
    got = render._pass(scene, opts, pix, torch.tensor(5, dtype=torch.int32), 12, 3)
    assert torch.equal(got, want)
    assert torch.equal(render.render_pass(scene, opts, pix, 5, 12, 3), want)


def test_render_pass_matches_take_tpu():
    """The port's render_pass against take_tpu's on cbox at 16x16, 4 samples
    a pass from sample 4, within test_torch_render.py's tolerance (means
    1e-3, 99% of pixels within 1e-3)."""
    from tests.test_torch_render import _compare

    js = with_res(jax_parse(CBOX), 16, JCamera)
    ps = with_res(port_scene(jax_parse(CBOX)), 16, Camera)
    with torch.inference_mode():
        got = render.render_pass(ps, RenderOptions(spp=8, max_depth=4), torch.arange(256, dtype=torch.int32), 4,
                                 16, 4).numpy()
    want = np.asarray(jrender.render_pass(js, JOptions(spp=8, max_depth=4), jnp.arange(256, dtype=jnp.int32), 4,
                                          16, 4))
    _compare(got.reshape(16, 16, 3), want.reshape(16, 16, 3))


class _HostSyncs(TorchDispatchMode):
    """Records the ops that a CUDA graph cannot capture: host reads of a
    value (item, bool), outputs shaped by data (nonzero, boolean masks,
    unique), and tensors made from host data (torch.tensor, new_tensor).
    Ops inside a kernel wrapper are not checked: on the card the wrapper
    launches its kernel."""

    aten = torch.ops.aten
    BAD = {aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten.lift_fresh, aten.lift_fresh_copy,
           aten.repeat_interleave, aten.bincount, aten.equal, aten.is_nonzero, aten._unique2, aten.unique_dim,
           aten.unique_consecutive}

    def __init__(self):
        super().__init__()
        self.in_kernel, self.found = 0, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.in_kernel:
            if func.overloadpacket in self.BAD:
                self.found.add(str(func))
            if func.overloadpacket in (self.aten.index, self.aten.index_put, self.aten.index_put_) and any(
                    i is not None and i.dtype == torch.bool for i in args[1]):
                self.found.add(f"{func} with a boolean mask")
        return func(*args, **(kwargs or {}))

    def kernel(self, fn):
        def wrapped(*a):
            self.in_kernel += 1
            try:
                return fn(*a)
            finally:
                self.in_kernel -= 1
        return wrapped


@pytest.mark.parametrize("name", ["cbox/cbox.xml", "mis/mis.xml", "ibl/ibl.xml", "textured/textured.xml"])
def test_pass_makes_no_host_sync(name, monkeypatch):
    """The body of a pass, for each integrator render_pass captures, with
    and without Russian roulette, on a brute scene with spheres, an envmap
    scene with Disney lobes and a BVH scene (K3's route, then K6's and
    K4/K5's), makes no op that a capture cannot hold (mis_replay's loop
    running every trip, as it does under a capture)."""
    scene = tiny(f"{SCENES}/{name}", 6)
    probe = _HostSyncs()
    monkeypatch.setattr(path_tracer, "_capturing", lambda: True)
    for module in (brute, packet, cluster, sweep):
        for fn in ("closest", "occluded"):
            monkeypatch.setattr(module, fn, probe.kernel(getattr(module, fn)))
    routes = [{}] + ([{"FORCE_SWEEP": True}, {"FORCE_CLUSTER": True}] if scene.bvh is not None else [])
    pix, s0 = torch.arange(5, 29, dtype=torch.int32), torch.tensor(3, dtype=torch.int32)
    for route in routes:
        for flag, value in route.items():
            monkeypatch.setattr(traverse, flag, value)
        for integrator in render.GRAPH_INTEGRATORS:
            for rr_depth in (-1, 1):
                opts = RenderOptions(spp=2, max_depth=3, integrator=integrator, rr_depth=rr_depth)
                with torch.inference_mode(), probe:
                    out = render._pass(scene, opts, pix, s0, 6, 2)
                assert probe.found == set(), (route, integrator, rr_depth)
                assert out.shape == (24, 3) and torch.isfinite(out).all()


# -- capture and replay, on a recorder of torch ops ------------------------------


class _Recorder(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func, args, kwargs or {}, out))
        return out


class FakeGraph:
    """torch.cuda.CUDAGraph in pure Python: a capture records every torch op
    with its arguments and outputs; a replay runs the ops again on the same
    tensors and writes each result into the output recorded for it. So it
    replays what was captured, with the values the static inputs hold now,
    and a value baked into the capture stays baked, as on the card. A
    capture under autograd records the backward's ops too, after the
    forward's; a replay runs them all with autograd off."""

    made = []
    capturing = False  # whether a fake capture is recording (path_tracer._capturing)

    def __init__(self, keep_graph=False):
        self.ops, self.replays, self.instantiated = None, 0, False
        FakeGraph.made.append(self)

    def instantiate(self):
        self.instantiated = True

    def replay(self):
        assert self.instantiated
        self.replays += 1
        with torch.no_grad():  # a graph replays kernels: autograd records nothing
            for func, args, kwargs, out in self.ops:
                new = func(*args, **kwargs)
                for rec, x in zip(tree_leaves(out), tree_leaves(new)):
                    if isinstance(rec, torch.Tensor) and rec.untyped_storage().data_ptr() != \
                            x.untyped_storage().data_ptr():
                        rec.copy_(x)


@contextlib.contextmanager
def fake_capture(graph, pool=None, capture_error_mode="global"):
    graph.ops = []
    FakeGraph.capturing = True
    try:
        with _Recorder(graph.ops):
            yield
    finally:
        FakeGraph.capturing = False


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """render_pass and grad.partial_loss_grad take their graph paths on the
    CPU, with torch.cuda's graph entry points standing in: FakeGraph,
    fake_capture (inside which path_tracer._capturing() is true), streams
    that do nothing. Yields FakeGraph's list of graphs made."""
    graphed, grad_graphed = render.graphed, grad.graphed
    monkeypatch.setattr(render, "graphed", lambda options, pix: graphed(options, types.SimpleNamespace(is_cuda=True)))
    monkeypatch.setattr(grad, "graphed", lambda pix: grad_graphed(types.SimpleNamespace(is_cuda=True)))
    monkeypatch.setattr(path_tracer, "_capturing", lambda: FakeGraph.capturing)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    render.clear_cache()
    FakeGraph.made = []
    yield FakeGraph.made
    render.clear_cache()


def counts(fn):
    """(fn(), the launches and passes it counted)."""
    _launch.reset_launches()
    passes = dict(render.PASSES)
    out = fn()
    return out, {k: v for k, v in _launch.LAUNCHES.items() if v}, {k: render.PASSES[k] - passes[k] for k in passes}


@pytest.mark.parametrize("name, integrator", [("cbox/cbox.xml", "mis"), ("mis/mis.xml", "one_sample_mis"),
                                              ("ibl/ibl.xml", "raw"), ("cbox/cbox.xml", "mis_replay")])
def test_replayed_render_equals_eager(fake_cuda, name, integrator):
    """render_image through captured passes equals it op by op bit for bit,
    over three row bands of three passes (the last band shorter, so a key
    of its own): one graph per key, captured at the key's first pass and
    replayed at every pass; a rerender replays only. Launches: each key's
    warm-up ran and counts, the capture's are taken back out, each replay
    adds a pass's; so a rerender counts what the eager render does."""
    scene = tiny(f"{SCENES}/{name}", 10)
    opts = RenderOptions(spp=3, max_depth=3, seed=2, integrator=integrator, max_rays_per_pass=40)
    with render.eager():
        want, eager_launches, eager_passes = counts(lambda: render.render_image(scene, opts))
    assert eager_passes == {"graph": 0, "eager": 9}
    first, first_launches, first_passes = counts(lambda: render.render_image(scene, opts))
    assert first_passes == {"graph": 9, "eager": 0} and len(fake_cuda) == 2  # bands of 4, 4 and 2 rows
    assert [g.replays for g in fake_cuda] == [6, 3]
    again, launches, _ = counts(lambda: render.render_image(scene, opts))
    assert np.array_equal(first, want) and np.array_equal(again, want)
    assert launches == eager_launches
    assert first_launches == {k: v + v // 9 * 2 for k, v in eager_launches.items()}  # + two warm-ups
    assert [g.replays for g in fake_cuda] == [12, 6] and len(_graph.captured()) == 2


def test_replayed_passes_do_not_alias(fake_cuda):
    """Each pass's output is a tensor of its own: passes kept in a list (as
    run_configs.render_pixels keeps them, or an accumulator that starts as
    the first pass, as render_image_sharded's) keep their values."""
    scene = tiny(CBOX, 8)
    opts = RenderOptions(spp=4, max_depth=2)
    pix = torch.arange(16, 48, dtype=torch.int32)
    with torch.inference_mode():
        outs = [render.render_pass(scene, opts, pix, s, 8, 2) for s in (0, 2, 4)]
        with render.eager():
            want = [render.render_pass(scene, opts, pix, s, 8, 2) for s in (0, 2, 4)]
    assert len(fake_cuda) == 1 and fake_cuda[0].replays == 3
    assert len({o.data_ptr() for o in outs} | {_graph.captured()[0].output.data_ptr()}) == 4
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
    assert not torch.equal(outs[0], outs[1])


def test_graph_path_only_for_captured_integrators_without_autograd(fake_cuda):
    """mis_wavefront, which syncs the host, a pass autograd records and
    every pass inside eager() run op by op (mis_replay is captured: its
    loop runs every trip under a capture); eager() nests and restores
    itself, also when its body raises."""
    scene = tiny(CBOX, 4)
    pix = torch.arange(16, dtype=torch.int32)

    def kinds(opts, grad=False):
        with torch.set_grad_enabled(grad):
            return counts(lambda: render.render_pass(scene, opts, pix, 0, 4, 1))[2]

    graph, eager = {"graph": 1, "eager": 0}, {"graph": 0, "eager": 1}
    for integrator in render.GRAPH_INTEGRATORS:
        assert kinds(RenderOptions(max_depth=2, integrator=integrator)) == graph
        assert kinds(RenderOptions(max_depth=2, integrator=integrator), grad=True) == eager
    assert "mis_replay" in render.GRAPH_INTEGRATORS
    assert kinds(RenderOptions(max_depth=2, integrator="mis_wavefront")) == eager
    opts = RenderOptions(max_depth=2)
    with render.eager():
        with render.eager():
            assert kinds(opts) == eager
        assert kinds(opts) == eager
        with pytest.raises(KeyError):
            with render.eager():
                raise KeyError
        assert kinds(opts) == eager
    assert kinds(opts) == graph and render._EAGER == [0]
    with pytest.raises(ValueError, match="unknown integrator"):
        render.render_pass(scene, RenderOptions(integrator="nope"), pix, 0, 4, 1)


def test_launch_bookkeeping():
    """What a capture counts is taken back out of LAUNCHES (also when it
    raises), and each replay adds it back."""
    _launch.reset_launches()
    _launch.LAUNCHES["closest"] = 5

    def capture():
        _launch.LAUNCHES["closest"] += 3
        _launch.LAUNCHES["anyhit"] += 2
        return "graph"

    assert _graph.uncounted(capture) == ("graph", {"closest": 3, "anyhit": 2})
    assert _launch.LAUNCHES["closest"] == 5 and _launch.LAUNCHES["anyhit"] == 0

    def failing():
        _launch.LAUNCHES["packet_closest"] += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        _graph.uncounted(failing)
    assert _launch.LAUNCHES["packet_closest"] == 0
    for _ in range(4):
        _graph.add_launches({"closest": 3, "anyhit": 2})
    assert {k: v for k, v in _launch.LAUNCHES.items() if v} == {"closest": 17, "anyhit": 8}


def test_cpu_render_never_touches_cuda(monkeypatch):
    """A render on the CPU runs every pass op by op and calls none of
    torch.cuda's graph or stream entry points."""

    def refuse(*a, **k):
        raise AssertionError("torch.cuda was called")

    for name in ("CUDAGraph", "graph", "graph_pool_handle", "Stream", "current_stream", "stream", "device",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    scene = tiny(CBOX, 8)
    img, _, passes = counts(lambda: render.render_image(scene, RenderOptions(spp=4, max_depth=2,
                                                                            max_rays_per_pass=128)))
    assert passes == {"graph": 0, "eager": 2} and img.shape == (8, 8, 3) and np.isfinite(img).all()
