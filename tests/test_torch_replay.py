"""take_tpu_torch's early-exit loop and path-replay backward
(`trace_mis_replay`) on the CPU, mirroring test_replay.py and
test_rr.py::test_rr_replay_grad_finite_and_matches_ad: the primal equals
trace_mis bit for bit, replay gradients equal autograd through the scan
loop table by table (including an exactly black albedo, against FD), the
render_radiance route, the early exit, and Russian roulette. The port's
replay gradients are held against take_tpu's table by table in
test_torch_grad.py."""

import dataclasses

import numpy as np
import pytest
import torch

from take_tpu_torch.core import rng as R
from take_tpu_torch.core.camera import generate_rays
from take_tpu_torch.grad import render_loss_grad, render_radiance
from take_tpu_torch.integrator.path_tracer import trace_mis, trace_mis_replay
from take_tpu_torch.scene.types import RenderOptions, float_tables, replace_tables
from tests.scenes import cornell_box
from tests.torch_parity import port_scene, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _camera_batch(scene, seed=0):
    cam = scene.meta.camera
    n = cam.width * cam.height
    pix = torch.arange(n, dtype=torch.int32)
    streams = R.make_stream(seed, pix, torch.zeros_like(pix))
    jx = R.uniform(streams, R.camera_counter(R.DIM_CAMERA_JITTER_X))
    jy = R.uniform(streams, R.camera_counter(R.DIM_CAMERA_JITTER_Y))
    px = (pix % cam.width).float()
    py = torch.div(pix, cam.width, rounding_mode="floor").float()
    ro, rd = generate_rays(cam, px, py, jx, jy)
    return ro, rd, streams, n


def _table_grads(scene, fn):
    """{table path: gradient} of fn(scene on leaf tables)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in float_tables(scene).items()}
    fn(replace_tables(scene, leaves)).backward()
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}


@pytest.fixture(scope="module")
def cbox8():
    return port_scene(cornell_box(width=8, height=8).build())


def test_replay_primal_bitexact():
    scene = port_scene(cornell_box(width=16, height=16).build())
    ro, rd, streams, _ = _camera_batch(scene)
    opts = RenderOptions(spp=1, max_depth=4)
    a = trace_mis(scene, opts, ro, rd, streams)
    b = trace_mis_replay(scene, opts, ro, rd, streams)
    with torch.no_grad():
        c = trace_mis_replay(scene, opts, ro, rd, streams)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_replay_grads_match_ad(cbox8):
    """Every table, including the exactly-zero albedo of the black light
    material: within 1e-5 * max(|g|, 1) (test_replay.py's)."""
    ro, rd, streams, n = _camera_batch(cbox8)
    opts = RenderOptions(spp=1, max_depth=3)
    w_im = torch.as_tensor(np.random.default_rng(0).normal(size=(n, 3)), dtype=torch.float32)
    g_ad = _table_grads(cbox8, lambda s: torch.sum(trace_mis(s, opts, ro, rd, streams) * w_im))
    g_rp = _table_grads(cbox8, lambda s: torch.sum(trace_mis_replay(s, opts, ro, rd, streams) * w_im))
    assert g_ad["materials.attr"].abs().max() > 0
    for key, a in g_ad.items():
        scale = max(float(a.abs().max()), 1.0)
        torch.testing.assert_close(g_rp[key], a, rtol=0, atol=1e-5 * scale, msg=key)


def _black_albedo_f(scene, m, opts, pix):
    def f(d, mode):
        attr = scene.materials.attr.clone()
        attr[m, 7:10] = attr[m, 7:10] + d
        s = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, attr=attr))
        return render_radiance(s, dataclasses.replace(opts, grad_mode=mode), pix, 0, 64).mean()
    return f


def _grad(f, mode):
    d = torch.zeros((), requires_grad=True)
    f(d, mode).backward()
    return float(d.grad)


def test_black_albedo_grad_matches_fd(cbox8):
    """An exactly black material's albedo gradient: nonzero, equal between
    replay and autograd (rtol 1e-4) and against one-sided FD (rtol 0.08)."""
    albedo = cbox8.materials.attr[:, 7:10].numpy()
    m = int(np.where(np.all(albedo == 0.0, axis=1))[0][0])
    pix = torch.arange(64, dtype=torch.int32)
    opts = RenderOptions(spp=1, max_depth=3, seed=2)
    f = _black_albedo_f(cbox8, m, opts, pix)
    g_rp, g_ad = _grad(f, "replay"), _grad(f, "ad")
    np.testing.assert_allclose(g_rp, g_ad, rtol=1e-4, atol=1e-7)
    eps = 2e-2
    with torch.no_grad():
        fd = (float(f(torch.tensor(eps), "ad")) - float(f(torch.tensor(0.0), "ad"))) / eps
    assert abs(fd) > 1e-5
    np.testing.assert_allclose(g_ad, fd, rtol=0.08, atol=1e-5)


def test_replay_via_render_radiance(cbox8):
    """grad_mode="replay" through the public API: finite images, and the
    tri_attr gradient equal to autograd's (within 1e-6 of its scale)."""
    pix = torch.arange(64, dtype=torch.int32)
    for mode in ("ad", "replay"):
        with torch.no_grad():
            img = render_radiance(cbox8, RenderOptions(spp=1, max_depth=2, grad_mode=mode), pix, 0, 1)
        assert torch.isfinite(img).all()
    g = {mode: float_tables(render_loss_grad(cbox8, RenderOptions(spp=1, max_depth=2, grad_mode=mode), pix,
                                             torch.zeros(64, 3), 2)[1])["geometry.tri_attr"]
         for mode in ("ad", "replay")}
    scale = max(float(g["ad"].abs().max()), 1.0)
    torch.testing.assert_close(g["replay"], g["ad"], rtol=0, atol=1e-6 * scale)


def test_replay_early_exit_semantics():
    """A cap deeper than the longest live path: the early-exit loop equals
    the fixed-trip scan loop at the same cap bit for bit."""
    scene = port_scene(cornell_box(width=8, height=8, light_scale=0.3).build())
    ro, rd, streams, _ = _camera_batch(scene)
    opts = RenderOptions(spp=1, max_depth=8)
    with torch.no_grad():
        assert torch.equal(trace_mis_replay(scene, opts, ro, rd, streams), trace_mis(scene, opts, ro, rd, streams))


def test_rr_replay_grad_finite_and_matches_ad(cbox8):
    """Russian roulette from bounce 1: the albedo gradient is finite,
    nonzero, and replay's equals autograd's (rtol 1e-4)."""
    pix = torch.arange(64, dtype=torch.int32)

    def f(d, mode):
        o = RenderOptions(spp=1, max_depth=4, rr_depth=1, grad_mode=mode, seed=7)
        attr = cbox8.materials.attr.clone()
        attr[0, 7:10] = attr[0, 7:10] + d
        s = dataclasses.replace(cbox8, materials=dataclasses.replace(cbox8.materials, attr=attr))
        return render_radiance(s, o, pix, 0, 32).mean()

    g_ad, g_rp = _grad(f, "ad"), _grad(f, "replay")
    assert np.isfinite(g_ad) and abs(g_ad) > 1e-6
    np.testing.assert_allclose(g_rp, g_ad, rtol=1e-4, atol=1e-7)
