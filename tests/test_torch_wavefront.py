"""take_tpu_torch's wavefront-refill loop on the CPU: against the port's
scan loop per path, against take_tpu's refill loop per path and by its
query counts, and the default policy's textured render against take_tpu's
(in the pattern of tests/test_wavefront.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu import config as jconfig
from take_tpu.core.camera import Camera as JCamera
from take_tpu.integrator.wavefront import trace_wavefront as j_wavefront
from take_tpu.render import render_image as j_render
from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch.core import rng
from take_tpu_torch.core.camera import Camera as TCamera
from take_tpu_torch.core.camera import generate_rays
from take_tpu_torch.integrator import wavefront
from take_tpu_torch.integrator.path_tracer import trace_mis
from take_tpu_torch.render import render_image as t_render
from take_tpu_torch.render import use_wavefront_policy
from take_tpu_torch.scene.types import RenderOptions as TOptions
from tests.scenes import cornell_box
from tests.test_torch_bvh import TEXTURED
from tests.torch_parity import port_builder, port_scene, with_res


def _paths(cam, spp):
    """Sample-major paths (pixel, sample) of every pixel, as numpy."""
    n = cam.width * cam.height
    return np.tile(np.arange(n, dtype=np.int32), spp), np.repeat(np.arange(spp, dtype=np.int32), n)


def _scan(scene, options, pix, samp):
    """The port's scan loop on the same paths."""
    cam = scene.meta.camera
    st = rng.make_stream(options.seed, pix, samp)
    jx = rng.uniform(st, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
    jy = rng.uniform(st, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
    px = (pix % cam.width).float()
    py = torch.div(pix, cam.width, rounding_mode="floor").float()
    return trace_mis(scene, options, *generate_rays(cam, px, py, jx, jy), st)


def _scenes(name):
    if name == "cbox":
        return cornell_box(12, 12).build(), port_builder(cornell_box, 12, 12).build(device="cpu")
    js = with_res(jax_parse(TEXTURED), 12, JCamera)
    return js, with_res(port_scene(js), 12, TCamera)


def _assert_paths_agree(got, want, exact):
    """Per path: bit for bit when `exact`; else (RR on, or two packages)
    elements within 1e-5 relative (1e-6 absolute) but for < 0.5% of them,
    where an ulp-level difference flips a discrete choice, and means within
    1e-3 relative."""
    if exact:
        assert torch.equal(got, want)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    assert 1.0 - np.isclose(got, want, rtol=1e-5, atol=1e-6).mean() < 0.005
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3)


@pytest.mark.parametrize("name,depth,rr_depth,wave", [
    ("cbox", 2, -1, 64), ("cbox", 6, 2, 100), ("textured", 2, -1, 64), ("textured", 6, 1, 50)])
def test_wavefront_matches_scan(monkeypatch, name, depth, rr_depth, wave):
    """trace_wavefront with a wave of 50-100 lanes (a few hundred paths, so
    lanes refill many times) against trace_mis on the same paths: bit for bit
    without Russian roulette; with it, the reweight's association differs
    (T * w * 1/p against T * (w * 1/p))."""
    _, ps = _scenes(name)
    options = TOptions(spp=2, max_depth=depth, seed=3, rr_depth=rr_depth)
    pix, samp = (torch.from_numpy(a) for a in _paths(ps.meta.camera, options.spp))
    monkeypatch.setattr(wavefront, "WAVE_SIZE", wave)
    with torch.inference_mode():
        want = _scan(ps, options, pix, samp)
        got = wavefront.trace_wavefront(ps, options, pix, samp, ps.meta.camera.width)
    _assert_paths_agree(got, want, exact=rr_depth < 0)


@pytest.mark.parametrize("name,depth,rr_depth", [("cbox", 6, 2), ("textured", 6, -1)])
def test_wavefront_matches_jax_and_counts(monkeypatch, name, depth, rr_depth):
    """The port's and take_tpu's refill loops, both with a wave of 96
    lanes, on the same paths: per-path radiance as in _assert_paths_agree,
    and the nominal and active query counts equal."""
    js, ps = _scenes(name)
    options = dict(spp=2, max_depth=depth, seed=5, rr_depth=rr_depth)
    pix, samp = _paths(ps.meta.camera, 2)
    monkeypatch.setattr(jconfig, "WAVE_SIZE", 96)
    monkeypatch.setattr(wavefront, "WAVE_SIZE", 96)
    want, j_nom, j_act = j_wavefront(js, JOptions(**options), jnp.asarray(pix), jnp.asarray(samp),
                                     ps.meta.camera.width, with_counts=True)
    with torch.inference_mode():
        got, nom, act = wavefront.trace_wavefront(ps, TOptions(**options), torch.from_numpy(pix),
                                                  torch.from_numpy(samp), ps.meta.camera.width,
                                                  with_counts=True)
    _assert_paths_agree(got, want, exact=False)
    assert (nom, act) == (int(j_nom), int(j_act))
    assert 0 < act <= nom


def test_default_policy_renders_textured_like_jax():
    """textured.xml at 16x16, 2 spp, max_depth 6 with the default integrator:
    take_tpu's policy picks its refill loop (an open BVH scene at d >= 3),
    the port's its scan loop (test_policy_is_the_scan_loop_unless_forced),
    and the images agree: means within 1e-3 relative; pixels within 1e-3
    relative (floor 1e-4) but for at most 2 of 256, where an ulp-level
    difference may send a path another way. (The JAX render traverses with
    its jnp while-loop, the port with the K3 twin.) Measured: every pixel
    within 6.8e-5 relative, means within 1.1e-6."""
    from take_tpu.render import use_wavefront_policy as j_policy

    js = with_res(jax_parse(TEXTURED), 16, JCamera)
    ps = with_res(port_scene(jax_parse(TEXTURED)), 16, TCamera)
    opts = dict(spp=2, max_depth=6, seed=0)
    assert j_policy(js, JOptions(**opts)) and not use_wavefront_policy(ps, TOptions(**opts))
    img_j = j_render(js, JOptions(**opts))
    img_t = t_render(ps, TOptions(**opts))
    assert img_t.shape == img_j.shape == (16, 16, 3) and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t.mean(axis=(0, 1)), img_j.mean(axis=(0, 1)), rtol=1e-3)
    err = (np.abs(img_t - img_j) / np.maximum(np.abs(img_j), 1e-4)).max(axis=-1)
    assert (err > 1e-3).sum() <= 2


def test_policy_is_the_scan_loop_unless_forced():
    """The port runs the refill loop only under integrator="mis_wavefront":
    the scan loop won every arm of take_tpu's policy on the H100 (ibl, an
    envmap scene at d6; textured, an open BVH scene at d6; room, a BVH
    scene at d8; PERF.md), where take_tpu picks its refill loop."""
    from take_tpu.render import use_wavefront_policy as j_policy
    from take_tpu_torch.lights.envmap import build_envmap

    box = port_builder(cornell_box, 4, 4)
    box.envmap = build_envmap(np.ones((2, 4, 3), np.float32))
    envmap_scene = box.build(device="cpu")
    textured = port_scene(jax_parse(TEXTURED))
    assert envmap_scene.meta.has_envmap and textured.bvh is not None and textured.meta.has_background
    for scene, depth in ((envmap_scene, 6), (textured, 6), (textured, 8)):
        for integrator in ("mis", "mis_scan", "one_sample_mis", "raw"):
            assert not use_wavefront_policy(scene, TOptions(max_depth=depth, integrator=integrator))
        assert use_wavefront_policy(scene, TOptions(max_depth=depth, integrator="mis_wavefront"))
    assert j_policy(jax_parse(TEXTURED), JOptions(max_depth=6))  # where take_tpu differs
