"""scenes/ibl/ibl.xml on take_tpu_torch against take_tpu on the CPU: the
parsed tables (the environment map's included), renders through each
integrator, the scan loop against the refill loop, the camera arrival of
the refill loop, and the port's mirror of tests/test_ibl_analytic.py's
closed-form azimuth environment."""

import os

import numpy as np
import pytest
import torch

from take_tpu.core.camera import Camera as JCamera
from take_tpu.render import render_image as j_render
from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu.scene.types import RenderOptions as JOptions
from chip_smoke import azimuth_env_scene
from take_tpu_torch.core.camera import Camera as TCamera
from take_tpu_torch.integrator.path_tracer import _arrival_contribs
from take_tpu_torch.lights.envmap import envmap_eval
from take_tpu_torch.render import render_image as t_render
from take_tpu_torch.render import use_wavefront_policy
from take_tpu_torch.scene.parse_xml import parse_scene_file as port_parse
from take_tpu_torch.scene.types import MAT_DIFFUSE, MAT_DISNEY_BSDF, MAT_DISNEY_METAL, Hit, RenderOptions
from tests.test_torch_scene import _assert_meta_equal, _assert_tables_equal
from tests.torch_parity import port_scene, with_res

IBL = os.path.join(os.path.dirname(__file__), "..", "scenes", "ibl", "ibl.xml")


@pytest.fixture(scope="module")
def jax_ibl():
    return jax_parse(IBL)


def test_ibl_tables_match_jax(jax_ibl):
    """Every table of the parsed scene bit for bit, the envmap's seven
    (sky_2k.exr, 2048x1024: the alias table over 2^21 texels) included."""
    port = port_parse(IBL, device="cpu")
    assert port.meta.has_envmap and port.bvh is None and port.meta.n_lights == 0
    assert port.meta.n_tri == 2 and port.meta.n_sph == 3
    assert {MAT_DIFFUSE, MAT_DISNEY_METAL, MAT_DISNEY_BSDF} <= set(port.meta.used_material_tags)
    assert port.envmap.data.shape == (1024, 2048, 3)
    _assert_tables_equal(port, jax_ibl)
    _assert_meta_equal(port, jax_ibl)


@pytest.mark.parametrize("integrator", ["mis", "mis_scan", "one_sample_mis", "raw"])
def test_ibl_render_matches_jax(jax_ibl, integrator):
    """ibl at 24x24, 4 spp, max_depth 6 (take_tpu's tables, bit-equal by the
    test above): means within 1e-3 relative; pixels within 1e-3 relative
    (floor 1e-4) but for at most 3 of 576, as test_mis_render_matches_jax
    holds mis. "mis" takes each package's default loop (the port's scan
    loop against take_tpu's refill loop), "mis_scan" the scan loop in
    both. ibl has no light but the map, so
    one-sample MIS has no NEE arm and equals raw. Measured: every pixel
    within 9.5e-4 (mis) and 2.4e-3 (one_sample_mis, raw: 1 pixel beyond
    1e-3) relative, means within 1.9e-6."""
    js = with_res(jax_ibl, 24, JCamera)
    ps = with_res(port_scene(jax_ibl), 24, TCamera)
    opts = dict(spp=4, max_depth=6, seed=0, integrator=integrator)
    img_j = j_render(js, JOptions(**opts))
    img_t = t_render(ps, RenderOptions(**opts))
    assert img_t.shape == img_j.shape == (24, 24, 3) and np.isfinite(img_t).all() and img_t.mean() > 0.1
    np.testing.assert_allclose(img_t.mean(axis=(0, 1)), img_j.mean(axis=(0, 1)), rtol=1e-3)
    err = (np.abs(img_t - img_j) / np.maximum(np.abs(img_j), 1e-4)).max(axis=-1)
    assert (err > 1e-3).sum() <= 3


def test_ibl_scan_and_refill_loops_agree(jax_ibl):
    """Without Russian roulette the refill loop gives the scan loop's
    image bit for bit (integrator/wavefront.py), on ibl too: shadow rays
    toward the map, Disney lobes, escapes MIS-weighted."""
    ps = with_res(port_scene(jax_ibl), 16, TCamera)
    opts = dict(spp=2, max_depth=6, seed=1)
    img_s = t_render(ps, RenderOptions(integrator="mis_scan", **opts))
    img_w = t_render(ps, RenderOptions(integrator="mis_wavefront", **opts))
    np.testing.assert_array_equal(img_w, img_s)


def test_camera_arrival_gives_envmap_radiance(jax_ibl):
    """The refill loop hands a camera ray to _arrival_contribs as a bounce
    arrival with FG = 1, bpdf = 1 and spec set: an escape must then carry
    the map's radiance with weight 1, bit for bit, and a hit nothing."""
    ps = port_scene(jax_ibl)
    n = 512
    rng = np.random.default_rng(8)
    rd = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    rd = rd / rd.norm(dim=1, keepdim=True)
    valid = torch.from_numpy(rng.random(n) < 0.5)
    z3, z = torch.zeros(n, 3), torch.zeros(n)
    hit = Hit(valid=valid, t=z, pos=z3, geo_n=z3, sh_n=z3, uv=torch.zeros(n, 2),
              mat_id=torch.zeros(n, dtype=torch.int32), light_id=torch.full((n,), -1, dtype=torch.int32),
              front=valid, emit=z3, light_geom=z)
    ones, yes = torch.ones(n), torch.ones(n, dtype=torch.bool)
    miss_term, c2, contrib = _arrival_contribs(ps, z3, rd, torch.ones(n, 3), ones, yes, yes, yes, hit)
    want = torch.where(valid[:, None], 0.0, envmap_eval(ps.envmap, rd))
    assert torch.equal(miss_term, want) and torch.equal(c2, z3) and torch.equal(contrib, torch.ones(n, 3))


@pytest.mark.parametrize("integrator,rtol", [("mis", 0.02), ("one_sample_mis", 0.04), ("raw", 0.08)])
def test_ibl_azimuth_env_closed_form(integrator, rtol):
    """test_ibl_analytic.py's closed form, its scene (chip_smoke's copy),
    spp, depth, seed and rtol, on the port: the image mean within rtol,
    every pixel within 5 rtol."""
    scene, expected = azimuth_env_scene("cpu")
    options = RenderOptions(spp=512 if integrator != "raw" else 1024, max_depth=3, seed=7, integrator=integrator)
    assert not use_wavefront_policy(scene, options)
    img = t_render(scene, options)
    np.testing.assert_allclose(img.mean(), expected, rtol=rtol)
    np.testing.assert_allclose(img.mean(axis=2), expected, rtol=5 * rtol)
