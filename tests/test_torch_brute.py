"""take_tpu_torch brute-force queries against take_tpu's XLA brute path.

On the CPU the port's queries run the plain twins of the CUDA kernels
(geometry/brute.py); tests/test_pallas_brute.py ties take_tpu's XLA path
to its Pallas kernels in interpret mode, so this closes the chain. The
kernels themselves are compared with the twins on the card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import near_boundary
from take_tpu.geometry.intersect import _brute_force_intersect, _tri_uvt
from take_tpu.geometry.intersect import occluded as j_occluded
from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu_torch.geometry import _launch, brute
from take_tpu_torch.geometry.intersect import _pad_rays, intersect_scene, occluded
from tests.scenes import cornell_box
from tests.torch_parity import CBOX, port_builder, port_scene

# tests/test_pallas_brute.py's tolerance for the Hit fields of agreeing rays
RTOL, ATOL = 2e-4, 2e-3


def _rays(rng_np, n, lo=(-400.0, -100.0, -400.0), hi=(400.0, 600.0, 400.0)):
    ro = rng_np.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng_np.normal(size=(n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


def _jax_prim(js, ro, rd, tmin, tmax):
    t, _, _, valid = _tri_uvt(js.geometry, *map(jnp.asarray, (ro, rd, tmin, tmax)), js.meta.n_tri)
    t_m = np.where(np.asarray(valid), np.asarray(t), 3.4e38)
    return np.where(t_m.min(axis=1) < 3.4e38, t_m.argmin(axis=1), -1)


def _scene_pair():
    js = jax_parse(CBOX)
    return js, port_scene(js)


def test_closest_matches_jax_brute(rng_np):
    js, ps = _scene_pair()
    n = 4096
    ro, rd = _rays(rng_np, n)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    ref = _brute_force_intersect(js, *map(jnp.asarray, (ro, rd, tmin, tmax)))
    args = tuple(map(torch.from_numpy, (ro, rd, tmin, tmax)))
    hit = intersect_scene(ps, *args)
    g = ps.geometry
    prim = brute.closest_plain(g.tri_rows, g.tri_attr, ps.meta.n_tri, *args)[5].numpy()
    jprim = _jax_prim(js, ro, rd, tmin, tmax)

    bad = prim != jprim
    assert bad.mean() <= 1e-3  # measured: 0 of 4096
    if bad.any():
        idx = torch.from_numpy(np.nonzero(bad)[0])
        prims = torch.from_numpy(np.stack([prim[bad], jprim[bad]], 1))
        assert near_boundary(torch, g, ps.meta.n_tri, *(a[idx] for a in args), prims).all()
    sel = ~bad & np.asarray(ref.valid)
    np.testing.assert_array_equal(hit.valid.numpy()[~bad], np.asarray(ref.valid)[~bad])
    assert sel.sum() > n // 4
    for field in ("t", "pos", "geo_n", "sh_n", "uv", "emit", "light_geom"):
        np.testing.assert_allclose(
            getattr(hit, field).numpy()[sel], np.asarray(getattr(ref, field))[sel],
            rtol=RTOL, atol=ATOL, err_msg=field)
    for field in ("mat_id", "light_id", "front"):
        np.testing.assert_array_equal(
            getattr(hit, field).numpy()[sel], np.asarray(getattr(ref, field))[sel], err_msg=field)


def test_occluded_matches_jax_with_dead_and_padded_lanes(rng_np):
    js, ps = _scene_pair()
    n = 3000
    ro, rd = _rays(rng_np, n)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = rng_np.uniform(10.0, 2000.0, n).astype(np.float32)
    tmax[rng_np.random(n) < 0.1] = -3.4e38  # dead lanes
    _, *padded = _pad_rays(*map(torch.from_numpy, (ro, rd, tmin, tmax)), 1024)
    assert padded[0].shape[0] == 3072
    ro, rd, tmin, tmax = (a.numpy() for a in padded)

    ref = np.asarray(j_occluded(js, *map(jnp.asarray, (ro, rd, tmin, tmax))))
    occ = occluded(ps, *padded).numpy()
    assert not occ[tmax <= 0].any()
    bad = occ != ref
    assert bad.mean() <= 1e-3  # measured: 0 of 3072
    if bad.any():
        idx = torch.from_numpy(np.nonzero(bad)[0])
        g = ps.geometry
        assert near_boundary(torch, g, ps.meta.n_tri, *(a[idx] for a in padded), None).all()
    assert 0.1 < occ.mean() < 0.9


def test_dead_and_padded_lanes_miss(rng_np):
    _, ps = _scene_pair()
    n = 1000
    ro, rd = _rays(rng_np, n, lo=(100.0, 100.0, 100.0), hi=(450.0, 450.0, 450.0))
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::2] = -3.4e38
    _, *rays = _pad_rays(*map(torch.from_numpy, (ro, rd, tmin, tmax)), 256)
    g = ps.geometry
    attrs, t, u, v, found, prim = brute.closest(g.tri_rows, g.tri_attr, ps.meta.n_tri, *rays)
    dead = rays[3] <= 0
    assert found[~dead].float().mean() > 0.6  # the box is open only at the front
    assert not found[dead].any() and (prim[dead] == -1).all()
    assert (t[dead] == brute.BIG).all() and (attrs[dead] == 0).all()
    assert (u[dead] == 0).all() and (v[dead] == 0).all()


def test_spheres_and_triangles_match_jax(rng_np):
    jb, tb = cornell_box(), port_builder(cornell_box)
    for b in (jb, tb):
        m = b.add_material(0, tex_value=(0.3, 0.6, 0.9))
        b.add_sphere((0.3, 0.25, -0.3), 0.2, m)
        b.add_sphere((0.7, 0.6, -0.6), 0.15, m, emission=(2.0, 2.0, 2.0))
    js, ps = jb.build(), tb.build(device="cpu")
    n = 2048
    ro, rd = _rays(rng_np, n, lo=(0.05, 0.05, -0.95), hi=(0.95, 0.95, -0.05))
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    ref = _brute_force_intersect(js, *map(jnp.asarray, (ro, rd, tmin, tmax)))
    hit = intersect_scene(ps, *map(torch.from_numpy, (ro, rd, tmin, tmax)))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(hit.valid.numpy(), valid)
    same = (hit.mat_id.numpy() == np.asarray(ref.mat_id)) & valid
    assert same.sum() >= valid.sum() - 2  # measured: all agree
    for field in ("t", "pos", "geo_n", "sh_n", "uv", "emit", "light_geom"):
        np.testing.assert_allclose(
            getattr(hit, field).numpy()[same], np.asarray(getattr(ref, field))[same],
            rtol=RTOL, atol=ATOL, err_msg=field)
    np.testing.assert_array_equal(hit.light_id.numpy()[same], np.asarray(ref.light_id)[same])

    tmax_f = rng_np.uniform(0.05, 1.5, n).astype(np.float32)
    ref_o = np.asarray(j_occluded(js, *map(jnp.asarray, (ro, rd, tmin, tmax_f))))
    occ = occluded(ps, *map(torch.from_numpy, (ro, rd, tmin, tmax_f))).numpy()
    assert (occ != ref_o).sum() <= 2  # measured: 0


def test_cpu_tensors_run_the_twins(rng_np):
    _, ps = _scene_pair()
    g, n_tri = ps.geometry, ps.meta.n_tri
    ro, rd = map(torch.from_numpy, _rays(rng_np, 64))
    tmin, tmax = torch.full((64,), 1e-4), torch.full((64,), float("inf"))
    _launch.reset_launches()
    brute.closest(g.tri_rows, g.tri_attr, n_tri, ro, rd, tmin, tmax)
    brute.occluded(g.tri_rows, n_tri, ro, rd, tmin, tmax)
    assert _launch.LAUNCHES == {**dict.fromkeys(_launch.LAUNCHES, 0), "closest_plain": 1, "anyhit_plain": 1}


def test_wrapper_checks_refuse_bad_inputs():
    x = torch.zeros((8, 3))
    _launch.check("ro", x, torch.float32, (8, 3), x.device)
    with pytest.raises(ValueError, match="ro"):
        _launch.check("ro", x.double(), torch.float32, (8, 3), x.device)
    with pytest.raises(ValueError, match="ro"):
        _launch.check("ro", x.T, torch.float32, (3, 8), x.device)
    with pytest.raises(ValueError, match="n_tri"):
        g = port_scene(jax_parse(CBOX)).geometry
        brute._check(g.tri_rows, None, 0, x, x, x[:, 0], x[:, 0])

