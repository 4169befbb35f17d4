"""take_tpu_torch's plain twin of K6 (the cluster cull and sweep) against
take_tpu's Pallas sweep kernel in interpret mode, the brute-force sweep and
the K3 twin, on the CPU: prims exactly equal; t, u and v within the float32
rounding bound; its independence of the ray order; NaN-padded cluster rows
never hit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import fp32_bounds
from take_tpu.geometry.intersect import _pad_rays as jax_pad_rays
from take_tpu.geometry.pallas_sweep import sweep_traverse
from take_tpu.geometry.pallas_traverse import prep_tables
from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu_torch.core.camera import generate_rays
from take_tpu_torch.geometry import brute, packet, sweep
from tests.test_bvh import random_soup_scene
from tests.test_torch_bvh import TEXTURED
from tests.torch_parity import port_scene, port_soup

BIG = 3.4e38


def _rays(n, seed, spread=15.0, scene=None):
    """Random rays around the soup (half aimed inside random triangles of
    `scene`, if given): a third with a finite tmax, 25% dead lanes
    (tmax = -3.4e38), and every 16th a padded ray (ro = rd = 0, tmax = -1),
    as numpy."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    if scene is not None:
        k = rng.integers(0, scene.meta.n_tri, n // 2)
        g = {f: getattr(scene.geometry, f).numpy()[k] for f in ("tri_v0", "tri_e1", "tri_e2")}
        d[: n // 2] = g["tri_v0"] + 0.3 * g["tri_e1"] + 0.3 * g["tri_e2"] - ro[: n // 2]
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.random(n) < 1 / 3, rng.uniform(1.0, 25.0, n), np.inf)
    tmax = np.where(rng.random(n) < 0.25, -BIG, tmax).astype(np.float32)
    ro[::16], rd[::16], tmax[::16] = 0.0, 0.0, -1.0
    return ro, rd, np.full(n, 1e-4, np.float32), tmax


def _jax_sweep(jax_scene, rays, any_hit=False):
    """sweep_traverse in interpret mode on the rays padded to its block,
    cut back to the rays given."""
    n = rays[0].shape[0]
    _, *padded = jax_pad_rays(*(jnp.asarray(a) for a in rays), 128)
    out = sweep_traverse(jax_scene.bvh.cl_aabb, prep_tables(jax_scene)[1], *padded,
                         n_tri=jax_scene.meta.n_tri, any_hit=any_hit, interpret=True)
    return [np.asarray(x)[:n] for x in out]


def _port_args(port):
    return port.bvh.cl_aabb, port.bvh.tris, port.meta.n_tri


@pytest.mark.parametrize("n_tri", [40, 700])
def test_sweep_plain_matches_jax_sweep(n_tri):
    """N = 356 rays (not a multiple of 128): the twin's prims equal the
    interpret-mode kernel's and the brute sweep's exactly, closest and any
    hit; t, u and v of the hits lie within the float32 rounding bound of
    their operands (the JAX kernel takes the affine sums as HIGHEST-precision
    dots, another rounding order than torch's); dead and padded lanes miss."""
    jax_scene = random_soup_scene(n_tri, build_bvh=True)
    port = port_soup(n_tri, build_bvh=True)
    rays = _rays(356, seed=n_tri, scene=port)
    r = [torch.from_numpy(a) for a in rays]
    t, u, v, prim = (x.numpy() for x in sweep.sweep_plain(*_port_args(port), *r))
    t_j, u_j, v_j, prim_j = _jax_sweep(jax_scene, rays)
    np.testing.assert_array_equal(prim, prim_j)
    g = port.geometry
    np.testing.assert_array_equal(prim, brute.closest_plain(g.tri_rows, g.tri_attr,
                                                            n_tri, *r)[5].numpy())
    hit = prim >= 0
    assert 60 < hit.sum() < hit.size
    bounds = fp32_bounds(torch, g, torch.from_numpy(prim[hit]), r[0][hit], r[1][hit])
    for got, want, bound in zip((t, u, v), (t_j, u_j, v_j), bounds):
        assert (np.abs(got[hit] - want[hit]) <= bound.numpy()).all()
    assert (t[~hit] == np.float32(BIG)).all() and (t_j[~hit] == np.float32(BIG)).all()
    off = rays[3] < rays[2]
    assert (prim[off] == -1).all()

    occ = sweep.sweep_plain(*_port_args(port), *r, any_hit=True).numpy()
    np.testing.assert_array_equal(occ, _jax_sweep(jax_scene, rays, any_hit=True)[3] >= 0)
    np.testing.assert_array_equal(occ, hit)
    assert not occ[off].any()


def test_sweep_plain_matches_packet_plain_on_textured():
    """textured.xml: camera rays and rays from inside the scene's box; the
    sweep twin and the K3 twin (the same affine test, each exact over its
    own visiting order) find the same triangle for every ray."""
    port = port_scene(jax_parse(TEXTURED))
    cam = port.meta.camera
    rng = np.random.default_rng(2)
    n = 3000
    pix = rng.integers(0, cam.width * cam.height, n // 2)
    ro_c, rd_c = generate_rays(cam, torch.tensor(pix % cam.width, dtype=torch.float32),
                               torch.tensor(pix // cam.width, dtype=torch.float32),
                               *(torch.tensor(rng.random(n // 2), dtype=torch.float32) for _ in range(2)))
    lo = port.bvh.node_min[0].amin(dim=0).numpy()
    hi = port.bvh.node_max[0].amax(dim=0).numpy()
    ro_b = rng.uniform(lo, hi, (n - n // 2, 3))
    d = rng.normal(size=(n - n // 2, 3))
    ro = torch.cat([ro_c, torch.tensor(ro_b, dtype=torch.float32)])
    rd = torch.cat([rd_c, torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), dtype=torch.float32)])
    tmax = torch.where(torch.from_numpy(rng.random(n) < 0.1), -BIG, float("inf"))
    r = (ro, rd, torch.full((n,), 1e-4), tmax)
    got = sweep.sweep_plain(*_port_args(port), *r)
    want = packet.packet_plain(port.bvh, *r)
    assert torch.equal(got[3], want[3]) and (got[3] >= 0).float().mean() > 0.3
    assert torch.equal(got[0], want[0])
    assert torch.equal(sweep.sweep_plain(*_port_args(port), *r, any_hit=True), want[3] >= 0)


def test_sweep_plain_does_not_depend_on_ray_order():
    """Each ray's (t, u, v, prim) and occlusion follow it through a random
    permutation bit for bit, shared origins (equal-t candidates) included."""
    port = port_soup(300, build_bvh=True)
    ro, rd, tmin, tmax = _rays(2000, seed=3)
    ro[:1000] = ro[1]
    r = [torch.from_numpy(a) for a in (ro, rd, tmin, tmax)]
    perm = torch.from_numpy(np.random.default_rng(4).permutation(2000))
    plain = [*sweep.sweep_plain(*_port_args(port), *r), sweep.sweep_plain(*_port_args(port), *r, any_hit=True)]
    r = [x[perm] for x in r]
    permuted = [*sweep.sweep_plain(*_port_args(port), *r), sweep.sweep_plain(*_port_args(port), *r, any_hit=True)]
    for a, b in zip(plain, permuted):
        assert torch.equal(a[perm], b)


def test_nan_padded_clusters_never_hit():
    """Extra all-NaN rows leave every answer as it was, rays whose origin is
    inside the scene included; a table of NaN rows alone hits nothing."""
    port = port_soup(700, build_bvh=True)
    cl, tris, n_tri = _port_args(port)
    assert torch.isnan(cl[-1]).all()  # the build pads with NaN rows
    r = [torch.from_numpy(a) for a in _rays(500, seed=8, spread=5.0)]
    base = sweep.sweep_plain(cl, tris, n_tri, *r)
    more = torch.cat([cl, torch.full((16, 8), float("nan"))])
    for a, b in zip(base, sweep.sweep_plain(more, tris, n_tri, *r)):
        assert torch.equal(a, b)
    nan = torch.full_like(cl, float("nan"))
    assert (sweep.sweep_plain(nan, tris, n_tri, *r)[3] == -1).all()
    assert not sweep.sweep_plain(nan, tris, n_tri, *r, any_hit=True).any()
    assert (base[3] >= 0).any()
