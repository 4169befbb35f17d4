"""take_tpu_torch's BVH queries against take_tpu's on the CPU: the plain
twins of K3 (packet) and K4/K5 (cluster) against the JAX package's Pallas
kernels in interpret mode and against the brute-force sweep, their
independence of the ray order, and a textured render end to end."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from unittest import mock

from take_tpu.core.camera import Camera as JCamera
from take_tpu.geometry.intersect import _pad_rays as jax_pad_rays
from take_tpu.geometry.pallas_cluster import cluster_traverse
from take_tpu.geometry.pallas_traverse import packet_traverse, prep_tables
from take_tpu.render import render_image as j_render
from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch.core.camera import Camera as TCamera
from take_tpu_torch.geometry import brute, cluster, intersect, packet, traverse
from take_tpu_torch.render import render_image as t_render
from take_tpu_torch.scene.types import RenderOptions as TOptions
from tests.test_bvh import random_soup_scene
from tests.torch_parity import port_scene, port_soup, with_res
from tests.test_torch_bvh import TEXTURED

BIG = 3.4e38
# t/u/v of the twins against the interpret-mode kernels, which take the
# affine sums as HIGHEST-precision dots (another rounding order): the
# bound test_cluster_traverse.py holds the TPU kernels to
RTOL = ATOL = 2e-5


def _rays(n, seed, spread=15.0):
    """Random rays around the soup; 10% dead lanes (tmax = -3.4e38), a
    third with a finite tmax (shadow-style), the rest unbounded."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.random(n) < 1 / 3, rng.uniform(1.0, 25.0, n), np.inf)
    tmax = np.where(rng.random(n) < 0.1, -BIG, tmax).astype(np.float32)
    return ro, rd, np.full(n, 1e-4, np.float32), tmax


def _padded(rays, block):
    """The rays with a padded tail (tmax = -1) up to a multiple of `block`,
    as the JAX package pads its Pallas grid; numpy and torch views."""
    _, *padded = jax_pad_rays(*(jnp.asarray(a) for a in rays), block)
    np_rays = [np.asarray(a) for a in padded]
    return np_rays, [torch.from_numpy(a.copy()) for a in np_rays]


def _near_tie(t_a, t_b, p_a, p_b):
    """Rays whose winners differ only as a near-tie: both hit, t within 1e-5."""
    both = (p_a >= 0) & (p_b >= 0)
    return both & (np.abs(t_a - t_b) <= 1e-5 * np.maximum(np.abs(t_b), 1.0))


def _assert_closest_agree(got, want, what):
    t, u, v, prim = (np.asarray(x) for x in got)
    t_w, u_w, v_w, prim_w = (np.asarray(x) for x in want)
    diff = prim != prim_w
    assert not (diff & ~_near_tie(t, t_w, prim, prim_w)).any(), what
    assert diff.mean() <= 1e-3, what
    same = ~diff & (prim >= 0)
    np.testing.assert_allclose(t[same], t_w[same], rtol=RTOL, atol=ATOL, err_msg=what)
    np.testing.assert_allclose(u[same], u_w[same], rtol=RTOL, atol=ATOL, err_msg=what)
    np.testing.assert_allclose(v[same], v_w[same], rtol=RTOL, atol=ATOL, err_msg=what)
    assert (t[prim < 0] == np.float32(BIG)).all(), what


def _brute_closest(port, r):
    g = port.geometry
    _, t, u, v, _, prim = brute.closest_plain(g.tri_rows, g.tri_attr, port.meta.n_tri, *r)
    return t, u, v, prim


@pytest.mark.parametrize("n_tri", [120, 1500])
def test_packet_plain_matches_jax_packet(n_tri):
    """K3's twin against packet_traverse (interpret mode) and the brute
    sweep on the same BVH-ordered tables: prim equal except near-ties, t/u/v
    within RTOL; dead lanes and the padded tail miss."""
    jax_scene = random_soup_scene(n_tri, build_bvh=True)
    port = port_soup(n_tri, build_bvh=True)
    (ro, rd, tmin, tmax), r = _padded(_rays(700, seed=n_tri), 256)
    nodes, tris = prep_tables(jax_scene)
    want = packet_traverse(nodes, tris, *(jnp.asarray(a) for a in (ro, rd, tmin, tmax)), interpret=True)
    got = packet.packet_plain(port.bvh, *r)
    _assert_closest_agree(got, want, "packet_plain vs packet_traverse")
    _assert_closest_agree(got, _brute_closest(port, r), "packet_plain vs closest_plain")
    assert (np.asarray(got[3])[tmax <= 0] == -1).all()

    *_, prim_j = packet_traverse(nodes, tris, *(jnp.asarray(a) for a in (ro, rd, tmin, tmax)),
                                 interpret=True, any_hit=True)
    occ = packet.packet_plain(port.bvh, *r, any_hit=True).numpy()
    np.testing.assert_array_equal(occ, np.asarray(prim_j) >= 0)
    g = port.geometry
    np.testing.assert_array_equal(
        occ, brute.occluded_plain(g.tri_rows, port.meta.n_tri, *r).numpy())
    assert not occ[tmax <= 0].any()


@pytest.mark.parametrize("n_tri", [40, 700])
def test_cluster_plain_matches_jax_cluster(n_tri):
    """K4/K5's twin against cluster_traverse (interpret mode) and the brute
    sweep, in the pattern of test_cluster_traverse.py."""
    jax_scene = random_soup_scene(n_tri, build_bvh=True)
    port = port_soup(n_tri, build_bvh=True)
    (ro, rd, tmin, tmax), r = _padded(_rays(3 * 128 - 28, seed=n_tri), 128)
    args = (jax_scene.bvh.sup_aabb, jax_scene.geometry.tri_sweep, *(jnp.asarray(a) for a in (ro, rd, tmin, tmax)))
    want = cluster_traverse(*args, interpret=True)
    got = cluster.cluster_plain(port.bvh.sup_aabb, port.bvh.tris, *r)
    _assert_closest_agree(got, want, "cluster_plain vs cluster_traverse")
    _assert_closest_agree(got, _brute_closest(port, r), "cluster_plain vs closest_plain")

    occ = cluster.cluster_plain(port.bvh.sup_aabb, port.bvh.tris, *r, any_hit=True).numpy()
    np.testing.assert_array_equal(occ, np.asarray(cluster_traverse(*args, any_hit=True, interpret=True)))
    assert not occ[tmax <= 0].any()


def test_twins_do_not_depend_on_ray_order():
    """Each ray's result is its own (exact-t ties go to the lower triangle
    index in every route), so the twins' outputs, closest and any-hit,
    follow the rays through a permutation bit for bit: the property that
    lets a kernel give any ray to any thread."""
    port = port_soup(300, build_bvh=True)
    ro, rd, tmin, tmax = _rays(3000, seed=3)
    ro[:1500] = ro[0]  # shared origins: many equal-t candidates across rays
    r = [torch.from_numpy(a) for a in (ro, rd, tmin, tmax)]
    perm = torch.from_numpy(np.random.default_rng(4).permutation(3000))
    sup, tris = port.bvh.sup_aabb, port.bvh.tris
    for fn in (lambda *a: packet.packet_plain(port.bvh, *a),
               lambda *a: cluster.cluster_plain(sup, tris, *a),
               lambda *a: (packet.packet_plain(port.bvh, *a, any_hit=True),),
               lambda *a: (cluster.cluster_plain(sup, tris, *a, any_hit=True),)):
        plain = fn(*r)
        permuted = fn(*(x[perm] for x in r))
        for a, b in zip(plain, permuted):
            assert torch.equal(a[perm], b)


@pytest.mark.parametrize("force_cluster,force_sweep", [(False, False), (True, False), (False, True)],
                         ids=["False", "True", "sweep"])
def test_bvh_queries_match_brute_scene(force_cluster, force_sweep):
    """intersect_scene/occluded on a BVH scene (each route: K3, K4/K5 under
    FORCE_CLUSTER, K6 for closest hits under FORCE_SWEEP) against the same
    soup built without a BVH: the same affine arithmetic on the same
    triangles, so every Hit field is equal."""
    port_bvh = port_soup(700, build_bvh=True)
    port_bf = port_soup(700, build_bvh=False)
    r = [torch.from_numpy(a) for a in _rays(2000, seed=9)]
    with mock.patch.object(traverse, "FORCE_CLUSTER", force_cluster), \
            mock.patch.object(traverse, "FORCE_SWEEP", force_sweep):
        h_bvh = intersect.intersect_scene(port_bvh, *r)
        o_bvh = intersect.occluded(port_bvh, *r)
    h_bf = intersect.intersect_scene(port_bf, *r)
    assert torch.equal(h_bvh.valid, h_bf.valid) and h_bvh.valid.any()
    v = h_bf.valid
    for name in ("t", "pos", "geo_n", "sh_n", "uv", "mat_id", "light_id", "front", "emit", "light_geom"):
        assert torch.equal(getattr(h_bvh, name)[v], getattr(h_bf, name)[v]), name
    assert torch.equal(o_bvh, intersect.occluded(port_bf, *r))


def _textured(res):
    js = with_res(jax_parse(TEXTURED), res, JCamera)
    return js, with_res(port_scene(js), res, TCamera)


def test_textured_render_matches_jax():
    """textured.xml (BVH, image texture, open scene) at 24x24, 2 spp,
    max_depth 3, integrator mis_scan: the port on the CPU (packet twin)
    against take_tpu.render_image on the CPU (its jnp while-loop traversal,
    which tests leaves with the edge form of Moller-Trumbore and so rounds t,
    u and v differently from the affine form). Means within 1e-3 relative;
    pixels within 1e-3 relative (floor 1e-4) except at most 2 of 576, where
    an ulp-level difference may send a path another way. Measured: every
    pixel within 7.9e-5 relative, means within 3.4e-7, no divergent pixel."""
    js, ps = _textured(24)
    opts = dict(spp=2, max_depth=3, seed=0, integrator="mis_scan")
    img_j = j_render(js, JOptions(**opts))
    img_t = t_render(ps, TOptions(**opts))
    assert img_t.shape == img_j.shape == (24, 24, 3) and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t.mean(axis=(0, 1)), img_j.mean(axis=(0, 1)), rtol=1e-3)
    err = (np.abs(img_t - img_j) / np.maximum(np.abs(img_j), 1e-4)).max(axis=-1)
    assert (err > 1e-3).sum() <= 2


def test_textured_sweep_route_render_matches_packet_route():
    """textured.xml at 16x16, 2 spp, max_depth 6 (the default policy: the
    refill loop), closest hits through K6's twin (FORCE_SWEEP) against the
    same render through K3's twin. The JAX package cannot be the reference
    here: its FORCE_SWEEP needs the TPU. Both twins return the least
    (t, prim) of the same affine tests, so every pixel agrees within 1e-6
    relative."""
    _, ps = _textured(16)
    opts = TOptions(spp=2, max_depth=6, seed=0)
    img_k3 = t_render(ps, opts)
    with mock.patch.object(traverse, "FORCE_SWEEP", True):
        img_k6 = t_render(ps, opts)
    assert np.isfinite(img_k6).all() and img_k6.mean() > 0
    np.testing.assert_allclose(img_k6, img_k3, rtol=1e-6, atol=0)


def test_textured_query_counts_match_jax():
    from take_tpu.core import rng as jrng
    from take_tpu.core.camera import generate_rays as jgen
    from take_tpu.integrator.path_tracer import trace_query_counts as jcounts
    from take_tpu_torch.core import rng as trng
    from take_tpu_torch.core.camera import generate_rays as tgen
    from take_tpu_torch.integrator.path_tracer import trace_query_counts as tcounts

    js, ps = _textured(16)
    opts = dict(spp=1, max_depth=3, seed=0, integrator="mis_scan")
    pix = np.arange(256, dtype=np.int32)
    px, py = (pix % 16).astype(np.float32), (pix // 16).astype(np.float32)
    jst = jrng.make_stream(0, jnp.asarray(pix), jnp.zeros(256, jnp.int32))
    tst = trng.make_stream(0, torch.from_numpy(pix), torch.zeros(256, dtype=torch.int32))
    jj = [jrng.uniform(jst, jrng.camera_counter(d)) for d in (0, 1)]
    tj = [trng.uniform(tst, trng.camera_counter(d)) for d in (0, 1)]
    jnom, jact, _ = jcounts(js, JOptions(**opts), *jgen(js.meta.camera, jnp.asarray(px), jnp.asarray(py), *jj), jst)
    with torch.inference_mode():
        tnom, tact = tcounts(ps, TOptions(**opts), *tgen(ps.meta.camera, torch.from_numpy(px),
                                                         torch.from_numpy(py), *tj), tst)
    assert tnom == int(jnom) == 256 * (1 + 2 * 4)
    assert abs(tact - int(jact)) <= 2  # a path or two may diverge at the ulp level
