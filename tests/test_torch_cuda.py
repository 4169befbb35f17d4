"""take_tpu_torch's CUDA kernels against their plain twins, on the card.

These tests need a CUDA device and skip without one. They import neither
JAX nor take_tpu, so they run where only PyTorch is installed:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import contextlib
import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import capture_queries, fp32_bounds, near_boundary, with_res
from take_tpu_torch.geometry import _launch, brute, cluster, packet, sweep
from take_tpu_torch.geometry.packet import prep_tables
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.parse_xml import parse_scene_file
from take_tpu_torch.scene.types import BVHArrays

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
CBOX = os.path.join(SCENES, "cbox", "cbox.xml")
ROOM = os.path.join(SCENES, "room", "room.xml")
N = 1 << 16


def chain_scene(depth, device):
    """A degenerate deep tree: `depth` triangles at z = k + 0.5 (k < depth),
    and a chain of nested boxes C_0 ... C_{depth-1}, where C_k holds the
    triangles k ... depth-1 and has two inner children, C_{k+1} and a side
    node S_k over triangle k (the last chain node holds its triangle as a
    leaf). Wide depth `depth`; a ray down the chain keeps one stack entry
    per level."""
    b = SceneBuilder()
    m = b.add_material(0)
    for k in range(depth):
        b.add_mesh(np.array([[-1.0, -1.0, k + 0.5], [3.0, -1.0, k + 0.5], [-1.0, 3.0, k + 0.5]]),
                   np.array([[0, 1, 2]]), m)
    scene = b.build(device=device, build_bvh=False)
    n = 2 * depth - 1  # C_0 = 0, C_k = 2k - 1, S_k = 2k + 2 (breadth first)
    lo = np.full((n, 8, 3), 3e38, np.float32)
    hi = np.full((n, 8, 3), -3e38, np.float32)
    child = np.full((n, 8), -1, np.int32)
    count = np.zeros((n, 8), np.int32)
    c_of = lambda k: 0 if k == 0 else 2 * k - 1
    for k in range(depth):
        c = c_of(k)
        if k == depth - 1:
            lo[c, 0], hi[c, 0], child[c, 0], count[c, 0] = (-1, -1, k + 0.5), (3, 3, k + 0.5), -(k + 1), 1
            continue
        s = 2 * k + 2
        lo[c, 0], hi[c, 0], child[c, 0] = (-1, -1, k + 1.5), (3, 3, depth - 0.5), c_of(k + 1)
        lo[c, 1], hi[c, 1], child[c, 1] = (-1, -1, k + 0.5), (3, 3, k + 0.5), s
        lo[s, 0], hi[s, 0], child[s, 0], count[s, 0] = (-1, -1, k + 0.5), (3, 3, k + 0.5), -(k + 1), 1
    bvh = BVHArrays(*(torch.from_numpy(a).to(device) for a in (lo, hi, child, count)),
                    cl_aabb=None, sup_aabb=None, depth=depth)
    bvh.nodes, bvh.tris, bvh.qnodes = prep_tables(bvh, scene.geometry)
    return dataclasses.replace(scene, bvh=bvh)


def tiled_tables(sup, cl, tris, copies, shift):
    """`copies` copies of a scene's cluster tables (sup_aabb, cl_aabb,
    bvh.tris), the k-th moved by k shift: each copy keeps its supercluster
    rows (NaN padding included), 8 cluster rows each (NaN for padding
    superclusters) and 512 triangle rows each (zero past the copy's rows),
    so the tables stay consistent for any number of superclusters. The
    rows' constant terms move with the boxes."""
    n_sup, dev = sup.shape[0], sup.device
    cl_full = torch.full((n_sup * 8, 8), float("nan"), device=dev)
    cl_full[:cl.shape[0]] = cl
    rows = torch.zeros((n_sup * 512, 24), device=dev)
    rows[:tris.shape[0]] = tris
    out = ([], [], [])
    for k in range(copies):
        s = k * torch.tensor(shift, dtype=torch.float32, device=dev)
        r = rows.clone()
        for j in range(3):  # o_j' = o_j - row_j . s: the map of the moved triangle
            r[:, 4 * j + 3] -= (r[:, 4 * j:4 * j + 3] * s).sum(dim=1)
        move = torch.cat([s, s, torch.zeros(2, device=dev)])
        out[0].append(sup + move)
        out[1].append(cl_full + move)
        out[2].append(r)
    return tuple(torch.cat(x).contiguous() for x in out)


@pytest.fixture
def cbox_rays():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    scene = parse_scene_file(CBOX, device="cuda")
    rng = np.random.default_rng(1234)
    ro = rng.uniform((1.0, 1.0, 1.0), (555.0, 547.0, 558.0), (N, 3))
    d = rng.normal(size=(N, 3))
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(N) < 0.1, -3.4e38, rng.uniform(10.0, 2000.0, N))
    tmax[rng.random(N) < 0.5] = np.inf
    rays = [torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
            for a in (ro, rd, np.full(N, 1e-4), tmax)]
    return scene, rays


@pytest.mark.cuda
def test_closest_kernel_matches_twin(cbox_rays):
    scene, rays = cbox_rays
    g, n_tri = scene.geometry, scene.meta.n_tri
    k = brute.closest(g.tri_rows, g.tri_attr, n_tri, *rays)
    p = brute.closest_plain(g.tri_rows, g.tri_attr, n_tri, *rays)
    torch.cuda.synchronize()
    agree = k[5] == p[5]
    assert agree.float().mean().item() >= 0.9999
    bad = (~agree).nonzero()[:, 0]
    prims = torch.stack([k[5][bad], p[5][bad]], dim=1)
    assert near_boundary(torch, g, n_tri, *(r[bad] for r in rays), prims).all()
    both = agree & k[4]
    bt, bu, bv = fp32_bounds(torch, g, k[5][both], rays[0][both], rays[1][both])
    assert ((k[1] - p[1]).abs()[both] <= bt).all()
    assert ((k[2] - p[2]).abs()[both] <= bu).all()
    assert ((k[3] - p[3]).abs()[both] <= bv).all()
    assert torch.equal(k[0][both], p[0][both])
    dead = rays[3] <= 0
    assert (k[5][dead] == -1).all() and (k[1][dead] == brute.BIG).all()


@pytest.mark.cuda
def test_anyhit_kernel_matches_twin(cbox_rays):
    scene, rays = cbox_rays
    g, n_tri = scene.geometry, scene.meta.n_tri
    k = brute.occluded(g.tri_rows, n_tri, *rays)
    p = brute.occluded_plain(g.tri_rows, n_tri, *rays)
    torch.cuda.synchronize()
    bad = (k != p).nonzero()[:, 0]
    assert bad.numel() <= N // 10000
    assert near_boundary(torch, g, n_tri, *(r[bad] for r in rays), None).all()
    assert not k[rays[3] <= 0].any()


@pytest.mark.cuda
def test_kernel_launches_are_counted_and_checked(cbox_rays):
    scene, rays = cbox_rays
    g, n_tri = scene.geometry, scene.meta.n_tri
    _launch.reset_launches()
    brute.closest(g.tri_rows, g.tri_attr, n_tri, *rays)
    brute.occluded(g.tri_rows, n_tri, *rays)
    assert _launch.LAUNCHES == {**dict.fromkeys(_launch.LAUNCHES, 0), "closest": 1, "anyhit": 1}
    with pytest.raises(ValueError, match="ro"):
        brute.occluded(g.tri_rows, n_tri, rays[0].double(), *rays[1:])


@pytest.fixture(scope="module")
def room():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return parse_scene_file(ROOM, device="cuda")


@pytest.fixture
def room_rays(room):
    """Rays from inside the room, random directions; 10% dead lanes, half
    with a finite tmax."""
    rng = np.random.default_rng(4321)
    lo = room.bvh.node_min[0].amin(dim=0).cpu().numpy()
    hi = room.bvh.node_max[0].amax(dim=0).cpu().numpy()
    ro = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), (N, 3))
    d = rng.normal(size=(N, 3))
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(N) < 0.5, rng.uniform(0.1, 3.0, N), np.inf)
    tmax[rng.random(N) < 0.1] = -3.4e38
    return [torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
            for a in (ro, rd, np.full(N, 1e-4), tmax)]


def _closest_agree(room, k, p, rays):
    """Winner equal on >= 99.99% of rays and every mismatch at a near-tie
    or an edge; t/u/v of agreeing hits within the float32 rounding bound."""
    g, n_tri = room.geometry, room.meta.n_tri
    agree = k[3] == p[3]
    assert agree.float().mean().item() >= 0.9999
    bad = (~agree).nonzero()[:, 0]
    tie = (k[3][bad] >= 0) & (p[3][bad] >= 0) & ((k[0][bad] - p[0][bad]).abs() <= 1e-5 * p[0][bad].abs())
    prims = torch.stack([k[3][bad], p[3][bad]], dim=1)
    assert (tie | near_boundary(torch, g, n_tri, *(r[bad] for r in rays), prims)).all()
    both = agree & (k[3] >= 0)
    bt, bu, bv = fp32_bounds(torch, g, k[3][both], rays[0][both], rays[1][both])
    for j, b in ((0, bt), (1, bu), (2, bv)):
        assert ((k[j] - p[j]).abs()[both] <= b).all()
    dead = rays[3] <= 0
    assert (k[3][dead] == -1).all() and (k[0][dead] == brute.BIG).all()


@pytest.mark.cuda
def test_packet_kernels_match_twin(room, room_rays):
    k = packet.closest(room.bvh, *room_rays)
    p = packet.packet_plain(room.bvh, *room_rays)
    torch.cuda.synchronize()
    _closest_agree(room, k, p, room_rays)
    o_k = packet.occluded(room.bvh, *room_rays)
    o_p = packet.packet_plain(room.bvh, *room_rays, any_hit=True)
    bad = (o_k != o_p).nonzero()[:, 0]
    assert bad.numel() <= N // 10000
    assert near_boundary(torch, room.geometry, room.meta.n_tri, *(r[bad] for r in room_rays), None).all()
    assert not o_k[room_rays[3] <= 0].any()


def _cluster_equal(tables, rays):
    """K4 and K5 against cluster_plain on `rays`: equal bit for bit (the
    kernels round their triangle test as the twin does)."""
    sup, cl, tris = tables
    k = cluster.closest(sup, cl, tris, *rays)
    o_k = cluster.occluded(sup, cl, tris, *rays)
    p = cluster.cluster_plain(sup, tris, *rays)
    o_p = cluster.cluster_plain(sup, tris, *rays, any_hit=True)
    torch.cuda.synchronize()
    _assert_bits_equal(k, p)
    assert torch.equal(o_k, o_p)
    return k, o_k


@pytest.mark.cuda
def test_cluster_kernels_match_twin(room, room_rays):
    """K4 and K5 on room rays: cluster_plain's answers bit for bit, so also
    within the closest-hit gate; dead lanes miss."""
    bvh = room.bvh
    k, o_k = _cluster_equal((bvh.sup_aabb, bvh.cl_aabb, bvh.tris), room_rays)
    _closest_agree(room, k, cluster.cluster_plain(bvh.sup_aabb, bvh.tris, *room_rays), room_rays)
    assert not o_k[room_rays[3] <= 0].any() and o_k.any()


@pytest.mark.cuda
def test_cluster_kernels_on_captured_batches(room):
    """K4 and K5 on the queries a room render launches under FORCE_CLUSTER
    (one pass of a 192x108, 1 spp, d6 render: camera, bounce and shadow
    rays): cluster_plain's answers bit for bit."""
    from take_tpu_torch.scene.types import RenderOptions

    calls = capture_queries(torch, with_res(room, 192, 108), RenderOptions(spp=1, max_depth=6, seed=0),
                            cluster_route=True)
    assert [k for k, _ in calls].count("closest") == 8 and [k for k, _ in calls].count("anyhit") == 7
    bvh = room.bvh
    for _, rays in calls:
        _cluster_equal((bvh.sup_aabb, bvh.cl_aabb, bvh.tris), rays)


@pytest.mark.cuda
def test_cluster_streams_tables_of_many_chunks(room, room_rays):
    """Room's tables twice, the copy moved 20 along x (416 superclusters:
    the kernels stage 256 a chunk, so the copy streams through the second
    chunk; no size cap), with half the rays moved into the copy: K4 and K5
    equal cluster_plain bit for bit, and most moved rays hit the copy's
    triangles in the second chunk (a few leave room through its openings)."""
    bvh = room.bvh
    tables = tiled_tables(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, 2, (20.0, 0.0, 0.0))
    assert tables[0].shape[0] == 416 and tables[1].shape[0] == 3328
    ro, rd, tmin, tmax = (r.clone() for r in room_rays)
    ro[1::2, 0] += 20.0
    k, _ = _cluster_equal(tables, (ro, rd, tmin, tmax))
    moved = k[3][1::2]
    assert (moved >= 256 * 512).sum() > (moved >= 0).sum() // 2


@pytest.mark.cuda
def test_cluster_odd_sizes_dead_and_padded_lanes(room, room_rays):
    """n = 0, 1 and 1000 (not a multiple of the block): answers equal the
    whole batch's and the twin's; dead lanes (tmax = -3.4e38) and padded
    lanes (ro = rd = 0, tmax = -1) miss in both modes."""
    bvh = room.bvh
    tables = (bvh.sup_aabb, bvh.cl_aabb, bvh.tris)
    ro, rd, tmin, tmax = (r[:1000].clone() for r in room_rays)
    tmax[::3] = -3.4e38
    ro[1::7], rd[1::7], tmax[1::7] = 0.0, 0.0, -1.0
    (t, u, v, prim), occ = _cluster_equal(tables, (ro, rd, tmin, tmax))
    for m in (0, 1):
        part = [x[:m].contiguous() for x in (ro, rd, tmin, tmax)]
        k, o = _cluster_equal(tables, part)
        _assert_bits_equal(k, (t[:m], u[:m], v[:m], prim[:m]))
        assert torch.equal(o, occ[:m])
    off = tmax < tmin
    assert off.sum() > 300 and (prim[off] == -1).all() and (t[off] == brute.BIG).all()
    assert not occ[off].any() and (prim[~off] >= 0).any()


@pytest.mark.cuda
def test_traversal_launches_are_counted_and_checked(room, room_rays):
    import dataclasses

    bvh = room.bvh
    _launch.reset_launches()
    packet.closest(bvh, *room_rays)
    packet.occluded(bvh, *room_rays)
    cluster.closest(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *room_rays)
    cluster.occluded(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *room_rays)
    sweep.closest(bvh.cl_aabb, bvh.tris, room.meta.n_tri, *room_rays)
    sweep.occluded(bvh.cl_aabb, bvh.tris, room.meta.n_tri, *room_rays)
    assert _launch.LAUNCHES == {**dict.fromkeys(_launch.LAUNCHES, 0), "packet_closest": 1,
                               "packet_anyhit": 1, "cluster_closest": 1, "cluster_anyhit": 1,
                               "sweep_closest": 1, "sweep_anyhit": 1}
    deep = dataclasses.replace(bvh, depth=100)  # needs a stack of 100 entries
    _launch.reset_launches()
    with pytest.raises(RuntimeError, match="stack"):
        packet.closest(deep, *room_rays)
    with pytest.raises(ValueError, match="bvh.tris"):
        cluster.closest(bvh.sup_aabb, bvh.cl_aabb, bvh.tris[:, :12], *room_rays)
    with pytest.raises(ValueError, match="cl_aabb"):
        cluster.occluded(bvh.sup_aabb, bvh.cl_aabb[:-8], bvh.tris, *room_rays)
    with pytest.raises(ValueError, match="cl_aabb"):
        cluster.closest(bvh.sup_aabb, bvh.cl_aabb[:, :6], bvh.tris, *room_rays)
    assert not any(_launch.LAUNCHES.values())


def _sweep_equal(cl, tris, n_tri, rays):
    """K6 closest and any hit against sweep_plain on `rays`: equal bit for
    bit (the kernel tests the twin's clusters and rounds its triangle test
    as the twin does)."""
    k = sweep.closest(cl, tris, n_tri, *rays)
    o_k = sweep.occluded(cl, tris, n_tri, *rays)
    p = sweep.sweep_plain(cl, tris, n_tri, *rays)
    o_p = sweep.sweep_plain(cl, tris, n_tri, *rays, any_hit=True)
    torch.cuda.synchronize()
    _assert_bits_equal(k, p)
    assert torch.equal(o_k, o_p)
    return k, o_k


@pytest.mark.cuda
def test_sweep_kernels_match_twin(room, room_rays):
    """K6 closest and any hit on room rays: sweep_plain's answers bit for
    bit, so also within the closest-hit gate; dead lanes miss."""
    args = (room.bvh.cl_aabb, room.bvh.tris, room.meta.n_tri)
    k, o_k = _sweep_equal(*args, room_rays)
    _closest_agree(room, k, sweep.sweep_plain(*args, *room_rays), room_rays)
    assert (o_k == (k[3] >= 0)).all() and not o_k[room_rays[3] <= 0].any()


@pytest.mark.cuda
def test_sweep_kernels_on_captured_batches(room):
    """K6 on the queries a room render launches under FORCE_SWEEP (one pass
    of a 192x108, 1 spp, d6 render: its closest-hit batches, and any hit on
    the pass's any-hit batches): sweep_plain's answers bit for bit."""
    from take_tpu_torch.scene.types import RenderOptions

    calls = capture_queries(torch, with_res(room, 192, 108), RenderOptions(spp=1, max_depth=6, seed=0),
                            sweep_route=True)
    assert [k for k, _ in calls].count("closest") == 8 and [k for k, _ in calls].count("anyhit") == 7
    for _, rays in calls:
        _sweep_equal(room.bvh.cl_aabb, room.bvh.tris, room.meta.n_tri, rays)


@pytest.mark.cuda
def test_sweep_dead_padded_and_tail_lanes_miss(room, room_rays):
    """A batch of 1000 rays (7 full blocks and a tail of 104) whose dead
    lanes (tmax = -3.4e38) and padded lanes (ro = rd = 0, tmax = -1) miss,
    while the live lanes' answers equal a run over the live lanes alone."""
    ro, rd, tmin, tmax = (r[:1000].clone() for r in room_rays)
    tmax[::3] = -3.4e38
    ro[1::7], rd[1::7], tmax[1::7] = 0.0, 0.0, -1.0
    args = (room.bvh.cl_aabb, room.bvh.tris, room.meta.n_tri)
    t, u, v, prim = sweep.closest(*args, ro, rd, tmin, tmax)
    occ = sweep.occluded(*args, ro, rd, tmin, tmax)
    off = tmax < tmin
    assert off.sum() > 300 and (prim[off] == -1).all() and (t[off] == brute.BIG).all()
    assert not occ[off].any()
    on = (~off).nonzero()[:, 0]
    alone = sweep.closest(*args, *(x[on].contiguous() for x in (ro, rd, tmin, tmax)))
    assert torch.equal(alone[3], prim[on]) and torch.equal(alone[0], t[on])
    assert (prim[on] >= 0).any()


@pytest.mark.cuda
def test_sweep_refuses_what_it_cannot_take(room, room_rays):
    """Bad inputs raise; nothing falls back to the twin, and nothing is
    counted as launched. A table of more than 16,384 clusters (room's ten
    times over, 16,640, which the parent kernel's shared-memory list
    refused) is streamed and answered as sweep_plain answers it, bit for
    bit, with hits in the last copy."""
    args = (room.bvh.cl_aabb, room.bvh.tris, room.meta.n_tri)
    _launch.reset_launches()
    with pytest.raises(ValueError, match="ro"):
        sweep.closest(*args, room_rays[0].double(), *room_rays[1:])
    with pytest.raises(ValueError, match="cl_aabb"):
        sweep.occluded(room.bvh.cl_aabb[:, :6], *args[1:], *room_rays)
    with pytest.raises(ValueError, match="aligned"):
        sweep.closest(torch.zeros(args[0].numel() + 1, device="cuda")[1:].view(args[0].shape), *args[1:],
                      *room_rays)
    assert not any(_launch.LAUNCHES.values())
    bvh = room.bvh
    _, cl, tris = tiled_tables(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, 10, (20.0, 0.0, 0.0))
    assert cl.shape[0] == 16640 > 16384
    ro, rd, tmin, tmax = (r[:512].clone() for r in room_rays)
    ro[1::2, 0] += 9 * 20.0  # into the last copy
    k, _ = _sweep_equal(cl, tris, tris.shape[0], (ro, rd, tmin, tmax))
    assert (k[3][1::2] >= 9 * bvh.sup_aabb.shape[0] * 512).sum() > 50


@pytest.mark.cuda
def test_packet_kernels_match_twin_on_captured_batches(room):
    """K3 against packet_plain on the queries a room render launches (one
    pass of a 192x108, 1 spp, d6 render: camera, bounce and shadow rays),
    with the closest-hit gate and occlusion equal except near a boundary."""
    from take_tpu_torch.scene.types import RenderOptions

    calls = capture_queries(torch, with_res(room, 192, 108), RenderOptions(spp=1, max_depth=6, seed=0))
    assert [k for k, _ in calls].count("closest") == 8 and [k for k, _ in calls].count("anyhit") == 7
    for kind, rays in calls:
        if kind == "closest":
            _closest_agree(room, packet.closest(room.bvh, *rays), packet.packet_plain(room.bvh, *rays), rays)
        else:
            o_k = packet.occluded(room.bvh, *rays)
            o_p = packet.packet_plain(room.bvh, *rays, any_hit=True)
            bad = (o_k != o_p).nonzero()[:, 0]
            assert bad.numel() <= max(1, rays[0].shape[0] // 10000)
            assert near_boundary(torch, room.geometry, room.meta.n_tri, *(r[bad] for r in rays), None).all()
            assert not o_k[rays[3] < rays[2]].any()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
def test_packet_deep_chain_traverses_or_raises(card):
    """A chain of nested boxes 32 levels deep (31 stack entries down the
    chain) traverses fully and finds what the twin finds; 33 levels raise
    on the host before the launch."""
    scene = chain_scene(packet._lib().tt_packet_stack_size(), "cuda")
    n = 256
    rng = np.random.default_rng(2)
    down = np.arange(n) < n // 2
    ro = np.column_stack([rng.uniform(0.0, 0.5, n), rng.uniform(0.0, 0.5, n), np.where(down, 40.0, -1.0)])
    rd = np.column_stack([rng.normal(0, 0.005, n), rng.normal(0, 0.005, n), np.where(down, -1.0, 1.0)])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rays = [torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
            for a in (ro, rd, np.full(n, 1e-4), np.full(n, np.inf))]
    k = packet.closest(scene.bvh, *rays)
    occ = packet.occluded(scene.bvh, *rays)
    p = packet.packet_plain(scene.bvh, *rays)
    assert torch.equal(k[3], p[3]) and torch.allclose(k[0], p[0], rtol=1e-6, atol=0)
    assert set(k[3].tolist()) == {0, scene.meta.n_tri - 1} and occ.all()
    too_deep = chain_scene(packet._lib().tt_packet_stack_size() + 1, "cuda")
    _launch.reset_launches()
    with pytest.raises(RuntimeError, match="stack"):
        packet.closest(too_deep.bvh, *rays)
    with pytest.raises(RuntimeError, match="stack"):
        packet.occluded(too_deep.bvh, *rays)
    assert not any(_launch.LAUNCHES.values())


@pytest.mark.cuda
def test_packet_odd_sizes_dead_and_padded_lanes(room, room_rays):
    """n = 0, 1 and 1000 (not a multiple of 32 or of the block): answers
    equal the full batch's; dead lanes (tmax = -3.4e38) and padded lanes
    (ro = rd = 0, tmax = -1) miss in both modes."""
    ro, rd, tmin, tmax = (r[:1000].clone() for r in room_rays)
    tmax[::3] = -3.4e38
    ro[1::7], rd[1::7], tmax[1::7] = 0.0, 0.0, -1.0
    t, u, v, prim = packet.closest(room.bvh, ro, rd, tmin, tmax)
    occ = packet.occluded(room.bvh, ro, rd, tmin, tmax)
    for m in (0, 1):
        part = [x[:m].contiguous() for x in (ro, rd, tmin, tmax)]
        k = packet.closest(room.bvh, *part)
        assert torch.equal(k[3], prim[:m]) and torch.equal(k[0], t[:m])
        assert torch.equal(packet.occluded(room.bvh, *part), occ[:m])
    off = tmax < tmin
    assert off.sum() > 300 and (prim[off] == -1).all() and (t[off] == brute.BIG).all()
    assert not occ[off].any() and (prim[~off] >= 0).any()


def _assert_bits_equal(got, want):
    """K1's tuples (or K2's answers) equal in every bit."""
    if isinstance(got, torch.Tensor):
        assert torch.equal(got, want)
        return
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)


def _brute_pair(g, n_tri, rays):
    """(K1, K2) and the reference kernel's (closest, any hit) on `rays`."""
    k = (brute.closest(g.tri_rows, g.tri_attr, n_tri, *rays), brute.occluded(g.tri_rows, n_tri, *rays))
    ref = (brute.reference(g.tri_rows, g.tri_attr, n_tri, *rays),
           brute.reference(g.tri_rows, g.tri_attr, n_tri, *rays, any_hit=True))
    torch.cuda.synchronize()
    return k, ref


@pytest.mark.cuda
def test_brute_odd_sizes_dead_and_padded_lanes(cbox_rays):
    """n = 0, 1, 1000 and 2^20 + 7 (ragged against every block): K1 and K2
    equal the one-ray-per-thread reference kernel bit for bit; dead lanes
    (tmax = -3.4e38) and padded lanes (ro = rd = 0, tmax = -1) miss, with a
    zero attribute row; a prefix answers as the whole batch does."""
    scene, rays = cbox_rays
    g, n_tri = scene.geometry, scene.meta.n_tri
    big = (1 << 20) + 7
    reps = -(-big // N)
    ro, rd, tmin, tmax = (torch.cat([r] * reps)[:big].clone() for r in rays)
    tmax[::5] = -3.4e38
    ro[3::11], rd[3::11], tmax[3::11] = 0.0, 0.0, -1.0
    (c, o), (c_ref, o_ref) = _brute_pair(g, n_tri, (ro, rd, tmin, tmax))
    _assert_bits_equal(c, c_ref)
    _assert_bits_equal(o, o_ref)
    off = tmax <= 0
    assert (c[5][off] == -1).all() and (c[1][off] == brute.BIG).all() and not c[0][off].any()
    assert not o[off].any() and (c[5][~off] >= 0).any() and o[~off].any()
    for m in (0, 1, 1000):
        part = [x[:m].contiguous() for x in (ro, rd, tmin, tmax)]
        (cm, om), (cm_ref, om_ref) = _brute_pair(g, n_tri, part)
        _assert_bits_equal(cm, cm_ref)
        _assert_bits_equal(om, om_ref)
        _assert_bits_equal(cm, tuple(x[:m] for x in c))
        assert torch.equal(om, o[:m])


@pytest.mark.cuda
def test_brute_tiled_soup(card):
    """A soup of 3000 triangles, swept in tiles of 256 rows: K1 and K2 equal
    the reference kernel bit for bit and agree with the plain twins."""
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    m = b.add_material(0)
    centers = rng.uniform(-10.0, 10.0, (3000, 3))
    for c in centers:
        b.add_mesh(c + rng.uniform(-0.8, 0.8, (3, 3)), np.array([[0, 1, 2]]), m)
    scene = b.build(device="cuda", build_bvh=False)
    g, n_tri = scene.geometry, scene.meta.n_tri
    assert scene.bvh is None and n_tri == 3000
    n = 1 << 14
    ro = rng.uniform(-12.0, 12.0, (n, 3))
    d = rng.normal(size=(n, 3))
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.5, rng.uniform(0.5, 5.0, n), np.inf)
    tmax[rng.random(n) < 0.1] = -3.4e38
    rays = [torch.tensor(a, dtype=torch.float32, device="cuda").contiguous() for a in (ro, rd, np.full(n, 1e-4), tmax)]
    (c, o), (c_ref, o_ref) = _brute_pair(g, n_tri, rays)
    _assert_bits_equal(c, c_ref)
    _assert_bits_equal(o, o_ref)
    p = brute.closest_plain(g.tri_rows, g.tri_attr, n_tri, *rays)
    _closest_agree(scene, (c[1], c[2], c[3], c[5]), (p[1], p[2], p[3], p[5]), rays)
    bad = (o != brute.occluded_plain(g.tri_rows, n_tri, *rays)).nonzero()[:, 0]
    assert bad.numel() <= 2 and near_boundary(torch, g, n_tri, *(r[bad] for r in rays), None).all()
    assert (c[5] >= 1000).any() and (c[5] >= 0).float().mean() > 0.1  # winners beyond the first tiles


@pytest.mark.cuda
def test_bench_soup_check_of_every_route(card):
    """take_tpu_torch/bench.py's kernel check (bench.py:224-300's, with K3's
    and K5's any hit added): on benchmarks/tpu_smoke.py's 3000-triangle soup
    with a BVH and 1024 rays with tmax = +inf, K3, K4 and K6 give
    brute.closest_plain's winner on every ray, and K3, K5 and K6 any hit
    its prim >= 0; each kernel launches once."""
    from take_tpu_torch import bench

    _launch.reset_launches()
    ok, err = bench.kernels_check("cuda")
    assert ok, err
    for kernel in ("packet", "cluster", "sweep"):
        assert _launch.LAUNCHES[f"{kernel}_closest"] == _launch.LAUNCHES[f"{kernel}_anyhit"] == 1
    assert _launch.LAUNCHES["packet_closest_plain"] == _launch.LAUNCHES["closest"] == 0


@pytest.mark.cuda
def test_brute_kernels_equal_reference_on_captured_batches(card):
    """K1 and K2 on the queries a cbox render launches (one pass of a 256x256,
    1 spp, d4 render: camera, bounce and shadow rays) equal the reference
    kernel, the first design's loop, bit for bit."""
    from take_tpu_torch.scene.types import RenderOptions

    scene = with_res(parse_scene_file(CBOX, device="cuda"), 256)
    calls = capture_queries(torch, scene, RenderOptions(spp=1, max_depth=4, seed=0))
    assert [k for k, _ in calls].count("closest") == 6 and [k for k, _ in calls].count("anyhit") == 5
    g, n_tri = scene.geometry, scene.meta.n_tri
    for kind, rays in calls:
        (c, o), (c_ref, o_ref) = _brute_pair(g, n_tri, rays)
        if kind == "closest":
            _assert_bits_equal(c, c_ref)
            assert (c[5] >= 0).any()
        else:
            _assert_bits_equal(o, o_ref)


@pytest.mark.cuda
def test_brute_anyhit_infinite_tmax(cbox_rays):
    """Shadow rays toward an environment map carry tmax = +inf, a range end
    no cbox or mis shadow ray had (K2's upper end is nextafterf(tmax, inf),
    which stays +inf). On cbox's rays with every live tmax = +inf, mixed
    with dead and padded lanes: K1 and K2 equal the reference kernel bit for
    bit, and K2 agrees with the plain twin but near a triangle's boundary."""
    scene, rays = cbox_rays
    g, n_tri = scene.geometry, scene.meta.n_tri
    ro, rd, tmin, tmax = (r.clone() for r in rays)
    tmax = torch.where(tmax > 0, float("inf"), tmax)
    ro[3::11], rd[3::11], tmax[3::11] = 0.0, 0.0, -1.0
    assert torch.isinf(tmax).float().mean() > 0.8
    rays = (ro, rd, tmin, tmax)
    (c, o), (c_ref, o_ref) = _brute_pair(g, n_tri, rays)
    _assert_bits_equal(c, c_ref)
    _assert_bits_equal(o, o_ref)
    bad = (o != brute.occluded_plain(g.tri_rows, n_tri, *rays)).nonzero()[:, 0]
    assert bad.numel() <= N // 10000 and near_boundary(torch, g, n_tri, *(r[bad] for r in rays), None).all()
    live = tmax > 0
    assert o[live].float().mean() > 0.5 and not o[~live].any() and (c[5][live] >= 0).float().mean() > 0.5


@pytest.mark.cuda
def test_brute_kernels_on_ibl_batches(card):
    """ibl's queries (one pass of a 128x128, 1 spp, d6 render with the
    default loop): its shadow rays toward the map have tmax = +inf. K1 and
    K2 equal the reference kernel bit for bit; K2 equals the plain twin but
    for rays near a triangle's boundary."""
    from take_tpu_torch.scene.types import RenderOptions

    scene = with_res(parse_scene_file(os.path.join(SCENES, "ibl", "ibl.xml"), device="cuda"), 128)
    calls = capture_queries(torch, scene, RenderOptions(spp=1, max_depth=6, seed=0))
    g, n_tri = scene.geometry, scene.meta.n_tri
    n_inf = 0
    for kind, rays in calls:
        (c, o), (c_ref, o_ref) = _brute_pair(g, n_tri, rays)
        if kind == "closest":
            _assert_bits_equal(c, c_ref)
        else:
            _assert_bits_equal(o, o_ref)
            n_inf += int(torch.isinf(rays[3]).sum())
            bad = (o != brute.occluded_plain(g.tri_rows, n_tri, *rays)).nonzero()[:, 0]
            assert bad.numel() <= 2 and near_boundary(torch, g, n_tri, *(r[bad] for r in rays), None).all()
    assert n_inf > 1000 and "anyhit" in [k for k, _ in calls]


@pytest.mark.cuda
def test_envmap_on_card_matches_cpu(card):
    """envmap_eval, envmap_pdf and envmap_sample on sky_2k.exr's tables
    (2048x1024), on the card against the CPU, for 2^16 seeded directions
    and uniforms. The card's atan2f, acosf, sinf and cosf differ from the
    CPU's in the last bits, and nvcc contracts the bilinear blend into
    fused multiply-adds, so the rules are those of the JAX comparison
    (tests/test_torch_envmap.py) but for eval, held at 1e-3 relative: near
    the sun (peak 200) an ulp of v moves the blend by up to 6.1e-3. At most
    0.1% of lanes on a neighbouring texel, the pdf within 1e-5 relative
    where the texel agrees, sampled directions within 1e-5 relative / 1e-6
    absolute, their pdfs within 1e-5 relative. Measured on the H100: eval
    within 1.5e-4 relative (81% of lanes bit-equal), texels agreeing on
    99.997% of lanes and the pdf there within 6.5e-6, directions within
    1.2e-7, their pdfs within 1.8e-7."""
    from take_tpu_torch.io.images import imread3
    from take_tpu_torch.lights import envmap as te
    from take_tpu_torch.scene.types import EnvMap

    tables = te.build_envmap(imread3(os.path.join(SCENES, "ibl", "assets", "sky_2k.exr")))
    envs = {dev: EnvMap(**{k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in tables.items()})
            for dev in ("cpu", "cuda")}
    H, W = tables["data"].shape[:2]
    n = 1 << 16
    rng = np.random.default_rng(12)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    u = rng.random((3, n)).astype(np.float32)
    out = {}
    for dev, env in envs.items():
        dd, uu = torch.from_numpy(d).to(dev), [torch.from_numpy(x).to(dev) for x in u]
        uv = te._dir_to_uv(env, dd)
        sd, sp = te.envmap_sample(env, *uu)
        out[dev] = [x.cpu().numpy() for x in (te.envmap_eval(env, dd), te.envmap_pdf(env, dd), *uv, sd, sp)]
    (e_c, p_c, u_c, v_c, sd_c, sp_c), (e_g, p_g, u_g, v_g, sd_g, sp_g) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(e_g, e_c, rtol=1e-3, atol=1e-6)
    same = ((u_c * W).astype(np.int32) == (u_g * W).astype(np.int32)) & (
        (v_c * H).astype(np.int32) == (v_g * H).astype(np.int32))
    assert same.mean() >= 0.999
    np.testing.assert_allclose(p_g[same], p_c[same], rtol=1e-5)
    np.testing.assert_allclose(sd_g, sd_c, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sp_g, sp_c, rtol=1e-5)


@pytest.mark.cuda
def test_k1_function_emission_grad_matches_twin(cbox_rays):
    """K1's autograd Function (`intersect._BruteClosest`) on 2^16 cbox rays:
    the tri_attr gradient through the kernel equals the one through
    closest_plain (the module patched, as chip_smoke patches it), on the
    lanes whose winners agree, within 1e-5 of its scale (the backward's
    index_add_ adds in any order); it lies in the EMIT columns alone."""
    from unittest import mock

    from take_tpu_torch.geometry import intersect
    from take_tpu_torch.scene.types import ATTR_EMIT

    scene, rays = cbox_rays
    g, n_tri = scene.geometry, scene.meta.n_tri
    k = brute.closest(g.tri_rows, g.tri_attr, n_tri, *rays)
    p = brute.closest_plain(g.tri_rows, g.tri_attr, n_tri, *rays)
    w = torch.randn((N, g.tri_attr.shape[1]), generator=torch.Generator("cuda").manual_seed(3), device="cuda")
    w = w * (k[5] == p[5])[:, None]
    grads = []
    for fn in (brute.closest, brute.closest_plain):
        attr = g.tri_attr.clone().requires_grad_(True)
        with mock.patch.object(brute, "closest", fn):
            attrs = intersect._BruteClosest.apply(g.tri_rows, attr, n_tri, *rays)[0]
        (attrs * w).sum().backward()
        grads.append(attr.grad)
    scale = float(grads[1].abs().max())
    assert scale > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-5 * scale)
    others = torch.ones(g.tri_attr.shape[1], dtype=torch.bool, device="cuda")
    others[ATTR_EMIT : ATTR_EMIT + 3] = False
    assert not grads[0][:, others].any()


@pytest.mark.cuda
def test_replay_grads_match_ad_on_card(card):
    """cbox.xml at 32x32 (4 samples a pixel, d4) through K1/K2: every table
    of the replay gradient within 1e-5 * max(|g|, 1) of autograd's."""
    from take_tpu_torch.grad import render_loss_grad
    from take_tpu_torch.scene.types import RenderOptions, float_tables

    scene = with_res(parse_scene_file(CBOX, device="cuda"), 32)
    pix = torch.arange(32 * 32, dtype=torch.int32, device="cuda")
    target = torch.full((32 * 32, 3), 0.2, device="cuda")
    g = {mode: float_tables(render_loss_grad(scene, RenderOptions(spp=1, max_depth=4, grad_mode=mode), pix,
                                             target, 4)[1])
         for mode in ("ad", "replay")}
    assert g["ad"]["materials.attr"].abs().max() > 0
    for key, a in g["ad"].items():
        torch.testing.assert_close(g["replay"][key], a, rtol=0, atol=1e-5 * max(float(a.abs().max()), 1.0), msg=key)


@pytest.mark.cuda
def test_mis_replay_image_equals_mis_on_card(card):
    """integrator "mis_replay" renders cbox.xml at 64x64, 4 spp, d4 through
    K1/K2 to the "mis" image bit for bit."""
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.types import RenderOptions

    scene = with_res(parse_scene_file(CBOX, device="cuda"), 64)
    a = render_image(scene, RenderOptions(spp=4, max_depth=4))
    b = render_image(scene, RenderOptions(spp=4, max_depth=4, integrator="mis_replay"))
    assert np.array_equal(a, b)


@pytest.mark.cuda
def test_sharded_and_resumable_images_on_card(card, tmp_path):
    """cbox.xml at 64x64, 4 spp, d4 (k saturated at spp): the sharded render
    over make_mesh() and over two shards of the card, and a checkpointed
    render stopped after its first checkpoint (1 sample a pass) and resumed,
    each bit for bit render_image's; K1/K2 alone."""
    from take_tpu_torch.parallel.sharding import make_mesh, render_image_sharded
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.types import RenderOptions
    from take_tpu_torch.utils.checkpoint import load_accumulator, render_image_resumable

    scene = with_res(parse_scene_file(CBOX, device="cuda"), 64)
    opts = RenderOptions(spp=4, max_depth=4)
    ref = render_image(scene, opts)
    _launch.reset_launches()
    for mesh in (make_mesh(), ["cuda:0"] * 2):
        assert np.array_equal(render_image_sharded(scene, opts, mesh), ref)
    one = dataclasses.replace(opts, max_rays_per_pass=64 * 64)
    path = str(tmp_path / "c.ckpt")

    class Stop(Exception):
        pass

    def stop(s, spp):
        if s > 2:
            raise Stop

    with pytest.raises(Stop):
        render_image_resumable(scene, one, path, checkpoint_every=2, progress=stop)
    assert load_accumulator(path)[1] == 2
    assert np.array_equal(render_image_resumable(scene, one, path, checkpoint_every=2), render_image(scene, one))
    assert {k for k, v in _launch.LAUNCHES.items() if v} == {"closest", "anyhit"}


@pytest.mark.cuda
def test_banded_grad_matches_monolithic_on_card(card):
    """cbox.xml at 32x32 (4 samples a pixel, d4) through K1/K2: the banded
    gradient at world size 1 (4 bands) and the sharded one over two shards
    of the card against render_loss_grad (tests/test_overlap.py's rtol 2e-4,
    atol 1e-6)."""
    from take_tpu_torch.grad import render_loss_grad
    from take_tpu_torch.parallel.overlap import banded_loss_grad
    from take_tpu_torch.parallel.sharding import sharded_loss_grad
    from take_tpu_torch.scene.types import RenderOptions, float_tables

    scene = with_res(parse_scene_file(CBOX, device="cuda"), 32)
    opts = RenderOptions(spp=1, max_depth=4)
    pix = torch.arange(32 * 32, dtype=torch.int32, device="cuda")
    target = torch.full((32 * 32, 3), 0.2, device="cuda")
    loss, g = render_loss_grad(scene, opts, pix, target, 4)
    assert float_tables(g)["materials.attr"].abs().max() > 0
    for loss_x, g_x in (banded_loss_grad(scene, opts, pix, target, 4, n_samples=4),
                        sharded_loss_grad(scene, opts, pix, target, 4, ["cuda:0"] * 2)):
        torch.testing.assert_close(loss_x, loss, rtol=1e-5, atol=0)
        for key, a in float_tables(g).items():
            torch.testing.assert_close(float_tables(g_x)[key], a, rtol=2e-4, atol=1e-6, msg=key)


@pytest.mark.cuda
def test_run_configs_cbox_meets_its_gates(card, tmp_path, capsys):
    """`python -m take_tpu_torch.run_configs --only cbox` on the card: cbox at
    its published 256x256, 16 spp, d4 through K1/K2, held against take_tpu's
    TPU render benchmarks/out/cbox_256_16spp.exr by run_configs' gates
    (channel means within 1e-4, at most 0.5% of pixels beyond 1e-3 x
    max(pixel, 1e-2)); the EXR lands in the output directory."""
    from take_tpu_torch import run_configs

    _launch.reset_launches()
    assert run_configs.main(["--only", "cbox", "--out", str(tmp_path)]) == 0
    assert {k for k, v in _launch.LAUNCHES.items() if v} == {"closest", "anyhit"}
    assert os.listdir(tmp_path) == ["cbox_256_16spp.exr"]
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("cbox_256_16spp "))
    agreement = json.loads(line.split(" ", 1)[1])["vs_take_tpu"]
    assert agreement["n_pixels"] == 256 * 256 and run_configs.agreement_misses("cbox", agreement) == []


def _graph_and_eager(scene, opts):
    """(graph image, eager image, graph launches, eager launches) of one
    render each, after a warm render of each (the graph's keys captured)."""
    import importlib

    render = importlib.import_module("take_tpu_torch.render")
    out = {}
    for mode in ("graph", "eager"):
        with render.eager() if mode == "eager" else contextlib.nullcontext():
            render.render_image(scene, opts)
            _launch.reset_launches()
            out[mode] = (render.render_image(scene, opts), {k: v for k, v in _launch.LAUNCHES.items() if v})
    return out["graph"][0], out["eager"][0], out["graph"][1], out["eager"][1]


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["raw", "one_sample_mis"])
@pytest.mark.parametrize("name, res", [("cbox", (64, 64)), ("room", (96, 54)), ("ibl", (32, 32))])
def test_graph_passes_equal_eager_on_card(card, request, name, res, integrator):
    """render_image through captured pass graphs equals it op by op
    (render.eager()) bit for bit, over several bands and passes, with the
    same kernel launches a render; cbox and ibl through K1, room through
    K3."""
    from take_tpu_torch.scene.types import RenderOptions

    scene = request.getfixturevalue("room") if name == "room" else parse_scene_file(
        os.path.join(SCENES, name, f"{name}.xml"), device="cuda")
    scene = with_res(scene, *res)
    opts = RenderOptions(spp=3, max_depth=4, seed=1, integrator=integrator, max_rays_per_pass=res[0] * 20)
    img_g, img_e, launches_g, launches_e = _graph_and_eager(scene, opts)
    assert img_g.shape == (res[1], res[0], 3) and np.isfinite(img_g).all() and img_g.mean() > 0
    assert np.array_equal(img_g, img_e)
    assert launches_g == launches_e  # the variants make closest-hit queries only (integrator/variants.py)
    assert set(launches_g) == ({"packet_closest"} if name == "room" else {"closest"})


@pytest.mark.cuda
def test_graph_passes_in_a_list_do_not_alias(card):
    """Each render_pass returns a tensor of its own: passes of one key kept
    in a list keep their values, each equal to its eager pass bit for bit."""
    import importlib

    from take_tpu_torch.scene.types import RenderOptions

    render = importlib.import_module("take_tpu_torch.render")
    scene = with_res(parse_scene_file(CBOX, device="cuda"), 32)
    opts = RenderOptions(spp=8, max_depth=4)
    pix = torch.arange(32 * 32, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        passes = [render.render_pass(scene, opts, pix, s, 32, 2) for s in (0, 2, 4, 6)]
        with render.eager():
            want = [render.render_pass(scene, opts, pix, s, 32, 2) for s in (0, 2, 4, 6)]
    assert len({p.data_ptr() for p in passes}) == 4
    for p, w in zip(passes, want):
        assert torch.equal(p, w)
    assert not torch.equal(passes[0], passes[1])


@pytest.mark.cuda
def test_uncapturable_route_raises_outside_eager(card, room):
    """K3's route patched to packet_plain, which reads counts on the host
    (.nonzero(), int(top.max())): a capture raises, nothing falls back to
    eager; inside render.eager() the same render runs, through the twin."""
    import importlib

    from take_tpu_torch.scene.types import RenderOptions

    render = importlib.import_module("take_tpu_torch.render")
    small = with_res(room, 24, 16)
    opts = RenderOptions(spp=1, max_depth=2)
    plain = (lambda b, *r: packet.packet_plain(b, *r), lambda b, *r: packet.packet_plain(b, *r, any_hit=True))
    with mock.patch.object(packet, "closest", plain[0]), mock.patch.object(packet, "occluded", plain[1]):
        with pytest.raises(RuntimeError):
            render.render_image(small, opts)
        torch.cuda.synchronize()
        _launch.reset_launches()
        with render.eager():
            img = render.render_image(small, opts)
    assert np.isfinite(img).all() and img.mean() > 0
    assert {k for k, v in _launch.LAUNCHES.items() if v} == {"packet_closest_plain", "packet_anyhit_plain"}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ad", "replay"])
@pytest.mark.parametrize("name", ["cbox", "room"])
def test_gradient_is_the_same_from_run_to_run_on_card(card, request, name, mode):
    """Two op-by-op gradients (render.eager()) of cbox.xml at 64x64 (K1's
    backward, the table gathers) and of room at 64x36 (K3's route), 2
    samples a pixel, d4: the same loss bit for bit and every table within
    one float32 rounding of the other. The backward's scatter-adds run on
    atomics in no fixed order; they add in float64 (core.math.gather_rows,
    intersect._BruteClosest), where a float32 sum would differ by ~1e-5 of
    a row."""
    import importlib

    from take_tpu_torch import grad
    from take_tpu_torch.scene.types import RenderOptions, float_tables

    render = importlib.import_module("take_tpu_torch.render")
    if name == "room":
        scene = with_res(request.getfixturevalue("room"), 64, 36)
    else:
        scene = with_res(parse_scene_file(CBOX, device="cuda"), 64)
    n = scene.meta.camera.width * scene.meta.camera.height
    opts = RenderOptions(spp=1, max_depth=4, seed=3, grad_mode=mode)
    pix = torch.arange(n, dtype=torch.int32, device="cuda")
    target = torch.full((n, 3), 0.2, device="cuda")
    with render.eager():
        (loss1, g1), (loss2, g2) = (grad.render_loss_grad(scene, opts, pix, target, 2) for _ in range(2))
    assert torch.equal(loss1, loss2)
    t1, t2 = float_tables(g1), float_tables(g2)
    assert t1["materials.attr"].abs().max() > 0
    for key, x in t1.items():
        torch.testing.assert_close(t2[key], x, rtol=2.0**-23, atol=0.0, msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ad", "replay"])
@pytest.mark.parametrize("name", ["cbox", "room"])
def test_graph_gradient_equals_eager_on_card(card, request, name, mode):
    """render_loss_grad through captured gradient passes (forward and
    backward in one graph a key) against it op by op (render.eager()):
    cbox.xml at 64x64 through K1/K2 and room at 64x36 through K3, 2 samples
    a pixel, d4, in passes of 3/8 of the pixels (two keys). Over 3 steps of
    changed parameters (the first material's reflectance, the light scale,
    as scene/edit.py sets them each Adam step): the loss bit for bit, every
    table within max(2 x its difference between two eager runs, 1e-5 x its
    largest magnitude) of eager's (scatter-adds use atomics), the same
    kernel launches, and no capture after the first call."""
    import importlib

    from take_tpu_torch import _graph, grad
    from take_tpu_torch.scene import edit
    from take_tpu_torch.scene.types import RenderOptions, float_tables

    render = importlib.import_module("take_tpu_torch.render")
    if name == "room":
        scene = with_res(request.getfixturevalue("room"), 64, 36)
    else:
        scene = with_res(parse_scene_file(CBOX, device="cuda"), 64)
    cam = scene.meta.camera
    n = cam.width * cam.height
    opts = RenderOptions(spp=1, max_depth=4, seed=3, grad_mode=mode, max_rays_per_pass=2 * (3 * n // 8))
    pix = torch.arange(n, dtype=torch.int32, device="cuda")
    target = torch.full((n, 3), 0.2, device="cuda")
    want = {"packet_closest", "packet_anyhit"} if name == "room" else {"closest", "anyhit"}

    def run(s, eager):
        with render.eager() if eager else contextlib.nullcontext():
            _launch.reset_launches()
            loss, g = grad.render_loss_grad(s, opts, pix, target, 2)
            torch.cuda.synchronize()
            return loss, float_tables(g), {k: v for k, v in _launch.LAUNCHES.items() if v}

    render.clear_cache()
    run(scene, False)
    graphs = {id(e) for e in _graph.captured()}
    assert len(graphs) == 2
    for step in range(3):
        s = edit.with_material_reflectance(scene, 0, (0.3 + 0.1 * step, 0.5, 0.4))
        s = edit.with_light_intensity_scale(s, 1.0 + 0.25 * step)
        (loss_e, e1, launches_e), (_, e2, _), (loss_g, g, launches_g) = run(s, True), run(s, True), run(s, False)
        assert torch.equal(loss_g, loss_e) and set(launches_g) == want and launches_g == launches_e
        assert e1["materials.attr"].abs().max() > 0
        for key, x in e1.items():
            tol = max(2 * float((e2[key] - x).abs().max()), 1e-5 * float(x.abs().max()))
            assert float((g[key] - x).abs().max()) <= tol, (step, key)
    assert {id(e) for e in _graph.captured()} == graphs
