"""K4/K5's loop (csrc/cluster.cu) on the CPU.

`walk` follows the kernels step by step in torch: blocks of kThreads rays,
the supercluster table in chunks of kChunk rows, a block vote over each
group of kGroup boxes at the range of the group's start, then for each
voted supercluster, in order, the exact re-test at the ray's current range
(cluster_plain's cull), the supercluster's kSupClusters cluster boxes
widened by kBoxRel, the block's (ray, cluster) pair list, kWin rows a pair,
and the merge of each ray's hits into a 64-bit key (order bits of t, row)
by a minimum; K5 stops a ray at the supercluster of its first hit. The
kernels' constants are read from the source. The walk must answer as
`cluster_plain` does bit for bit (the kernels round their triangle test as
the twin does), on room's rays and on edge rays, and its work counters
must equal `cluster.cluster_work`'s, a hand count on a table made by hand,
and the figures counted for room's mix. The kernels themselves are held to
the twin on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from take_tpu_torch.geometry import bvh as bvh_build
from take_tpu_torch.geometry import cluster
from take_tpu_torch.geometry.packet import BIG, affine_test, inv_dir, slab
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.parse_xml import parse_scene_file
from tests.test_torch_cuda import tiled_tables
from tests.torch_parity import one_torch_thread, port_soup  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOM = os.path.join(os.path.dirname(__file__), "..", "scenes", "room", "room.xml")
SOURCE = os.path.join(os.path.dirname(__file__), "..", "take_tpu_torch", "csrc", "cluster.cu")


def _constant(name):
    value = re.search(rf"constexpr (?:int|float) {name} = ([0-9.e+-]+)f?;", open(SOURCE).read()).group(1)
    return float(value) if "." in value else int(value)


THREADS, CHUNK, GROUP = _constant("kThreads"), _constant("kChunk"), _constant("kGroup")
SUPC, WIN, BOX_REL = _constant("kSupClusters"), _constant("kWin"), _constant("kBoxRel")
ROW_BITS = 31  # the walk's key: order bits of t above a 31-bit row (the kernel's: above 32 bits)
NO_KEY = torch.iinfo(torch.int64).max
U32 = 0xFFFFFFFF


def order_bits(t):
    """csrc/cluster.cu's order_bits as int64 in [0, 2^32): unsigned order is
    the float order, -0 reads as +0."""
    u = (t + 0.0).view(torch.int32).to(torch.int64) & U32
    return torch.where(u >= 1 << 31, ~u & U32, u | 1 << 31)


def order_float(b):
    u = torch.where(b >= 1 << 31, b & 0x7FFFFFFF, ~b & U32)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def walk(sup_aabb, cl_aabb, tris, ro, rd, tmin, tmax, any_hit=False):
    """The kernels' loop in torch. Returns (cluster_plain's answer, work
    [N, 4] as cluster_work counts it, pairs: the largest pair list a block
    built for one supercluster)."""
    n, n_sup, n_cl, tpad = ro.shape[0], sup_aabb.shape[0], cl_aabb.shape[0], tris.shape[0]
    m = max(1, -(-n // THREADS)) * THREADS
    blocks = m // THREADS

    def grid(x, fill):  # threads past n hold no ray
        return torch.cat([x, x.new_full((m - n, *x.shape[1:]), fill)])

    ro, rd, tmin, tmax = grid(ro, 0.0), grid(rd, 0.0), grid(tmin, 0.0), grid(tmax, -BIG)
    inv = inv_dir(rd)
    live = tmax >= tmin
    best_t = ro.new_full((m,), BIG)
    key = torch.full((m,), NO_KEY, dtype=torch.int64)
    occ = torch.zeros(m, dtype=torch.bool)
    work = torch.zeros((m, 4), dtype=torch.int64)
    most_pairs = 0
    offs = torch.arange(WIN)
    for ch in range(-(-n_sup // CHUNK)):
        first = ch * CHUNK
        for g in range(0, min(CHUNK, n_sup - first), GROUP):
            # 1. cull: the group's boxes at the range of its start, and the block vote
            pending = live & ~occ
            tcap = tmax if any_hit else torch.minimum(best_t, tmax)
            boxes = sup_aabb[first + g:first + g + GROUP][None].expand(m, GROUP, 8)
            mask, _ = slab(boxes[..., 0:3], boxes[..., 3:6], ro, inv, tmin, tcap)
            mask &= pending[:, None]
            voted = mask.view(blocks, THREADS, GROUP).any(dim=1)  # [blocks, GROUP]
            if any_hit and not pending.any():
                break  # every block has left
            for w in range(GROUP):
                sup = first + g + w
                on = voted[:, w].repeat_interleave(THREADS)
                if not on.any():
                    continue
                work[:, 3] += on
                # 2. pairs: the supercluster at the current range, then its widened clusters
                cap = tmax if any_hit else torch.minimum(best_t, tmax)
                enter = mask[:, w] & ~occ
                if not any_hit:
                    box = sup_aabb[sup].expand(m, 8)
                    again, _ = slab(box[:, None, 0:3], box[:, None, 3:6], ro, inv, tmin, cap)
                    enter &= again[:, 0]
                assert not (enter & ~on).any()  # the vote covers every ray that enters
                c0, c1 = sup * SUPC, min(sup * SUPC + SUPC, n_cl)
                pairs = torch.zeros((m, SUPC), dtype=torch.bool)
                r = enter.nonzero()[:, 0]
                if r.numel() and c1 > c0:
                    cl = cl_aabb[c0:c1]
                    a = ro[r].abs()[:, None]
                    lo = cl[None, :, 0:3] - BOX_REL * (cl[None, :, 0:3].abs() + a)
                    hi = cl[None, :, 3:6] + BOX_REL * (cl[None, :, 3:6].abs() + a)
                    pairs[r, :c1 - c0], _ = slab(lo, hi, ro[r], inv[r], tmin[r], cap[r])
                most_pairs = max(most_pairs, int(pairs.view(blocks, -1).sum(dim=1).max()))
                work[:, 0] += enter
                work[:, 1] += pairs.sum(dim=1)
                # 3. sweep: kWin rows a pair, merged per ray by the least key
                pr, pc = pairs.nonzero().unbind(dim=1)
                if pr.numel() == 0:
                    continue
                row = (c0 + pc)[:, None] * WIN + offs  # [P, WIN]
                valid = row < tpad
                work.index_add_(0, pr, torch.stack([torch.zeros_like(pr), torch.zeros_like(pr),
                                                    valid.sum(dim=1), torch.zeros_like(pr)], dim=1))
                t, _, _, inside = affine_test(tris[row.clamp(max=tpad - 1)], ro[pr][:, None], rd[pr][:, None])
                ok = valid & inside & (t >= tmin[pr, None]) & (t <= tmax[pr, None])
                if any_hit:
                    occ[pr[ok.any(dim=1)]] = True
                    continue
                ok &= t < best_t[pr, None]
                k = torch.where(ok, order_bits(t) << ROW_BITS | row, NO_KEY)
                key.scatter_reduce_(0, pr, k.amin(dim=1), "amin")
                found = key != NO_KEY
                best_t = torch.where(found, order_float(key >> ROW_BITS), best_t)
        else:
            continue
        break  # K5: every block has left
    if any_hit:
        return occ[:n], work[:n], most_pairs
    # 4. the winner's t, u, v from its row
    best = torch.where(key != NO_KEY, key & ((1 << ROW_BITS) - 1), -1)
    hit = (best >= 0) & (best_t <= tmax)
    t, u, v, _ = affine_test(tris[best.clamp(min=0)], ro, rd)
    out = (torch.where(hit, t, BIG), torch.where(hit, u, 0.0), torch.where(hit, v, 0.0),
           torch.where(hit, best, -1).to(torch.int32))
    return tuple(x[:n] for x in out), work[:n], most_pairs


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_walk(tables, rays):
    """The walk against cluster_plain bit for bit and against cluster_work's
    counters, both modes. Returns the closest-hit and any-hit work."""
    sup, cl, tris = tables
    works = []
    for any_hit in (False, True):
        got, work, pairs = walk(sup, cl, tris, *rays, any_hit=any_hit)
        want = cluster.cluster_plain(sup, tris, *rays, any_hit=any_hit)
        if any_hit:
            assert torch.equal(got, want)
        else:
            for a, b in zip(got, want):
                assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(work, cluster.cluster_work(sup, cl, tris, *rays, any_hit=any_hit))
        assert pairs <= THREADS * SUPC
        works.append(work)
    return works


def test_constants_match_the_tables():
    """The kernels' cluster width, supercluster size, group and block are
    the tables' and the wrapper's."""
    assert (SUPC, WIN, GROUP) == (bvh_build.SUP, bvh_build.CLUSTER_K, bvh_build.GROUP)
    assert THREADS == cluster.THREADS and BOX_REL == cluster.BOX_REL == 2.0 ** -16
    assert CHUNK % GROUP == 0 and cluster.SUPT == SUPC * WIN


def test_order_bits_order_floats():
    t = torch.tensor([-BIG, -2.5, -1e-30, -0.0, 0.0, 1e-30, 1e-4, 1.0, 3.0, BIG, float("inf")])
    b = order_bits(t)
    assert (b[1:] >= b[:-1]).all() and b[3] == b[4] and (b < 1 << 32).all()
    assert torch.equal(_bits(order_float(b)), _bits(t + 0.0))


def _slabs(n_tri=1024, step=0.01):
    """Triangle k in the plane x = 1 + k step, spanning y, z in [-1, 3]: a
    cluster of 64 is a slab of x 0.63 thick, a supercluster 5.11 (two valid
    superclusters and six of NaN padding for n_tri = 1024). Returns (sup,
    cl, tris, x of each triangle)."""
    b = SceneBuilder()
    m = b.add_material(0)
    x = 1.0 + step * np.arange(n_tri)
    for xk in x:
        b.add_mesh(np.array([[xk, -1.0, -1.0], [xk, 3.0, -1.0], [xk, -1.0, 3.0]]), np.array([[0, 1, 2]]), m)
    g = b.build(device="cpu", build_bvh=False).geometry
    lo = np.stack([x, np.full(n_tri, -1.0), np.full(n_tri, -1.0)], axis=1).astype(np.float32)
    hi = np.stack([x, np.full(n_tri, 3.0), np.full(n_tri, 3.0)], axis=1).astype(np.float32)
    cl, sup = bvh_build.cluster_aabbs(lo, hi, n_tri)
    return torch.from_numpy(sup), torch.from_numpy(cl), g.tri_rows, x


def _rays(rows):
    """[(o, d, tmin, tmax)] -> float32 tensors."""
    o, d, t0, t1 = zip(*rows)
    return [torch.tensor(np.array(a, dtype=np.float64), dtype=torch.float32).contiguous() for a in (o, d, t0, t1)]


def test_work_counters_match_a_hand_count():
    """On the hand-made slabs: a ray down +x from x = 0 enters supercluster 0
    and its 8 clusters (512 rows) and stops at triangle 0, which culls
    supercluster 1 (voted for at the group's range, dropped by the re-test);
    from x = 20 down -x it enters both superclusters and all 16 clusters
    (1024 rows) and ends at triangle 1023; with tmax = 10 only supercluster 1
    and its clusters 14 and 15 (128 rows); a ray above the slabs, a dead and
    a padded lane enter nothing. The block of six votes for both
    superclusters. K5 stops each ray at its first supercluster with a hit."""
    sup, cl, tris, x = _slabs()
    assert sup.shape[0] == 8 and cl.shape[0] == 16 and torch.isnan(sup[2:]).all()
    rays = _rays([
        ((0.0, 0.2, 0.3), (1.0, 0.0, 0.0), 1e-4, np.inf),
        ((20.0, 0.2, 0.3), (-1.0, 0.0, 0.0), 1e-4, np.inf),
        ((20.0, 0.2, 0.3), (-1.0, 0.0, 0.0), 1e-4, 10.0),
        ((0.0, 10.0, 0.3), (1.0, 0.0, 0.0), 1e-4, np.inf),
        ((0.0, 0.2, 0.3), (1.0, 0.0, 0.0), 1e-4, -BIG),
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0.0, -1.0),
    ])
    closest, anyhit = _assert_walk((sup, cl, tris), rays)
    expect = [[1, 8, 512, 2], [2, 16, 1024, 2], [1, 2, 128, 2], [0, 0, 0, 2], [0, 0, 0, 2], [0, 0, 0, 2]]
    assert closest.tolist() == expect
    assert anyhit.tolist() == [[1, 8, 512, 2], [1, 8, 512, 2], [1, 2, 128, 2], [0, 0, 0, 2], [0, 0, 0, 2],
                               [0, 0, 0, 2]]
    t, _, _, prim = cluster.cluster_plain(sup, tris, *rays)
    assert prim.tolist() == [0, 1023, 1023, -1, -1, -1]
    np.testing.assert_allclose(t[:3].numpy(), [x[0], 20.0 - x[1023], 20.0 - x[1023]], rtol=1e-6)


@pytest.fixture(scope="module")
def room():
    return parse_scene_file(ROOM, device="cpu")


def _mix(room, n, seed=0):
    bvh = room.bvh
    lo = bvh.node_min[0].amin(dim=0).numpy().astype(np.float64)
    hi = bvh.node_max[0].amax(dim=0).numpy().astype(np.float64)
    pad = 0.02 * (hi - lo)
    return chip_smoke.make_rays(torch, room, np.random.default_rng(seed), n, lo + pad, hi - pad)[0]


def test_walk_matches_twin_on_room_mix(room):
    """8,192 rays of chip_smoke's room mix (seed 0; camera, inside the room,
    shadow rays, dead and padded lanes): the walk answers as cluster_plain
    bit for bit. Its work per live ray is the figure counted for the
    redesign: 2.449 superclusters (within 0.01), at most 3.04 clusters
    (2.742) and 195 rows (175.5) a closest-hit query, against the parent
    kernel's 512 rows for each supercluster its block voted for at the
    group's range: 55.375 a block (within 0.5; 53.0 for the union of the
    rays' own culls), 28,352 rows; the any-hit query enters fewer."""
    bvh = room.bvh
    rays = _mix(room, 8192)
    closest, anyhit = _assert_walk((bvh.sup_aabb, bvh.cl_aabb, bvh.tris), rays)
    live = rays[3] >= rays[2]
    assert int(live.sum()) == 7284
    per_ray = closest[live].double().mean(dim=0)
    assert abs(per_ray[0].item() - 2.449) < 0.01
    assert 2.6 < per_ray[1].item() <= 3.04 and per_ray[2].item() <= 195.0
    block_sups = closest[::THREADS, 3].double().mean().item()  # per block, as the parent swept them
    assert abs(block_sups - 55.375) < 0.5
    assert (anyhit[live].double().mean(dim=0)[:3] < per_ray[:3]).all()


def _edge_rays(room, n_each=96, seed=5):
    """Rays on the decision edges of the culls: inside room's cluster boxes
    along each box face (direction in the face's plane, origin on it), from
    box centres, grazing room's axis-aligned walls, aimed at triangle
    vertices (shared by neighbours: exact-t ties), with tmax = +inf, dead
    and padded lanes, and a count that is not a multiple of the block."""
    rng = np.random.default_rng(seed)
    cl = room.bvh.cl_aabb.numpy().astype(np.float64)
    cl = cl[~np.isnan(cl[:, 0])]
    pick = cl[rng.integers(0, cl.shape[0], n_each)]
    lo, hi = pick[:, 0:3], pick[:, 3:6]
    rows = []
    for k in range(n_each):
        axis = k % 3
        o = lo[k] + rng.random(3) * (hi[k] - lo[k])
        o[axis] = (lo[k] if k % 2 else hi[k])[axis]  # on a face
        d = rng.normal(size=3)
        d[axis] = 0.0  # in its plane
        rows.append((o, d / np.linalg.norm(d), 1e-4, np.inf))
        c = 0.5 * (lo[k] + hi[k])
        d = rng.normal(size=3)
        rows.append((c, d / np.linalg.norm(d), 1e-4, np.inf if k % 3 else rng.uniform(0.01, 2.0)))
    g = room.geometry
    v0 = g.tri_v0[:room.meta.n_tri].numpy().astype(np.float64)
    e1 = g.tri_e1[:room.meta.n_tri].numpy().astype(np.float64)
    tri = rng.integers(0, v0.shape[0], n_each)
    eye = chip_smoke.make_rays(torch, room, rng, 1024, lo.min(0), hi.max(0))[0][0][:n_each].numpy()
    for k in range(n_each):
        target = v0[tri[k]] + (e1[tri[k]] if k % 2 else 0.0)
        d = target - eye[k]
        rows.append((eye[k], d / np.linalg.norm(d), 1e-4, np.inf))
    box_lo = room.bvh.node_min[0].amin(dim=0).numpy().astype(np.float64)
    box_hi = room.bvh.node_max[0].amax(dim=0).numpy().astype(np.float64)
    for k in range(n_each):  # grazing a wall of the room's bounds
        axis = k % 3
        o = box_lo + rng.random(3) * (box_hi - box_lo)
        o[axis] = (box_lo if k % 2 else box_hi)[axis] + rng.choice([0.0, 1e-6, -1e-6])
        d = rng.normal(size=3)
        d[axis] = rng.choice([0.0, 1e-7])
        rows.append((o, d / np.linalg.norm(d), 1e-4, np.inf))
    rows += [((0.0, 1.0, 0.0), (0.0, 0.0, 1.0), 1e-4, -BIG)] * 7 + [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0.0, -1.0)] * 5
    return _rays(rows)


def test_walk_matches_twin_on_edge_rays(room, monkeypatch):
    """Room's edge rays (_edge_rays): the walk, whose cluster boxes are
    widened, drops no hit the twin finds, and answers as cluster_plain bit
    for bit; dead and padded lanes miss. Unwidened boxes would drop some
    (7 of these rays): hits on a box face that rounding puts outside it."""
    bvh = room.bvh
    rays = _edge_rays(room)
    assert rays[0].shape[0] % THREADS
    _assert_walk((bvh.sup_aabb, bvh.cl_aabb, bvh.tris), rays)
    t, _, _, prim = cluster.cluster_plain(bvh.sup_aabb, bvh.tris, *rays)
    off = rays[3] < rays[2]
    assert (prim[off] == -1).all() and (t[off] == BIG).all() and (prim[~off] >= 0).float().mean() > 0.8
    monkeypatch.setattr(sys.modules[__name__], "BOX_REL", 0.0)
    assert (walk(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *rays)[0][3] != prim).sum() > 0


def test_walk_streams_many_chunks():
    """A 700-triangle soup's tables tiled 40 times along x (320
    superclusters, more than one chunk of kChunk): rays through every copy,
    from inside them and from past the last, dead and padded lanes; the walk
    answers as cluster_plain bit for bit, with hits in the later chunks."""
    soup = port_soup(700, build_bvh=True)
    tables = tiled_tables(soup.bvh.sup_aabb, soup.bvh.cl_aabb, soup.bvh.tris, 40, (30.0, 0.0, 0.0))
    assert tables[0].shape[0] == 320 > CHUNK and tables[1].shape[0] == 320 * SUPC
    rng = np.random.default_rng(11)
    n = 700
    o = np.stack([rng.uniform(-12.0, 40 * 30.0, n), rng.uniform(-12.0, 12.0, n), rng.uniform(-12.0, 12.0, n)], 1)
    d = rng.normal(size=(n, 3)) * np.array([4.0, 1.0, 1.0])
    tmax = np.where(rng.random(n) < 0.3, rng.uniform(1.0, 60.0, n), np.inf)
    tmax[::9] = -BIG
    o[1::13], d[1::13], tmax[1::13] = 0.0, 0.0, -1.0
    rays = _rays(zip(o, d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30), np.full(n, 1e-4), tmax))
    _assert_walk(tables, rays)
    prim = cluster.cluster_plain(tables[0], tables[2], *rays)[3]
    assert (prim >= CHUNK * cluster.SUPT).any()  # winners in the second chunk


def test_wrapper_refuses_what_the_kernels_do_not_take():
    """The launch checks run on any device: a cluster table that does not
    make sup_aabb's superclusters, a row table of the wrong width, and a
    table that does not start 16-byte aligned raise."""
    sup, cl, tris, _ = _slabs(n_tri=100)
    rays = _rays([((0.0, 0.2, 0.3), (1.0, 0.0, 0.0), 1e-4, np.inf)])
    assert cluster._check(sup, cl, tris, *rays) == (1, 8, 8, tris.shape[0])
    with pytest.raises(ValueError, match="cl_aabb"):
        cluster._check(sup, cl[:4], tris, *rays)
    with pytest.raises(ValueError, match="cl_aabb"):
        cluster._check(sup, torch.cat([cl] * 9), tris, *rays)
    with pytest.raises(ValueError, match="cover"):  # rows of bvh.tris past the last cluster
        cluster._check(sup, cl, torch.zeros((cl.shape[0] * WIN + 128, 24)), *rays)
    with pytest.raises(ValueError, match="bvh.tris"):
        cluster._check(sup, cl, tris[:, :12], *rays)
    with pytest.raises(ValueError, match="aligned"):
        cluster._check(sup, cl, torch.zeros(tris.numel() + 1)[1:].view(tris.shape), *rays)
