"""K6's loop (csrc/sweep.cu) on the CPU.

`walk` follows the kernel step by step in torch: blocks of kThreads rays,
the cluster box table in chunks of kChunk boxes, the union box of each
kGroup boxes of a chunk tested first, then, box by box for every thread of
a block, a (ray, cluster) pair for each box of an entered group that passes
(a) the twin's slab test at [tmin, tmax] and, closest hit, (b) the box
widened by kBoxRel at [tmin, min(best t, tmax)], best t as of the block's
last sweep;
the block's list of kPairs pairs, swept where it fills (the block resumes
at the box where it filled) and at each chunk's end, kWin rows a pair; the
merge of each ray's hits into a 64-bit key (order bits of t, prim) by a
minimum; any hit stops a ray at the sweep that answers it. The kernel's
constants are read from the source. The walk must answer as `sweep_plain`
does bit for bit (the kernel rounds its triangle test as the twin does),
on room's rays, on edge rays, on a table of several chunks and on one of
more than 16,384 clusters, and its work counters must equal
`sweep.sweep_work`'s, a hand count on a table made by hand, and the
figures counted for room's mix. The walk on edge rays and with lists
that fill lives in test_torch_sweep_walk.py and test_torch_sweep_walk_fill.py,
so that the test suite's workers run them beside this file. The kernel
itself is held to the twin on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from take_tpu_torch.geometry import sweep
from take_tpu_torch.geometry.bvh import CLUSTER_K
from take_tpu_torch.geometry.packet import BIG, affine_test, inv_dir, slab
from tests.test_torch_cluster_layout import _edge_rays, _mix, _rays, _slabs, room  # noqa: F401 (fixture)
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SOURCE = os.path.join(os.path.dirname(__file__), "..", "take_tpu_torch", "csrc", "sweep.cu")


def _constant(name):
    value = re.search(rf"constexpr (?:int|float) {name} = ([0-9.e+-]+)f?;", open(SOURCE).read()).group(1)
    return float(value) if "." in value else int(value)


THREADS, CHUNK, PAIRS = _constant("kThreads"), _constant("kChunk"), _constant("kPairs")
GROUP, WIN, BOX_REL = _constant("kGroup"), _constant("kWin"), _constant("kBoxRel")
NO_KEY = torch.iinfo(torch.int64).max


def walk(cl_aabb, tris, n_tri, ro, rd, tmin, tmax, any_hit=False):
    """The kernel's loop in torch. Returns (sweep_plain's answer, work
    [N, 4] as sweep_work counts it, the most pairs a block listed)."""
    n, n_rows = ro.shape[0], min(n_tri, tris.shape[0])
    n_walk = min(cl_aabb.shape[0], -(-n_rows // WIN))
    m = max(1, -(-n // THREADS)) * THREADS
    blocks = m // THREADS

    def grid(x, fill):  # threads past n hold no ray
        return torch.cat([x, x.new_full((m - n, *x.shape[1:]), fill)])

    ro, rd, tmin, tmax = grid(ro, 0.0), grid(rd, 0.0), grid(tmin, 0.0), grid(tmax, -BIG)
    inv = inv_dir(rd)
    live = tmax >= tmin
    key = torch.full((m,), NO_KEY, dtype=torch.int64)  # order bits of t << 31 | prim, as of the last sweep
    occ = torch.zeros(m, dtype=torch.bool)
    work = torch.zeros((m, 4), dtype=torch.int64)
    most = 0
    offs = torch.arange(WIN)
    block_of = torch.arange(m) // THREADS

    def best_t():
        return torch.where(key != NO_KEY, sweep.order_float(key >> 31), BIG)

    def rows_of(c):
        return min(WIN, n_rows - c * WIN)

    def sweep_blocks(listed, first, which):
        """Sweep the lists of the blocks `which` ([blocks] bool): pairs
        listed [m, chunk] of those blocks, kWin rows each."""
        nonlocal key
        mine = listed & which[block_of][:, None]
        pr, pc = mine.nonzero().unbind(dim=1)
        listed &= ~mine
        if pr.numel() == 0:
            return
        row = (first + pc)[:, None] * WIN + offs
        valid = row < n_rows
        t, _, _, inside = affine_test(tris[row.clamp(max=tris.shape[0] - 1)], ro[pr][:, None], rd[pr][:, None])
        ok = valid & inside & (t >= tmin[pr, None]) & (t <= tmax[pr, None])
        if any_hit:
            occ[pr[ok.any(dim=1)]] = True
            return
        k = torch.where(ok, sweep.order_bits(t) << 31 | row, NO_KEY)  # per row, then the pair's least
        key.scatter_reduce_(0, pr, k.amin(dim=1), "amin")

    for first in range(0, n_walk, CHUNK):
        last = min(first + CHUNK, n_walk)
        boxes = cl_aabb[first:last]
        a_all = slab(boxes[None, :, 0:3].expand(m, -1, 3), boxes[None, :, 3:6].expand(m, -1, 3),
                     ro, inv, tmin, tmax)[0]
        union = (a_all & live[:, None]).view(blocks, THREADS, -1).any(dim=1)
        rows = torch.tensor([rows_of(c) for c in range(first, last)])
        work[:, 3] += (union * rows).sum(dim=1)[block_of] * live
        listed = torch.zeros((m, last - first), dtype=torch.bool)
        count = torch.zeros(blocks, dtype=torch.int64)
        groups = sweep.group_boxes(boxes)  # the union of each GROUP boxes: the walk's first test

        def group_pass():
            cap = tmax if any_hit else torch.minimum(best_t(), tmax)
            return sweep.group_hit(groups, ro, inv, tmin, tmax, cap, any_hit)

        entered = group_pass()  # [m, groups] at each ray's range as of its block's last sweep
        fresh = torch.zeros(m, dtype=torch.bool)  # tests its group box at the next box it takes
        for c in range(first, last):
            j = c - first
            todo = live & ~occ  # the threads that take box c
            fresh |= j % GROUP == 0
            if not (todo & a_all[:, j] & entered[:, j // GROUP]).any():  # no pair: each thread walks on
                work[:, 0] += todo & fresh
                work[:, 0] += todo & entered[:, j // GROUP]
                fresh &= ~todo
                continue
            while todo.any():
                cap = tmax if any_hit else torch.minimum(best_t(), tmax)
                inside = entered[:, j // GROUP]
                pair = todo & inside & a_all[:, j]
                if not any_hit:
                    wide = sweep._widened_hit(boxes[j:j + 1], ro, inv, tmin, cap)[:, 0]
                    pair &= wide
                # append in thread order; where a block's list fills, the threads from the first left out on
                # take box c again after the block's sweep
                pos = count[block_of] + (pair.view(blocks, THREADS).cumsum(dim=1).view(-1))
                fits = pair & (pos <= PAIRS)
                out = pair & ~fits
                cut = torch.where(out, torch.arange(m) % THREADS, THREADS).view(blocks, THREADS).amin(dim=1)
                before = (torch.arange(m) % THREADS) < cut[block_of]
                work[:, 0] += todo & before & fresh  # its group box
                work[:, 0] += todo & before & inside  # box c
                fresh &= ~(todo & before)
                listed[:, j] |= fits
                work[:, 1] += fits
                work[:, 2] += fits * rows_of(c)
                count += fits.view(blocks, THREADS).sum(dim=1)
                most = max(most, int(count.max()))
                full = cut < THREADS
                if not full.any():
                    break
                sweep_blocks(listed, first, full)
                count[full] = 0
                entered = group_pass()
                fresh |= full[block_of]  # each thread of the block takes its group box again
                todo = todo & ~before & live & ~occ
        sweep_blocks(listed, first, torch.ones(blocks, dtype=torch.bool))
        if any_hit and not (live & ~occ).any():
            break
    if any_hit:
        return occ[:n], work[:n], most
    best = torch.where(key != NO_KEY, key & ((1 << 31) - 1), -1)
    hit = best >= 0
    t, u, v, _ = affine_test(tris[best.clamp(min=0)], ro, rd)
    out = (torch.where(hit, t, BIG), torch.where(hit, u, 0.0), torch.where(hit, v, 0.0),
           torch.where(hit, best, -1).to(torch.int32))
    return tuple(x[:n] for x in out), work[:n], most


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_walk(cl, tris, n_tri, rays):
    """The walk against sweep_plain bit for bit and against sweep_work's
    counters, both modes. Returns the closest-hit and any-hit work and the
    twin's closest-hit answer."""
    works = []
    for any_hit in (False, True):
        got, work, most = walk(cl, tris, n_tri, *rays, any_hit=any_hit)
        want = sweep.sweep_plain(cl, tris, n_tri, *rays, any_hit=any_hit)
        if any_hit:
            assert torch.equal(got, want)
        else:
            for a, b in zip(got, want):
                assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(work, sweep.sweep_work(cl, tris, n_tri, *rays, any_hit=any_hit))
        assert most <= PAIRS
        works.append(work)
        if not any_hit:
            answer = want
    return (*works, answer)


def test_constants_match_the_wrapper():
    """The kernel's block, chunk, list, cluster width and widening are the
    wrapper's and the tables'."""
    assert (THREADS, CHUNK, PAIRS, BOX_REL) == (sweep.THREADS, sweep.BOXES, sweep.PAIRS, sweep.BOX_REL)
    assert WIN == CLUSTER_K and BOX_REL == 2.0 ** -16 and PAIRS >= THREADS


def test_order_bits_order_floats():
    t = torch.tensor([-BIG, -2.5, -1e-30, -0.0, 0.0, 1e-30, 1e-4, 1.0, 3.0, BIG, float("inf")])
    b = sweep.order_bits(t)
    assert (b[1:] >= b[:-1]).all() and b[3] == b[4] and (b < 1 << 32).all()
    assert torch.equal(_bits(sweep.order_float(b)), _bits(t + 0.0))


def _hand_rays():
    """Six rays across the hand-made slabs of tests/test_torch_cluster_layout
    (triangle k in the plane x = 1 + 0.01 k; cluster c spans x 1 + 0.64 c
    .. 1.63 + 0.64 c)."""
    return _rays([
        ((0.0, 0.2, 0.3), (1.0, 0.0, 0.0), 1e-4, np.inf),
        ((20.0, 0.2, 0.3), (-1.0, 0.0, 0.0), 1e-4, np.inf),
        ((20.0, 0.2, 0.3), (-1.0, 0.0, 0.0), 1e-4, 10.0),
        ((0.0, 10.0, 0.3), (1.0, 0.0, 0.0), 1e-4, np.inf),
        ((0.0, 0.2, 0.3), (1.0, 0.0, 0.0), 1e-4, -BIG),
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0.0, -1.0),
    ])


def test_work_counters_match_a_hand_count(monkeypatch):
    """On 1,024 hand-made slabs (16 clusters, one chunk, one group box
    spanning x 1 .. 11.23, y and z -1 .. 3): with the list never full, the
    block sweeps once, at the chunk's end, so no range shrinks while it
    walks. A ray down +x from x = 0 and one down -x from x = 20 test the
    group box and its 16 boxes and enter all 16 clusters (1,024 rows; they
    end at triangles 0 and 1023); with tmax = 10, only clusters 14 and 15
    (their far faces at x 10.59 and 11.23); a ray above the slabs misses
    the group box and tests nothing else; dead and padded lanes count
    nothing. The parent's block-wide cull left each live ray the union, 16
    clusters. With a list of 8, the +x ray lists clusters 0-7, the block
    sweeps where the list fills, at cluster 8, and the ray takes its group
    box and boxes 8-15 again, but the hit at t = 1 culls them: 18 boxes, 8
    clusters; the -x ray's hits (t >= 16.45) cull none: 16 clusters; any
    hit stops the +x ray at that sweep, after 9 boxes."""
    _, cl, tris, x = _slabs()
    cl = cl[:16]
    rays = _hand_rays()
    closest, anyhit, (t, _, _, prim) = _assert_walk(cl, tris, 1024, rays)
    expect = [[17, 16, 1024, 1024], [17, 16, 1024, 1024], [17, 2, 128, 1024], [1, 0, 0, 1024],
              [0, 0, 0, 0], [0, 0, 0, 0]]
    assert closest.tolist() == expect and anyhit.tolist() == expect
    assert prim.tolist() == [0, 1023, 1023, -1, -1, -1]
    np.testing.assert_allclose(t[:3].numpy(), [x[0], 20.0 - x[1023], 20.0 - x[1023]], rtol=1e-6)
    monkeypatch.setattr(sys.modules[__name__], "PAIRS", 8)
    monkeypatch.setattr(sweep, "PAIRS", 8)
    two = [r[:2] for r in rays]
    closest, anyhit, _ = _assert_walk(cl, tris, 1024, [r[:1] for r in rays])
    assert closest.tolist() == [[18, 8, 512, 1024]] and anyhit.tolist() == [[9, 8, 512, 1024]]
    closest, _, _ = _assert_walk(cl, tris, 1024, [r[1:2] for r in rays])
    assert closest.tolist() == [[18, 16, 1024, 1024]]
    _assert_walk(cl, tris, 1024, two)


def test_walk_matches_twin_on_room_mix(room):  # noqa: F811
    """8,192 rays of chip_smoke's room mix (seed 0; camera, inside the room,
    shadow rays, dead and padded lanes; 1,657 boxes, 7 chunks): the walk
    answers as sweep_plain bit for bit. Its work per live ray is the figure
    counted for the redesign: 142.0 boxes walked (104 group boxes and the
    members of the groups entered, of 1,657 cluster boxes), 2.931 clusters
    entered (within 0.01; the twin's own cull passes 3.04) and 175.9 rows,
    against 7,589 rows of the parent kernel's block-wide cull (within 1%);
    the any-hit query walks and enters less."""
    bvh = room.bvh
    rays = _mix(room, 8192)
    closest, anyhit, _ = _assert_walk(bvh.cl_aabb, bvh.tris, room.meta.n_tri, rays)
    live = rays[3] >= rays[2]
    assert int(live.sum()) == 7284
    per_ray = closest[live].double().mean(dim=0)
    assert abs(per_ray[0].item() - 142.0) < 0.1 and abs(per_ray[1].item() - 2.931) < 0.01
    assert abs(per_ray[2].item() - 175.9) < 1.0 and abs(per_ray[3].item() / 7589 - 1) < 0.01
    assert (anyhit[live].double().mean(dim=0)[:3] < per_ray[:3]).all()


@pytest.mark.parametrize("which", ["edge", "mix"])
def test_widened_cull_keeps_every_winner(room, which):  # noqa: F811
    """Why (b) widens the boxes: the cull caps a ray's range at its best t
    so far, which is never below the answer t*, so it keeps the winner's
    cluster when the widened box is entered at [tmin, t*]. It is for every
    winner of room's edge rays and of its mix; the unwidened box is not for
    some (3 of 321 edge hits, 66 of 5,288 mix hits: the triangle lies on
    its box's face and its t rounds below the box's entry distance), which
    a capped cull without the widening could drop."""
    bvh = room.bvh
    rays = _edge_rays(room) if which == "edge" else _mix(room, 8192)
    t, _, _, prim = sweep.sweep_plain(bvh.cl_aabb, bvh.tris, room.meta.n_tri, *rays)
    hit = prim >= 0
    ro, rd, tmin, _ = (r[hit] for r in rays)
    box = bvh.cl_aabb[(prim[hit] // WIN).long()]
    inv = inv_dir(rd)
    plain = slab(box[:, None, 0:3], box[:, None, 3:6], ro, inv, tmin, t[hit])[0][:, 0]
    wide = torch.stack([sweep._widened_hit(box[k:k + 1], ro[k:k + 1], inv[k:k + 1], tmin[k:k + 1], t[hit][k:k + 1])[0, 0]
                        for k in range(box.shape[0])])
    assert wide.all()
    assert int((~plain).sum()) == {"edge": 3, "mix": 66}[which]


def test_group_boxes_hold_their_members(room):  # noqa: F811
    """The walk's group boxes: each holds its kGroup members (a partial last
    group its own), NaN boxes are skipped and a group of them is NaN; on
    room's mix, a ray enters the group box of every box it enters, at
    [tmin, tmax] (any hit) and widened at [tmin, t*] (closest hit), so
    testing members only inside entered groups drops no pair."""
    cl = room.bvh.cl_aabb
    n = -(-room.meta.n_tri // WIN)
    groups = sweep.group_boxes(cl[:n])
    assert groups.shape[0] == -(-n // GROUP) == 104
    member_group = torch.arange(n) // GROUP
    assert (groups[member_group, 0:3] <= cl[:n, 0:3]).all() and (groups[member_group, 3:6] >= cl[:n, 3:6]).all()
    nan = torch.full((GROUP + 3, 8), float("nan"))
    nan[GROUP + 1] = cl[0]
    assert torch.isnan(sweep.group_boxes(nan)[0, :6]).all() and torch.equal(sweep.group_boxes(nan)[1, :6], cl[0, :6])
    ro, rd, tmin, tmax = _mix(room, 2048)
    inv = inv_dir(rd)
    t = sweep.sweep_plain(cl, room.bvh.tris, room.meta.n_tri, ro, rd, tmin, tmax)[0]
    cap = torch.minimum(t, tmax)
    boxes = cl[:n][None].expand(ro.shape[0], n, 8)
    member_a = slab(boxes[..., 0:3], boxes[..., 3:6], ro, inv, tmin, tmax)[0]
    assert (member_a <= sweep.group_hit(groups, ro, inv, tmin, tmax, cap, True)[:, member_group]).all()
    member_b = sweep._widened_hit(cl[:n], ro, inv, tmin, cap)
    assert (member_b <= sweep.group_hit(groups, ro, inv, tmin, tmax, cap, False)[:, member_group]).all()
    assert member_a.any(dim=1).float().mean() > 0.5


def _tiled(cl, tris, copies, shift):
    """`copies` copies of one cluster's box and rows, the k-th moved by
    k shift (the rows' constant terms move with the triangles)."""
    s = torch.arange(copies, dtype=torch.float32)[:, None] * torch.tensor(shift, dtype=torch.float32)
    boxes = cl[None].expand(copies, 8).clone()
    boxes[:, 0:3] += s
    boxes[:, 3:6] += s
    rows = tris[None].expand(copies, *tris.shape).clone()
    for j in range(3):  # o_j' = o_j - row_j . s: the map of the moved triangle
        rows[:, :, 4 * j + 3] -= (rows[:, :, 4 * j:4 * j + 3] * s[:, None]).sum(dim=2)
    return boxes.contiguous(), rows.reshape(-1, 24).contiguous()


def _soup_rays(n, span, seed):
    """Rays through a slab soup spanning x in [0, span]: down the slabs
    from before, inside and past them, a third with a finite tmax, dead
    and padded lanes."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-2.0, span + 2.0, n), rng.uniform(-0.8, 1.0, n), rng.uniform(-0.8, 1.0, n)], 1)
    d = rng.normal(size=(n, 3)) * np.array([4.0, 0.2, 0.2])
    tmax = np.where(rng.random(n) < 0.3, rng.uniform(0.5, 40.0, n), np.inf)
    tmax[::9] = -BIG
    o[1::13], d[1::13], tmax[1::13] = 0.0, 0.0, -1.0
    return _rays(zip(o, d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30), np.full(n, 1e-4), tmax))


def test_walk_streams_many_chunks():
    """One hand-made cluster of 64 slabs tiled 1,000 times along x (a slab
    every 0.01 up to x = 1.63, a cluster every 1.0: 4 chunks of the
    kernel): the walk answers as sweep_plain bit for bit, with winners in
    the last chunk."""
    _, cl, tris, _ = _slabs(n_tri=64)
    boxes, rows = _tiled(cl[0], tris[:WIN], 1000, (1.0, 0.0, 0.0))
    rays = _soup_rays(300, 1000.0, seed=11)
    prim = _assert_walk(boxes, rows, rows.shape[0], rays)[2][3]
    assert (prim >= 3 * CHUNK * WIN).any() and (prim >= 0).float().mean() > 0.3


def test_walk_takes_more_than_16384_clusters():
    """The same cluster tiled 16,400 times (the parent kernel's shared-memory
    list held 16,384 clusters and refused more): few rays, from before the
    soup, inside it and past its end, some down its whole length; the walk
    answers as sweep_plain bit for bit, with hits past cluster 16,384."""
    _, cl, tris, _ = _slabs(n_tri=64)
    boxes, rows = _tiled(cl[0], tris[:WIN], 16400, (1.0, 0.0, 0.0))
    assert boxes.shape[0] > 16384
    rays = _soup_rays(64, 16400.0, seed=12)
    rays[0][:4] = torch.tensor([[-1.0, 0.2, 0.3], [16410.0, 0.2, 0.3], [16390.5, 0.2, 0.3], [8000.5, 0.2, 0.3]])
    rays[1][:4] = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    rays[3][:4] = float("inf")
    prim = _assert_walk(boxes, rows, rows.shape[0], rays)[2][3]
    assert prim[0] == 0 and prim[1] == 16400 * WIN - 1 and (prim >= 16384 * WIN).sum() >= 2


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The launch checks run on any device: a box table of the wrong width,
    a row table of the wrong width, n_tri past either table, and a table
    that does not start 16-byte aligned raise."""
    _, cl, tris, _ = _slabs(n_tri=100)
    rays = _hand_rays()
    assert sweep._check(cl, tris, 100, *rays) == (6, cl.shape[0], tris.shape[0])
    with pytest.raises(ValueError, match="cl_aabb"):
        sweep._check(cl[:, :6], tris, 100, *rays)
    with pytest.raises(ValueError, match="bvh.tris"):
        sweep._check(cl, tris[:, :12], 100, *rays)
    with pytest.raises(ValueError, match="n_tri"):
        sweep._check(cl, tris, tris.shape[0] + 1, *rays)
    with pytest.raises(ValueError, match="n_tri"):
        sweep._check(cl[:1], tris, 100, *rays)
    with pytest.raises(ValueError, match="aligned"):
        sweep._check(cl, torch.zeros(tris.numel() + 1)[1:].view(tris.shape), 100, *rays)
