"""Tree-free cluster cull and sweep: the CUDA kernel K6 (closest and any hit)
and its plain twin.

`closest` and `occluded` replace the JAX package's Pallas sweep kernel
(take_tpu/geometry/pallas_sweep.py::_sweep_kernel, entry `sweep_traverse`,
static `any_hit`); the CUDA source and its design note are in
csrc/sweep.cu. Both read `bvh.cl_aabb` (the box of each run of CLUSTER_K =
64 BVH-ordered triangles, NaN-padded) and `bvh.tris` (the packet kernel's
row layout, geometry/packet.py::prep_tables), tables the scene already
keeps on the card.

Dispatch is by the device of the rays: a CUDA tensor launches the kernel
(and raises if it cannot), a CPU tensor runs the plain twin
(`sweep_plain`): every cluster box is slab-tested at [tmin, tmax] for every
live ray, and each cluster's 64 rows are tested for the rays whose box test
passed; a ray keeps the least (t, prim) over them, or with any_hit ORs.
That is the kernel's answer whatever order it sweeps the clusters in, and
is exactly independent of the order here. The kernel culls per ray (group
boxes of GROUP clusters it builds itself, then the clusters, the closest
hit's range capped at its best hit) and sweeps the surviving (ray,
cluster) pairs with the whole block; `sweep_work` counts that work per
ray. `_launch.LAUNCHES` counts what ran.
"""

import ctypes

import torch

from take_tpu_torch.geometry import _launch
from take_tpu_torch.geometry.bvh import CLUSTER_K
from take_tpu_torch.geometry.packet import BIG, affine_test, inv_dir, slab

CHUNK = 1 << 16  # rays per batch of the plain twin (bounds its temporaries)
THREADS = 128  # rays per block of K6 (csrc/sweep.cu kThreads)
BOXES = 256  # cluster boxes per staged chunk (kChunk)
PAIRS = 256  # (ray, cluster) pairs a block's list holds (kPairs)
GROUP = 16  # cluster boxes under one group box of the walk (kGroup)
BOX_REL = 2.0 ** -16  # the cull (b) widens each box by this share of |coordinate| + |origin| (kBoxRel)
_IMAX = torch.iinfo(torch.int64).max

# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------


def sweep_plain(cl_aabb, tris, n_tri, ro, rd, tmin, tmax, any_hit=False):
    """Plain twin of K6: (t, u, v, prim [int32]) of each ray, or with
    any_hit its occlusion [bool]."""
    _launch.LAUNCHES["sweep_anyhit_plain" if any_hit else "sweep_closest_plain"] += 1
    n, dev = ro.shape[0], ro.device
    inv = inv_dir(rd)
    live = tmax >= tmin
    best_t = ro.new_full((n,), BIG)
    best_u = ro.new_zeros(n)
    best_v = ro.new_zeros(n)
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in range(cl_aabb.shape[0]):
        start = c * CLUSTER_K
        stop = min(start + CLUSTER_K, n_tri)
        if stop <= start:
            break  # clusters past n_tri are padding
        box = cl_aabb[c].expand(n, 8)
        hit, _ = slab(box[:, None, 0:3], box[:, None, 3:6], ro, inv, tmin, tmax)
        rays = (hit[:, 0] & live).nonzero()[:, 0]
        rows = tris[start:stop]
        prim = torch.arange(start, stop, device=dev)
        for r in rays.split(CHUNK):
            t, u, v, inside = affine_test(rows, ro[r][:, None], rd[r][:, None])
            ok = inside & (t >= tmin[r, None]) & (t <= tmax[r, None])
            if any_hit:
                occ[r] |= ok.any(dim=1)
                continue
            tm = torch.where(ok, t, BIG)
            t_new = tm.amin(dim=1)
            win = ok & (tm == t_new[:, None])
            p_new = torch.where(win, prim, _IMAX).amin(dim=1)
            pick = (p_new - start)[:, None].clamp(max=stop - start - 1)
            bt, bp = best_t[r], best_p[r]
            better = win.any(dim=1) & ((t_new < bt) | ((t_new == bt) & (p_new < bp)))
            best_t[r] = torch.where(better, t_new, bt)
            best_u[r] = torch.where(better, u.gather(1, pick)[:, 0], best_u[r])
            best_v[r] = torch.where(better, v.gather(1, pick)[:, 0], best_v[r])
            best_p[r] = torch.where(better, p_new, bp)
    if any_hit:
        return occ
    ok = best_t <= tmax
    return (torch.where(ok, best_t, BIG), best_u, best_v,
            torch.where(ok, best_p, -1).to(torch.int32))


# ---------------------------------------------------------------------------
# Work counters
# ---------------------------------------------------------------------------


def order_bits(t):
    """csrc/sweep.cu's order_bits as int64 in [0, 2^32): the unsigned order
    is the float order, -0 reads as +0."""
    u = (t + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | 1 << 31)


def order_float(b):
    """The float whose order_bits is b."""
    u = torch.where(b >= 1 << 31, b & 0x7FFFFFFF, ~b & 0xFFFFFFFF)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def _widened_hit(box, ro, inv, tmin, tcap):
    """The cull (b): boxes [K, 8] widened by BOX_REL (|coordinate| +
    |origin|), slab-tested at [tmin, tcap] for rays [A] -> [A, K]. BOX_REL is
    a power of two, so the kernel's contraction of the product into the
    subtraction rounds the same."""
    a = ro.abs()[:, None]
    lo, hi = box[None, :, 0:3], box[None, :, 3:6]
    return slab(lo - BOX_REL * (lo.abs() + a), hi + BOX_REL * (hi.abs() + a), ro, inv, tmin, tcap)[0]


def group_boxes(boxes):
    """The union box [ceil(K / GROUP), 8] of each GROUP consecutive boxes
    [K, 8], as K6 builds them from a staged chunk (fmin/fmax: a NaN box is
    skipped; a group of NaN boxes is NaN)."""
    k = boxes.shape[0]
    pad = boxes.new_full((-k % GROUP, 8), float("nan"))
    g = torch.cat([boxes, pad]).view(-1, GROUP, 8)
    lo, hi = g[:, 0, 0:3], g[:, 0, 3:6]
    for j in range(1, GROUP):
        lo, hi = torch.fmin(lo, g[:, j, 0:3]), torch.fmax(hi, g[:, j, 3:6])
    return torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], dim=1)


def group_hit(groups, ro, inv, tmin, tmax, cap, any_hit):
    """K6's group test [A, G]: any hit, the group box at [tmin, tmax]; closest
    hit, the group box widened as the cull (b) widens, at [tmin, cap]."""
    if any_hit:
        return slab(groups[None, :, 0:3].expand(ro.shape[0], -1, 3), groups[None, :, 3:6].expand(ro.shape[0], -1, 3),
                    ro, inv, tmin, tmax)[0]
    return _widened_hit(groups, ro, inv, tmin, cap)


def sweep_work(cl_aabb, tris, n_tri, ro, rd, tmin, tmax, any_hit=False):
    """The work of K6 per live ray, [N, 4] int64 (zero for rays that are not
    live): boxes walked (group boxes tested, and the cluster boxes of the
    groups entered; any hit: up to the sweep that answers the ray),
    clusters entered ((ray, cluster) pairs: the twin's slab test at [tmin,
    tmax] and, closest hit, the widened box at [tmin, min(best t, tmax)],
    best t as of the block's last sweep), triangle rows those pairs hold,
    and the rows the parent kernel's block-wide cull left each live ray (64
    a cluster that any live ray of its block of THREADS enters at [tmin,
    tmax], before its stop rule).

    The block sweeps its list at the end of each chunk of BOXES boxes and
    when the list of PAIRS fills; the model takes the block's pairs box by
    box, threads in order, and sweeps where the list fills, resuming at
    that box (a ray that resumes inside a group tests its group box again).
    The kernel's warps run apart, so its list may fill at another pair:
    the answer is the same, the counts may differ by the pairs a sweep
    moves. Any hit counts the rows of every listed pair (the kernel skips a
    pair whose ray an earlier one answered)."""
    n, dev = ro.shape[0], ro.device
    n_rows = min(n_tri, tris.shape[0])
    n_walk = min(cl_aabb.shape[0], -(-n_rows // CLUSTER_K))
    m = max(1, -(-n // THREADS)) * THREADS
    blocks = m // THREADS

    def grid(x, fill):  # threads past n hold no ray
        return torch.cat([x, x.new_full((m - n, *x.shape[1:]), fill)])

    ro, rd, tmin, tmax = grid(ro, 0.0), grid(rd, 0.0), grid(tmin, 0.0), grid(tmax, -BIG)
    inv = inv_dir(rd)
    live = tmax >= tmin
    best_t = ro.new_full((m,), BIG)
    best_k = torch.full((m,), _IMAX, dtype=torch.int64, device=dev)  # order bits of t << 31 | prim
    occ = torch.zeros(m, dtype=torch.bool, device=dev)
    work = torch.zeros((m, 4), dtype=torch.int64, device=dev)
    thread = torch.arange(THREADS, device=dev).repeat(blocks)
    offs = torch.arange(CLUSTER_K, device=dev)
    for first in range(0, n_walk, BOXES):
        box = cl_aabb[first:min(first + BOXES, n_walk)]
        k = box.shape[0]
        entered = slab(box[None, :, 0:3].expand(m, k, 3), box[None, :, 3:6].expand(m, k, 3), ro, inv, tmin, tmax)[0]
        union = (entered & live[:, None]).view(blocks, THREADS, k).any(dim=1)  # [blocks, k]
        rows = (n_rows - (first + torch.arange(k, device=dev)) * CLUSTER_K).clamp(max=CLUSTER_K)
        work[:, 3] += ((union * rows).sum(dim=1).repeat_interleave(THREADS)) * live
        groups = group_boxes(box)
        group_of = torch.arange(k, device=dev) // GROUP
        pos = torch.where(live & ~occ, 0, k)  # each thread's next box in the chunk
        while True:
            cap = tmax if any_hit else torch.minimum(best_t, tmax)
            tested = group_hit(groups, ro, inv, tmin, tmax, cap, any_hit)[:, group_of]  # [m, k]: members tested
            pair = entered & tested & (torch.arange(k, device=dev) >= pos[:, None])
            if not any_hit:
                pair &= _widened_hit(box, ro, inv, tmin, cap)
            order = pair.view(blocks, THREADS, k).transpose(1, 2).reshape(blocks, k * THREADS)  # box by box
            listed = order & (order.cumsum(dim=1) <= PAIRS)
            full = order.sum(dim=1) > PAIRS
            # where a block's list fills: the box and thread of its first pair left out
            left = torch.where(order & ~listed, torch.arange(k * THREADS, device=dev), k * THREADS).amin(dim=1)
            stop_box, stop_thread = left // THREADS, left % THREADS
            listed = listed.view(blocks, k, THREADS).transpose(1, 2).reshape(m, k)
            resume = torch.where(full, stop_box, k).repeat_interleave(THREADS)
            resume = resume + (full.repeat_interleave(THREADS) & (thread < stop_thread.repeat_interleave(THREADS)))
            end = torch.minimum(resume, torch.full_like(pos, k))  # boxes pos .. end - 1 walked
            span = (pos < end) & (pos < k)
            members = torch.cat([tested.new_zeros((m, 1), dtype=torch.int64), tested.cumsum(dim=1)], dim=1)
            walked = (end - 1).clamp(min=0) // GROUP - pos.clamp(max=k - 1) // GROUP + 1  # group boxes
            walked = walked + members.gather(1, end[:, None])[:, 0] - members.gather(1, pos.clamp(max=k)[:, None])[:, 0]
            work[:, 0] += torch.where(span, walked, 0)
            pr, pc = listed.nonzero().unbind(dim=1)
            work[:, 1] += listed.sum(dim=1)
            work[:, 2].index_add_(0, pr, rows[pc])
            if pr.numel():
                row = (first + pc)[:, None] * CLUSTER_K + offs
                valid = row < n_rows
                t, _, _, inside = affine_test(tris[row.clamp(max=tris.shape[0] - 1)], ro[pr][:, None],
                                              rd[pr][:, None])
                ok = valid & inside & (t >= tmin[pr, None]) & (t <= tmax[pr, None])
                if any_hit:
                    occ[pr[ok.any(dim=1)]] = True
                else:  # the least (t, prim) of each pair, merged into the ray's key
                    keys = torch.where(ok, order_bits(t) << 31 | row, _IMAX).amin(dim=1)
                    best_k.scatter_reduce_(0, pr, keys, "amin")
                    best_t = torch.where(best_k != _IMAX, order_float(best_k >> 31), BIG)
            if not full.any():
                break
            pos = torch.where(full.repeat_interleave(THREADS) & live & ~occ, resume, k)
        if any_hit and not (live & ~occ).any():
            break
    work[:, 0] = torch.where(live, work[:, 0], 0)
    return work[:n]


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


_lib = _launch.declare("sweep", {
    "tt_sweep_closest": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "tt_sweep_occluded": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P],
}, launches=_launch.LAUNCHES)


def _check(cl_aabb, tris, n_tri, ro, rd, tmin, tmax):
    """Raise on tables the kernel does not take; returns the launch's sizes."""
    n = _launch.check_rays(ro, rd, tmin, tmax)
    n_cl, tpad = cl_aabb.shape[0], tris.shape[0]
    for name, x, shape in (("cl_aabb", cl_aabb, (n_cl, 8)), ("bvh.tris", tris, (tpad, 24))):
        _launch.check(name, x, torch.float32, shape, ro.device)
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it as float4, so it must start 16-byte aligned")
    if not 0 <= n_tri <= min(tpad, n_cl * CLUSTER_K):
        raise ValueError(f"n_tri {n_tri} outside the tables ({tpad} rows, {n_cl} clusters)")
    return n, n_cl, tpad


def closest(cl_aabb, tris, n_tri, ro, rd, tmin, tmax):
    """K6: closest hit of each ray in [tmin, tmax] over the clusters.

    Args:
        cl_aabb: [Cpad, 8] cluster boxes (BVHArrays.cl_aabb).
        tris: [Tpad, 24] triangle rows (BVHArrays.tris).
        n_tri: valid triangle count (rows >= n_tri never hit).
        ro, rd: [N, 3] rays; tmin, tmax: [N].
    Returns:
        (t, u, v [N] float32, prim [N] int32); t = 3.4e38, prim = -1 on a miss.
    """
    if not ro.is_cuda:
        return sweep_plain(cl_aabb, tris, n_tri, ro, rd, tmin, tmax)
    n, n_cl, tpad = _check(cl_aabb, tris, n_tri, ro, rd, tmin, tmax)
    t, u, v = (torch.empty(n, dtype=torch.float32, device=ro.device) for _ in range(3))
    prim = torch.empty(n, dtype=torch.int32, device=ro.device)
    code = _lib().tt_sweep_closest(
        cl_aabb.data_ptr(), n_cl, tris.data_ptr(), tpad, n_tri, ro.data_ptr(), rd.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), n, t.data_ptr(), u.data_ptr(), v.data_ptr(),
        prim.data_ptr(), torch.cuda.current_stream(ro.device).cuda_stream,
    )
    _launch.raise_on(_lib(), code, "sweep closest-hit kernel")
    _launch.LAUNCHES["sweep_closest"] += 1
    return t, u, v, prim


def occluded(cl_aabb, tris, n_tri, ro, rd, tmin, tmax):
    """K6, any hit: whether any triangle lies in [tmin, tmax]. Returns [N] bool."""
    if not ro.is_cuda:
        return sweep_plain(cl_aabb, tris, n_tri, ro, rd, tmin, tmax, any_hit=True)
    n, n_cl, tpad = _check(cl_aabb, tris, n_tri, ro, rd, tmin, tmax)
    occ = torch.empty(n, dtype=torch.bool, device=ro.device)
    code = _lib().tt_sweep_occluded(
        cl_aabb.data_ptr(), n_cl, tris.data_ptr(), tpad, n_tri, ro.data_ptr(), rd.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), n, occ.data_ptr(),
        torch.cuda.current_stream(ro.device).cuda_stream,
    )
    _launch.raise_on(_lib(), code, "sweep any-hit kernel")
    _launch.LAUNCHES["sweep_anyhit"] += 1
    return occ
