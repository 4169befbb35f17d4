"""Streaming supercluster sweep: the CUDA kernels K4 (closest) and K5 (any hit)
and their plain twin.

`closest` (K4) and `occluded` (K5) replace the JAX package's Pallas cluster
kernels (take_tpu/geometry/pallas_cluster.py::_sweep_kernel,
::_occluded_kernel, entry `cluster_traverse`); the CUDA source and its
design note are in csrc/cluster.cu. Both read `bvh.sup_aabb` (supercluster
boxes, NaN-padded to a multiple of GROUP rows), `bvh.cl_aabb` (the boxes of
the clusters of 64 rows; supercluster s holds clusters 8 s .. 8 s + 7) and
`bvh.tris` (the packet kernel's row layout, geometry/packet.py::prep_tables):
supercluster s is rows s * 512 .. s * 512 + 511. The TPU kernel reads the
same operands as transposed [24, 512] granules (`geometry.tri_sweep`), which
the port builds but keeps on the host.

Dispatch is by the device of the rays: a CUDA tensor launches the kernel
(and raises if it cannot), a CPU tensor runs the plain twin
(`cluster_plain`): every supercluster box is slab-tested for every live ray,
in ascending order, and each supercluster is swept densely over its 512
rows for the rays that hit its box, merging with strict `<` (the lowest
triangle index wins a tie); the any-hit version ORs. The kernels cull the
same superclusters and then, inside each, the cluster boxes, widened by
BOX_REL so that no hit the twin finds is dropped; `cluster_work` counts that
walk's work per ray. `_launch.LAUNCHES` counts what ran.
"""

import ctypes

import torch

from take_tpu_torch.geometry import _launch
from take_tpu_torch.geometry.bvh import CLUSTER_K, GROUP, SUP
from take_tpu_torch.geometry.packet import BIG, affine_test, inv_dir, slab

SUPT = SUP * CLUSTER_K  # triangles per supercluster
CHUNK = 1 << 16  # rays per sweep of the plain twin (bounds its temporaries)
THREADS = 128  # rays per block of K4/K5 (csrc/cluster.cu kThreads)
BOX_REL = 2.0 ** -16  # K4/K5 widen each cluster box by this share of |coordinate| + |origin| (kBoxRel)

# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------


def cluster_plain(sup_aabb, tris, ro, rd, tmin, tmax, any_hit=False):
    """Plain twin of K4/K5: (t, u, v, prim [int32]) of each ray, or with
    any_hit its occlusion [bool]."""
    _launch.LAUNCHES["cluster_anyhit_plain" if any_hit else "cluster_closest_plain"] += 1
    n, dev = ro.shape[0], ro.device
    inv = inv_dir(rd)
    live = tmax >= tmin
    best_t = ro.new_full((n,), BIG)
    best_u = ro.new_zeros(n)
    best_v = ro.new_zeros(n)
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    for sup in range(sup_aabb.shape[0]):
        rows = tris[sup * SUPT:(sup + 1) * SUPT]  # [<= SUPT, 24]; rows past Tpad never hit
        if rows.shape[0] == 0:
            break
        tcap = tmax if any_hit else torch.minimum(best_t, tmax)
        box = sup_aabb[sup].expand(n, 8)
        hit, _ = slab(box[:, None, 0:3], box[:, None, 3:6], ro, inv, tmin, tcap)
        hit = hit[:, 0] & live & ~occ
        rays = hit.nonzero()[:, 0]
        for r in rays.split(CHUNK):
            t, u, v, inside = affine_test(rows, ro[r][:, None], rd[r][:, None])
            ok = inside & (t >= tmin[r, None]) & (t <= tcap[r, None])
            if any_hit:
                occ[r] = ok.any(dim=1)
                continue
            t_new, j = torch.where(ok, t, BIG).min(dim=1)  # first column on ties
            better = t_new < best_t[r]
            best_t[r] = torch.where(better, t_new, best_t[r])
            best_u[r] = torch.where(better, u.gather(1, j[:, None])[:, 0], best_u[r])
            best_v[r] = torch.where(better, v.gather(1, j[:, None])[:, 0], best_v[r])
            best_p[r] = torch.where(better, sup * SUPT + j, best_p[r])
    if any_hit:
        return occ
    ok = best_t <= tmax
    return (torch.where(ok, best_t, BIG), best_u, best_v,
            torch.where(ok, best_p, -1).to(torch.int32))


# ---------------------------------------------------------------------------
# Work counters
# ---------------------------------------------------------------------------


def _widened(box, ro):
    """The cluster boxes [K, 8] as K4/K5 test them against rays ro [A, 3]:
    (lo, hi) [A, K, 3], each face moved out by BOX_REL (|coordinate| +
    |origin|). BOX_REL is a power of two, so the kernels' contraction of
    the product into the subtraction rounds the same."""
    a = ro.abs()[:, None]
    lo, hi = box[None, :, 0:3], box[None, :, 3:6]
    return lo - BOX_REL * (lo.abs() + a), hi + BOX_REL * (hi.abs() + a)


def cluster_work(sup_aabb, cl_aabb, tris, ro, rd, tmin, tmax, any_hit=False):
    """The work of K4 (K5 with any_hit) per ray, [N, 4] int64: superclusters
    entered (cluster_plain's cull), clusters entered (widened boxes at the
    range of the supercluster's start), triangle rows tested (64 a cluster,
    rows at or past Tpad not read; K5 stops after the supercluster of its
    first hit), and the superclusters the ray's block of THREADS rays votes
    for, each a phase of the kernel between two block barriers (the parent
    kernel, which this one replaced, tested all 512 rows of each for every
    live ray)."""
    n, dev = ro.shape[0], ro.device
    n_sup, n_cl, tpad = sup_aabb.shape[0], cl_aabb.shape[0], tris.shape[0]
    inv = inv_dir(rd)
    live = tmax >= tmin
    best_t = ro.new_full((n,), BIG)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    work = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    pad = -n % THREADS
    rows_of = torch.arange(CLUSTER_K, device=dev)
    for sup in range(n_sup):
        if sup % GROUP == 0:  # the block vote tests a group at the range of its start
            vcap = tmax if any_hit else torch.minimum(best_t, tmax)
            pending = live & ~occ
        box = sup_aabb[sup].expand(n, 8)
        voted, _ = slab(box[:, None, 0:3], box[:, None, 3:6], ro, inv, tmin, vcap)
        voted = voted[:, 0] & pending
        block = torch.cat([voted, voted.new_zeros(pad)]).view(-1, THREADS).any(dim=1)
        work[:, 3] += block.repeat_interleave(THREADS)[:n]
        cap = tmax if any_hit else torch.minimum(best_t, tmax)
        enter, _ = slab(box[:, None, 0:3], box[:, None, 3:6], ro, inv, tmin, cap)
        enter = enter[:, 0] & voted & ~occ
        first, last = sup * SUP, min(sup * SUP + SUP, n_cl)
        if last <= first:
            continue
        for r in enter.nonzero()[:, 0].split(CHUNK // SUP):  # bounds the [rays, 512] temporaries
            work[r, 0] += 1
            lo, hi = _widened(cl_aabb[first:last], ro[r])
            cl_hit, _ = slab(lo, hi, ro[r], inv[r], tmin[r], cap[r])  # [R, K]
            row = (torch.arange(first, last, device=dev)[:, None] * CLUSTER_K + rows_of).view(-1)  # [K * 64]
            take = (cl_hit[:, :, None] & (row < tpad).view(last - first, CLUSTER_K)).view(r.numel(), row.numel())
            work[r, 1] += cl_hit.sum(dim=1)
            work[r, 2] += take.sum(dim=1)
            t, _, _, inside = affine_test(tris[row.clamp(max=tpad - 1)], ro[r][:, None], rd[r][:, None])
            ok = take & inside & (t >= tmin[r, None]) & (t <= tmax[r, None])
            if any_hit:
                occ[r] = ok.any(dim=1)
            else:
                best_t[r] = torch.minimum(best_t[r], torch.where(ok, t, BIG).amin(dim=1))
    return work


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


_lib = _launch.declare("cluster", {
    "tt_cluster_closest": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "tt_cluster_occluded": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P],
}, launches=_launch.LAUNCHES)


def _check(sup_aabb, cl_aabb, tris, ro, rd, tmin, tmax):
    """Raise on tables the kernels do not take; returns the launch's sizes."""
    n = _launch.check_rays(ro, rd, tmin, tmax)
    n_sup, n_cl, tpad = sup_aabb.shape[0], cl_aabb.shape[0], tris.shape[0]
    if n_sup % GROUP:
        raise ValueError(f"sup_aabb has {n_sup} rows, not a multiple of {GROUP}")
    if n_cl % SUP or n_sup != max(GROUP, -(-(n_cl // SUP) // GROUP) * GROUP) or n_cl * CLUSTER_K < tpad:
        raise ValueError(f"cl_aabb has {n_cl} rows, which do not make the {n_sup} superclusters of sup_aabb "
                         f"or cover the {tpad} rows of bvh.tris (geometry/bvh.py::cluster_aabbs)")
    for name, x, shape in (("sup_aabb", sup_aabb, (n_sup, 8)), ("cl_aabb", cl_aabb, (n_cl, 8)),
                           ("bvh.tris", tris, (tpad, 24))):
        _launch.check(name, x, torch.float32, shape, ro.device)
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels read it as float4, so it must start 16-byte aligned")
    return n, n_sup, n_cl, tpad


def closest(sup_aabb, cl_aabb, tris, ro, rd, tmin, tmax):
    """K4: closest hit of each ray in [tmin, tmax] over the superclusters.

    Args:
        sup_aabb: [SupP, 8] supercluster boxes (BVHArrays.sup_aabb).
        cl_aabb: [Cpad, 8] cluster boxes (BVHArrays.cl_aabb), SUP a
            supercluster.
        tris: [Tpad, 24] triangle rows (BVHArrays.tris); rows at or past
            Tpad of a supercluster are absent and never hit.
        ro, rd: [N, 3] rays; tmin, tmax: [N].
    Returns:
        (t, u, v [N] float32, prim [N] int32); t = 3.4e38, prim = -1 on a miss.
    """
    if not ro.is_cuda:
        return cluster_plain(sup_aabb, tris, ro, rd, tmin, tmax)
    n, n_sup, n_cl, tpad = _check(sup_aabb, cl_aabb, tris, ro, rd, tmin, tmax)
    t, u, v = (torch.empty(n, dtype=torch.float32, device=ro.device) for _ in range(3))
    prim = torch.empty(n, dtype=torch.int32, device=ro.device)
    code = _lib().tt_cluster_closest(
        sup_aabb.data_ptr(), n_sup, cl_aabb.data_ptr(), n_cl, tris.data_ptr(), tpad, ro.data_ptr(),
        rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n, t.data_ptr(), u.data_ptr(), v.data_ptr(),
        prim.data_ptr(), torch.cuda.current_stream(ro.device).cuda_stream,
    )
    _launch.raise_on(_lib(), code, "cluster closest-hit kernel")
    _launch.LAUNCHES["cluster_closest"] += 1
    return t, u, v, prim


def occluded(sup_aabb, cl_aabb, tris, ro, rd, tmin, tmax):
    """K5: whether any triangle lies in [tmin, tmax]. Returns [N] bool."""
    if not ro.is_cuda:
        return cluster_plain(sup_aabb, tris, ro, rd, tmin, tmax, any_hit=True)
    n, n_sup, n_cl, tpad = _check(sup_aabb, cl_aabb, tris, ro, rd, tmin, tmax)
    occ = torch.empty(n, dtype=torch.bool, device=ro.device)
    code = _lib().tt_cluster_occluded(
        sup_aabb.data_ptr(), n_sup, cl_aabb.data_ptr(), n_cl, tris.data_ptr(), tpad, ro.data_ptr(),
        rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n, occ.data_ptr(),
        torch.cuda.current_stream(ro.device).cuda_stream,
    )
    _launch.raise_on(_lib(), code, "cluster any-hit kernel")
    _launch.LAUNCHES["cluster_anyhit"] += 1
    return occ
