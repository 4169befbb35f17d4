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
is exactly independent of the order here. `_launch.LAUNCHES` counts what
ran.
"""

import ctypes
import functools

import torch

from take_tpu_torch.geometry import _build, _launch
from take_tpu_torch.geometry.bvh import CLUSTER_K
from take_tpu_torch.geometry.packet import BIG, affine_test, inv_dir, slab

CHUNK = 1 << 16  # rays per batch of the plain twin (bounds its temporaries)
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
# CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("sweep")
    lib.tt_sweep_closest.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P]
    lib.tt_sweep_closest.restype = _I
    lib.tt_sweep_occluded.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P]
    lib.tt_sweep_occluded.restype = _I
    lib.tt_sweep_max_clusters.argtypes = []
    lib.tt_sweep_max_clusters.restype = _I
    return lib


def _check(cl_aabb, tris, n_tri, ro, rd, tmin, tmax):
    n = _launch.check_rays(ro, rd, tmin, tmax)
    n_cl, tpad = cl_aabb.shape[0], tris.shape[0]
    _launch.check("cl_aabb", cl_aabb, torch.float32, (n_cl, 8), ro.device)
    _launch.check("bvh.tris", tris, torch.float32, (tpad, 24), ro.device)
    if not 0 <= n_tri <= min(tpad, n_cl * CLUSTER_K):
        raise ValueError(f"n_tri {n_tri} outside the tables ({tpad} rows, {n_cl} clusters)")
    most = _lib().tt_sweep_max_clusters()
    if n_cl > most:
        raise RuntimeError(
            f"cl_aabb has {n_cl} clusters; the sweep kernel's shared-memory list holds {most}"
        )
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
