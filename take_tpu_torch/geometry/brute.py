"""Brute-force triangle sweeps: the CUDA kernels K1/K2 and their plain twins.

`closest` (K1) and `occluded` (K2) replace the JAX package's Pallas kernels
in take_tpu/geometry/pallas_brute.py (`_closest_kernel`, `_anyhit_kernel`);
the CUDA source and its design note are in csrc/brute.cu. Both read the
scene's triangle rows (`geometry.tri_rows` [Tpad, 24], built once per
upload: scene/types.py::affine_rows) and sweep the first `n_tri` of them.

Dispatch is by the device of the rays: a CUDA tensor launches the kernel
(and raises if it cannot), a CPU tensor runs the plain twin
(`closest_plain`, `occluded_plain`), which computes the same outputs in
torch, one [N, T] array at a time, with the affine products taken element
by element in a fixed order. `reference` launches the first design's
one-ray-per-thread loop (csrc/brute.cu::reference_kernel), which the
kernels are held to bit for bit on the card. `_launch.LAUNCHES` counts what
ran.
"""

import ctypes

import torch

from take_tpu_torch.geometry import _launch
from take_tpu_torch.scene.types import ATTR_DIM

BIG = 3.4e38  # t of a miss
DW_EPS = 1e-12  # parallel-ray reject on the (u, v, w)-frame direction
ROW = 24  # floats in a triangle row


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def tri_uvt(rows, n_tri, ro, rd, tmin, tmax):
    """All rays x the first n_tri triangle rows -> (t, u, v, ok), each [N, T].

    The pairwise test of both kernels (and of take_tpu's `_tri_uvt`):
    t = -s_w / d_w, u = s_u + t d_u, v = s_v + t d_v, rejected when parallel,
    outside the triangle or outside [tmin, tmax]; rays with tmax <= 0 miss.
    """
    r = rows[:n_tri]
    ox, oy, oz = ro[:, 0:1], ro[:, 1:2], ro[:, 2:3]
    dx, dy, dz = rd[:, 0:1], rd[:, 1:2], rd[:, 2:3]

    def s(c):
        return r[:, c] * ox + r[:, c + 1] * oy + r[:, c + 2] * oz + r[:, c + 3]

    def d(c):
        return r[:, c] * dx + r[:, c + 1] * dy + r[:, c + 2] * dz

    su, sv, sw = s(0), s(4), s(8)
    du, dv, dw = d(12), d(15), d(18)
    parallel = dw.abs() < DW_EPS
    inv_dw = 1.0 / torch.where(parallel, 1.0, dw)
    t = -sw * inv_dw
    u = su + t * du
    v = sv + t * dv
    ok = (
        ~parallel
        & (tmax > 0.0)[:, None]
        & (u >= 0.0)
        & (v >= 0.0)
        & (1.0 - (u + v) >= 0.0)
        & (t - tmin[:, None] >= 0.0)
        & (tmax[:, None] - t >= 0.0)
    )
    return t, u, v, ok


def closest_plain(rows, attr, n_tri, ro, rd, tmin, tmax):
    """Plain twin of `closest`: same outputs, in torch."""
    _launch.LAUNCHES["closest_plain"] += 1
    t, u, v, ok = tri_uvt(rows, n_tri, ro, rd, tmin, tmax)
    t_best, best = torch.where(ok, t, BIG).min(dim=1)  # first index on ties
    found = t_best < BIG
    pick = best[:, None]
    u_best = torch.where(found, u.gather(1, pick)[:, 0], 0.0)
    v_best = torch.where(found, v.gather(1, pick)[:, 0], 0.0)
    attrs = torch.where(found[:, None], attr[best], 0.0)
    prim = torch.where(found, best, -1).to(torch.int32)
    return attrs, t_best, u_best, v_best, found, prim


def occluded_plain(rows, n_tri, ro, rd, tmin, tmax):
    """Plain twin of `occluded`."""
    _launch.LAUNCHES["anyhit_plain"] += 1
    return tri_uvt(rows, n_tri, ro, rd, tmin, tmax)[3].any(dim=1)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


_lib = _launch.declare("brute", {
    "tt_brute_closest": [_P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "tt_brute_occluded": [_P, _I, _P, _P, _P, _P, _I, _P, _P],
    "tt_brute_reference": [_P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P],
}, launches=_launch.LAUNCHES)


def _check(rows, attr, n_tri, ro, rd, tmin, tmax):
    """Check the kernels' inputs (`attr` may be None); returns N."""
    tpad = rows.shape[0]
    if not 0 < n_tri <= tpad:
        raise ValueError(f"n_tri={n_tri} outside (0, {tpad}]")
    n = _launch.check_rays(ro, rd, tmin, tmax)
    for name, x, shape in (("rows", rows, (tpad, ROW)), ("attr", attr, (tpad, ATTR_DIM))):
        if x is not None:
            _launch.check(name, x, torch.float32, shape, ro.device)
            if x.data_ptr() % 16:
                raise ValueError(f"{name}: the kernels read it as float4, so it must start 16-byte aligned")
    return n


def _outputs(n, device):
    """(attrs [n, ATTR_DIM], t, u, v [n], prim [n] int32), empty."""
    attrs = torch.empty((n, ATTR_DIM), dtype=torch.float32, device=device)
    t, u, v = (torch.empty(n, dtype=torch.float32, device=device) for _ in range(3))
    return attrs, t, u, v, torch.empty(n, dtype=torch.int32, device=device)


def closest(rows, attr, n_tri, ro, rd, tmin, tmax):
    """K1: closest hit of each ray against the first n_tri triangles.

    Args:
        rows: the scene's triangle rows `tri_rows` [Tpad, 24].
        attr: packed attribute rows [Tpad, ATTR_DIM].
        ro, rd: [N, 3] rays; tmin, tmax: [N].
    Returns:
        (attrs [N, ATTR_DIM], t, u, v [N], found [N] bool, prim [N] int32):
        pallas_tri_sweep's tuple plus the winner's index. On a miss
        t = 3.4e38, prim = -1, and attrs, u, v are 0.
    """
    if not ro.is_cuda:
        return closest_plain(rows, attr, n_tri, ro, rd, tmin, tmax)
    n = _check(rows, attr, n_tri, ro, rd, tmin, tmax)
    attrs, t, u, v, prim = _outputs(n, ro.device)
    stream = torch.cuda.current_stream(ro.device).cuda_stream
    code = _lib().tt_brute_closest(
        rows.data_ptr(), n_tri, attr.data_ptr(),
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        attrs.data_ptr(), t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(), stream,
    )
    _launch.raise_on(_lib(), code, "closest-hit kernel")
    _launch.LAUNCHES["closest"] += 1
    return attrs, t, u, v, prim >= 0, prim


def occluded(rows, n_tri, ro, rd, tmin, tmax):
    """K2: whether any of the first n_tri triangles is hit in [tmin, tmax].

    Returns [N] bool.
    """
    if not ro.is_cuda:
        return occluded_plain(rows, n_tri, ro, rd, tmin, tmax)
    n = _check(rows, None, n_tri, ro, rd, tmin, tmax)
    occ = torch.empty(n, dtype=torch.bool, device=ro.device)
    stream = torch.cuda.current_stream(ro.device).cuda_stream
    code = _lib().tt_brute_occluded(
        rows.data_ptr(), n_tri, ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        occ.data_ptr(), stream,
    )
    _launch.raise_on(_lib(), code, "any-hit kernel")
    _launch.LAUNCHES["anyhit"] += 1
    return occ


def reference(rows, attr, n_tri, ro, rd, tmin, tmax, any_hit=False):
    """The one-ray-per-thread reference kernel, on the card only: `closest`'s
    tuple, or with `any_hit` `occluded`'s answer."""
    n = _check(rows, attr, n_tri, ro, rd, tmin, tmax)
    if not ro.is_cuda:
        raise ValueError("the reference kernel runs on the card only")
    attrs, t, u, v, prim = _outputs(n, ro.device)
    occ = torch.empty(n, dtype=torch.bool, device=ro.device)
    stream = torch.cuda.current_stream(ro.device).cuda_stream
    code = _lib().tt_brute_reference(
        rows.data_ptr(), n_tri, attr.data_ptr(),
        ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
        attrs.data_ptr(), t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(), occ.data_ptr(),
        int(any_hit), stream,
    )
    _launch.raise_on(_lib(), code, "reference kernel")
    _launch.LAUNCHES["reference"] += 1
    return occ if any_hit else (attrs, t, u, v, prim >= 0, prim)
