"""Wide-BVH traversal: the CUDA kernel K3 (closest and any hit) and its plain twin.

`closest` and `occluded` replace the JAX package's Pallas packet kernel
(take_tpu/geometry/pallas_traverse.py::_kernel, entry `packet_traverse`);
the CUDA source and its design note are in csrc/traverse.cu. Both read the
kernel layout of `prep_tables`, which the scene builds once when it is
uploaded (scene/types.py::scene_from_numpy) and keeps in `scene.bvh`.

Dispatch is by the device of the rays: a CUDA tensor launches the kernel
(and raises if it cannot), a CPU tensor runs the plain twin
(`packet_plain`): the same per-ray stack traversal in torch, with the same
near-first child order, the same affine leaf test on the same rows and the
same tie rule, a batch of rays at a time. `_launch.LAUNCHES` counts what
ran.

The per-ray stack is sized from the tree: a pop removes one node and
pushes at most WIDTH, so a tree of wide depth D needs `stack_bound(D)` =
7 D + 1 entries. The kernel's stack is fixed when it is compiled; the
wrapper raises when the tree needs more, and the twin sizes its own.
"""

import ctypes
import functools

import torch

from take_tpu_torch.geometry import _build, _launch
from take_tpu_torch.geometry.bvh import LEAF_SIZE, WIDTH

BIG = 3.4e38  # t of a miss
DW_EPS = 1e-12  # parallel-ray reject on the (u, v, w)-frame direction
INV_DIR_EPS = 1e-20  # |d| below this reads as 1e-20 in 1 / d
CHUNK = 1 << 16  # rays per batch of the plain twin (bounds its temporaries)


def stack_bound(depth: int) -> int:
    """Stack entries a per-ray traversal of a tree of wide depth `depth` needs."""
    return (WIDTH - 1) * depth + 1


def prep_tables(bvh, geometry):
    """The kernel layout of the BVH and triangle tables (the counterpart of
    pallas_traverse.py::prep_tables).

    Returns (nodes [M * WIDTH, 8], tris [Tpad, 24]), float32, contiguous:
    node rows (min xyz, max xyz, child, count), child and count as floats
    (exact below 2^24); triangle rows (o_u[4], o_v[4], o_w[4], d_u[3],
    d_v[3], d_w[3], 0, 0, 0), the affine maps of `tri_affine_o/d` in row form.
    """
    m = bvh.node_child.shape[0]
    nodes = torch.cat(
        [bvh.node_min, bvh.node_max,
         bvh.node_child.to(torch.float32)[..., None], bvh.node_count.to(torch.float32)[..., None]],
        dim=2,
    ).reshape(m * WIDTH, 8)
    tpad = geometry.tri_attr.shape[0]
    o = geometry.tri_affine_o.reshape(4, 3, tpad)  # [row, uvw, tri]
    d = geometry.tri_affine_d.reshape(3, 3, tpad)
    tris = torch.cat(
        [o.permute(2, 1, 0).reshape(tpad, 12), d.permute(2, 1, 0).reshape(tpad, 9),
         o.new_zeros((tpad, 3))],
        dim=1,
    )
    return nodes.contiguous(), tris.contiguous()


# ---------------------------------------------------------------------------
# Plain twin
# ---------------------------------------------------------------------------


def inv_dir(rd):
    """1 / d per axis, |d| < 1e-20 read as 1e-20 (the kernels' rule)."""
    return 1.0 / torch.where(rd.abs() < INV_DIR_EPS, INV_DIR_EPS, rd)


def slab(lo, hi, ro, inv, tmin, tcap):
    """Slab test of boxes lo, hi [A, K, 3] at [tmin, tcap] -> (hit, tlo) [A, K].

    torch.minimum/maximum and amax/amin carry a NaN through, so a NaN box
    never hits (the kernels reach the same decision by comparisons).
    """
    t0 = (lo - ro[:, None]) * inv[:, None]
    t1 = (hi - ro[:, None]) * inv[:, None]
    tlo = torch.minimum(t0, t1).amax(dim=-1)
    thi = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tlo <= thi) & (thi >= tmin[:, None]) & (tlo <= tcap[:, None])
    return hit, tlo


def affine_test(rows, ro, rd):
    """The kernels' affine triangle test, rows [..., 24] against rays
    broadcast to them ([..., 3]) -> (t, u, v, inside)."""
    o = [ro[..., k] for k in range(3)]
    d = [rd[..., k] for k in range(3)]

    def s(c):
        return rows[..., c] * o[0] + rows[..., c + 1] * o[1] + rows[..., c + 2] * o[2] + rows[..., c + 3]

    def dd(c):
        return rows[..., c] * d[0] + rows[..., c + 1] * d[1] + rows[..., c + 2] * d[2]

    su, sv, sw = s(0), s(4), s(8)
    du, dv, dw = dd(12), dd(15), dd(18)
    parallel = dw.abs() < DW_EPS
    inv_dw = 1.0 / torch.where(parallel, 1.0, dw)
    t = -sw * inv_dw
    u = su + t * du
    v = sv + t * dv
    inside = ~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, inside


def _traverse_chunk(bvh, ro, rd, tmin, tmax, any_hit):
    """Per-ray stack traversal of one batch -> (t, u, v, prim)."""
    n = ro.shape[0]
    dev = ro.device
    size = stack_bound(bvh.depth)
    nodes = bvh.nodes.reshape(-1, WIDTH, 8)
    inv = inv_dir(rd)
    best_t = ro.new_full((n,), BIG)
    best_u = ro.new_zeros(n)
    best_v = ro.new_zeros(n)
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, size), dtype=torch.int64, device=dev)  # root at slot 0
    sp = (tmax >= tmin).to(torch.int64)  # dead and padded lanes: empty stack
    offs = torch.arange(LEAF_SIZE, device=dev)
    slot = torch.arange(WIDTH, device=dev)
    while True:
        act = (sp > 0).nonzero()[:, 0]
        if act.numel() == 0:
            break
        sp_a = sp[act] - 1
        rows = nodes[stack[act, sp_a]]  # [A, W, 8]
        child = rows[..., 6].to(torch.int64)
        count = rows[..., 7].to(torch.int64)
        tcap = torch.minimum(best_t[act], tmax[act])
        hit, tlo = slab(rows[..., 0:3], rows[..., 3:6], ro[act], inv[act], tmin[act], tcap)
        leaf = hit & (child < 0) & (count > 0)
        inner = hit & (child >= 0)

        # every triangle of the node's hit leaves at once: the kept hit is the
        # least (t, prim) whatever the order, so this equals K3's sweep of
        # the leaves nearest first
        la = leaf.any(dim=1).nonzero()[:, 0]
        if la.numel():
            r = act[la]
            idx = -(child[la] + 1)[:, :, None] + offs  # [L, W, LEAF]
            valid = (leaf[la][:, :, None] & (offs < count[la][:, :, None])).reshape(la.numel(), -1)
            idx = torch.where(valid, idx.reshape(la.numel(), -1), 0)
            t, u, v, inside = affine_test(bvh.tris[idx], ro[r][:, None], rd[r][:, None])
            ok = (valid & inside & (t >= tmin[r, None]) & (t <= tmax[r, None])
                  & (t <= best_t[r, None]))
            tm = torch.where(ok, t, BIG)
            t_new = tm.amin(dim=1)
            win = ok & (tm == t_new[:, None])
            p_new = torch.where(win, idx, torch.iinfo(torch.int64).max).amin(dim=1)
            pick = (win & (idx == p_new[:, None])).to(torch.int8).argmax(dim=1, keepdim=True)
            bt, bp = best_t[r], best_p[r]
            better = win.any(dim=1) & ((t_new < bt) | ((t_new == bt) & (p_new < bp)))
            best_t[r] = torch.where(better, t_new, bt)
            best_u[r] = torch.where(better, u.gather(1, pick)[:, 0], best_u[r])
            best_v[r] = torch.where(better, v.gather(1, pick)[:, 0], best_v[r])
            best_p[r] = torch.where(better, p_new, bp)

        # inner children, farthest first, so that the nearest is popped next
        key = torch.where(inner, tlo, float("inf"))
        order = torch.sort(key, dim=1, stable=True).indices
        k = inner.sum(dim=1)
        top = sp_a + k
        if int(top.max()) > size:
            raise RuntimeError(f"traversal stack overflow: {int(top.max())} > {size}")
        put = slot < k[:, None]  # rank r < k -> stack slot top - 1 - r
        rows_i = act[:, None].expand(-1, WIDTH)[put]
        stack[rows_i, (top[:, None] - 1 - slot)[put]] = child.gather(1, order)[put]
        sp[act] = top
        if any_hit:
            sp[best_p >= 0] = 0
    ok = best_t <= tmax
    return (torch.where(ok, best_t, BIG), best_u, best_v,
            torch.where(ok, best_p, -1).to(torch.int32))


def packet_plain(bvh, ro, rd, tmin, tmax, any_hit=False):
    """Plain twin of K3: (t, u, v, prim [int32]) of each ray, or with
    any_hit its occlusion [bool], in batches of CHUNK rays."""
    _launch.LAUNCHES["packet_anyhit_plain" if any_hit else "packet_closest_plain"] += 1
    parts = [
        _traverse_chunk(bvh, ro[s:s + CHUNK], rd[s:s + CHUNK], tmin[s:s + CHUNK], tmax[s:s + CHUNK], any_hit)
        for s in range(0, ro.shape[0], CHUNK)
    ]
    t, u, v, prim = (torch.cat(x) for x in zip(*parts)) if parts else (
        ro.new_zeros(0), ro.new_zeros(0), ro.new_zeros(0), torch.zeros(0, dtype=torch.int32, device=ro.device))
    return prim >= 0 if any_hit else (t, u, v, prim)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    lib = _build.load("traverse")
    lib.tt_packet_closest.argtypes = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P]
    lib.tt_packet_closest.restype = _I
    lib.tt_packet_occluded.argtypes = [_P, _P, _P, _P, _P, _P, _I, _P, _P]
    lib.tt_packet_occluded.restype = _I
    lib.tt_packet_stack_size.argtypes = []
    lib.tt_packet_stack_size.restype = _I
    return lib


def _check(bvh, ro, rd, tmin, tmax):
    n = _launch.check_rays(ro, rd, tmin, tmax)
    m, tpad = bvh.node_child.shape[0], bvh.tris.shape[0]
    _launch.check("bvh.nodes", bvh.nodes, torch.float32, (m * WIDTH, 8), ro.device)
    _launch.check("bvh.tris", bvh.tris, torch.float32, (tpad, 24), ro.device)
    need, have = stack_bound(bvh.depth), _lib().tt_packet_stack_size()
    if need > have:
        raise RuntimeError(
            f"BVH of wide depth {bvh.depth} needs a traversal stack of {need} entries; "
            f"the kernel holds {have}"
        )
    return n


def closest(bvh, ro, rd, tmin, tmax):
    """K3: closest hit of each ray in [tmin, tmax] through the wide BVH.

    Args:
        bvh: the scene's BVHArrays (`nodes`, `tris`, `depth` set).
        ro, rd: [N, 3] rays; tmin, tmax: [N].
    Returns:
        (t, u, v [N] float32, prim [N] int32): the winner's t, barycentrics
        and BVH-order triangle index; t = 3.4e38 and prim = -1 on a miss.
    """
    if not ro.is_cuda:
        return packet_plain(bvh, ro, rd, tmin, tmax)
    n = _check(bvh, ro, rd, tmin, tmax)
    t, u, v = (torch.empty(n, dtype=torch.float32, device=ro.device) for _ in range(3))
    prim = torch.empty(n, dtype=torch.int32, device=ro.device)
    code = _lib().tt_packet_closest(
        bvh.nodes.data_ptr(), bvh.tris.data_ptr(), ro.data_ptr(), rd.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), n, t.data_ptr(), u.data_ptr(), v.data_ptr(),
        prim.data_ptr(), torch.cuda.current_stream(ro.device).cuda_stream,
    )
    _launch.raise_on(_lib(), code, "packet closest-hit kernel")
    _launch.LAUNCHES["packet_closest"] += 1
    return t, u, v, prim


def occluded(bvh, ro, rd, tmin, tmax):
    """K3, any hit: whether any triangle lies in [tmin, tmax]. Returns [N] bool."""
    if not ro.is_cuda:
        return packet_plain(bvh, ro, rd, tmin, tmax, any_hit=True)
    n = _check(bvh, ro, rd, tmin, tmax)
    occ = torch.empty(n, dtype=torch.bool, device=ro.device)
    code = _lib().tt_packet_occluded(
        bvh.nodes.data_ptr(), bvh.tris.data_ptr(), ro.data_ptr(), rd.data_ptr(),
        tmin.data_ptr(), tmax.data_ptr(), n, occ.data_ptr(),
        torch.cuda.current_stream(ro.device).cuda_stream,
    )
    _launch.raise_on(_lib(), code, "packet any-hit kernel")
    _launch.LAUNCHES["packet_anyhit"] += 1
    return occ
