"""Wide-BVH traversal: the CUDA kernel K3 (closest and any hit) and its plain twin.

`closest` and `occluded` replace the JAX package's Pallas packet kernel
(take_tpu/geometry/pallas_traverse.py::_kernel, entry `packet_traverse`);
the CUDA source and its design note are in csrc/traverse.cu. The scene
builds their tables once, when it is uploaded (scene/types.py::
scene_from_numpy, through `prep_tables`), and keeps them in `scene.bvh`:
the exact node rows `nodes` (which the twin reads), the triangle rows
`tris`, and the kernel's quantised 96-byte nodes `qnodes`.

Dispatch is by the device of the rays: a CUDA tensor launches the kernel
(and raises if it cannot), a CPU tensor runs the plain twin
(`packet_plain`): a per-ray stack traversal in torch over the exact boxes,
near-first by entry distance, with the same affine leaf test on the same
rows and the same tie rule, a batch of rays at a time. `_launch.LAUNCHES`
counts what ran; `packet_work` counts, per ray, the node visits, slab tests
and triangle tests the twin makes (the work a bound is counted from).

The kernel keeps a stack of (base, mask of children still to visit)
entries, at most one per ancestor of the node it visits: a tree of wide
depth D needs `entry_bound(D)` = D entries. The stack's size is fixed when
the kernel is compiled; the wrapper raises when the tree needs more. The
twin pushes single nodes and sizes its own stack, `stack_bound(D)`.
"""

import ctypes

import numpy as np
import torch

from take_tpu_torch.geometry import _launch
from take_tpu_torch.geometry.bvh import LEAF_SIZE, WIDTH
from take_tpu_torch.scene.types import affine_rows

BIG = 3.4e38  # t of a miss
DW_EPS = 1e-12  # parallel-ray reject on the (u, v, w)-frame direction
INV_DIR_EPS = 1e-20  # |d| below this reads as 1e-20 in 1 / d
CHUNK = 1 << 16  # rays per batch of the plain twin (bounds its temporaries)

# The quantised node (`quantize_nodes`): 24 int32 words = 96 bytes
QWORDS = 24
EMPTY_REF = -1  # child reference of an empty slot
LEAF_START_BITS = 26  # a leaf reference: sign bit, count - 1 in 5 bits, start in 26
MAX_NODES = 1 << 24  # a stack entry holds a row index above an 8-bit mask


def stack_bound(depth: int) -> int:
    """Stack entries the twin's per-ray traversal of a tree of wide depth
    `depth` needs: a pop removes one node and pushes at most WIDTH."""
    return (WIDTH - 1) * depth + 1


def entry_bound(depth: int) -> int:
    """(base, mask) entries the kernel's stack holds for a tree of wide depth
    `depth`: one per ancestor with children left to visit, at most D - 1
    below a node at depth D, and one spare."""
    return depth


def prep_tables(bvh, geometry):
    """The kernel layouts of the BVH and triangle tables.

    Returns (nodes [M * WIDTH, 8] float32, tris [Tpad, 24] float32, qnodes
    [M', 24] int32), contiguous, on the device of the tables. nodes and tris
    are the counterpart of pallas_traverse.py::prep_tables: node rows (min
    xyz, max xyz, child, count), child and count as floats (exact below
    2^24); triangle rows (o_u[4], o_v[4], o_w[4], d_u[3], d_v[3], d_w[3], 0,
    0, 0), the affine maps of `tri_affine_o/d` in row form. qnodes is
    `quantize_nodes` of the same tree.
    """
    m = bvh.node_child.shape[0]
    nodes = torch.cat(
        [bvh.node_min, bvh.node_max,
         bvh.node_child.to(torch.float32)[..., None], bvh.node_count.to(torch.float32)[..., None]],
        dim=2,
    ).reshape(m * WIDTH, 8)
    tris = affine_rows(geometry.tri_affine_o, geometry.tri_affine_d)
    qnodes = quantize_nodes(*(x.cpu().numpy() for x in (bvh.node_min, bvh.node_max,
                                                        bvh.node_child, bvh.node_count)))[0]
    return nodes.contiguous(), tris, torch.from_numpy(qnodes).to(nodes.device)


# ---------------------------------------------------------------------------
# Quantised nodes
# ---------------------------------------------------------------------------


def _decode(origin, scale, q):
    """The kernel's decoding of 8-bit values: fl32(origin + q * scale), one
    rounding (q * scale is exact: q < 256, scale a power of two)."""
    return np.float32(origin) + q.astype(np.float32) * np.float32(scale)


def _octant_slots(lo, hi, ok):
    """[M, WIDTH] slot order of each node: quantised slot s holds the child
    whose box centre lies farthest along (+-1, +-1, +-1), bit k of s set
    meaning + on axis k (a greedy assignment, best pair first). A ray whose
    direction has sign bits `oct` (bit k set where d_k < 0) visits slots
    in the order s ^ oct = 0, 1, ..., roughly near first (Ylitie, Karras
    and Laine, HPG 2017). Children that are not `ok` take the slots left."""
    m = lo.shape[0]
    centre = np.where(ok[..., None], 0.5 * (lo.astype(np.float64) + hi), 0.0)
    node_c = centre.sum(1) / np.maximum(ok.sum(1), 1)[:, None]
    signs = np.array([[1.0 if s >> k & 1 else -1.0 for k in range(3)] for s in range(WIDTH)])
    score = np.einsum("mck,sk->mcs", centre - node_c[:, None], signs)
    score = np.where(ok[..., None], score, -1e300)  # after every real child
    perm = np.zeros((m, WIDTH), np.int64)
    rows = np.arange(m)
    for _ in range(WIDTH):
        flat = score.reshape(m, -1).argmax(1)
        c, s = flat // WIDTH, flat % WIDTH
        perm[rows, s] = c
        score[rows, c, :] = -np.inf
        score[rows, :, s] = -np.inf
    return perm


def quantize_nodes(node_min, node_max, node_child, node_count):
    """The kernel's 96-byte nodes (Ylitie, Karras and Laine's compressed wide
    node, with 32-bit child references). Returns (qnodes [M', 24] int32,
    perm [M, WIDTH]: the original slot of each quantised slot, index [M]:
    the row of each node in qnodes).

    The rows are numbered so that the inner child in quantised slot j of a
    node is row base + j, base the node's own (the kernel's stack entries
    hold base and a mask of slots); rows no node takes are empty nodes, so
    M' <= 1 + WIDTH M.

    Words 0-2: the node's origin (float32), the least corner of its
    children; word 3: the biased float32 exponent of each axis's scale
    (a power of two) in bytes 0-2; words 4-15: for x, y, z in turn, the
    children's 8-bit minima (8 bytes) then maxima, slot j in byte j; words
    16-23: the children's references (`EMPTY_REF`; an inner node's row;
    a leaf's INT_MIN | (count - 1) << 26 | start).

    A bound decodes as fl32(origin + q * scale). Each q is chosen by its
    decoded value, not by a formula: the largest q whose decoded minimum
    is <= the exact minimum, the least q whose decoded maximum is >= the
    exact maximum, so that every decoded box contains its exact box in
    float32. The slab test is monotone in its box, so a ray enters every
    child the exact boxes let it enter, and the winner does not change.
    Empty slots, and children with a NaN or inverted box (which the exact
    slab test never enters, or which no build makes), are empty.
    """
    lo = np.asarray(node_min, np.float32)
    hi = np.asarray(node_max, np.float32)
    child = np.asarray(node_child, np.int64)
    count = np.asarray(node_count, np.int64)
    m = lo.shape[0]
    filled = (child >= 0) | (count > 0)
    ok = filled & (lo <= hi).all(-1)
    if not np.isfinite(np.where(ok[..., None], np.concatenate([lo, hi], -1), 0.0)).all():
        raise ValueError("a BVH child box has an infinite bound: it cannot be quantised")
    start = -(child + 1)
    if ((count > 32) | (ok & (child < 0) & (start + count >= (1 << LEAF_START_BITS) - 32))).any():
        raise ValueError("a BVH leaf lies beyond the kernel's 26-bit start or holds more than 32 triangles")
    perm = _octant_slots(lo, hi, ok)
    take = lambda a: np.take_along_axis(a, perm.reshape(m, WIDTH, *[1] * (a.ndim - 2)), axis=1)
    lo, hi, child, count, ok = (take(a) for a in (lo, hi, child, count, ok))

    origin = np.where(ok[..., None], lo, np.inf).min(1)  # [M, 3]
    top = np.where(ok[..., None], hi, -np.inf).max(1)
    empty_node = ~ok.any(1)
    origin[empty_node], top[empty_node] = 0.0, 0.0
    ext = top.astype(np.float64) - origin
    e = np.where(ext > 0, np.ceil(np.log2(np.maximum(ext, 1e-300) / 255.0)), -126)
    e = np.clip(e, -126, 127).astype(np.int64)
    while True:  # the least scale whose 255 decodes at or beyond the top
        short = _decode(origin, np.ldexp(1.0, e), np.full(e.shape, 255)) < top
        if not short.any():
            break
        if (e[short] >= 127).any():
            raise ValueError("a BVH node is too large to quantise")
        e = e + short
    scale = np.ldexp(1.0, e)[:, None, :]  # [M, 1, 3]
    o = origin[:, None, :]

    def search(exact, q, down):
        """Largest q with decode <= exact (down), or least with decode >= exact."""
        q = np.clip(q, 0, 255).astype(np.int64)
        while True:
            dec = _decode(o, scale, q)
            if down:
                step = np.where(dec > exact, -1, np.where((q < 255) & (_decode(o, scale, q + 1) <= exact), 1, 0))
            else:
                step = np.where(dec < exact, 1, np.where((q > 0) & (_decode(o, scale, q - 1) >= exact), -1, 0))
            step = np.where(ok[..., None], step, 0)
            if not step.any():
                return q
            q = q + step

    safe_lo, safe_hi = np.where(ok[..., None], lo, o), np.where(ok[..., None], hi, o)
    qlo = search(safe_lo, np.floor((safe_lo - o) / scale), True)
    qhi = search(safe_hi, np.ceil((safe_hi - o) / scale), False)
    qlo, qhi = np.where(ok[..., None], qlo, 0), np.where(ok[..., None], qhi, 0)

    index = np.full(m, -1, np.int64)  # breadth first from the root
    index[0], rows, queue = 0, 1, [0]
    for node in queue:
        slots = np.nonzero(ok[node] & (child[node] >= 0))[0]
        if slots.size:
            index[child[node, slots]] = rows + slots
            rows += int(slots.max()) + 1
            queue.extend(child[node, slots].tolist())
    if rows >= MAX_NODES:
        raise ValueError(f"{rows} quantised BVH nodes: the kernel's stack entries hold fewer than {MAX_NODES}")
    leaf_ref = -(1 << 31) | (count - 1) << LEAF_START_BITS | np.clip(-(child + 1), 0, None)
    ref = np.where(child >= 0, index[np.clip(child, 0, None)], leaf_ref)
    ref = np.where(ok, ref, EMPTY_REF)
    words = np.zeros((m, QWORDS), np.int64)
    words[:, 0:3] = origin.astype(np.float32).view(np.int32)
    words[:, 3] = (e[:, 0] + 127) | (e[:, 1] + 127) << 8 | (e[:, 2] + 127) << 16
    for k in range(3):
        for part, q in enumerate((qlo[..., k], qhi[..., k])):
            b = q.reshape(m, 2, 4) << (8 * np.arange(4))
            words[:, 4 + 4 * k + 2 * part:6 + 4 * k + 2 * part] = b.sum(-1)
    words[:, 16:24] = ref
    table = np.zeros((rows, QWORDS), np.int64)
    table[:, 16:24] = EMPTY_REF
    reached = index >= 0  # a node under a NaN or inverted box is never entered
    table[index[reached]] = words[reached]
    qnodes = (table & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return np.ascontiguousarray(qnodes), perm, index


def decode_nodes(qnodes):
    """The kernel's reading of `quantize_nodes`: (lo, hi [M, WIDTH, 3]
    float32, ref [M, WIDTH] int64) in quantised slot order."""
    w = np.asarray(qnodes).view(np.uint32).astype(np.int64)
    m = w.shape[0]
    origin = w[:, 0:3].astype(np.uint32).view(np.float32)
    scale = np.ldexp(np.float32(1.0), ((w[:, 3:4] >> (8 * np.arange(3))) & 0xFF) - 127).astype(np.float32)

    def q(word):
        return (w[:, word:word + 2, None] >> (8 * np.arange(4))).reshape(m, WIDTH) & 0xFF

    lo = np.stack([_decode(origin[:, None, k], scale[:, None, k], q(4 + 4 * k)) for k in range(3)], -1)
    hi = np.stack([_decode(origin[:, None, k], scale[:, None, k], q(6 + 4 * k)) for k in range(3)], -1)
    ref = np.asarray(qnodes)[:, 16:24].astype(np.int64)
    return lo, hi, ref


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


def _traverse_chunk(bvh, ro, rd, tmin, tmax, any_hit, work=None):
    """Per-ray stack traversal of one batch -> (t, u, v, prim). With `work`
    ([n, 3] int64), adds each ray's node visits, slab tests (the visited
    nodes' non-empty slots) and triangle tests (the triangles of the hit
    leaves) to it."""
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
        if work is not None:
            work[act, 0] += 1
            work[act, 1] += ((child >= 0) | (count > 0)).sum(dim=1)
            work[act, 2] += torch.where(leaf, count, 0).sum(dim=1)

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


def packet_work(bvh, ro, rd, tmin, tmax, any_hit=False):
    """[N, 3] int64 per-ray work of the twin's traversal: node visits, slab
    tests and triangle tests (see `_traverse_chunk`). Any hit stops after
    the node of its first hit, whose hit leaves are all counted."""
    work = torch.zeros((ro.shape[0], 3), dtype=torch.int64, device=ro.device)
    for s in range(0, ro.shape[0], CHUNK):
        _traverse_chunk(bvh, ro[s:s + CHUNK], rd[s:s + CHUNK], tmin[s:s + CHUNK], tmax[s:s + CHUNK], any_hit,
                        work[s:s + CHUNK])
    return work


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


_lib = _launch.declare("traverse", {
    "tt_packet_closest": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "tt_packet_occluded": [_P, _P, _P, _P, _P, _P, _I, _P, _P],
    "tt_packet_stack_size": [],
}, launches=_launch.LAUNCHES)


def _check(bvh, ro, rd, tmin, tmax):
    n = _launch.check_rays(ro, rd, tmin, tmax)
    _launch.check("bvh.qnodes", bvh.qnodes, torch.int32, (bvh.qnodes.shape[0], QWORDS), ro.device)
    tpad = bvh.tris.shape[0]
    _launch.check("bvh.tris", bvh.tris, torch.float32, (tpad, 24), ro.device)
    need, have = entry_bound(bvh.depth), _lib().tt_packet_stack_size()
    if need > have:
        raise RuntimeError(
            f"BVH of wide depth {bvh.depth} needs a traversal stack of {need} entries; "
            f"the kernel holds {have}"
        )
    return n


def _launch_args(bvh, ro, rd, tmin, tmax, n):
    return (bvh.qnodes.data_ptr(), bvh.tris.data_ptr(), ro.data_ptr(), rd.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), n)


def closest(bvh, ro, rd, tmin, tmax):
    """K3: closest hit of each ray in [tmin, tmax] through the wide BVH.

    Args:
        bvh: the scene's BVHArrays (`qnodes`, `tris`, `depth` set).
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
        *_launch_args(bvh, ro, rd, tmin, tmax, n), t.data_ptr(), u.data_ptr(), v.data_ptr(), prim.data_ptr(),
        torch.cuda.current_stream(ro.device).cuda_stream,
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
        *_launch_args(bvh, ro, rd, tmin, tmax, n), occ.data_ptr(), torch.cuda.current_stream(ro.device).cuda_stream,
    )
    _launch.raise_on(_lib(), code, "packet any-hit kernel")
    _launch.LAUNCHES["packet_anyhit"] += 1
    return occ
