"""Wide-BVH construction (host-side numpy), copied from take_tpu/geometry/bvh.py.

A copy, because importing take_tpu pulls in JAX: binned-SAH binary build,
collapsed into a WIDTH-ary tree whose leaves reference contiguous runs of
reordered triangles, plus the cluster and supercluster AABB tables of the
streaming cluster sweep (geometry/cluster.py). Both packages build the same
tables bit for bit from the same triangles (tests/test_torch_bvh.py).
`wide_depth` is the port's addition: the traversal kernels size their
per-ray stacks from it (geometry/packet.py).
"""

from dataclasses import dataclass

import numpy as np

WIDTH = 8  # children per node
LEAF_SIZE = 16  # max primitives per leaf

# Streaming group-sweep pipeline granularities (geometry/cluster.py).
# Clusters are consecutive runs of CLUSTER_K Morton-ordered triangles;
# superclusters group SUP consecutive clusters (the HBM->VMEM DMA granule);
# the sweep kernel slab-tests GROUP consecutive superclusters per aligned
# VMEM read.
CLUSTER_K = 64
SUP = 8
GROUP = 8


def cluster_pad(n_tri: int) -> int:
    """Padded cluster count: covers n_tri and is a multiple of SUP."""
    C = max(1, -(-n_tri // CLUSTER_K))
    return max(SUP, -(-C // SUP) * SUP)


def cluster_aabbs(bmin: np.ndarray, bmax: np.ndarray, n_tri: int):
    """(cl_aabb [Cpad, 8], sup_aabb [SupP, 8]) AABB tables, rows =
    (min.xyz, max.xyz, 0, 0), over runs of Morton-ordered triangles.
    bmin/bmax are per-triangle AABBs in final (reordered) order, length
    >= n_tri. SupP = Cpad/SUP rounded up to a multiple of GROUP.

    Padding rows (clusters beyond the last valid one; supercluster rows
    beyond the last valid supercluster) are all-NaN: NaN comparisons are
    false, so the kernels' slab tests can never hit them. (Inverted boxes
    do NOT work for this — per-axis min/max of the two plane distances
    turns an inverted box into an all-space box that hits every ray.)"""
    C = max(1, -(-n_tri // CLUSTER_K))
    Cpad = cluster_pad(n_tri)
    out = np.full((Cpad, 8), np.nan, np.float32)
    for c in range(C):
        s, e = c * CLUSTER_K, min((c + 1) * CLUSTER_K, n_tri)
        if e > s:
            out[c, 0:3] = bmin[s:e].min(axis=0)
            out[c, 3:6] = bmax[s:e].max(axis=0)
            out[c, 6:8] = 0.0
    Csup = Cpad // SUP
    SupP = max(GROUP, -(-Csup // GROUP) * GROUP)
    sup = np.full((SupP, 8), np.nan, np.float32)
    n_valid_sup = -(-C // SUP)  # sups containing at least one valid cluster
    for s_id in range(n_valid_sup):
        lo, hi = s_id * SUP, min(s_id * SUP + SUP, C)
        sup[s_id, 0:3] = out[lo:hi, 0:3].min(axis=0)
        sup[s_id, 3:6] = out[lo:hi, 3:6].max(axis=0)
        sup[s_id, 6:8] = 0.0
    return out, sup


@dataclass
class _BuildNode:
    lo: int  # primitive range start (in sorted order)
    hi: int  # primitive range end
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    children: list  # empty = leaf


def _morton3(x, y, z):
    """30-bit Morton code from 10-bit quantized coordinates."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (spread(x) << 2) | (spread(y) << 1) | spread(z)


_SAH_BINS = 16


def _build_binary(order, centers, bmin, bmax, lo, hi, depth=0):
    """Top-down binned-SAH split; returns a _BuildNode.

    Quality matters directly on TPU: the packet kernel sweeps every leaf
    ANY ray in a block touches, so false-positive leaf visits multiply by
    the block width. Binned SAH (16 bins, all 3 axes) cuts visited leaves
    ~2-3x vs the earlier Morton median split. Partitioning reorders
    `order` in place, so the final primitive order is DFS leaf order —
    spatially coherent, which is what the supercluster tables want too.
    """
    idx = order[lo:hi]
    node_min = bmin[idx].min(axis=0)
    node_max = bmax[idx].max(axis=0)
    n = hi - lo
    if n <= LEAF_SIZE:
        return _BuildNode(lo, hi, node_min, node_max, [])

    c = centers[idx]
    c_lo = c.min(axis=0)
    c_ext = c.max(axis=0) - c_lo
    best = None  # (cost, going_left mask)
    # depth cap: SAH can chain unbalanced splits; beyond it median splits
    # guarantee O(log n) remaining depth (keeps traversal stacks bounded)
    axes = range(3) if depth < 48 else ()
    for axis in axes:
        if c_ext[axis] <= 1e-12:
            continue
        bins = np.minimum(
            (((c[:, axis] - c_lo[axis]) / c_ext[axis]) * _SAH_BINS).astype(
                np.int64
            ),
            _SAH_BINS - 1,
        )
        counts = np.bincount(bins, minlength=_SAH_BINS)
        # per-bin bounds via scatter-min/max
        bb_lo = np.full((_SAH_BINS, 3), np.inf)
        bb_hi = np.full((_SAH_BINS, 3), -np.inf)
        np.minimum.at(bb_lo, bins, bmin[idx])
        np.maximum.at(bb_hi, bins, bmax[idx])

        def areas(lo_c, hi_c):
            e = np.maximum(hi_c - lo_c, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        # prefix (left of boundary b = bins 0..b) and suffix accumulations
        pre_lo = np.minimum.accumulate(bb_lo, axis=0)
        pre_hi = np.maximum.accumulate(bb_hi, axis=0)
        suf_lo = np.minimum.accumulate(bb_lo[::-1], axis=0)[::-1]
        suf_hi = np.maximum.accumulate(bb_hi[::-1], axis=0)[::-1]
        nl = np.cumsum(counts)[:-1]
        nr = n - nl
        cost = areas(pre_lo[:-1], pre_hi[:-1]) * nl + areas(
            suf_lo[1:], suf_hi[1:]
        ) * nr
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        b = int(np.argmin(cost))
        if np.isfinite(cost[b]) and (best is None or cost[b] < best[0]):
            best = (cost[b], bins <= b)

    if best is None:
        going_left = np.zeros(n, bool)
        going_left[: n // 2] = True  # degenerate: median fallback
    else:
        going_left = best[1]
        if not going_left.any() or going_left.all():
            going_left = np.zeros(n, bool)
            going_left[: n // 2] = True
    # stable partition in place
    order[lo:hi] = np.concatenate([idx[going_left], idx[~going_left]])
    mid = lo + int(going_left.sum())
    left = _build_binary(order, centers, bmin, bmax, lo, mid, depth + 1)
    right = _build_binary(order, centers, bmin, bmax, mid, hi, depth + 1)
    return _BuildNode(lo, hi, node_min, node_max, [left, right])


def _collapse_wide(node):
    """Collapse a binary tree into WIDTH-ary by pulling up grandchildren."""
    if not node.children:
        return node
    kids = list(node.children)
    # greedily expand the child with the largest surface area until WIDTH
    while len(kids) < WIDTH:
        best = None
        for i, k in enumerate(kids):
            if k.children:
                area = np.prod(np.maximum(k.bbox_max - k.bbox_min, 0) + 1e-9)
                if best is None or area > best[1]:
                    best = (i, area)
        if best is None:
            break
        i = best[0]
        expanded = kids.pop(i)
        kids.extend(expanded.children)
    node.children = [_collapse_wide(k) for k in kids]
    return node


def build_bvh(bbox_min: np.ndarray, bbox_max: np.ndarray):
    """Build a wide BVH over primitives with the given AABBs.

    Returns (node_min [M,W,3], node_max [M,W,3], node_child [M,W],
    node_count [M,W], prim_order [P]):
      * node_child[m, w] >= 0: internal child node index,
      * node_child[m, w] < 0 with node_count > 0: leaf — primitives
        prim_order[-(child+1) : -(child+1)+count],
      * node_count[m, w] == 0 and child == -1: empty slot.
    """
    P = bbox_min.shape[0]
    centers = 0.5 * (bbox_min + bbox_max)
    lo = centers.min(axis=0)
    ext = np.maximum(centers.max(axis=0) - lo, 1e-12)
    q = np.clip(((centers - lo) / ext * 1023.0), 0, 1023).astype(np.uint32)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int64)

    root = _build_binary(order, centers, bbox_min, bbox_max, 0, P)
    root = _collapse_wide(root)

    # flatten breadth-first
    nodes = []

    def alloc(node):
        idx = len(nodes)
        nodes.append(node)
        return idx

    alloc(root)
    i = 0
    while i < len(nodes):
        for k in nodes[i].children:
            if k.children:
                alloc(k)
        i += 1

    # assign indices
    index_of = {}
    for idx, nd in enumerate(nodes):
        index_of[id(nd)] = idx

    M = len(nodes)
    node_min = np.zeros((M, WIDTH, 3), np.float32)
    node_max = np.zeros((M, WIDTH, 3), np.float32)
    node_child = np.full((M, WIDTH), -1, np.int32)
    node_count = np.zeros((M, WIDTH), np.int32)
    # empty slots get inverted boxes so every slab test misses
    node_min[:] = np.float32(3e38)
    node_max[:] = np.float32(-3e38)

    for idx, nd in enumerate(nodes):
        for w, k in enumerate(nd.children):
            node_min[idx, w] = k.bbox_min
            node_max[idx, w] = k.bbox_max
            if k.children:
                node_child[idx, w] = index_of[id(k)]
            else:
                node_child[idx, w] = -(k.lo + 1)
                node_count[idx, w] = k.hi - k.lo
    if not root.children:
        # tiny scene: root itself is a leaf — encode as single-slot node
        node_min[0, 0] = root.bbox_min
        node_max[0, 0] = root.bbox_max
        node_child[0, 0] = -(root.lo + 1)
        node_count[0, 0] = root.hi - root.lo

    return node_min, node_max, node_child, node_count, order


def wide_depth(node_child: np.ndarray) -> int:
    """Levels of internal nodes on the longest root-to-leaf path (root = 1).

    Nodes are numbered breadth-first, so a child's index exceeds its
    parent's and one forward pass settles every depth.
    """
    depth = np.zeros(node_child.shape[0], np.int64)
    depth[0] = 1
    for m, row in enumerate(node_child):
        for c in row[row >= 0]:
            depth[c] = depth[m] + 1
    return int(depth.max())
