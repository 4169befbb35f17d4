"""K3's quantised node layout (geometry/packet.py::quantize_nodes) on the CPU:
decoded boxes contain the exact ones, empty and broken slots decode as
empty, the twin's answers do not change over the decoded boxes, a walk that
follows csrc/traverse.cu step for step agrees with the twin within the
stack bound, the twin's work counters match a hand count, and the scene
entry points build on the card unless asked for the CPU."""

import dataclasses
import inspect
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import take_tpu_torch
from take_tpu_torch.geometry import brute, packet
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.parse_xml import parse_scene_file
from take_tpu_torch.scene.types import BVHArrays
from tests.test_torch_cuda import chain_scene
from tests.torch_parity import one_torch_thread, port_soup  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOM = os.path.join(os.path.dirname(__file__), "..", "scenes", "room", "room.xml")
BIG = float(np.float32(packet.BIG))  # t of a miss, as float32 holds it


@pytest.fixture(scope="module")
def room_bvh():
    return parse_scene_file(ROOM, device="cpu").bvh


def _rays(n, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-spread, spread, (n, 3))
    d = rng.normal(size=(n, 3))
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.3, rng.uniform(1.0, 20.0, n), np.inf)
    tmax = np.where(rng.random(n) < 0.1, -BIG, tmax)
    tmax[:5] = -1.0  # padded lanes
    return [torch.tensor(a, dtype=torch.float32).contiguous() for a in (ro, rd, np.full(n, 1e-4), tmax)]


def _assert_contains(bvh):
    """Every non-empty child's decoded box contains its exact box, in float32."""
    lo, hi, child, count = (x.numpy() for x in (bvh.node_min, bvh.node_max, bvh.node_child, bvh.node_count))
    q, perm, index = packet.quantize_nodes(lo, hi, child, count)
    m = lo.shape[0]
    assert q.dtype == np.int32 and q.shape[1] == packet.QWORDS and q.itemsize * packet.QWORDS == 96
    assert m <= q.shape[0] <= 1 + 8 * m and index[0] == 0 and len(set(index.tolist())) == m
    np.testing.assert_array_equal(q, bvh.qnodes.numpy())
    dlo, dhi, ref = (a[index] for a in packet.decode_nodes(q))  # by node, in quantised slot order
    take = lambda a: np.take_along_axis(a, perm.reshape(*perm.shape, *[1] * (a.ndim - 2)), axis=1)
    elo, ehi, ec, en = take(lo), take(hi), take(child), take(count)
    filled = (ec >= 0) | (en > 0)
    assert ((ref != packet.EMPTY_REF) == filled).all()
    assert (dlo[filled] <= elo[filled]).all() and (dhi[filled] >= ehi[filled]).all()
    assert dlo.dtype == np.float32
    # the references: inner children by row, base + slot; leaves by start and count
    inner = filled & (ec >= 0)
    assert (ref[inner] == index[ec[inner]]).all()
    base = ref - np.arange(8)
    assert all(len(set(base[k][inner[k]].tolist())) <= 1 for k in range(m))
    unused = np.setdiff1d(np.arange(q.shape[0]), index)
    assert (q[unused, 16:24] == packet.EMPTY_REF).all()
    leaf = filled & (ec < 0)
    r = ref[leaf] & 0xFFFFFFFF
    assert ((r >> 31) == 1).all()
    assert ((r & ((1 << 26) - 1)) == -(ec[leaf] + 1)).all() and (((r >> 26) & 31) + 1 == en[leaf]).all()
    # each node's slots are a permutation of its original slots
    assert (np.sort(perm, axis=1) == np.arange(8)).all()
    return dlo, dhi, perm


def test_decoded_boxes_contain_exact_room(room_bvh):
    """room's BVH (105,998 triangles, 2,913 nodes): 96 bytes a row, 4,227
    rows with the empty ones, boxes contain."""
    _assert_contains(room_bvh)
    assert room_bvh.node_child.shape[0] == 2913 and room_bvh.qnodes.shape[0] == 4227


@pytest.mark.parametrize("n_tri,spread", [(40, 10.0), (1500, 10.0), (700, 1e4), (300, 1e-3)])
def test_decoded_boxes_contain_exact_soups(n_tri, spread):
    port = port_soup(n_tri, build_bvh=True, spread=spread, seed=n_tri)
    _assert_contains(port.bvh)


def test_empty_nan_and_inverted_slots_decode_empty():
    """A node with an empty slot, a NaN box and an inverted box beside
    normal children: the three decode as empty references, never as boxes."""
    lo = np.full((2, 8, 3), 3e38, np.float32)
    hi = np.full((2, 8, 3), -3e38, np.float32)
    child = np.full((2, 8), -1, np.int32)
    count = np.zeros((2, 8), np.int32)
    lo[0, 0], hi[0, 0], child[0, 0] = (0, 0, 0), (1, 1, 1), 1  # inner node 1
    lo[0, 1], hi[0, 1], child[0, 1], count[0, 1] = (2, 0, 0), (3, 1, 1), -1, 4  # leaf 0..3
    lo[0, 2], hi[0, 2], child[0, 2], count[0, 2] = (np.nan, 0, 0), (1, 1, 1), -5, 2  # NaN box
    lo[0, 3], hi[0, 3], child[0, 3], count[0, 3] = (5, 0, 0), (4, 1, 1), -7, 1  # inverted box
    lo[1, 0], hi[1, 0], child[1, 0], count[1, 0] = (0, 0, 0), (1, 1, 1), -8, 3
    q, perm, index = packet.quantize_nodes(lo, hi, child, count)
    ref = packet.decode_nodes(q)[2][index]
    orig = np.take_along_axis(np.broadcast_to(np.arange(8), (2, 8)), perm, axis=1)
    kept = {int(o) for o, r in zip(orig[0], ref[0]) if r != packet.EMPTY_REF}
    assert kept == {0, 1}
    assert (ref[1] != packet.EMPTY_REF).sum() == 1
    # an all-empty node quantises too, and decodes as nothing
    q2 = packet.quantize_nodes(lo[:1] * 0 + 3e38, hi[:1] * 0 - 3e38, child[:1] * 0 - 1, count[:1] * 0)
    assert (packet.decode_nodes(q2[0])[2] == packet.EMPTY_REF).all()


def _decoded_bvh(bvh):
    """bvh with every non-empty child's box replaced by its decoded box."""
    dlo, dhi, perm = _assert_contains(bvh)
    lo, hi = bvh.node_min.numpy().copy(), bvh.node_max.numpy().copy()
    rows = np.arange(perm.shape[0])[:, None]
    filled = ((bvh.node_child >= 0) | (bvh.node_count > 0)).numpy()
    dl, dh = np.empty_like(lo), np.empty_like(hi)
    dl[rows, perm], dh[rows, perm] = dlo, dhi
    lo[filled], hi[filled] = dl[filled], dh[filled]
    node_min, node_max = torch.from_numpy(lo), torch.from_numpy(hi)
    m = lo.shape[0]
    nodes = torch.cat([node_min, node_max, bvh.node_child.float()[..., None], bvh.node_count.float()[..., None]],
                      dim=2).reshape(m * 8, 8)
    return dataclasses.replace(bvh, node_min=node_min, node_max=node_max, nodes=nodes)


@pytest.mark.parametrize("n_tri", [300, 1500])
def test_twin_over_decoded_boxes_matches_exact(n_tri):
    """packet_plain over the decoded boxes gives the same (t, u, v, prim)
    and occlusion as over the exact boxes, bit for bit."""
    port = port_soup(n_tri, build_bvh=True, seed=3)
    r = _rays(3000, seed=n_tri)
    coarse = _decoded_bvh(port.bvh)
    for a, b in zip(packet.packet_plain(port.bvh, *r), packet.packet_plain(coarse, *r)):
        assert torch.equal(a, b)
    assert torch.equal(packet.packet_plain(port.bvh, *r, any_hit=True),
                       packet.packet_plain(coarse, *r, any_hit=True))
    w_exact, w_coarse = packet.packet_work(port.bvh, *r), packet.packet_work(coarse, *r)
    assert (w_coarse >= 0).all() and w_coarse[:, 0].sum() >= w_exact[:, 0].sum()


def _walk(bvh, ro, rd, tmin, tmax, any_hit):
    """One ray through csrc/traverse.cu's loop, in Python over the decoded
    nodes: (t, u, v, prim, the most stack entries held)."""
    lo, hi, ref = packet.decode_nodes(bvh.qnodes.numpy())
    inv = packet.inv_dir(rd[None])
    octant = int(rd[0] < 0) | int(rd[1] < 0) << 1 | int(rd[2] < 0) << 2
    best_t, best_u, best_v, best = BIG, 0.0, 0.0, -1
    stack, most, node = [], 0, 0
    if not tmax >= tmin:
        return BIG, 0.0, 0.0, -1, 0
    while True:
        tcap = torch.minimum(torch.tensor(best_t, dtype=torch.float32), tmax)
        hit, tlo = packet.slab(torch.from_numpy(lo[node])[None], torch.from_numpy(hi[node])[None],
                               ro[None], inv, tmin[None], tcap[None])
        inner = leaves = 0
        near_t, near_j = BIG, 0
        for j in range(8):
            if ref[node, j] != packet.EMPTY_REF and hit[0, j]:
                if ref[node, j] >= 0:
                    inner |= 1 << (j ^ octant)
                    if max(float(tlo[0, j]), float(tmin)) < near_t:
                        near_t, near_j = max(float(tlo[0, j]), float(tmin)), j
                else:
                    leaves |= 1 << (j ^ octant)
        for b in range(8):
            if leaves >> b & 1:
                r = int(ref[node, b ^ octant]) & 0xFFFFFFFF
                start, n = r & ((1 << 26) - 1), (r >> 26 & 31) + 1
                for prim in range(start, start + n):
                    t, u, v, inside = packet.affine_test(bvh.tris[prim], ro, rd)
                    if inside and tmin <= t <= tmax and t <= best_t and (t < best_t or prim < best):
                        best_t, best_u, best_v, best = float(t), float(u), float(v), prim
                        if any_hit:
                            return best_t, best_u, best_v, best, most
        if inner:  # enter the nearest, keep the rest as (base, mask)
            nxt = int(ref[node, near_j])
            inner &= ~(1 << (near_j ^ octant))
            if inner:
                stack.append((nxt - near_j, inner))
                most = max(most, len(stack))
            node = nxt
            continue
        if not stack:
            break
        base, mask = stack.pop()
        b = (mask & -mask).bit_length() - 1
        if mask & (mask - 1):
            stack.append((base, mask & (mask - 1)))
        node = base + (b ^ octant)
    ok = best_t <= float(tmax)
    return (best_t if ok else BIG), best_u, best_v, (best if ok else -1), most


def _assert_walk_matches_twin(bvh, r, n):
    t, u, v, prim = packet.packet_plain(bvh, *r)
    occ = packet.packet_plain(bvh, *r, any_hit=True)
    most = 0
    for i in range(n):
        wt, wu, wv, wp, deep = _walk(bvh, *(x[i] for x in r), any_hit=False)
        assert (wp, wt) == (int(prim[i]), float(t[i])), i
        if wp >= 0:
            assert (wu, wv) == (float(u[i]), float(v[i])), i
        assert (_walk(bvh, *(x[i] for x in r), any_hit=True)[3] >= 0) == bool(occ[i]), i
        most = max(most, deep)
    assert most <= packet.entry_bound(bvh.depth) - 1
    return most


def test_kernel_walk_matches_twin_on_soup():
    """The kernel's loop (the nearest hit inner child entered, the rest kept
    as one (base, mask) entry and taken in octant order, leaves as the node
    is visited) gives the twin's answers; its stack stays within
    entry_bound(depth) - 1 entries."""
    port = port_soup(700, build_bvh=True, seed=5)
    assert _assert_walk_matches_twin(port.bvh, _rays(160, seed=8), 160) >= 1


def test_deep_chain_traverses_fully():
    """A chain of nested boxes 20 levels deep, a side node at each level:
    the walk holds 19 entries and finds what the brute sweep finds."""
    scene = chain_scene(20, "cpu")
    assert scene.bvh.depth == 20 and packet.entry_bound(20) <= 32
    n = 40
    rng = np.random.default_rng(2)
    ro = np.column_stack([rng.uniform(0.0, 0.5, n), rng.uniform(0.0, 0.5, n), np.full(n, 21.0)])
    ro[n // 2:, 2] = -1.0
    rd = np.column_stack([rng.normal(0, 0.02, n), rng.normal(0, 0.02, n), np.where(np.arange(n) < n // 2, -1.0, 1.0)])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    r = [torch.tensor(a, dtype=torch.float32).contiguous() for a in (ro, rd, np.full(n, 1e-4), np.full(n, np.inf))]
    assert _assert_walk_matches_twin(scene.bvh, r, n) == 19
    g = scene.geometry
    _, t, _, _, _, prim = brute.closest_plain(g.tri_rows, g.tri_attr, scene.meta.n_tri, *r)
    tw, _, _, pw = packet.packet_plain(scene.bvh, *r)
    assert torch.equal(prim, pw) and torch.equal(t, tw)
    assert set(pw.tolist()) == {0, 19}


def test_work_counters_match_a_hand_count():
    """A root with an inner child (two leaves of 5 and 2 triangles) and a
    leaf of 3 triangles: per-ray node visits, slab tests and triangle tests."""
    lo = np.full((2, 8, 3), 3e38, np.float32)
    hi = np.full((2, 8, 3), -3e38, np.float32)
    child = np.full((2, 8), -1, np.int32)
    count = np.zeros((2, 8), np.int32)
    lo[0, 0], hi[0, 0], child[0, 0] = (0, 0, 0), (10, 1, 1), 1  # inner: x in [0, 10]
    lo[0, 1], hi[0, 1], child[0, 1], count[0, 1] = (0, 0, 0), (1, 1, 1), -1, 3  # leaf: x in [0, 1]
    lo[1, 0], hi[1, 0], child[1, 0], count[1, 0] = (4, 0, 0), (5, 1, 1), -4, 5  # leaf: x in [4, 5]
    lo[1, 1], hi[1, 1], child[1, 1], count[1, 1] = (8, 0, 0), (9, 1, 1), -9, 2  # leaf: x in [8, 9]
    tris = torch.zeros((10, 24))  # no triangle is ever hit (parallel rows)
    bvh = BVHArrays(*(torch.from_numpy(a) for a in (lo, hi, child, count)), cl_aabb=None, sup_aabb=None, depth=2)
    geometry = SimpleNamespace(tri_attr=torch.zeros((10, 32)), tri_affine_o=torch.zeros((12, 10)),
                               tri_affine_d=torch.zeros((9, 10)))
    bvh.nodes, tris, bvh.qnodes = packet.prep_tables(bvh, geometry)
    bvh.tris = tris
    # along +y at x = 0.5 (the root's leaf, then the inner node's two
    # missed leaves), x = 4.5 (the inner node's first leaf), x = 8.5 with
    # tmax 1.5 (its second), x = 20 (nothing), and a dead lane
    ro = torch.tensor([[0.5, -1, 0.5], [4.5, -1, 0.5], [8.5, -1, 0.5], [20, -1, 0.5], [4.5, -1, 0.5]])
    rd = torch.tensor([[0.0, 1, 0]] * 5)
    tmin = torch.full((5,), 1e-4)
    tmax = torch.tensor([np.inf, np.inf, 1.5, np.inf, -BIG])
    work = packet.packet_work(bvh, ro, rd, tmin, tmax)
    assert work.tolist() == [[2, 4, 3], [2, 4, 5], [2, 4, 2], [1, 2, 0], [0, 0, 0]]
    assert torch.equal(packet.packet_work(bvh, ro, rd, tmin, tmax, any_hit=True), work)


def test_scene_entry_points_default_to_the_card():
    """load_scene and SceneBuilder.build build on "cuda" unless asked for
    the CPU; without a card the default raises torch's own error."""
    for fn in (take_tpu_torch.load_scene, SceneBuilder.build):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cbox = os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox", "cbox.xml")
    scene = take_tpu_torch.load_scene(cbox, device="cpu")
    assert scene.geometry.tri_attr.device.type == "cpu"
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.add_material(0))
    assert b.build(device="cpu").background.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            b.build()
        with pytest.raises((AssertionError, RuntimeError)):
            take_tpu_torch.load_scene(cbox)
    else:
        assert b.build().background.is_cuda
