"""K1/K2's row tables and loop (csrc/brute.cu) on the CPU.

`geometry.tri_rows` holds the affine tables `tri_affine_o/d` bit for bit,
one row a triangle (a BVH scene shares `bvh.tris`). `mirror` follows the
kernels' loop in torch with the plain twin's arithmetic: R rays a thread,
warps of 32 lanes, the dead-warp skip, the per-warp exit of the any-hit
sweep (voted every few triangles), and the kernels' form of the range test (lo <= t < hi, u + v <= 1),
which must agree with the twin's pair by pair. It must equal
`closest_plain` / `occluded_plain` bit for bit, on rays made to sit on the
test's edges: s_w = +-0 at tmin = 0, |d_w| at 1e-12, t at each end of
[tmin, tmax] and overflowing to +-inf, infinite and NaN ranges, exact-t
ties, zero rows, dead, padded and NaN lanes, and n not a multiple of the
block. The kernels themselves are held to the reference kernel and the
twins on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch

from take_tpu_torch.geometry import brute
from take_tpu_torch.scene.parse_xml import parse_scene_file
from take_tpu_torch.scene.types import ATTR_DIM
from tests.torch_parity import CBOX, port_soup

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
SOURCE = os.path.join(os.path.dirname(__file__), "..", "take_tpu_torch", "csrc", "brute.cu")


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", open(SOURCE).read()).group(1))


THREADS, GROUP = _constant("kThreads"), _constant("kGroup")  # the kernels' shape
RAYS = {False: 1, True: _constant("kAnyHitRays")}  # rays a thread, by any_hit
WARP = 32


@pytest.mark.parametrize("which", ["cbox", "mis", "soup", "bvh"])
def test_tri_rows_hold_the_affine_tables(which):
    if which in ("cbox", "mis"):
        scene = parse_scene_file(CBOX if which == "cbox" else os.path.join(SCENES, "mis", "mis.xml"), device="cpu")
    else:
        scene = port_soup(300, build_bvh=which == "bvh")
    g = scene.geometry
    o, d = g.tri_affine_o.numpy(), g.tri_affine_d.numpy()
    tpad = o.shape[1] // 3
    want = np.zeros((tpad, brute.ROW), np.float32)
    for k in range(3):  # u, v, w
        want[:, 4 * k:4 * k + 4] = o[:, k * tpad:(k + 1) * tpad].T
        want[:, 12 + 3 * k:15 + 3 * k] = d[:, k * tpad:(k + 1) * tpad].T
    rows = g.tri_rows
    assert rows.dtype == torch.float32 and rows.is_contiguous() and tuple(rows.shape) == (tpad, brute.ROW)
    np.testing.assert_array_equal(rows.numpy().view(np.int32), want.view(np.int32))
    assert tpad > scene.meta.n_tri and not rows[scene.meta.n_tri:].any()  # zero padding rows
    if which == "bvh":
        assert rows is scene.bvh.tris
    else:
        assert scene.bvh is None


FLT_MAX = float(torch.finfo(torch.float32).max)


def _range(tmin, tmax):
    """brute.cu's load_ray: a dead ray's tmax is -inf, and [lo, hi) is the
    set of t that pass t - tmin >= 0 and tmax - t >= 0."""
    tmax = torch.where(tmax > 0, tmax, -torch.inf)
    lo = torch.where(tmin == -torch.inf, -FLT_MAX, tmin)
    return tmax, lo, torch.nextafter(tmax, torch.tensor(torch.inf))


def mirror(rows, attr, n_tri, ro, rd, tmin, tmax, any_hit=False):
    """The kernels' loop in torch. Ray i of thread (block b, thread h) slot k
    is b * R * THREADS + k * THREADS + h (R rays a thread); a warp whose
    rays are all dead skips the sweep, and in the any-hit sweep a warp
    leaves once its rays are all answered, as it finds every GROUP
    triangles. The test is the kernels' form: not parallel, u >= 0,
    v >= 0, u + v <= 1, lo <= t < hi, with K1's hi its best t so far (at
    first min(3.4e38, the float above tmax)). Returns closest_plain's
    tuple, or occluded_plain's answer with any_hit."""
    n = ro.shape[0]
    block = RAYS[any_hit] * THREADS
    m = -(-max(n, 1) // block) * block
    pad = m - n
    ro, rd, tmin = (torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) for x in (ro, rd, tmin))
    tmax, lo, hi = _range(tmin, torch.cat([tmax, tmax.new_full((pad,), -1.0)]))
    t, u, v, ok = brute.tri_uvt(rows, n_tri, ro, rd, tmin, tmax)  # [m, T], the twin's arithmetic
    r = rows[:n_tri]
    dw = r[:, 18] * rd[:, 0:1] + r[:, 19] * rd[:, 1:2] + r[:, 20] * rd[:, 2:3]
    inside = ~(dw.abs() < brute.DW_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    assert torch.equal(inside & (t >= lo[:, None]) & (t < hi[:, None]), ok)  # the forms agree pair by pair
    shape = (m // block, RAYS[any_hit], THREADS // WARP, WARP)  # (block, slot, warp, lane)
    live = tmax > 0

    def per_warp(x, reduce):
        return reduce(x.reshape(shape), dim=(1, 3), keepdim=True).expand(shape).reshape(m)

    awake = per_warp(live, torch.any)
    if any_hit:
        occ = torch.zeros(m, dtype=torch.bool)
        for j in range(n_tri):
            if j % GROUP == 0:
                sweeping = awake & ~per_warp(occ | ~live, torch.all)
            occ = occ | (sweeping & inside[:, j] & (t[:, j] >= lo) & (t[:, j] < hi))
        return occ[:n]
    best_t = torch.minimum(torch.tensor(brute.BIG), hi)
    best_u, best_v = torch.zeros(m), torch.zeros(m)
    best = torch.full((m,), -1, dtype=torch.int64)
    for j in range(n_tri):
        win = awake & inside[:, j] & (t[:, j] >= lo) & (t[:, j] < best_t)
        best_t = torch.where(win, t[:, j], best_t)
        best_u = torch.where(win, u[:, j], best_u)
        best_v = torch.where(win, v[:, j], best_v)
        best = torch.where(win, j, best)
    best_t = torch.where(best >= 0, best_t, brute.BIG)
    best_t, best_u, best_v, best = best_t[:n], best_u[:n], best_v[:n], best[:n]
    attrs = torch.where((best >= 0)[:, None], attr[best.clamp(min=0)], 0.0)
    return attrs, best_t, best_u, best_v, best >= 0, best.to(torch.int32)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same(got, want):
    if isinstance(got, torch.Tensor):
        assert torch.equal(got, want)
        return
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


def _plane_rows():
    """Hand-made rows: the unit triangle of the plane z = 0 (s_w = o_z, whose
    constant is -0, so s_w = -0 where o_z = -0), its duplicate (an exact-t
    tie), a neighbour sharing its hypotenuse, a zero row, and a tilted
    triangle below them."""
    rows = torch.zeros((8, brute.ROW))

    def tri(i, ou, ov, ow, du, dv, dw):
        rows[i, 0:4], rows[i, 4:8], rows[i, 8:12] = (torch.tensor(x) for x in (ou, ov, ow))
        rows[i, 12:15], rows[i, 15:18], rows[i, 18:21] = (torch.tensor(x) for x in (du, dv, dw))

    unit = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, -0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
            (0.0, 0.0, 1.0))
    tri(0, *unit)
    tri(1, *unit)
    # u' = 1 - x, v' = 1 - y: the triangle across the hypotenuse x + y = 1
    tri(2, (-1.0, 0.0, 0.0, 1.0), (0.0, -1.0, 0.0, 1.0), (0.0, 0.0, 1.0, -0.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
        (0.0, 0.0, 1.0))
    # row 3 stays zero: |d_w| = 0 < 1e-12 rejects it
    tri(4, (1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0), (0.0, 0.25, 1.0, 0.5), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
        (0.0, 0.25, 1.0))
    attr = torch.arange(8 * ATTR_DIM, dtype=torch.float32).reshape(8, ATTR_DIM)
    return rows, attr, 5


def _edge_rays(n=1000, seed=0):
    """Rays at the skip's and the test's edges, in a batch of n (not a
    multiple of the block), with dead, padded and NaN lanes."""
    rng = np.random.default_rng(seed)
    ro = np.column_stack([rng.uniform(-0.5, 1.5, n), rng.uniform(-0.5, 1.5, n), rng.uniform(-2.0, 2.0, n)])
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.where(rng.random(n) < 0.5, 0.0, 1e-4)
    tmax = np.where(rng.random(n) < 0.5, np.inf, rng.uniform(0.01, 5.0, n))
    ro, rd, tmin, tmax = (torch.tensor(a, dtype=torch.float32) for a in (ro, rd, tmin, tmax))
    q = n // 10
    ro[:q, 2] = torch.where(torch.arange(q) % 2 == 0, 0.0, -0.0)  # s_w = +-0 ...
    tmin[:q] = torch.where(torch.arange(q) % 4 < 2, 0.0, 1e-4)  # ... at tmin = 0 and > 0
    eps = torch.tensor(1e-12, dtype=torch.float32)
    near = torch.stack([torch.nextafter(eps, torch.tensor(0.0)), eps, torch.nextafter(eps, torch.tensor(1.0))])
    sl = slice(q, 2 * q)  # |d_w| at 1e-12, either side, either sign
    rd[sl, 2] = near[torch.arange(q) % 3] * torch.where(torch.arange(q) % 2 == 0, 1.0, -1.0)
    ro[sl, 2] = -rd[sl, 2] * 0.5  # t = 0.5, inside the unit triangle
    ro[sl, :2], rd[sl, :2] = 0.25, 0.0
    sl = slice(2 * q, 3 * q)  # straight down onto the hypotenuse or a vertex: ties between rows 0 and 2
    x = torch.tensor(rng.uniform(0.0, 1.0, q), dtype=torch.float32)
    ro[sl, 0], ro[sl, 1], ro[sl, 2] = x, 1.0 - x, 1.0
    ro[2 * q:2 * q + 5, :2] = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [0.25, 0.75]])
    rd[sl] = torch.tensor([0.0, 0.0, -1.0])
    sl = slice(5 * q, 6 * q)  # straight down onto the plane at t = 1, at each end of the range
    ro[sl], rd[sl] = torch.tensor([0.25, 0.25, 1.0]), torch.tensor([0.0, 0.0, -1.0])
    one = torch.tensor(1.0)
    ends = torch.stack([one, torch.nextafter(one, torch.tensor(0.0)), torch.nextafter(one, torch.tensor(2.0))])
    tmin[sl] = torch.cat([ends, torch.tensor([0.0, -torch.inf, torch.inf])])[torch.arange(q) % 6]
    tmax[sl] = torch.cat([ends, torch.tensor([torch.inf, FLT_MAX, float("nan")])])[torch.arange(q) // 6 % 6]
    sl = slice(6 * q, 6 * q + 20)  # t overflows to +-inf
    ro[sl, 2] = torch.where(torch.arange(20) % 2 == 0, 1e30, -1e30)
    rd[sl] = torch.tensor([0.0, 0.0, 1e-11])
    tmin[sl], tmax[sl] = -torch.inf, torch.inf
    tmax[3 * q:3 * q + 50] = -3.4e38  # dead
    ro[3 * q + 50:3 * q + 100], rd[3 * q + 50:3 * q + 100], tmax[3 * q + 50:3 * q + 100] = 0.0, 0.0, -1.0  # padded
    ro[3 * q + 100:3 * q + 105, 0] = float("nan")
    rd[3 * q + 105:3 * q + 110, 2] = float("nan")
    return [x.contiguous() for x in (ro, rd, tmin, tmax)]


@pytest.mark.parametrize("any_hit", [False, True])
def test_mirror_equals_the_twins_on_edge_rays(any_hit):
    rows, attr, n_tri = _plane_rows()
    rays = _edge_rays()
    twin = brute.occluded_plain(rows, n_tri, *rays) if any_hit else brute.closest_plain(rows, attr, n_tri, *rays)
    _assert_same(mirror(rows, attr, n_tri, *rays, any_hit=any_hit), twin)
    if not any_hit:  # the edges were reached
        t, prim = twin[1], twin[5]
        q = rays[0].shape[0] // 10
        assert (prim[:q] >= 0).any() and (t[:q] == 0).any() and torch.signbit(t[:q][prim[:q] >= 0]).any()
        assert (prim[q:2 * q] >= 0).sum() > q // 3  # d_w at +-1e-12 and above
        assert (prim[2 * q:3 * q] == 0).any() and (prim != 1).all()  # row 0 wins its ties with its duplicate
        assert (prim[3 * q:3 * q + 110] == -1).all() and (prim != 3).all()
        on = prim[5 * q:6 * q] == 0  # the plane at t = 1 passes at tmin = 1 and tmax = 1, not beyond either
        assert on.any() and not on.all() and (t[5 * q:6 * q][on] == 1.0).all()


@pytest.mark.parametrize("n", [0, 1, 1000, 2 * THREADS + 7])
def test_mirror_equals_the_twins_on_cbox(n, rng_np):
    """Random rays through cbox's 32 rows (tiny batches and a ragged tail),
    10% dead lanes; both queries."""
    g = parse_scene_file(CBOX, device="cpu").geometry
    ro = rng_np.uniform((1.0, 1.0, 1.0), (555.0, 547.0, 558.0), (n, 3))
    d = rng_np.normal(size=(n, 3))
    rd = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    tmax = np.where(rng_np.random(n) < 0.1, -3.4e38, np.where(rng_np.random(n) < 0.5, np.inf, 300.0))
    rays = [torch.tensor(a, dtype=torch.float32).contiguous() for a in (ro, rd, np.full(n, 1e-4), tmax)]
    _assert_same(mirror(g.tri_rows, g.tri_attr, 32, *rays), brute.closest_plain(g.tri_rows, g.tri_attr, 32, *rays))
    _assert_same(mirror(g.tri_rows, g.tri_attr, 32, *rays, any_hit=True), brute.occluded_plain(g.tri_rows, 32, *rays))


def test_wrapper_refuses_misaligned_rows():
    g = parse_scene_file(CBOX, device="cpu").geometry
    x, t = torch.zeros((8, 3)), torch.zeros(8)
    assert brute._check(g.tri_rows, g.tri_attr, 32, x, x, t, t) == 8
    shifted = torch.zeros(g.tri_rows.numel() + 1)[1:].view(g.tri_rows.shape)
    with pytest.raises(ValueError, match="aligned"):
        brute._check(shifted, None, 32, x, x, t, t)
    with pytest.raises(ValueError, match="rows"):
        brute._check(g.tri_rows[:, :12], None, 32, x, x, t, t)
