"""Vector math primitives on batched [..., 3] tensors.

Port of take_tpu/core/math.py. Everything works on trailing-dimension-3
tensors, so the leading (ray-queue) axes are free.
"""

import math

import torch

C_PI = 3.14159265358979323846
C_INVPI = 1.0 / C_PI
C_TWOPI = 2.0 * C_PI
C_INVTWOPI = 1.0 / C_TWOPI


def dot(a, b):
    """Batched dot product over the trailing axis, keeps no dims."""
    return torch.sum(a * b, dim=-1)


def dot_k(a, b):
    """Batched dot product, keepdim=True (for broadcasting against vectors)."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a, eps=0.0):
    """Normalize over the trailing axis. With eps > 0, zero vectors divide
    by sqrt(eps) instead of 0 (same primal values as the JAX version)."""
    n2 = torch.sum(a * a, dim=-1, keepdim=True)
    if eps:
        n2 = torch.where(n2 > eps, n2, torch.full_like(n2, eps))
    return a / torch.sqrt(n2)


def constant(values, dtype, device):
    """A tensor of Python floats made on `device` by fills, with no copy
    from the host, which a captured CUDA graph (render.py) cannot hold. Each
    float rounds to `dtype` as torch.tensor(values, dtype) rounds it."""
    return torch.stack([torch.full((), float(x), dtype=dtype, device=device) for x in values])


def to_world(n, v):
    """Frisvad branchless ONB: map local vector v into the frame around n,
    including the n.z < -1+1e-6 singular branch (vector.h:314-326)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < (-1.0 + 1e-6)
    a = 1.0 / torch.where(singular, torch.ones_like(nz), 1.0 + nz)
    b = -nx * ny * a
    x_reg = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    y_reg = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    x_sing = constant((0.0, -1.0, 0.0), n.dtype, n.device).expand(n.shape)
    y_sing = constant((-1.0, 0.0, 0.0), n.dtype, n.device).expand(n.shape)
    s = singular[..., None]
    x = torch.where(s, x_sing, x_reg)
    y = torch.where(s, y_sing, y_reg)
    return x * v[..., 0:1] + y * v[..., 1:2] + n * v[..., 2:3]


def reflect(dir_in, n):
    """Mirror direction of `dir_in` (pointing away from the surface) about n."""
    return -dir_in + 2.0 * dot_k(dir_in, n) * n


def face_forward(n, ref):
    """Flip n to lie in the hemisphere of `ref` (dot(n, ref) >= 0)."""
    return torch.where(dot_k(n, ref) < 0.0, -n, n)


def safe_norm(x, dim=-1):
    """Euclidean norm with a zero gradient at x == 0.

    sqrt's backward at 0 is 0/0 = NaN, and degenerate lanes (dead paths, a
    light sample on the shading point) reach exactly 0; the double `where`
    keeps the primal bit for bit that of sqrt(sum(x * x)) and gives those
    lanes a gradient of 0 (take_tpu/core/math.py::safe_norm)."""
    sq = torch.sum(x * x, dim=dim)
    pos = sq > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def add_rows(rows: int, idx, src):
    """A table of `rows` rows of zeros with each lane's src[i] added into
    row idx[i], as index_add_. On the card index_add_ adds with atomics in
    no fixed order, and in float32 2^20 lanes into 8 rows round to a sum
    that differs from run to run by ~1.5e-5 of the table; so the sum is
    taken in float64 and rounded once (the same sum every run), and on a
    small table the lanes are spread over up to 64 copies of it (lane % k),
    summed after, so that fewer atomics contend for one address: for 2^20
    lanes into 8 x 24, 0.38 ms against float32's 0.79 and unspread
    float64's 2.64 (prof_room.py --scatter, NVIDIA H100 80GB HBM3,
    700.00 W)."""
    width = src.shape[1:]
    k = max(1, min(64, (1 << 14) // max(1, rows * math.prod(width))))
    slot = idx if k == 1 else torch.arange(idx.shape[0], device=idx.device) % k * rows + idx
    acc = src.new_zeros((k * rows, *width), dtype=torch.float64).index_add_(0, slot, src.double())
    return (acc.view(k, rows, *width).sum(0) if k > 1 else acc).to(src.dtype)


class _GatherRows(torch.autograd.Function):
    """torch.index_select(table, 0, idx) whose backward adds the rows'
    cotangents by add_rows."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return add_rows(ctx.rows, idx, g), None


def gather_rows(table, idx):
    """table[idx] for a 1-D integer index, as torch.index_select. Its
    backward adds the rows' cotangents with index_add_ (add_rows: in
    float64, the same every run); advanced indexing's backward sorts the
    indices and accumulates each run of equal ones in one warp, which took
    22 ms a call for 2^20 lanes into the 8 rows of a material table on the
    H100 (prof_room.py --grad) and was 90% of a gradient pass's device
    time."""
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(table, idx)
    return torch.index_select(table, 0, idx)


def safe_div(a, b, default=0.0):
    """a / b with b == 0 lanes returning `default`."""
    zero = b == 0.0
    q = a / torch.where(zero, torch.ones_like(b), b)
    return torch.where(zero, default, q)
