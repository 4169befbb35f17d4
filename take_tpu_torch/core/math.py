"""Vector math primitives on batched [..., 3] tensors.

Port of take_tpu/core/math.py. Everything works on trailing-dimension-3
tensors, so the leading (ray-queue) axes are free.
"""

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


def gather_rows(table, idx):
    """table[idx] for a 1-D integer index, as torch.index_select. Its
    backward adds the rows' cotangents with index_add_; advanced indexing's
    backward sorts the indices and accumulates each run of equal ones in one
    warp, which took 22 ms a call for 2^20 lanes into the 8 rows of a
    material table on the H100 (prof_room.py --grad) and was 90% of a
    gradient pass's device time."""
    return torch.index_select(table, 0, idx)


def safe_div(a, b, default=0.0):
    """a / b with b == 0 lanes returning `default`."""
    zero = b == 0.0
    q = a / torch.where(zero, torch.ones_like(b), b)
    return torch.where(zero, default, q)
