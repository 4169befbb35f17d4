"""Vector helpers of the reference on [..., 3] tensors."""

import torch


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def normalize(a, eps=0.0):
    """a / |a|; with eps, a squared length at most eps divides by sqrt(eps)."""
    n2 = torch.sum(a * a, dim=-1, keepdim=True)
    if eps:
        n2 = torch.where(n2 > eps, n2, torch.full_like(n2, eps))
    return a / torch.sqrt(n2)


def norm(a):
    """|a|, with a zero gradient at a == 0."""
    sq = torch.sum(a * a, dim=-1)
    pos = sq > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def to_world(n, v):
    """Local v (z along n) to world: Frisvad's branchless orthonormal basis,
    with its n.z near -1 branch."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    singular = nz < (-1.0 + 1e-6)
    a = 1.0 / torch.where(singular, torch.ones_like(nz), 1.0 + nz)
    b = -nx * ny * a
    x = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    y = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    s = singular[..., None]
    x = torch.where(s, torch.tensor([0.0, -1.0, 0.0], dtype=n.dtype, device=n.device), x)
    y = torch.where(s, torch.tensor([-1.0, 0.0, 0.0], dtype=n.dtype, device=n.device), y)
    return x * v[..., 0:1] + y * v[..., 1:2] + n * v[..., 2:3]


def safe_div(a, b):
    """a / b, 0 where b == 0."""
    zero = b == 0.0
    return torch.where(zero, 0.0, a / torch.where(zero, torch.ones_like(b), b))
