"""Low-level sampling warps (port of take_tpu/core/sampling.py).

Each function maps uniforms u1, u2 in [0,1) to directions or points,
mirroring the reference's samplers:
  * cosine hemisphere      — material.h:121-132
  * Phong/Blinn cos^alpha  — materials/phong.inl:10-17, blinn_phong.inl:10-22
  * triangle sqrt warp     — shape.cpp:146-169
  * sphere visible cone    — shape.cpp:125-144
"""

import torch

from take_tpu_torch.core.math import C_TWOPI, normalize, to_world


def sample_hemisphere_cos(u1, u2):
    """Cosine-weighted hemisphere in local frame (z-up). pdf = cos(theta)/pi."""
    phi = C_TWOPI * u2
    sqrt_u1 = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
    z = torch.sqrt(torch.clamp(1.0 - u1, 0.0, 1.0))
    return torch.stack([torch.cos(phi) * sqrt_u1, torch.sin(phi) * sqrt_u1, z], dim=-1)


def sample_cos_power(u1, u2, exponent):
    """cos^alpha lobe around local z, pdf = (alpha + 1) / (2 pi) cos^alpha(theta)
    (phong.inl:10-17, with its clamps). u1, u2 and exponent are [N]."""
    recip_a1 = 1.0 / (exponent + 1.0)
    phi = C_TWOPI * u2
    cos_t = torch.clamp(u1 ** recip_a1, 0.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - u1 ** (2.0 * recip_a1), 0.0, 1.0))
    return normalize(torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1))


def sample_triangle(u1, u2):
    """sqrt-warp uniform barycentric sampling (shape.cpp:157-160).

    Returns (b1, b2); the point is (1-b1-b2) v0 + b1 v1 + b2 v2.
    """
    su1 = torch.sqrt(u1)
    return 1.0 - su1, su1 * u2


def sample_sphere_visible(u1, u2, center, radius, ref_pos):
    """Visible-cap sphere sampling w.r.t. a reference point (shape.cpp:125-144).

    z runs over [r/d, 1] linearly in u1, in the local frame around
    normalize(ref_pos - center). Returns (point [..., 3], normal [..., 3]).
    """
    d = torch.linalg.vector_norm(center - ref_pos, dim=-1, keepdim=True)
    z = 1.0 + u1[..., None] * (radius[..., None] / d - 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    phi = C_TWOPI * u2[..., None]
    local_p = normalize(torch.cat([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, z], dim=-1))
    axis = normalize(ref_pos - center)
    n = normalize(to_world(axis, local_p))
    return center + radius[..., None] * n, n
