"""Per-material reflectance texture evaluation (port of
take_tpu/materials/textures.py).

Replicates the reference's bilinear sampler exactly, including its
wrap-column behavior: when x1 is the last texel, x2 wraps to 0 for the fetch
but the interpolation weights are computed with the wrapped coordinate, which
extrapolates rather than interpolates across the seam (texture.cpp:7-26).
"""

import torch

from take_tpu_torch.core.math import gather_rows
from take_tpu_torch.scene.types import (
    MATTR_TEX_IMAGE,
    MATTR_TEX_KIND,
    MATTR_UVOFFSET,
    MATTR_UVSCALE,
    TEX_IMAGE,
    Scene,
)


def _modulo1(x):
    """Positive fractional part, matching modulo(a, 1.0) in take.h:57-67."""
    r = torch.remainder(x, 1.0)
    return torch.where(r < 0.0, r + 1.0, r)


def eval_reflectance_packed(scene: Scene, mat_params, uv, const_val):
    """Image-texture path of the reflectance slot, from packed material
    params [N, MATTR_DIM] (bsdf.make_shade_point)."""
    tex_id = mat_params[:, MATTR_TEX_IMAGE].long()
    scale = mat_params[:, MATTR_UVSCALE : MATTR_UVSCALE + 2]
    offset = mat_params[:, MATTR_UVOFFSET : MATTR_UVOFFSET + 2]
    kind = mat_params[:, MATTR_TEX_KIND].to(torch.int32)

    w = scene.textures.width[tex_id].to(uv.dtype)  # [N]
    h = scene.textures.height[tex_id].to(uv.dtype)
    x = w * _modulo1(scale[:, 0] * uv[:, 0] + offset[:, 0])
    y = h * _modulo1(scale[:, 1] * uv[:, 1] + offset[:, 1])

    x1 = torch.floor(x)
    y1 = torch.floor(y)
    x1i = x1.long()
    y1i = y1.long()
    wi = w.long()
    hi = h.long()
    x2i = torch.where(x1i + 1 == wi, 0, x1i + 1)  # wrapped fetch column
    y2i = torch.where(y1i + 1 == hi, 0, y1i + 1)

    n, Hm, Wm, _ = scene.textures.data.shape  # [n, Hmax, Wmax, 3]
    texels = scene.textures.data.reshape(-1, 3)
    base = tex_id.clamp(0, n - 1) * Hm

    def fetch(yi, xi):
        # fetches clamp to the atlas, as JAX's gather does (x == w is
        # reachable when the fractional part of a tiny negative coordinate
        # rounds to 1)
        return gather_rows(texels, (base + yi.clamp(0, Hm - 1)) * Wm + xi.clamp(0, Wm - 1))

    q11 = fetch(y1i, x1i)
    q12 = fetch(y2i, x1i)
    q21 = fetch(y1i, x2i)
    q22 = fetch(y2i, x2i)

    # weights use the wrapped x2/y2; a 1-texel-wide image bumps x2 by one
    # (texture.cpp:17-25)
    x2 = x2i.to(x.dtype)
    y2 = y2i.to(y.dtype)
    x2 = torch.where(x1i == x2i, x2 + 1.0, x2)
    y2 = torch.where(y1i == y2i, y2 + 1.0, y2)

    denom = (x2 - x1) * (y2 - y1)
    num = (
        q11 * ((x2 - x) * (y2 - y))[:, None]
        + q21 * ((x - x1) * (y2 - y))[:, None]
        + q12 * ((x2 - x) * (y - y1))[:, None]
        + q22 * ((x - x1) * (y - y1))[:, None]
    )
    bilerp = num / denom[:, None]
    return torch.where((kind == TEX_IMAGE)[:, None], bilerp, const_val)
