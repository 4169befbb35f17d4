"""Environment light (IBL): lat-long map, alias-table importance sampling
(port of take_tpu/lights/envmap.py).

Mitsuba's envmap semantics: y-up lat-long with
    u = atan2(d.x, -d.z) / (2 pi) + 0.5,   v = acos(d.y) / pi,
texels importance-weighted by luminance * sin(theta); the alias table gives
O(1) texel sampling on the device (two gathers and one compare).

`build_alias_table` and `build_envmap` are host numpy code, copied step for
step so that the tables are bit-equal with the JAX package's; the scene
uploads them once (scene/types.py::scene_from_numpy); with tracing on,
their build is the span take.scene.envmap. The lookups work on tensors on
the scene's device.
"""

import numpy as np
import torch

from take_tpu_torch import tracing
from take_tpu_torch.core.math import C_PI, C_TWOPI, gather_rows
from take_tpu_torch.scene.types import EnvMap


def build_alias_table(w: np.ndarray):
    """Vose alias method. w: [n] nonneg weights -> (prob [n], alias [n])."""
    n = w.size
    p = w.astype(np.float64)
    s = p.sum()
    if s <= 0:
        p = np.full(n, 1.0 / n)
    else:
        p = p / s
    scaled = p * n
    alias = np.zeros(n, np.int64)
    prob = np.ones(n, np.float64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = scaled[l_i] - (1.0 - scaled[s_i])
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    for i in large + small:
        prob[i] = 1.0
        alias[i] = i
    return prob, alias


@tracing.spanned("take.scene.envmap")
def build_envmap(data: np.ndarray, to_world4=None, scale=1.0) -> dict:
    """The envmap's tables from [H, W, 3] radiance, in host numpy, keyed by
    EnvMap field ("data", "alias_prob", ...), as the JAX package's EnvMap
    holds them (float32; alias_idx int32)."""
    data = np.asarray(data, np.float32)
    H, W = data.shape[:2]
    lum = (
        data[..., 0] * 0.212671 + data[..., 1] * 0.715160 + data[..., 2] * 0.072169
    )
    # Importance-sample the 3x3-dilated luminance: a bright texel's bilinear
    # footprint spills into its 8 neighbours, so L/pdf stays bounded.
    lum_pad = np.pad(lum, ((1, 1), (0, 0)), mode="edge")
    lum_pad = np.concatenate(
        [lum_pad[:, -1:], lum_pad, lum_pad[:, :1]], axis=1
    )  # wrap in phi, clamp in theta
    spread = sum(
        lum_pad[dy : dy + H, dx : dx + W]
        for dy in range(3)
        for dx in range(3)
    ) / 9.0
    theta = (np.arange(H) + 0.5) / H * np.pi
    sin_t = np.sin(theta)
    weights = (spread * sin_t[:, None]).ravel()
    prob, alias = build_alias_table(weights)

    # Solid-angle pdf NUMERATOR p_texel * W * H / (2 pi^2): envmap_sample and
    # envmap_pdf divide by the exact sin(theta) of the direction.
    total = weights.sum()
    p_texel = (
        weights.reshape(H, W) / total if total > 0 else np.full((H, W), 1.0 / (H * W))
    )
    pdf = p_texel * (W * H) / (2.0 * np.pi * np.pi)

    if to_world4 is None:
        R = np.eye(3)
    else:
        R = np.asarray(to_world4, np.float64)[:3, :3]
    return dict(
        data=data,
        alias_prob=np.asarray(prob, np.float32),
        alias_idx=np.asarray(alias, np.int32),
        pdf=np.asarray(pdf, np.float32),
        to_world=np.asarray(R, np.float32),
        to_local=np.asarray(np.linalg.inv(R), np.float32),
        scale=np.float32(scale),
    )


def _dir_to_uv(env: EnvMap, d):
    """World direction [N, 3] -> (u, v) in [0, 1)^2 (Mitsuba lat-long)."""
    dl = d @ env.to_local.T
    u = torch.atan2(dl[..., 0], -dl[..., 2]) / C_TWOPI + 0.5
    v = torch.arccos(torch.clamp(dl[..., 1], -1.0, 1.0)) / C_PI
    return u, v


def _uv_to_dir(env: EnvMap, u, v):
    phi = (u - 0.5) * C_TWOPI
    theta = v * C_PI
    sin_t = torch.sin(theta)
    dl = torch.stack([sin_t * torch.sin(phi), torch.cos(theta), -sin_t * torch.cos(phi)], dim=-1)
    return dl @ env.to_world.T


def envmap_eval(env: EnvMap, d):
    """Bilinear radiance lookup along direction d [N, 3] -> [N, 3]."""
    H, W = env.data.shape[:2]
    texels = env.data.reshape(H * W, 3)
    u, v = _dir_to_uv(env, d)
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), W)  # floor-mod, as jnp.mod
    x1i = torch.remainder(x0i + 1, W)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    q00 = gather_rows(texels, y0i * W + x0i)
    q01 = gather_rows(texels, y1i * W + x0i)
    q10 = gather_rows(texels, y0i * W + x1i)
    q11 = gather_rows(texels, y1i * W + x1i)
    out = (
        q00 * (1 - fx) * (1 - fy)
        + q10 * fx * (1 - fy)
        + q01 * (1 - fx) * fy
        + q11 * fx * fy
    )
    return out * env.scale


def envmap_sample(env: EnvMap, u1, u2, u3):
    """Alias-table sample: returns (dir [N, 3], pdf [N] solid-angle).

    u1 picks the table slot, u2 the accept/alias branch, u3 reused with u2
    as the in-texel jitter.
    """
    H, W = env.data.shape[:2]
    n = H * W
    slot = torch.clamp((u1 * n).to(torch.int64), 0, n - 1)
    take_alias = u2 > env.alias_prob[slot]
    texel = torch.where(take_alias, env.alias_idx[slot].to(torch.int64), slot)
    ty = torch.div(texel, W, rounding_mode="floor")
    tx = texel % W
    # stratified jitter inside the texel
    ju = torch.remainder(u1 * n, 1.0)
    jv = u3
    u = (tx.to(u1.dtype) + ju) / W
    v = (ty.to(u1.dtype) + jv) / H
    d = _uv_to_dir(env, u, v)
    sin_t = torch.clamp(torch.sin(v * C_PI), min=1e-8)
    pdf = env.pdf.reshape(n)[ty * W + tx] / sin_t
    return d, pdf


def envmap_pdf(env: EnvMap, d):
    """Exact solid-angle pdf of sampling direction d by envmap_sample (the
    same numerator table, the same exact-sin(theta) Jacobian)."""
    H, W = env.data.shape[:2]
    u, v = _dir_to_uv(env, d)
    tx = torch.clamp((u * W).to(torch.int64), 0, W - 1)
    ty = torch.clamp((v * H).to(torch.int64), 0, H - 1)
    sin_t = torch.clamp(torch.sin(v * C_PI), min=1e-8)
    return env.pdf.reshape(H * W)[ty * W + tx] / sin_t
