"""Mitsuba's `envmap`: radiance at infinity from a latitude-longitude
image, importance-sampled through an alias table (Vose 1991).

Mitsuba's convention, y up: a direction d (in the map's frame, d =
to_world^-1 d_world) looks up u = atan2(d.x, -d.z) / 2 pi + 0.5 and v =
acos(d.y) / pi, bilinearly between the four nearest texel centres, wrapping
in u; the image's scale multiplies the radiance. A texel k of row y is drawn
with probability w_k / sum(w), and the direction's solid-angle pdf is that
over the texel's area in (theta, phi): w_k / sum(w) x W H / (2 pi^2 sin
theta), with theta the direction's own.

The comparison is path by path, so where the tracer under test states its
estimator differently, this module follows it:
  * the weights are the 3 x 3 mean of the luminance (0.212671 R + 0.715160
    G + 0.072169 B) around each texel (wrapping in u, clamped in v) times
    sin theta of the row's centre, and the luminance and the mean are
    rounded in float32, in the tracer's order of additions: the alias
    table pairs each texel below the mean weight with one above it, in the
    order of its two worklists (stacks filled in texel order, each pair
    popped from their ends, the rest of the larger texel pushed back), so
    a weight on the other side of the mean by one rounding would change
    every later pair, and a sample's texel with it;
  * a sample: u1 x (W H) picks the table's slot (its whole part) and the
    sample's u within the texel (its fractional part), u2 accepts the slot
    (u2 <= its probability) or takes its alias, and the bounce's draw 8
    places v within the texel. With 24-bit uniforms and 2^21 texels, u
    within the texel has 3 bits;
  * the bilinear lookup clamps the upper row index after adding 1 to the
    clamped lower one, so above the first row's centre it blends rows 0 and
    1 by the distance from the centre of the row above the image;
  * sin theta of a pdf is floored at 1e-8, the pdf capped at 1e18;
  * the map is one more light slot, chosen uniformly with the others.
"""

import math
import os

import numpy as np
import torch

from portbench.reference import exr, rng

LAST = True
ENV_U3 = 8  # the tracer's draw of a bounce for v within the texel
LUMINANCE = (0.212671, 0.715160, 0.072169)


def weights(radiance):
    """[H * W] float64 importance weights of an [H, W, 3] float32 image."""
    H = radiance.shape[0]
    lum = radiance[..., 0] * LUMINANCE[0] + radiance[..., 1] * LUMINANCE[1] + radiance[..., 2] * LUMINANCE[2]
    rows = np.concatenate([lum[:1], lum, lum[-1:]])  # clamped in v
    ring = np.concatenate([rows[:, -1:], rows, rows[:, :1]], 1)  # wrapped in u
    W = lum.shape[1]
    mean = sum(ring[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)) / 9.0
    return (mean * np.sin((np.arange(H) + 0.5) / H * np.pi)[:, None]).ravel()


def alias_table(w):
    """Vose's alias method: (probability [n], alias [n]) such that slot k
    keeps k with its probability and gives its alias otherwise."""
    n = w.size
    total = w.sum()
    scaled = (w / total if total > 0 else np.full(n, 1.0 / n)) * n
    prob, alias = np.ones(n), np.arange(n)
    small = np.flatnonzero(scaled < 1.0).tolist()
    large = np.flatnonzero(scaled >= 1.0).tolist()
    while small and large:
        s, g = small.pop(), large.pop()
        prob[s], alias[s] = scaled[s], g
        scaled[g] = scaled[g] - (1.0 - scaled[s])
        (small if scaled[g] < 1.0 else large).append(g)
    return prob, alias


def table(radiance, to_world=None, scale=1.0):
    """The host tables of a map: its radiance, the alias table, each texel's probability, its frame and scale."""
    radiance = np.asarray(radiance, np.float32)
    w = weights(radiance)
    prob, alias = alias_table(w)
    total = w.sum()
    frame = np.eye(3) if to_world is None else np.asarray(to_world, np.float64)[:3, :3]
    return {"radiance": radiance, "prob": prob, "alias": alias,
            "p_texel": w / total if total > 0 else np.full(w.size, 1.0 / w.size),
            "to_world": frame, "to_local": np.linalg.inv(frame), "scale": float(scale)}


def attach(node, parser):
    path, scale, to_world = None, 1.0, None
    for c in node:
        name = c.get("name")
        if name == "filename":
            path = os.path.join(parser.dir, parser.sub(c.get("value")))
        elif name == "scale":
            scale = parser.f(c.get("value"))
        elif name in ("toWorld", "to_world"):
            to_world = parser.transform(c)
        else:
            raise ValueError(f"the reference's envmap has no parameter {name!r}")
    if path is None:
        raise ValueError("an envmap needs a filename")
    return table(exr.read(path)[..., :3], to_world, scale)


def to_device(payloads, device, dtype):
    if len(payloads) != 1:
        raise ValueError("the reference holds one environment map a scene")
    p = payloads[0]

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    return {"radiance": t(p["radiance"]), "prob": t(p["prob"], torch.float64), "alias": t(p["alias"], torch.int64),
            "p_texel": t(p["p_texel"], torch.float64), "to_world": t(p["to_world"]), "to_local": t(p["to_local"]),
            "scale": p["scale"]}


def _apply(m, d):
    """m @ d for [3, 3] m and [..., 3] d, by products and sums."""
    return d[..., 0:1] * m[:, 0] + d[..., 1:2] * m[:, 1] + d[..., 2:3] * m[:, 2]


def uv(env, d):
    dl = _apply(env["to_local"], d)
    u = torch.atan2(dl[..., 0], -dl[..., 2]) / (2.0 * math.pi) + 0.5
    v = torch.acos(torch.clamp(dl[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def direction(env, u, v):
    phi, theta = 2.0 * math.pi * (u - 0.5), math.pi * v
    s = torch.sin(theta)
    return _apply(env["to_world"], torch.stack([s * torch.sin(phi), torch.cos(theta), -s * torch.cos(phi)], -1))


def radiance(env, d):
    """The bilinear lookup along directions d [N, 3]."""
    img = env["radiance"]
    H, W = img.shape[:2]
    u, v = uv(env, d)
    x, y = u * W - 0.5, v * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    c0 = torch.remainder(x0.long(), W)
    c1 = torch.remainder(c0 + 1, W)
    r0 = torch.clamp(y0.long(), 0, H - 1)
    r1 = torch.clamp(r0 + 1, 0, H - 1)
    out = ((1.0 - fx) * (1.0 - fy) * img[r0, c0] + fx * (1.0 - fy) * img[r0, c1]
           + (1.0 - fx) * fy * img[r1, c0] + fx * fy * img[r1, c1])
    return out * env["scale"]


def _solid_angle(env, texel, v):
    H, W = env["radiance"].shape[:2]
    sin_t = torch.clamp(torch.sin(math.pi * v), min=1e-8)
    return env["p_texel"][texel].to(v.dtype) * (W * H / (2.0 * math.pi * math.pi)) / sin_t


def pdf(env, d):
    """The solid-angle pdf with which `sample` draws direction d."""
    H, W = env["radiance"].shape[:2]
    u, v = uv(env, d)
    col = torch.clamp((u * W).long(), 0, W - 1)
    row = torch.clamp((v * H).long(), 0, H - 1)
    return _solid_angle(env, row * W + col, v)


def sample_uv(env, u1, u2, u3):
    """(u, v, texel) of the sample that the uniforms pick."""
    H, W = env["radiance"].shape[:2]
    x = u1 * (H * W)
    slot = torch.clamp(torch.floor(x).long(), 0, H * W - 1)
    texel = torch.where(u2 > env["prob"][slot], env["alias"][slot], slot)
    u = ((texel % W).to(u1.dtype) + (x - torch.floor(x))) / W
    v = (torch.div(texel, W, rounding_mode="floor").to(u1.dtype) + u3) / H
    return u, v, texel


def sample(s, slot, pos, draw, n_slots, emit):
    env = s.light_data["envmap"]
    u, v, texel = sample_uv(env, draw(rng.LIGHT_U1), draw(rng.LIGHT_U2), draw(ENV_U3))
    d = direction(env, u, v)
    p = _solid_angle(env, texel, v)
    return {"dir": d, "dist": torch.full_like(u, math.inf), "radiance": radiance(env, d),
            "pdf": torch.clamp(p / n_slots, max=1e18), "valid": p > 0.0}


def escape(s, dirs, n_slots):
    env = s.light_data["envmap"]
    return radiance(env, dirs), torch.clamp(pdf(env, dirs) / n_slots, max=1e18)
