"""Mitsuba's `sphere`, analytic: a centre and a radius (no to_world).

A ray o + t d meets it where |o + t d - c|^2 = r^2, the quadratic
a t^2 + 2 b t + c' = 0 with a = d.d, b = (o - c).d, c' = |o - c|^2 - r^2:
the nearer root if it lies in [tmin, tmax], else the farther. The normal is
(p - c) / |p - c|, outward, both geometric and for shading.

An emitting sphere is sampled, as the tracer under test samples it, over
the cap visible from the shaded point x at distance d from the centre:
cos theta uniform in [r / d, 1] about the axis (x - c) / d, phi = 2 pi u2 in
Frisvad's frame of that axis. Departure from that cap's pdf per area,
1 / (2 pi r^2 (1 - r / d)): the tracer measures d from x to the sampled
point, not to the centre (floored at 1e-6, the denominator at 1e-30), and
this module does the same.
"""

import math

import numpy as np
import torch

from portbench.reference import frame


def load(node, parser):
    centre, radius = np.zeros(3), 1.0
    for c in node:
        name = c.get("name")
        if name == "center":
            centre = np.array([parser.f(c.get(k, "0")) for k in "xyz"])
        elif name == "radius":
            radius = parser.f(c.get("value"))
        elif c.tag == "transform":
            raise ValueError("the reference's sphere takes a center and a radius, not a transform")
    return {"analytic": [{"center": centre, "radius": radius}]}


def _roots(data, ro, rd, tmin, tmax):
    """(t [N, P], hit [N, P]) of every ray against every sphere."""
    c, r = data["center"], data["radius"]
    o = ro.to(c.dtype)[:, None] - c[None]
    d = rd.to(c.dtype)[:, None]
    a = torch.sum(d * d, -1)
    b = torch.sum(o * d, -1)
    disc = b * b - a * (torch.sum(o * o, -1) - r * r)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    near, far = (-b - sq) / a, (-b + sq) / a
    lo, hi = tmin.to(c.dtype)[:, None], tmax.to(c.dtype)[:, None]
    near_ok = (near >= lo) & (near <= hi)
    far_ok = (far >= lo) & (far <= hi)
    return torch.where(near_ok, near, far), (disc >= 0.0) & (near_ok | far_ok) & (hi > 0.0)


def closest(data, ro, rd, tmin, tmax):
    t, hit = _roots(data, ro, rd, tmin, tmax)
    best, prim = torch.where(hit, t, math.inf).min(dim=1)
    found = torch.isfinite(best)
    return found, torch.where(found, best, 0.0), prim


def occluded(data, ro, rd, tmin, tmax):
    return _roots(data, ro, rd, tmin, tmax)[1].any(dim=1)


def surface(data, prim, pos):
    n = frame.normalize(pos - data["center"][prim].to(pos.dtype), eps=1e-30)
    return n, n


def sample(data, prim, ref_pos, u1, u2):
    c, r = data["center"][prim].to(ref_pos.dtype), data["radius"][prim].to(ref_pos.dtype)
    to_c = c - ref_pos
    d = frame.norm(to_c)
    z = 1.0 + u1 * (r / d - 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    phi = 2.0 * math.pi * u2
    local = frame.normalize(torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, z], -1))
    n = frame.normalize(frame.to_world(frame.normalize(-to_c), local))
    point = c + r[:, None] * n
    return point, n, pdf_area(data, prim, point, ref_pos)


def pdf_area(data, prim, point, ref_pos):
    r = data["radius"][prim].to(ref_pos.dtype)
    d = torch.clamp(frame.norm(point - ref_pos), min=1e-6)
    return 1.0 / torch.clamp(2.0 * math.pi * r * r * (1.0 - r / d), min=1e-30)
