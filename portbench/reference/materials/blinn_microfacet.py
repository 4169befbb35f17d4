"""TaKe's `blinn_microfacet`: a Blinn-Phong microfacet reflector.

Written from the published sources:

  * Walter et al. 2007, "Microfacet Models for Refraction through Rough
    Surfaces": the Phong (Blinn-Phong) distribution of normals
    D(h) = (alpha + 2) / (2 pi) cos^alpha theta_h, and Smith's masking for
    Beckmann by the paper's rational fit, G1(v) = (3.535 a + 2.181 a^2) /
    (1 + 2.276 a + 2.577 a^2) for a < 1.6 and 1 above, a = 1 / (alpha_b
    tan theta_v), with the paper's Phong-to-Beckmann map
    alpha_b = sqrt(2 / (alpha + 2)); G = G1(wi) G1(wo); the reflection's
    BRDF F D G / (4 |n.wi| |n.wo|);
  * Schlick 1994: F = R + (1 - R) (1 - h.wo)^5, per channel, R the
    reflectance;
  * half vectors sampled with density (alpha + 1) / (2 pi) cos^alpha
    theta_h about n (cos theta_h = u1^(1 / (alpha + 1)), phi = 2 pi u2,
    sin theta_h = sqrt(1 - u1^(2 / (alpha + 1)))), wi reflected about h,
    and the reflection's Jacobian 1 / (4 wo.h): pdf(wo) = p(h) / (4 wo.h).

The value returned is the BRDF times n.wo, F D G / (4 n.wi), as every
material of the reference returns it. Vectors as in materials/__init__.py:
`n` the shading normal turned toward wi, `geo_n` the geometric normal
facing the arriving ray.

The comparison that uses this module is path by path, so where the tracer
under test states the lobe differently from those sources, this module
follows the tracer:

  * floors: cos^2 theta_v and tan^2 theta_v each at least 1e-12 in G1's
    a; n.wi at least 1e-12 in the value's denominator; n.h clamped to
    [0, 1] in D; cos^alpha taken as 0 for cos <= 0;
  * the value is 0 where n.wo <= 0, wo.h <= 0 or wi.h <= 0 (these stand in
    for Walter's sidedness factors chi+ of D and G1), and where either
    direction lies below the geometric surface;
  * the pdf, and a sample's pdf, is 0 where n.h <= 0, wo.h <= 0, or wo lies
    on or below the geometric surface (<= 0, where the value tests < 0); a
    sample also fails where wi lies below the geometric surface;
  * the half vector of two directions is normalize(wi + wo) with its
    squared length floored at 1e-12; a sampled half vector's cosine is
    clamped to [0, 1], its sine's square at 0, and the local vector, the
    world half vector and the reflected direction are each normalized;
  * the parameters as the tracer's scene parser reads them: `reflectance`
    (default 0.5 grey) and `exponent` or `alpha` (default 5).
"""

import math

import numpy as np
import torch

from portbench.reference import frame, rng
from portbench.reference.frame import dot

DEFAULTS = {"reflectance": np.full(3, 0.5), "exponent": 5.0}  # the tracer's scene parser's defaults


def parse(node, parser):
    out = dict(DEFAULTS)
    for c in node:
        name = c.get("name")
        if name == "reflectance" and c.tag == "rgb":
            out["reflectance"] = parser.rgb(c)
        elif name in ("exponent", "alpha") and c.tag == "float":
            out["exponent"] = parser.f(c.get("value"))
        else:
            raise ValueError(f"the reference's blinn_microfacet has no parameter <{c.tag} name={name!r}>")
    return out


def _cos_power(c, alpha):
    """cos^alpha, 0 where cos <= 0."""
    return torch.where(c > 0.0, torch.clamp(c, min=0.0) ** alpha, 0.0)


def _half(a, b):
    return frame.normalize(a + b, eps=1e-12)


def _masking(v, n, alpha):
    """Walter et al.'s rational fit of Smith's G1 for Beckmann at alpha_b = sqrt(2 / (alpha + 2))."""
    cos2 = torch.clamp(dot(v, n) ** 2, min=1e-12)
    tan2 = torch.clamp(1.0 / cos2 - 1.0, min=1e-12)
    a = 1.0 / (torch.sqrt(2.0 / (alpha + 2.0)) * torch.sqrt(tan2))
    g = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return torch.where(a < 1.6, g, 1.0)


def _pdf(alpha, n, h, wo):
    """p(h) / (4 wo.h), p(h) = (alpha + 1) / (2 pi) cos^alpha theta_h; 0 where n.h <= 0 or wo.h <= 0."""
    nh, oh = dot(n, h), dot(wo, h)
    ph = (alpha + 1.0) / (2.0 * math.pi) * _cos_power(nh, alpha)
    return torch.where((nh <= 0.0) | (oh <= 0.0), 0.0, ph / (4.0 * torch.where(oh <= 0.0, 1.0, oh)))


def sample(p, n, geo_n, dir_in, draw):
    alpha = p["exponent"]
    u1, u2 = draw(rng.BSDF_U1), draw(rng.BSDF_U2)
    inv = 1.0 / (alpha + 1.0)
    cos_h = torch.clamp(u1 ** inv, 0.0, 1.0)
    sin_h = torch.sqrt(torch.clamp(1.0 - u1 ** (2.0 * inv), 0.0, 1.0))
    phi = (2.0 * math.pi) * u2
    local = frame.normalize(torch.stack([torch.cos(phi) * sin_h, torch.sin(phi) * sin_h, cos_h], -1))
    h = frame.normalize(frame.to_world(n, local))
    dir_out = frame.normalize(2.0 * dot(dir_in, h)[..., None] * h - dir_in)
    pdf = torch.where(dot(geo_n, dir_out) <= 0.0, 0.0, _pdf(alpha, n, h, dir_out))
    return dir_out, torch.where(dot(geo_n, dir_in) < 0.0, 0.0, pdf)


def eval(p, n, geo_n, dir_in, dir_out):
    alpha = p["exponent"]
    h = _half(dir_in, dir_out)
    d = (alpha + 2.0) / (2.0 * math.pi) * _cos_power(torch.clamp(dot(n, h), 0.0, 1.0), alpha)
    oh = dot(dir_out, h)
    fresnel = p["reflectance"] + (1.0 - p["reflectance"]) * (torch.clamp(1.0 - oh, 0.0, 1.0) ** 5)[..., None]
    g = _masking(dir_in, n, alpha) * _masking(dir_out, n, alpha)
    f = fresnel * (d * g / (4.0 * torch.clamp(dot(n, dir_in), min=1e-12)))[..., None]
    zero = ((dot(n, dir_out) <= 0.0) | (oh <= 0.0) | (dot(dir_in, h) <= 0.0)
            | (dot(geo_n, dir_in) < 0.0) | (dot(geo_n, dir_out) < 0.0))
    return torch.where(zero[..., None], 0.0, f)


def pdf(p, n, geo_n, dir_in, dir_out):
    pdf = _pdf(p["exponent"], n, _half(dir_in, dir_out), dir_out)
    return torch.where(dot(geo_n, dir_out) <= 0.0, 0.0, pdf)
