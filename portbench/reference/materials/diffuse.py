"""Lambertian reflection with cosine-weighted sampling (Mitsuba's
`diffuse`): f = reflectance / pi, zero where either direction lies below
the geometric surface."""

import math

import torch

from portbench.reference import frame, rng

INV_PI = 1.0 / math.pi


def parse(node, parser):
    refl = [parser.rgb(c) for c in node if c.get("name") == "reflectance"]
    return {"reflectance": refl[0] if refl else torch.full((3,), 0.5).numpy()}


def _below(geo_n, *dirs):
    bad = torch.zeros(geo_n.shape[:-1], dtype=torch.bool, device=geo_n.device)
    for d in dirs:
        bad = bad | (frame.dot(geo_n, d) < 0.0)
    return bad


def sample(p, n, geo_n, dir_in, draw):
    u1, u2 = draw(rng.BSDF_U1), draw(rng.BSDF_U2)
    phi = (2.0 * math.pi) * u2
    r = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
    local = torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, torch.sqrt(torch.clamp(1.0 - u1, 0.0, 1.0))], -1)
    dir_out = frame.to_world(n, local)
    pdf = torch.where(frame.dot(geo_n, dir_out) >= 0.0, torch.clamp(frame.dot(n, dir_out), min=0.0) * INV_PI, 0.0)
    return dir_out, torch.where(frame.dot(geo_n, dir_in) < 0.0, 0.0, pdf)


def eval(p, n, geo_n, dir_in, dir_out):
    f = p["reflectance"] * (torch.clamp(frame.dot(n, dir_out), min=0.0) * INV_PI)[..., None]
    return torch.where(_below(geo_n, dir_in, dir_out)[..., None], 0.0, f)


def pdf(p, n, geo_n, dir_in, dir_out):
    return torch.where(_below(geo_n, dir_out), 0.0, torch.clamp(frame.dot(n, dir_out), min=0.0) * INV_PI)
