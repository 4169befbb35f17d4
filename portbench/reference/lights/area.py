"""Area emitters on surfaces: a point on the slot's primitive from
reference/surfaces.py, its solid-angle pdf, and the same pdf where a BSDF
sample hits the emitter."""

import torch

from portbench.reference import rng, surfaces
from portbench.reference.frame import dot, norm, safe_div


def parse(node, parser):
    rad = [parser.rgb(c) for c in node if c.get("name") == "radiance"]
    return rad[0] if rad else torch.ones(3, dtype=torch.float64).numpy()


def _solid_angle(pdf_area, d, cos_l, n_slots):
    return torch.clamp(safe_div(pdf_area * d * d, torch.clamp(cos_l, min=1e-12) * n_slots), max=1e18)


def sample(s, slot, pos, draw, n_slots, emit):
    point, normal, pdf_area = surfaces.sample(s, s.light_shape[slot], s.light_prim[slot], pos,
                                              draw(rng.LIGHT_U1), draw(rng.LIGHT_U2))
    delta = point - pos
    d = norm(delta)
    ldir = delta / torch.clamp(d, min=1e-30)[:, None]
    facing = dot(-normal, ldir)
    return {"dir": ldir, "dist": d, "radiance": emit[slot],
            "pdf": _solid_angle(pdf_area, d, torch.clamp(facing, min=0.0), n_slots), "valid": facing > 0.0}


def hit_pdf(s, hit, em, ref_pos, direction, n_slots):
    d = norm(hit["pos"] - ref_pos)
    cos_l = torch.clamp(dot(-hit["geo_n"], direction), min=0.0)
    pdf_area = surfaces.pdf_area(s, hit["shape"], hit["prim"], hit["pos"], ref_pos)
    return _solid_angle(torch.where(em, pdf_area, 0.0), d, cos_l, n_slots)
