"""The principled BSDF (TaKe's `disneybsdf`, Burley 2012/2015): the
weighted composite of a diffuse lobe with subsurface, sheen, a metal lobe
with the dielectric specular folded into its Fresnel, clearcoat and rough
glass, sampled by picking one lobe. The lobes, the weights and each
departure from the published equations are in reference/principled.py.

Its draws at a bounce: the lobe choice (rng.LOBE_SELECT), the lobe's two
uniforms (rng.BSDF_U1, rng.BSDF_U2) and, for glass's choice between
reflection and refraction, dimension AUX, 7, which the tracer under test
draws at every bounce.

Departures of this module:
  * eta is taken as seen from outside the surface: the BSDF interface
    passes no side of the hit, and every ray arrives from outside on an
    opaque closed surface (specTrans 0, as on ibl.xml's spheres). A
    transmissive composite would need the side, which the tracer under
    test reads from its hit (Hit.front) and this module cannot.
  * no light sample is skipped for lying below either surface: glass
    transmits, and the composite's metal lobe does not test the geometric
    surface, so a light below it can still contribute, as in the tracer
    under test.
"""

import numpy as np
import torch

from portbench.reference import principled, rng

AUX = 7  # the tracer's spare draw of a bounce, glass's reflect-or-refract choice

DEFAULTS = {  # TaKe's parse_scene.cpp
    "reflectance": np.full(3, 0.5), "specTrans": 0.0, "metallic": 0.0, "subsurface": 0.0, "specular": 0.5,
    "roughness": 0.5, "specularTint": 0.0, "anisotropic": 0.0, "sheen": 0.0, "sheenTint": 0.5,
    "clearcoat": 0.0, "clearcoatGloss": 1.0, "eta": 1.5,
}


def parse(node, parser):
    return principled.parse(node, parser, DEFAULTS)


def sample(p, n, geo_n, dir_in, draw):
    return principled.composite_sample(p, p["eta"], n, geo_n, dir_in, draw(rng.LOBE_SELECT), draw(rng.BSDF_U1),
                                       draw(rng.BSDF_U2), draw(AUX))


def eval(p, n, geo_n, dir_in, dir_out):
    return principled.composite_eval(p, p["eta"], n, geo_n, dir_in, dir_out)


def pdf(p, n, geo_n, dir_in, dir_out):
    return principled.composite_pdf(p, p["eta"], n, geo_n, dir_in, dir_out)


def nee_skip(p, geo_n, dir_in, light_dir):
    return torch.zeros(geo_n.shape[:-1], dtype=torch.bool, device=geo_n.device)
