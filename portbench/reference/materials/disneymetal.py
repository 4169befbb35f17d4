"""The principled BSDF's metal lobe alone (TaKe's `disneymetal`):
anisotropic GGX with separable Smith masking, Schlick's Fresnel toward the
base colour, sampled by Heitz 2018's visible normals. The lobe and its
departures from the published equations are in reference/principled.py.

Departure from the reference's default light-sample skip: a light sample is
left out only where it lies below the geometric surface (the lobe's value is
0 there), not where the arriving direction does, since the lobe reads the
shading normal for that side, as the tracer under test does.
"""

import numpy as np

from portbench.reference import principled, rng
from portbench.reference.frame import dot

DEFAULTS = {"reflectance": np.full(3, 0.5), "roughness": 0.5, "anisotropic": 0.0}  # TaKe's parse_scene.cpp


def parse(node, parser):
    return principled.parse(node, parser, DEFAULTS)


def sample(p, n, geo_n, dir_in, draw):
    return principled.metal_sample(p["roughness"], p["anisotropic"], n, geo_n, dir_in,
                                   draw(rng.BSDF_U1), draw(rng.BSDF_U2))


def eval(p, n, geo_n, dir_in, dir_out):
    return principled.metal_eval(p["reflectance"], p["roughness"], p["anisotropic"], n, geo_n, dir_in, dir_out)


def pdf(p, n, geo_n, dir_in, dir_out):
    return principled.metal_pdf(p["roughness"], p["anisotropic"], n, geo_n, dir_in, dir_out)


def nee_skip(p, geo_n, dir_in, light_dir):
    return dot(geo_n, light_dir) < 0.0
