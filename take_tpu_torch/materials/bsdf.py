"""Vectorized tagged-dispatch BSDFs (port of take_tpu/materials/bsdf.py).

Every ray batch carries an int tag per lane; each tag that the scene uses
(SceneMeta.used_material_tags, a static fact) runs its lobe over the whole
batch, and the results are blended with torch.where. Semantics are 1:1 with
the reference .inl files: eval returns BRDF * cos(theta_out), and pdf == 0
marks an invalid sample.

The port has the Lambertian lobe (materials/diffuse.inl). The other tags of
the JAX package come with their own parity tests in later slices; a scene
that uses one raises NotImplementedError at dispatch.
"""

from typing import NamedTuple

import torch

from take_tpu_torch.core.math import C_INVPI, dot, face_forward, to_world
from take_tpu_torch.core.sampling import sample_hemisphere_cos
from take_tpu_torch.materials.textures import eval_reflectance_packed
from take_tpu_torch.scene import types as ST
from take_tpu_torch.scene.types import MAT_DIFFUSE, MAT_MIRROR, MAT_PLASTIC, Scene

PORTED_TAGS = (MAT_DIFFUSE,)


class ShadePoint(NamedTuple):
    """Per-ray gathered material state at a hit point."""

    tag: torch.Tensor  # [N] int32
    geo_n: torch.Tensor  # [N, 3] (faces the incoming ray)
    sh_n: torch.Tensor  # [N, 3] (unflipped shading normal)
    refl: torch.Tensor  # [N, 3] evaluated reflectance texture
    eta: torch.Tensor  # [N]
    exponent: torch.Tensor  # [N]
    roughness: torch.Tensor  # [N]
    subsurface: torch.Tensor  # [N]
    anisotropic: torch.Tensor
    metallic: torch.Tensor
    spec_trans: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    front: torch.Tensor  # [N] bool, ray arrived on the outward side


def make_shade_point(scene: Scene, hit) -> ShadePoint:
    """Gather material parameters and evaluate textures for a Hit batch."""
    p = scene.materials.attr[hit.mat_id.long()]
    front = hit.front if hit.front is not None else torch.ones_like(hit.mat_id, dtype=torch.bool)
    refl = p[:, ST.MATTR_TEX_VALUE : ST.MATTR_TEX_VALUE + 3]
    if scene.meta.has_image_textures:
        refl = eval_reflectance_packed(scene, p, hit.uv, refl)
    return ShadePoint(
        tag=p[:, ST.MATTR_TAG].to(torch.int32),
        geo_n=hit.geo_n,
        sh_n=hit.sh_n,
        front=front,
        refl=refl,
        eta=p[:, ST.MATTR_ETA],
        exponent=p[:, ST.MATTR_EXPONENT],
        roughness=p[:, ST.MATTR_ROUGHNESS],
        subsurface=p[:, ST.MATTR_SUBSURFACE],
        anisotropic=p[:, ST.MATTR_ANISOTROPIC],
        metallic=p[:, ST.MATTR_METALLIC],
        spec_trans=p[:, ST.MATTR_SPEC_TRANS],
        specular=p[:, ST.MATTR_SPECULAR],
        specular_tint=p[:, ST.MATTR_SPECULAR_TINT],
        sheen=p[:, ST.MATTR_SHEEN],
        sheen_tint=p[:, ST.MATTR_SHEEN_TINT],
        clearcoat=p[:, ST.MATTR_CLEARCOAT],
        clearcoat_gloss=p[:, ST.MATTR_CLEARCOAT_GLOSS],
    )


def is_specular(sp: ShadePoint):
    """Material-level 'specular' flag used by MIS (path_tracing.h:24-26)."""
    return (sp.tag == MAT_MIRROR) | (sp.tag == MAT_PLASTIC)


def _shading_frame(sp, dir_in):
    """n = shading normal flipped toward dir_in (common .inl preamble)."""
    return face_forward(sp.sh_n, dir_in)


def _backface_zero(sp, dir_in, dir_out, val):
    """eval preamble: zero when either direction is under the geo surface."""
    bad = (dot(sp.geo_n, dir_in) < 0.0) | (dot(sp.geo_n, dir_out) < 0.0)
    return torch.where(bad[..., None], 0.0, val)


# -- Diffuse (materials/diffuse.inl) --


def _cosine_sample(sp, dir_in, u1, u2):
    n = _shading_frame(sp, dir_in)
    dir_out = to_world(n, sample_hemisphere_cos(u1, u2))
    front = dot(sp.geo_n, dir_out) >= 0.0
    pdf = torch.where(front, torch.clamp(dot(n, dir_out), min=0.0) * C_INVPI, 0.0)
    pdf = torch.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)
    return dir_out, pdf


def _cosine_pdf(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    pdf = torch.clamp(dot(n, dir_out), min=0.0) * C_INVPI
    return torch.where(dot(sp.geo_n, dir_out) < 0.0, 0.0, pdf)


def _diffuse_eval(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    f = sp.refl * (torch.clamp(dot(n, dir_out), min=0.0) * C_INVPI)[..., None]
    return _backface_zero(sp, dir_in, dir_out, f)


def _tags(scene: Scene):
    tags = scene.meta.used_material_tags
    missing = [ST.MATERIAL_NAMES[t] for t in tags if t not in PORTED_TAGS]
    if missing:
        raise NotImplementedError(f"materials not yet ported: {', '.join(missing)}")
    return tags


def bsdf_sample(scene: Scene, sp: ShadePoint, dir_in, u_lobe, u1, u2, u3=None):
    """Sample an outgoing direction per ray. Returns (dir_out [N,3], pdf [N]).

    pdf == 0 encodes an invalid sample (material.cpp:76-82). u_lobe and u3
    are the lobe-choice uniforms of multi-lobe materials.
    """
    dir_out = torch.zeros_like(dir_in)
    pdf = torch.zeros(dir_in.shape[:-1], dtype=dir_in.dtype, device=dir_in.device)
    for tag in _tags(scene):
        d, p = _cosine_sample(sp, dir_in, u1, u2)
        m = sp.tag == tag
        dir_out = torch.where(m[..., None], d, dir_out)
        pdf = torch.where(m, p, pdf)
    return dir_out, pdf


def bsdf_eval(scene: Scene, sp: ShadePoint, dir_in, dir_out, sample_pdf=None):
    """Evaluate BRDF * cos(theta_out) (the reference folds the cosine in).

    `sample_pdf` is the pdf of the sample being evaluated, which multi-lobe
    materials read; None for NEE directions.
    """
    f = torch.zeros_like(dir_in)
    for tag in _tags(scene):
        f = torch.where((sp.tag == tag)[..., None], _diffuse_eval(sp, dir_in, dir_out), f)
    return f


def bsdf_pdf(scene: Scene, sp: ShadePoint, dir_in, dir_out):
    """Solid-angle pdf of sampling dir_out (get_bsdf_pdf, material.cpp:84-90)."""
    pdf = torch.zeros(dir_in.shape[:-1], dtype=dir_in.dtype, device=dir_in.device)
    for tag in _tags(scene):
        pdf = torch.where(sp.tag == tag, _cosine_pdf(sp, dir_in, dir_out), pdf)
    return pdf
