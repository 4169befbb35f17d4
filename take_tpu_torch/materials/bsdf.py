"""Vectorized tagged-dispatch BSDFs (port of take_tpu/materials/bsdf.py).

Every ray batch carries an int tag per lane; each tag that the scene uses
(SceneMeta.used_material_tags, a static fact) runs its lobe over the whole
batch, and the results are blended with torch.where. Semantics are 1:1 with
the reference .inl files: eval returns BRDF * cos(theta_out), pdf == 0 marks
an invalid sample, and Plastic's "pdf == 1 flags the specular lobe" trick is
kept (plastic.inl:44-45).

Here are diffuse, mirror, plastic, phong, blinn-phong, blinn-phong
microfacet and disney-diffuse; the other Disney tags (metal, glass,
clearcoat, sheen, disneybsdf) dispatch to disney.py, as the JAX package's
disney_mode="full" does (its other modes, the reference's stubs, are not
ported). With tracing on, the Disney lobes' work in each dispatch is phase
`disney` and the Phong, Blinn-Phong and Blinn-Phong microfacet lobes' is
phase `glossy` (tracing.phase), inside whichever phase called the dispatch.
"""

from typing import NamedTuple

import torch

from take_tpu_torch import tracing
from take_tpu_torch.core.math import C_INVPI, C_INVTWOPI, dot, face_forward, gather_rows, normalize, reflect, to_world
from take_tpu_torch.core.sampling import sample_cos_power, sample_hemisphere_cos
from take_tpu_torch.materials import disney
from take_tpu_torch.materials.textures import eval_reflectance_packed
from take_tpu_torch.scene import types as ST
from take_tpu_torch.scene.types import (
    MAT_BLINN_PHONG,
    MAT_BLINN_PHONG_MICROFACET,
    MAT_DISNEY_DIFFUSE,
    MAT_MIRROR,
    MAT_PHONG,
    MAT_PLASTIC,
    Scene,
)

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
    p = gather_rows(scene.materials.attr, hit.mat_id.long())
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


def _schlick(F0, cos_t):
    """F0 + (1 - F0) (1 - cos)^5, scalar or per channel."""
    return F0 + (1.0 - F0) * _pow5(torch.clamp(1.0 - cos_t, 0.0, 1.0))


def _pow5(x):
    """x^5 as XLA's integer_pow computes x ** 5: x * ((x x)(x x))."""
    x2 = x * x
    return x * (x2 * x2)


def _powz(base, expo):
    """pow with base <= 0 clamped to 0 (the reference feeds negative bases
    through fmax afterwards)."""
    return torch.where(base > 0.0, torch.clamp(base, min=1e-30) ** expo, 0.0)


def _blinn_phong_G_hat(w, n, alpha):
    """Rational-fit masking term (material.h:134-140)."""
    odn = dot(w, n)
    odn2 = torch.clamp(odn * odn, min=1e-12)
    inv = torch.clamp(1.0 / odn2 - 1.0, min=1e-12)
    a = torch.sqrt(0.5 * alpha + 1.0) / torch.sqrt(inv)
    a2 = a * a
    g = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    return torch.where(a < 1.6, g, 1.0)


def _backface_zero(sp, dir_in, dir_out, val):
    """eval preamble: zero when either direction is under the geo surface."""
    bad = (dot(sp.geo_n, dir_in) < 0.0) | (dot(sp.geo_n, dir_out) < 0.0)
    return torch.where(bad[..., None], 0.0, val)


# -- Diffuse (materials/diffuse.inl) --


def _cosine_sample(sp, dir_in, u1, u2):
    """Cosine-hemisphere sampling (Diffuse, DisneyDiffuse, Plastic's diffuse lobe)."""
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


# -- Mirror (materials/mirror.inl) --


def _mirror_sample(sp, dir_in):
    n = _shading_frame(sp, dir_in)
    pdf = torch.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, 1.0)
    return reflect(dir_in, n), pdf


def _mirror_eval(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    return _backface_zero(sp, dir_in, dir_out, _schlick(sp.refl, dot(n, dir_out)[..., None]))


def _mirror_pdf(dir_in):
    return dir_in.new_zeros(dir_in.shape[:-1])  # delta lobe (mirror.inl:13)


# -- Plastic (materials/plastic.inl) --


def _plastic_fresnel(sp, n, direction):
    r = (sp.eta - 1.0) / (sp.eta + 1.0)
    return _schlick(r * r, dot(n, direction))


def _plastic_sample(sp, dir_in, u_lobe, u1, u2):
    n = _shading_frame(sp, dir_in)
    refl_dir = reflect(dir_in, n)
    take_spec = u_lobe <= _plastic_fresnel(sp, n, refl_dir)
    d_out, d_pdf = _cosine_sample(sp, dir_in, u1, u2)
    dir_out = torch.where(take_spec[..., None], refl_dir, d_out)
    pdf = torch.where(take_spec, 1.0, d_pdf)
    return dir_out, torch.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)


def _plastic_eval(sp, dir_in, dir_out, sample_pdf):
    n = _shading_frame(sp, dir_in)
    diff = sp.refl * (torch.clamp(dot(n, dir_out), min=0.0) * C_INVPI)[..., None]
    f = torch.where((sample_pdf == 1.0)[..., None], 1.0, diff)  # lobe flag (plastic.inl:44-45)
    return _backface_zero(sp, dir_in, dir_out, f)


def _plastic_pdf(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    F = _plastic_fresnel(sp, n, dir_out)
    pdf = (1.0 - F) * torch.clamp(dot(n, dir_out), min=0.0) * C_INVPI
    return torch.where(dot(sp.geo_n, dir_out) < 0.0, 0.0, pdf)


# -- Phong (materials/phong.inl) --


def _phong_lobe(sp, cos_r):
    return (sp.exponent + 1.0) * C_INVTWOPI * _powz(cos_r, sp.exponent)


def _phong_sample(sp, dir_in, u1, u2):
    n = _shading_frame(sp, dir_in)
    refl_dir = normalize(reflect(dir_in, n))
    dir_out = normalize(to_world(refl_dir, sample_cos_power(u1, u2, sp.exponent)))
    pdf = torch.clamp(_phong_lobe(sp, dot(refl_dir, dir_out)), min=0.0)
    pdf = torch.where(dot(sp.geo_n, dir_out) < 0.0, 0.0, pdf)
    return dir_out, torch.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)


def _phong_pdf(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    refl_dir = normalize(reflect(dir_in, n))
    pdf = torch.clamp(_phong_lobe(sp, dot(refl_dir, dir_out)), min=0.0)
    return torch.where(dot(sp.geo_n, dir_out) < 0.0, 0.0, pdf)


def _phong_eval(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    refl_dir = normalize(reflect(dir_in, n))
    f = sp.refl * _phong_lobe(sp, torch.clamp(dot(dir_out, refl_dir), min=0.0))[..., None]
    f = torch.where((dot(n, dir_out) <= 0.0)[..., None], 0.0, f)
    return _backface_zero(sp, dir_in, dir_out, f)


# -- BlinnPhong (materials/blinn_phong.inl) --


def _bp_pdf_formula(sp, n, h, dir_out):
    ndh = dot(n, h)
    odh = dot(dir_out, h)
    pdf = (sp.exponent + 1.0) * 0.25 * C_INVTWOPI * _powz(ndh, sp.exponent)
    pdf = pdf / torch.where(odh <= 0.0, 1.0, odh)
    return torch.where((ndh <= 0.0) | (odh <= 0.0), 0.0, pdf)


def _blinn_phong_sample(sp, dir_in, u1, u2):
    n = _shading_frame(sp, dir_in)
    h = normalize(to_world(n, sample_cos_power(u1, u2, sp.exponent)))
    dir_out = normalize(reflect(dir_in, h))
    pdf = _bp_pdf_formula(sp, n, h, dir_out)
    pdf = torch.where(dot(sp.geo_n, dir_out) <= 0.0, 0.0, pdf)
    return dir_out, torch.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)


def _blinn_phong_pdf(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    h = normalize(dir_out + dir_in, eps=1e-12)
    pdf = _bp_pdf_formula(sp, n, h, dir_out)
    return torch.where(dot(sp.geo_n, dir_out) <= 0.0, 0.0, pdf)


def _blinn_phong_eval(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    h = normalize(dir_out + dir_in, eps=1e-12)
    Fh = _schlick(sp.refl, dot(h, dir_out)[..., None])
    norm = (sp.exponent + 2.0) * 0.25 * C_INVPI / (2.0 - 2.0 ** (-sp.exponent / 2.0))
    f = Fh * (norm * _powz(torch.clamp(dot(n, h), min=0.0), sp.exponent))[..., None]
    f = torch.where((dot(n, dir_out) <= 0.0)[..., None], 0.0, f)
    return _backface_zero(sp, dir_in, dir_out, f)


# -- BlinnPhongMicrofacet (materials/blinn_phong_microfacet.inl) --


def _bp_micro_eval(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    h = normalize(dir_out + dir_in, eps=1e-12)
    ndh = torch.clamp(dot(n, h), 0.0, 1.0)
    Fh = _schlick(sp.refl, dot(h, dir_out)[..., None])
    Dh = (sp.exponent + 2.0) * C_INVTWOPI * _powz(ndh, sp.exponent)
    G = _blinn_phong_G_hat(dir_out, n, sp.exponent) * _blinn_phong_G_hat(dir_in, n, sp.exponent)
    ndin = torch.clamp(dot(n, dir_in), min=1e-12)
    f = Fh * (Dh * G * 0.25 / ndin)[..., None]
    bad = (dot(n, dir_out) <= 0.0) | (dot(dir_out, h) <= 0.0) | (dot(dir_in, h) <= 0.0)
    f = torch.where(bad[..., None], 0.0, f)
    return _backface_zero(sp, dir_in, dir_out, f)


# -- DisneyDiffuse (materials/disney_diffuse.inl) --


def _disney_diffuse_eval(sp, dir_in, dir_out):
    n = _shading_frame(sp, dir_in)
    h = normalize(dir_in + dir_out, eps=1e-12)
    hdout = dot(h, dir_out)
    ndout = dot(n, dir_out)
    ndin = dot(n, dir_in)

    def F(w, FF):
        return 1.0 + (FF - 1.0) * _pow5(torch.clamp(1.0 - dot(n, w), 0.0, 1.0))

    F_D90 = 0.5 + 2.0 * sp.roughness * hdout * hdout
    f_base = sp.refl * (C_INVPI * F(dir_in, F_D90) * F(dir_out, F_D90) * ndout)[..., None]
    F_SS90 = sp.roughness * hdout * hdout
    denom = torch.clamp(ndin.abs() + ndout.abs(), min=1e-12)
    f_ss = 1.25 * sp.refl * (
        C_INVPI * (F(dir_in, F_SS90) * F(dir_out, F_SS90) * (1.0 / denom - 0.5) + 0.5) * ndout
    )[..., None]
    f = (1.0 - sp.subsurface)[..., None] * f_base + sp.subsurface[..., None] * f_ss
    return _backface_zero(sp, dir_in, dir_out, f)


# ---------------------------------------------------------------------------
# Dispatch (take_tpu/materials/bsdf.py:396-485, disney_mode "full")
# ---------------------------------------------------------------------------


def bsdf_sample(scene: Scene, sp: ShadePoint, dir_in, u_lobe, u1, u2, u3=None):
    """Sample an outgoing direction per ray. Returns (dir_out [N,3], pdf [N]).

    pdf == 0 encodes an invalid sample (material.cpp:76-82). u_lobe is
    Plastic's lobe choice and the Disney composite's; u3 is the composite's
    extra uniform (its glass lobe's reflect/refract choice).
    """
    dir_out = torch.zeros_like(dir_in)
    pdf = torch.zeros(dir_in.shape[:-1], dtype=dir_in.dtype, device=dir_in.device)
    for tag in scene.meta.used_material_tags:
        if tag == MAT_MIRROR:
            d, p = _mirror_sample(sp, dir_in)
        elif tag == MAT_PLASTIC:
            d, p = _plastic_sample(sp, dir_in, u_lobe, u1, u2)
        elif tag == MAT_PHONG:
            with tracing.phase("glossy"):
                d, p = _phong_sample(sp, dir_in, u1, u2)
        elif tag in (MAT_BLINN_PHONG, MAT_BLINN_PHONG_MICROFACET):
            with tracing.phase("glossy"):
                d, p = _blinn_phong_sample(sp, dir_in, u1, u2)
        elif tag in disney.TAGS:
            with tracing.phase("disney"):
                d, p = disney.sample(tag, sp, dir_in, u_lobe, u1, u2, u3)
        else:  # Diffuse, DisneyDiffuse
            d, p = _cosine_sample(sp, dir_in, u1, u2)
        m = sp.tag == tag
        dir_out = torch.where(m[..., None], d, dir_out)
        pdf = torch.where(m, p, pdf)
    return dir_out, pdf


def bsdf_eval(scene: Scene, sp: ShadePoint, dir_in, dir_out, sample_pdf=None):
    """Evaluate BRDF * cos(theta_out) (the reference folds the cosine in).

    `sample_pdf` is the pdf of the sample being evaluated, which Plastic's
    lobe flag reads; None for NEE directions.
    """
    if sample_pdf is None:
        sample_pdf = dir_in.new_zeros(dir_in.shape[:-1])
    f = torch.zeros_like(dir_in)
    for tag in scene.meta.used_material_tags:
        if tag == MAT_MIRROR:
            v = _mirror_eval(sp, dir_in, dir_out)
        elif tag == MAT_PLASTIC:
            v = _plastic_eval(sp, dir_in, dir_out, sample_pdf)
        elif tag == MAT_PHONG:
            with tracing.phase("glossy"):
                v = _phong_eval(sp, dir_in, dir_out)
        elif tag == MAT_BLINN_PHONG:
            with tracing.phase("glossy"):
                v = _blinn_phong_eval(sp, dir_in, dir_out)
        elif tag == MAT_BLINN_PHONG_MICROFACET:
            with tracing.phase("glossy"):
                v = _bp_micro_eval(sp, dir_in, dir_out)
        elif tag == MAT_DISNEY_DIFFUSE:
            with tracing.phase("disney"):
                v = _disney_diffuse_eval(sp, dir_in, dir_out)
        elif tag in disney.TAGS:
            with tracing.phase("disney"):
                v = disney.eval(tag, sp, dir_in, dir_out)
        else:  # Diffuse
            v = _diffuse_eval(sp, dir_in, dir_out)
        f = torch.where((sp.tag == tag)[..., None], v, f)
    return f


def bsdf_pdf(scene: Scene, sp: ShadePoint, dir_in, dir_out):
    """Solid-angle pdf of sampling dir_out (get_bsdf_pdf, material.cpp:84-90)."""
    pdf = torch.zeros(dir_in.shape[:-1], dtype=dir_in.dtype, device=dir_in.device)
    for tag in scene.meta.used_material_tags:
        if tag == MAT_MIRROR:
            p = _mirror_pdf(dir_in)
        elif tag == MAT_PLASTIC:
            p = _plastic_pdf(sp, dir_in, dir_out)
        elif tag == MAT_PHONG:
            with tracing.phase("glossy"):
                p = _phong_pdf(sp, dir_in, dir_out)
        elif tag in (MAT_BLINN_PHONG, MAT_BLINN_PHONG_MICROFACET):
            with tracing.phase("glossy"):
                p = _blinn_phong_pdf(sp, dir_in, dir_out)
        elif tag in disney.TAGS:
            with tracing.phase("disney"):
                p = disney.pdf(tag, sp, dir_in, dir_out)
        else:  # Diffuse, DisneyDiffuse
            p = _cosine_pdf(sp, dir_in, dir_out)
        pdf = torch.where(sp.tag == tag, p, pdf)
    return pdf
