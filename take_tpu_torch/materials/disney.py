"""Disney BSDF lobes (Burley 2012/2015 principled BSDF), port of
take_tpu/materials/disney.py.

The reference stubs these (disney_metal.inl:22-28 is diffuse.inl); the JAX
package implements the lobes its parameter set intends, and the port
computes the same expressions in the same order:

  * Metal: anisotropic GGX with Smith masking and Schlick-toward-baseColor
    Fresnel; visible-normal (VNDF) sampling with the Jacobian 1/(4 h.out).
  * Clearcoat: Burley's clearcoat D (alpha set by gloss), Smith G at a
    fixed roughness of 0.25, F = Schlick(0.04).
  * Glass: rough dielectric, GGX half vectors, exact dielectric Fresnel,
    reflection and refraction; Hit.front orients eta. Its value and pdf are
    0 where no microfacet scatters dir_in into dir_out (Walter et al.'s
    sidedness), and a sample that leaves on the other side of the surface
    than its event (reflection or refraction) fails, so that the pdf is
    the density of the samples (take_tpu keeps both).
  * Sheen: the tint-blended retro term (1 - h.out)^5.
  * DisneyBSDF: the weighted composite (diffuse, sheen, metal, clearcoat,
    glass) with lobe-probability sampling and a blended pdf; a sample
    fails where its own lobe has no density (take_tpu keeps it).

eval returns BRDF * cos folded together; pdfs are solid-angle; dir_in
points away from the surface. Every function is batched [N] and branch-free.

On CUDA tensors `sample`, `eval` and `pdf` launch the hand-written kernels
of csrc/disney.cu, one launch a call, or raise; under autograd through an
autograd Function whose backward is the plain lobes'. On CPU tensors they
run the plain versions below (`_sample_plain`, `_eval_plain`,
`_pdf_plain`), whose arithmetic the kernels repeat. `LAUNCHES` counts what
ran: each kernel launch, and each call of a plain version.
"""

import ctypes

import torch

from take_tpu_torch.core.math import (
    C_INVPI, C_PI, C_TWOPI, constant, cross, dot, face_forward, normalize, reflect, to_world,
)
from take_tpu_torch.core.sampling import sample_hemisphere_cos
from take_tpu_torch.geometry._launch import Field, declare, field, raise_on
from take_tpu_torch.materials import bsdf
from take_tpu_torch.scene.types import (
    MAT_DISNEY_BSDF,
    MAT_DISNEY_CLEARCOAT,
    MAT_DISNEY_GLASS,
    MAT_DISNEY_METAL,
    MAT_DISNEY_SHEEN,
)

TAGS = (
    MAT_DISNEY_METAL,
    MAT_DISNEY_GLASS,
    MAT_DISNEY_CLEARCOAT,
    MAT_DISNEY_SHEEN,
    MAT_DISNEY_BSDF,
)

_MIN_ALPHA = 1e-4

LAUNCHES = {"sample": 0, "eval": 0, "pdf": 0, "sample_plain": 0, "eval_plain": 0, "pdf_plain": 0}


def _luminance(c):
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


def _alphas(roughness, anisotropic):
    """Anisotropic GGX alphas (Burley): aspect from anisotropic."""
    aspect = torch.sqrt(torch.clamp(1.0 - 0.9 * anisotropic, min=1e-4))
    a2 = torch.clamp(roughness * roughness, min=_MIN_ALPHA)
    return a2 / aspect, a2 * aspect  # (alpha_x, alpha_y)


def _frame(sp, dir_in):
    """Shading frame (n flipped toward dir_in) and its tangents via to_world."""
    n = face_forward(sp.sh_n, dir_in)
    tx = to_world(n, constant((1.0, 0.0, 0.0), n.dtype, n.device).expand(n.shape))
    ty = to_world(n, constant((0.0, 1.0, 0.0), n.dtype, n.device).expand(n.shape))
    return n, tx, ty


def _to_local(n, tx, ty, w):
    return torch.stack([dot(tx, w), dot(ty, w), dot(n, w)], dim=-1)


def _ggx_D(hl, ax, ay):
    """Anisotropic GGX NDF in the local frame, as (1/k)^2 / (pi ax ay)."""
    hx, hy, hz = hl[..., 0], hl[..., 1], hl[..., 2]
    k = hx * hx / (ax * ax) + hy * hy / (ay * ay) + hz * hz
    ik = 1.0 / torch.clamp(k, min=1e-7)
    return torch.where(hz > 0.0, ik * ik / (C_PI * ax * ay), 0.0)


def _sqrt0(x):
    """sqrt clamped at 0 (the JAX package's form, which keeps a zero
    gradient at the boundary)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _smith_lambda(wl, ax, ay):
    wx, wy, wz = wl[..., 0], wl[..., 1], wl[..., 2]
    wz2 = torch.clamp(wz * wz, min=1e-12)
    a = (ax * ax * wx * wx + ay * ay * wy * wy) / wz2
    return 0.5 * (torch.sqrt(1.0 + a) - 1.0)


def _smith_G1(wl, ax, ay):
    return 1.0 / (1.0 + _smith_lambda(wl, ax, ay))


def _sample_ggx_vndf(wl, ax, ay, u1, u2):
    """Heitz 2018 visible-normal sampling in the local frame (wl.z > 0)."""
    v = normalize(torch.stack([wl[..., 0] * ax, wl[..., 1] * ay, wl[..., 2]], dim=-1), eps=1e-20)
    lensq = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack([-v[..., 1] * inv, v[..., 0] * inv, torch.zeros_like(inv)], -1),
        constant((1.0, 0.0, 0.0), v.dtype, v.device).expand(v.shape),
    )
    t2 = cross(v, t1)
    r = _sqrt0(torch.clamp(u1, 0.0, 1.0))
    phi = C_TWOPI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * _sqrt0(torch.clamp(1.0 - p1 * p1, 0.0, 1.0)) + s * p2
    p3 = _sqrt0(torch.clamp(1.0 - p1 * p1 - p2 * p2, 0.0, 1.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    h = torch.stack([nh[..., 0] * ax, nh[..., 1] * ay, torch.clamp(nh[..., 2], min=1e-6)], -1)
    return normalize(h, eps=1e-20)


def _vndf_pdf(wl_in, hl, ax, ay):
    """pdf of _sample_ggx_vndf in half-vector measure: G1 D max(0,w.h)/w.z."""
    D = _ggx_D(hl, ax, ay)
    G1 = _smith_G1(wl_in, ax, ay)
    wh = torch.clamp(torch.sum(wl_in * hl, dim=-1), min=0.0)
    wz = torch.clamp(wl_in[..., 2], min=1e-6)
    return G1 * D * wh / wz


def _schlick_w(cos_t):
    return bsdf._pow5(torch.clamp(1.0 - cos_t, 0.0, 1.0))


def _fresnel_dielectric(cos_i, eta):
    """Exact dielectric Fresnel; cos_i >= 0, eta = n_transmitted/n_incident."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = _sqrt0(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
    rs = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    rp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    F = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, F)


def _reflecting_ok(sp, il, ol, dir_out):
    return (il[..., 2] > 0.0) & (ol[..., 2] > 0.0) & (dot(sp.geo_n, dir_out) > 0.0)


# -- Metal --


def _metal_eval(sp, dir_in, dir_out):
    n, tx, ty = _frame(sp, dir_in)
    il = _to_local(n, tx, ty, dir_in)
    ol = _to_local(n, tx, ty, dir_out)
    h = normalize(dir_in + dir_out, eps=1e-20)
    hl = _to_local(n, tx, ty, h)
    ax, ay = _alphas(sp.roughness, sp.anisotropic)
    D = _ggx_D(hl, ax, ay)
    G = _smith_G1(il, ax, ay) * _smith_G1(ol, ax, ay)
    F = sp.refl + (1.0 - sp.refl) * _schlick_w(torch.sum(h * dir_out, -1))[..., None]
    niz = torch.clamp(il[..., 2], min=1e-6)
    f = F * (D * G / (4.0 * niz))[..., None]
    return torch.where(_reflecting_ok(sp, il, ol, dir_out)[..., None], f, 0.0)


def _metal_pdf(sp, dir_in, dir_out):
    n, tx, ty = _frame(sp, dir_in)
    il = _to_local(n, tx, ty, dir_in)
    h = normalize(dir_in + dir_out, eps=1e-20)
    hl = _to_local(n, tx, ty, h)
    ol = _to_local(n, tx, ty, dir_out)
    ax, ay = _alphas(sp.roughness, sp.anisotropic)
    hdo = torch.clamp(torch.sum(h * dir_out, -1), min=1e-8)
    pdf = _vndf_pdf(il, hl, ax, ay) / (4.0 * hdo)
    return torch.where(_reflecting_ok(sp, il, ol, dir_out), pdf, 0.0)


def _metal_sample(sp, dir_in, u1, u2):
    n, tx, ty = _frame(sp, dir_in)
    il = _to_local(n, tx, ty, dir_in)
    ax, ay = _alphas(sp.roughness, sp.anisotropic)
    hl = _sample_ggx_vndf(il, ax, ay, u1, u2)
    h = hl[..., 0:1] * tx + hl[..., 1:2] * ty + hl[..., 2:3] * n
    dir_out = reflect(dir_in, h)
    pdf = _metal_pdf(sp, dir_in, dir_out)
    return dir_out, torch.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)


# -- Clearcoat --


def _cc_alpha(sp):
    return (1.0 - sp.clearcoat_gloss) * 0.1 + sp.clearcoat_gloss * 0.001


def _cc_D(hz, alpha):
    a2 = alpha * alpha
    denom = C_PI * torch.log(torch.clamp(a2, min=1e-12)) * (1.0 + (a2 - 1.0) * hz * hz)
    return (a2 - 1.0) / torch.where(denom.abs() < 1e-12, 1e-12, denom)


def _clearcoat_eval(sp, dir_in, dir_out):
    n, tx, ty = _frame(sp, dir_in)
    il = _to_local(n, tx, ty, dir_in)
    ol = _to_local(n, tx, ty, dir_out)
    h = normalize(dir_in + dir_out, eps=1e-20)
    hl = _to_local(n, tx, ty, h)
    D = _cc_D(hl[..., 2], _cc_alpha(sp))
    F = 0.04 + 0.96 * _schlick_w(torch.sum(h * dir_out, -1))
    G = _smith_G1(il, 0.25, 0.25) * _smith_G1(ol, 0.25, 0.25)
    niz = torch.clamp(il[..., 2], min=1e-6)
    f = F * D * G / (4.0 * niz)
    return torch.where(_reflecting_ok(sp, il, ol, dir_out), f, 0.0)[..., None] * torch.ones_like(dir_in)


def _clearcoat_pdf(sp, dir_in, dir_out):
    n, tx, ty = _frame(sp, dir_in)
    ol = _to_local(n, tx, ty, dir_out)
    il = _to_local(n, tx, ty, dir_in)
    h = normalize(dir_in + dir_out, eps=1e-20)
    hl = _to_local(n, tx, ty, h)
    D = _cc_D(hl[..., 2], _cc_alpha(sp))
    hdo = torch.clamp(torch.sum(h * dir_out, -1), min=1e-8)
    pdf = D * torch.clamp(hl[..., 2], min=0.0) / (4.0 * hdo)  # D cos_h / (4 h.out)
    return torch.where(_reflecting_ok(sp, il, ol, dir_out), pdf, 0.0)


def _clearcoat_sample(sp, dir_in, u1, u2):
    n, tx, ty = _frame(sp, dir_in)
    alpha = _cc_alpha(sp)
    a2 = torch.clamp(alpha * alpha, min=1e-12)
    cos2 = (1.0 - a2 ** (1.0 - u1)) / (1.0 - a2)
    cos_h = _sqrt0(torch.clamp(cos2, 0.0, 1.0))
    sin_h = _sqrt0(torch.clamp(1.0 - cos2, 0.0, 1.0))
    phi = C_TWOPI * u2
    hl = torch.stack([sin_h * torch.cos(phi), sin_h * torch.sin(phi), cos_h], -1)
    h = hl[..., 0:1] * tx + hl[..., 1:2] * ty + cos_h[..., None] * n
    dir_out = reflect(dir_in, h)
    pdf = _clearcoat_pdf(sp, dir_in, dir_out)
    return dir_out, torch.where(dot(sp.geo_n, dir_in) < 0.0, 0.0, pdf)


# -- Sheen --


def _sheen_color(sp):
    lum = torch.clamp(_luminance(sp.refl), min=1e-8)
    tint = sp.refl / lum[..., None]
    return (1.0 - sp.sheen_tint)[..., None] + sp.sheen_tint[..., None] * tint


def _sheen_eval(sp, dir_in, dir_out):
    n = face_forward(sp.sh_n, dir_in)
    h = normalize(dir_in + dir_out, eps=1e-20)
    hdo = torch.sum(h * dir_out, -1)
    ndo = dot(n, dir_out)
    f = _sheen_color(sp) * (_schlick_w(hdo) * torch.clamp(ndo, min=0.0))[..., None]
    ok = (ndo > 0.0) & (dot(sp.geo_n, dir_out) > 0.0)
    return torch.where(ok[..., None], f, 0.0)


def _sheen_sample(sp, dir_in, u1, u2):
    n = face_forward(sp.sh_n, dir_in)
    dir_out = to_world(n, sample_hemisphere_cos(u1, u2))
    pdf = torch.clamp(dot(n, dir_out), min=0.0) * C_INVPI
    bad = (dot(sp.geo_n, dir_out) < 0.0) | (dot(sp.geo_n, dir_in) < 0.0)
    return dir_out, torch.where(bad, 0.0, pdf)


def _sheen_pdf(sp, dir_in, dir_out):
    n = face_forward(sp.sh_n, dir_in)
    pdf = torch.clamp(dot(n, dir_out), min=0.0) * C_INVPI
    return torch.where(dot(sp.geo_n, dir_out) < 0.0, 0.0, pdf)


# -- Glass (rough dielectric) --


def _glass_eta(sp):
    """eta = n_inside / n_outside, oriented by the side the ray came from."""
    return torch.where(sp.front, sp.eta, 1.0 / torch.clamp(sp.eta, min=1e-6))


def _glass_half(sp, dir_in, dir_out):
    """(frame, eta, local in/out, alphas, reflecting, half vector h and its
    local hl, both flipped into the upper hemisphere, h.in, h.out)."""
    n, tx, ty = _frame(sp, dir_in)
    eta = _glass_eta(sp)
    il = _to_local(n, tx, ty, dir_in)
    ol = _to_local(n, tx, ty, dir_out)
    ax, ay = _alphas(sp.roughness, sp.anisotropic)
    reflecting = ol[..., 2] > 0.0
    h_r = normalize(dir_in + dir_out, eps=1e-20)
    h_t = normalize(dir_in + dir_out * eta[..., None], eps=1e-20)
    h = torch.where(reflecting[..., None], h_r, h_t)
    hl = _to_local(n, tx, ty, h)
    flip = (hl[..., 2] < 0.0)[..., None]
    hl = torch.where(flip, -hl, hl)
    h = torch.where(flip, -h, h)
    hdi = torch.sum(h * dir_in, -1)
    hdo = torch.sum(h * dir_out, -1)
    return eta, il, ol, ax, ay, reflecting, hl, hdi, hdo


def _glass_valid(ol, reflecting, hdi, hdo):
    """Where the rough dielectric scatters dir_in into dir_out at all: off
    the horizon, and (Walter et al. 2007's sidedness) by a microfacet that
    faces dir_in, with dir_out on its front for a reflection and on its back
    for a refraction. Elsewhere no microfacet maps one into the other, and
    the value and the pdf are 0."""
    side = torch.where(reflecting, hdo > 0.0, hdo < 0.0)
    return (ol[..., 2].abs() > 1e-7) & (hdi > 0.0) & side


def _glass_eval(sp, dir_in, dir_out):
    eta, il, ol, ax, ay, reflecting, hl, hdi, hdo = _glass_half(sp, dir_in, dir_out)
    F = _fresnel_dielectric(hdi.abs(), eta)
    D = _ggx_D(hl, ax, ay)
    # Smith lambda reads squared components only, so ol works on both sides
    G = _smith_G1(il, ax, ay) * _smith_G1(ol, ax, ay)
    niz = torch.clamp(il[..., 2].abs(), min=1e-6)
    f_refl = (F * D * G / (4.0 * niz))[..., None] * torch.ones_like(sp.refl)
    denom = hdi + eta * hdo
    denom2 = torch.clamp(denom * denom, min=1e-12)
    f_trans = _sqrt0(torch.clamp(sp.refl, min=0.0)) * (
        (1.0 - F) * D * G * (hdo * hdi).abs() / (niz * denom2)
    )[..., None]
    f = torch.where(reflecting[..., None], f_refl, f_trans)
    return torch.where(_glass_valid(ol, reflecting, hdi, hdo)[..., None], f, 0.0)


def _glass_pdf(sp, dir_in, dir_out):
    eta, il, ol, ax, ay, reflecting, hl, hdi, hdo = _glass_half(sp, dir_in, dir_out)
    F = _fresnel_dielectric(hdi.abs(), eta)
    ph = _vndf_pdf(il, hl, ax, ay)
    pdf_refl = F * ph / torch.clamp(4.0 * hdo.abs(), min=1e-12)
    denom = hdi + eta * hdo
    denom2 = torch.clamp(denom * denom, min=1e-12)
    jac_t = eta * eta * hdo.abs() / denom2
    pdf_trans = (1.0 - F) * ph * jac_t
    pdf = torch.where(reflecting, pdf_refl, pdf_trans)
    return torch.where(_glass_valid(ol, reflecting, hdi, hdo), pdf, 0.0)


def _glass_sample(sp, dir_in, u_lobe, u1, u2):
    n, tx, ty = _frame(sp, dir_in)
    eta = _glass_eta(sp)
    il = _to_local(n, tx, ty, dir_in)
    ax, ay = _alphas(sp.roughness, sp.anisotropic)
    hl = _sample_ggx_vndf(il, ax, ay, u1, u2)
    h = hl[..., 0:1] * tx + hl[..., 1:2] * ty + hl[..., 2:3] * n

    hdi = torch.sum(h * dir_in, -1)
    F = _fresnel_dielectric(hdi.abs(), eta)
    d_refl = reflect(dir_in, h)
    # refraction (Snell through h)
    cos_i = hdi
    sin2_t = (1.0 - cos_i * cos_i) / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = _sqrt0(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
    d_trans = normalize(
        -dir_in / eta[..., None] + (cos_i.abs() / eta - cos_t)[..., None] * torch.sign(cos_i)[..., None] * h,
        eps=1e-20,
    )
    take_refl = (u_lobe <= F) | tir
    dir_out = torch.where(take_refl[..., None], d_refl, d_trans)
    # a reflection that leaves below the surface, or a refraction above it,
    # fails: the pdf there is the other event's density
    above = dot(n, dir_out) > 0.0
    return dir_out, torch.where(take_refl == above, _glass_pdf(sp, dir_in, dir_out), 0.0)


# -- DisneyBSDF composite --


def _bsdf_weights(sp):
    """Lobe mixture weights (Burley 2015 coefficients)."""
    diffuse_w = (1.0 - sp.metallic) * (1.0 - sp.spec_trans)
    metal_w = 1.0 - sp.spec_trans * (1.0 - sp.metallic)
    glass_w = (1.0 - sp.metallic) * sp.spec_trans
    clearcoat_w = 0.25 * sp.clearcoat
    return diffuse_w, metal_w, glass_w, clearcoat_w


def _bsdf_metal_fresnel(sp, h, dir_out, eta):
    """Metal lobe Fresnel with specular/specular_tint/eta modulation."""
    lum = torch.clamp(_luminance(sp.refl), min=1e-8)
    tint = sp.refl / lum[..., None]
    ks = (1.0 - sp.specular_tint)[..., None] + sp.specular_tint[..., None] * tint
    r = (eta - 1.0) / (eta + 1.0)
    r0 = r * r
    c0 = (
        sp.specular[..., None] * r0[..., None] * (1.0 - sp.metallic)[..., None] * ks
        + sp.metallic[..., None] * sp.refl
    )
    hdo = torch.sum(h * dir_out, -1)
    return c0 + (1.0 - c0) * _schlick_w(hdo)[..., None]


def _disney_bsdf_eval(sp, dir_in, dir_out):
    n, tx, ty = _frame(sp, dir_in)
    il = _to_local(n, tx, ty, dir_in)
    ol = _to_local(n, tx, ty, dir_out)
    dw, mw, gw, cw = _bsdf_weights(sp)
    eta = _glass_eta(sp)
    reflecting = (il[..., 2] > 0.0) & (ol[..., 2] > 0.0)

    # diffuse, sheen, metal and clearcoat only on the reflection side
    f_diff = bsdf._disney_diffuse_eval(sp, dir_in, dir_out)
    f_sheen = _sheen_eval(sp, dir_in, dir_out) * sp.sheen[..., None] * (1.0 - sp.metallic)[..., None]
    h = normalize(dir_in + dir_out, eps=1e-20)
    hl = _to_local(n, tx, ty, h)
    ax, ay = _alphas(sp.roughness, sp.anisotropic)
    D = _ggx_D(hl, ax, ay)
    G = _smith_G1(il, ax, ay) * _smith_G1(ol, ax, ay)
    Fm = _bsdf_metal_fresnel(sp, h, dir_out, eta)
    niz = torch.clamp(il[..., 2], min=1e-6)
    f_metal = Fm * (D * G / (4.0 * niz))[..., None]
    f_cc = _clearcoat_eval(sp, dir_in, dir_out)
    f_glass = _glass_eval(sp, dir_in, dir_out)
    return torch.where(
        reflecting[..., None],
        dw[..., None] * f_diff + f_sheen + mw[..., None] * f_metal + cw[..., None] * f_cc + gw[..., None] * f_glass,
        gw[..., None] * f_glass,
    )


def _bsdf_lobe_probs(sp):
    dw, mw, gw, cw = _bsdf_weights(sp)
    total = torch.clamp(dw + mw + gw + cw, min=1e-8)
    return dw / total, mw / total, gw / total, cw / total


def _disney_bsdf_pdf(sp, dir_in, dir_out):
    pd, pm, pg, pc = _bsdf_lobe_probs(sp)
    return (
        pd * bsdf._cosine_pdf(sp, dir_in, dir_out)
        + pm * _metal_pdf(sp, dir_in, dir_out)
        + pg * _glass_pdf(sp, dir_in, dir_out)
        + pc * _clearcoat_pdf(sp, dir_in, dir_out)
    )


def _disney_bsdf_sample(sp, dir_in, u_lobe, u1, u2, u3):
    """One lobe's sample, picked by u_lobe, with the mixture's pdf. A
    direction at which the lobe that drew it has no density (a metal or
    clearcoat reflection below the surface, say) is a failed sample: the
    mixture's pdf there counts the other lobes' draws only (glass's, below
    the surface), so keeping it would weight it by a pdf below its density."""
    pd, pm, pg, _ = _bsdf_lobe_probs(sp)
    d_d, p_d = bsdf._cosine_sample(sp, dir_in, u1, u2)
    d_m, p_m = _metal_sample(sp, dir_in, u1, u2)
    d_g, p_g = _glass_sample(sp, dir_in, u3, u1, u2)
    d_c, p_c = _clearcoat_sample(sp, dir_in, u1, u2)
    c1 = u_lobe < pd
    c2 = u_lobe < pd + pm
    c3 = u_lobe < pd + pm + pg
    dir_out = torch.where(
        c1[..., None],
        d_d,
        torch.where(c2[..., None], d_m, torch.where(c3[..., None], d_g, d_c)),
    )
    own = torch.where(c1, p_d, torch.where(c2, p_m, torch.where(c3, p_g, p_c)))
    return dir_out, torch.where(own > 0.0, _disney_bsdf_pdf(sp, dir_in, dir_out), 0.0)


# -- Dispatch (materials/bsdf.py calls these for TAGS) --


def _sample_plain(tag, sp, dir_in, u_lobe, u1, u2, u3):
    if tag == MAT_DISNEY_METAL:
        return _metal_sample(sp, dir_in, u1, u2)
    if tag == MAT_DISNEY_GLASS:
        return _glass_sample(sp, dir_in, u_lobe, u1, u2)
    if tag == MAT_DISNEY_CLEARCOAT:
        return _clearcoat_sample(sp, dir_in, u1, u2)
    if tag == MAT_DISNEY_SHEEN:
        return _sheen_sample(sp, dir_in, u1, u2)
    if tag == MAT_DISNEY_BSDF:
        return _disney_bsdf_sample(sp, dir_in, u_lobe, u1, u2, u3)
    raise NotImplementedError(tag)


def _eval_plain(tag, sp, dir_in, dir_out):
    if tag == MAT_DISNEY_METAL:
        return _metal_eval(sp, dir_in, dir_out)
    if tag == MAT_DISNEY_GLASS:
        return _glass_eval(sp, dir_in, dir_out)
    if tag == MAT_DISNEY_CLEARCOAT:
        return _clearcoat_eval(sp, dir_in, dir_out)
    if tag == MAT_DISNEY_SHEEN:
        return _sheen_eval(sp, dir_in, dir_out) * sp.sheen[..., None]
    if tag == MAT_DISNEY_BSDF:
        return _disney_bsdf_eval(sp, dir_in, dir_out)
    raise NotImplementedError(tag)


def _pdf_plain(tag, sp, dir_in, dir_out):
    if tag == MAT_DISNEY_METAL:
        return _metal_pdf(sp, dir_in, dir_out)
    if tag == MAT_DISNEY_GLASS:
        return _glass_pdf(sp, dir_in, dir_out)
    if tag == MAT_DISNEY_CLEARCOAT:
        return _clearcoat_pdf(sp, dir_in, dir_out)
    if tag == MAT_DISNEY_SHEEN:
        return _sheen_pdf(sp, dir_in, dir_out)
    if tag == MAT_DISNEY_BSDF:
        return _disney_bsdf_pdf(sp, dir_in, dir_out)
    raise NotImplementedError(tag)


_PLAIN = {"sample": _sample_plain, "eval": _eval_plain, "pdf": _pdf_plain}


# -- The kernels (csrc/disney.cu) --


# disney.cu's Inputs, field for field: the ShadePoint's fields it reads,
# the directions, the uniforms and the lane count
_VECTORS = ("refl", "geo_n", "sh_n", "dir_in", "dir_out")
_SCALARS = ("eta", "roughness", "subsurface", "anisotropic", "metallic", "spec_trans", "specular", "specular_tint",
            "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss")
_UNIFORMS = ("u_lobe", "u1", "u2", "u3")


class _Inputs(ctypes.Structure):
    _fields_ = [(name, Field) for name in ("tag", "front", *_VECTORS, *_SCALARS, *_UNIFORMS)] + [("n", ctypes.c_int64)]


def _inputs(sp, dir_in, dir_out, uniforms):
    """disney.cu's Inputs for a call: every field a pointer into its tensor
    and a row stride, with no copy. float32 only."""
    n, dev = dir_in.shape[0], dir_in.device
    ins = _Inputs(n=n)
    ins.tag = field("tag", sp.tag, n, torch.int32, 1, dev)
    ins.front = field("front", sp.front, n, torch.bool, 1, dev)
    vectors = {"refl": sp.refl, "geo_n": sp.geo_n, "sh_n": sp.sh_n, "dir_in": dir_in, "dir_out": dir_out}
    for name, x in vectors.items():
        if x is not None:
            setattr(ins, name, field(name, x, n, torch.float32, 3, dev))
    for name in _SCALARS:
        setattr(ins, name, field(name, getattr(sp, name), n, torch.float32, 1, dev))
    for name, u in zip(_UNIFORMS, uniforms):
        setattr(ins, name, field(name, u, n, torch.float32, 1, dev))
    return ins


def _launch(entry, tag, sp, dir_in, *rest):
    """One launch of take_disney_<entry> for `tag`: (dir_out [N, 3], pdf
    [N]) for sample (rest: u_lobe, u1, u2, u3), f [N, 3] for eval and pdf
    [N] for pdf (rest: dir_out). Lanes of other tags read 0."""
    n, dev = dir_in.shape[0], dir_in.device
    ins = _inputs(sp, dir_in, rest[0] if entry != "sample" else None, rest if entry == "sample" else ())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if entry == "sample":
        d, p = torch.empty((n, 3), dtype=torch.float32, device=dev), torch.empty(n, dtype=torch.float32, device=dev)
        if n:
            raise_on(_lib(), _lib().tt_disney_sample(ctypes.byref(ins), tag, d.data_ptr(), p.data_ptr(), stream),
                     "take_disney_sample")
        return d, p
    out = torch.empty((n, 3) if entry == "eval" else (n,), dtype=torch.float32, device=dev)
    if n:
        fn = _lib().tt_disney_eval if entry == "eval" else _lib().tt_disney_pdf
        raise_on(_lib(), fn(ctypes.byref(ins), tag, out.data_ptr(), stream), f"take_disney_{entry}")
    return out


class _Lobes(torch.autograd.Function):
    """take_disney_<entry> forward. The backward computes the plain lobes
    again on detached inputs and pulls the cotangent through them, so that
    gradients through the kernel are the plain version's. apply(tag,
    ShadePoint class, *its fields, dir_in, *rest)."""

    entry = None

    @classmethod
    def forward(cls, ctx, tag, sp_type, *xs):
        k = len(sp_type._fields)
        ctx.tag, ctx.sp_type = tag, sp_type
        ctx.save_for_backward(*xs)
        return _launch(cls.entry, tag, sp_type(*xs[:k]), *xs[k:])

    @classmethod
    def backward(cls, ctx, *grads):
        xs, need = ctx.saved_tensors, ctx.needs_input_grad[2:]
        k = len(ctx.sp_type._fields)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(want) for x, want in zip(xs, need)]
            outs = _PLAIN[cls.entry](ctx.tag, ctx.sp_type(*leaves[:k]), *leaves[k:])
            outs = outs if isinstance(outs, tuple) else (outs,)
            pulled = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            wanted = [x for x in leaves if x.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pulled], wanted, [g for _, g in pulled], allow_unused=True)
                       if pulled and wanted else [None] * len(wanted))
        return (None, None, *[next(got) if want else None for want in need])


class _Sample(_Lobes):
    entry = "sample"


class _Eval(_Lobes):
    entry = "eval"


class _Pdf(_Lobes):
    entry = "pdf"


_FUNCTIONS = {"sample": _Sample, "eval": _Eval, "pdf": _Pdf}


def _route(entry, tag, sp, dir_in, *rest):
    """The kernel for CUDA tensors (through its autograd Function where a
    gradient is wanted), the plain version for CPU tensors."""
    if tag not in TAGS:
        raise NotImplementedError(tag)
    if not dir_in.is_cuda:
        LAUNCHES[f"{entry}_plain"] += 1
        return _PLAIN[entry](tag, sp, dir_in, *rest)
    xs = (*sp, dir_in, *rest)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        out = _FUNCTIONS[entry].apply(tag, type(sp), *xs)
    else:
        out = _launch(entry, tag, sp, dir_in, *rest)
    LAUNCHES[entry] += 1
    return out


def sample(tag, sp, dir_in, u_lobe, u1, u2, u3=None):
    """(dir_out [N, 3], pdf [N]) of the Disney lobe `tag` at every lane."""
    return _route("sample", tag, sp, dir_in, u_lobe, u1, u2, u_lobe if u3 is None else u3)


def eval(tag, sp, dir_in, dir_out):
    """BSDF value times cos(theta_out), [N, 3], of the Disney lobe `tag`."""
    return _route("eval", tag, sp, dir_in, dir_out)


def pdf(tag, sp, dir_in, dir_out):
    """Solid-angle pdf [N] of the Disney lobe `tag` sampling dir_out."""
    return _route("pdf", tag, sp, dir_in, dir_out)


def _warm():
    """Each kernel once, on one lane of no Disney tag, uncounted."""
    dev = torch.device("cuda", torch.cuda.current_device())
    zero, v = torch.zeros(1, device=dev), torch.zeros((1, 3), device=dev)
    sp = bsdf.ShadePoint(*(v if name in _VECTORS else zero for name in bsdf.ShadePoint._fields))._replace(
        tag=torch.zeros(1, dtype=torch.int32, device=dev), front=torch.ones(1, dtype=torch.bool, device=dev))
    _launch("sample", MAT_DISNEY_BSDF, sp, v, zero, zero, zero, zero)
    _launch("eval", MAT_DISNEY_BSDF, sp, v, v)
    _launch("pdf", MAT_DISNEY_BSDF, sp, v, v)


_P, _I = ctypes.c_void_p, ctypes.c_int
# disney.cu rounds every float operation as torch's separate kernels do: no
# product is contracted into an FMA that the plain version rounds twice
_lib = declare("disney", {
    "tt_disney_sample": [_P, _I, _P, _P, _P],
    "tt_disney_eval": [_P, _I, _P, _P],
    "tt_disney_pdf": [_P, _I, _P, _P],
}, launches=LAUNCHES, flags=("--fmad=false",), warm=_warm)
