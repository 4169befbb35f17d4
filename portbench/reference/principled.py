"""The lobes of the principled BSDF in plain torch, for the reference's
`disneybsdf` and `disneymetal` material modules.

Written from the published equations:

  * Burley 2012, "Physically-Based Shading at Disney" (the diffuse lobe
    with its retro-reflection term F_D90 = 0.5 + 2 roughness cos^2(theta_d),
    the subsurface approximation with F_SS90 and its 1.25 factor, sheen
    (1 - cos theta_d)^5 tinted by the base colour's hue, the clearcoat's
    GTR1 distribution with alpha from 0.1 to 0.001 by gloss and its
    sampling, Appendix B eq. 2, Schlick's Fresnel toward the base colour, the
    anisotropic alphas by aspect = sqrt(1 - 0.9 anisotropic));
  * Burley 2015, "Extending the Disney BRDF to a BSDF with Integrated
    Subsurface Scattering" (the specular tint and IOR-derived F0 of the
    dielectric specular, sqrt of the base colour as the transmission tint);
  * Heitz 2014 (Smith's G1 for anisotropic GGX through Lambda) and Heitz
    2018, "Sampling the GGX Distribution of Visible Normals" (the listing
    and the pdf G1(v) max(0, v.h) D(h) / v.z);
  * Walter et al. 2007, "Microfacet Models for Refraction through Rough
    Surfaces" (the rough dielectric: half vectors, the exact dielectric
    Fresnel, the refraction Jacobian eta^2 |o.h| / (i.h + eta o.h)^2), in
    the radiance form whose eta^2 cancels (pbrt-v3's TransportMode::Radiance);
  * Frisvad 2012's branchless orthonormal basis (frame.to_world) for the
    tangent frame.

Vectors are world-space [..., 3]: `n` is the shading normal turned toward
`wi`, the direction back along the arriving ray; `geo_n` is the geometric
normal facing the arriving ray; `wo` is the other direction. Values are
BSDF x |cos| toward wo, pdfs per solid angle of wo.

The comparison that uses this module is path by path, so where the tracer
under test states its estimator differently from those sources, this module
follows the tracer:

  * alphas: roughness^2 floored at 1e-4 before the aspect (Burley floors
    each alpha at 0.001);
  * luminance for the tints with the Rec. 709 weights 0.212671, 0.715160,
    0.072169, floored at 1e-8 (Burley: 0.3, 0.6, 0.1, and a tint of 1 for
    black);
  * the Disney diffuse's n.wo is not clamped (Burley returns 0 for
    n.wo <= 0); both directions above the geometric surface are required;
  * Heitz's listing takes the tangent (1, 0, 0) where the stretched view
    vector lies within 1e-6 of the pole, and keeps the sampled normal's z
    at least 1e-6; the VNDF pdf divides by max(v.z, 1e-6), and the
    reflection Jacobian by max(4 h.wo, 4e-8);
  * the metal lobe (disneymetal): Schlick toward the base colour, valid only
    where wi and wo lie above the shading normal and wo above the
    geometric surface;
  * the composite's lobe weights: diffuse (1 - metallic)(1 - specTrans),
    sheen sheen (1 - metallic), metal 1 - specTrans (1 - metallic), glass
    (1 - metallic) specTrans, clearcoat 0.25 clearcoat; its metal lobe's
    Fresnel F0 = specular R0(eta) (1 - metallic) Ks + metallic baseColor;
  * the composite's sampling picks diffuse, metal, glass or clearcoat with
    probabilities proportional to their weights (sheen is not sampled) and
    returns the weighted sum of the four lobes' pdfs, or 0 where the lobe
    that drew the direction has no density there;
  * the composite adds the glass lobe on the reflection side too (with
    the other lobes) and only it where wo lies below the shading normal;
  * glass's transmission tint is sqrt(baseColor) and its reflection white.
"""

import math

import torch

from portbench.reference import frame
from portbench.reference.frame import dot

LUMINANCE = (0.212671, 0.715160, 0.072169)
ALPHA2_FLOOR = 1e-4  # least roughness^2
POLE = 1e-12  # squared length of the stretched view vector's xy under which the listing takes tangent (1, 0, 0)
H_Z_FLOOR = 1e-6  # least z of a sampled visible normal
COS_FLOOR = 1e-6  # least v.z that a pdf or a value divides by
JAC_FLOOR = 1e-8  # least h.wo of the reflection Jacobian


def luminance(c):
    return c[..., 0] * LUMINANCE[0] + c[..., 1] * LUMINANCE[1] + c[..., 2] * LUMINANCE[2]


def hue(c):
    """The colour over its luminance (Burley's Ctint)."""
    return c / torch.clamp(luminance(c), min=1e-8)[..., None]


def schlick_weight(cos):
    return torch.clamp(1.0 - cos, 0.0, 1.0) ** 5


class Frame:
    """The shading frame at n (Frisvad's basis)."""

    def __init__(self, n):
        x = torch.zeros_like(n)
        x[..., 0] = 1.0
        y = torch.zeros_like(n)
        y[..., 1] = 1.0
        self.n, self.tx, self.ty = n, frame.to_world(n, x), frame.to_world(n, y)

    def local(self, v):
        return torch.stack([dot(self.tx, v), dot(self.ty, v), dot(self.n, v)], -1)

    def world(self, v):
        return v[..., 0:1] * self.tx + v[..., 1:2] * self.ty + v[..., 2:3] * self.n


def alphas(roughness, anisotropic):
    aspect = torch.sqrt(torch.clamp(1.0 - 0.9 * anisotropic, min=1e-4))
    a2 = torch.clamp(roughness * roughness, min=ALPHA2_FLOOR)
    return a2 / aspect, a2 * aspect


def ggx_d(hl, ax, ay):
    """Anisotropic GGX: 1 / (pi ax ay (hx^2/ax^2 + hy^2/ay^2 + hz^2)^2) above the surface."""
    k = (hl[..., 0] / ax) ** 2 + (hl[..., 1] / ay) ** 2 + hl[..., 2] ** 2
    return torch.where(hl[..., 2] > 0.0, 1.0 / (math.pi * ax * ay * k * k), 0.0)


def smith_g1(vl, ax, ay):
    """1 / (1 + Lambda(v)), Lambda = (sqrt(1 + (ax^2 vx^2 + ay^2 vy^2) / vz^2) - 1) / 2."""
    tan2 = ((ax * vl[..., 0]) ** 2 + (ay * vl[..., 1]) ** 2) / torch.clamp(vl[..., 2] ** 2, min=1e-12)
    return 2.0 / (1.0 + torch.sqrt(1.0 + tan2))


def vndf_sample(vl, ax, ay, u1, u2):
    """Heitz 2018's listing: a visible normal (local) for view vl, vl.z >= 0."""
    vh = frame.normalize(torch.stack([ax * vl[..., 0], ay * vl[..., 1], vl[..., 2]], -1), eps=1e-20)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = torch.rsqrt(torch.where(lensq > POLE, lensq, torch.ones_like(lensq)))
    zero = torch.zeros_like(lensq)
    t1 = torch.where((lensq > POLE)[..., None], torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv, zero], -1),
                     torch.stack([torch.ones_like(lensq), zero, zero], -1))
    t2 = torch.linalg.cross(vh, t1, dim=-1)
    r, phi = torch.sqrt(u1), 2.0 * math.pi * u2
    p1, p2 = r * torch.cos(phi), r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None] * vh)
    ne = torch.stack([ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=H_Z_FLOOR)], -1)
    return frame.normalize(ne, eps=1e-20)


def vndf_pdf(vl, hl, ax, ay):
    """The density of vndf_sample over half vectors: G1(v) max(0, v.h) D(h) / v.z."""
    return (smith_g1(vl, ax, ay) * ggx_d(hl, ax, ay) * torch.clamp(torch.sum(vl * hl, -1), min=0.0)
            / torch.clamp(vl[..., 2], min=COS_FLOOR))


def reflect(wi, h):
    return 2.0 * dot(wi, h)[..., None] * h - wi


# -- the diffuse lobe (Burley 2012) and its cosine sampling --


def cosine_sample(n, u1, u2):
    """Malley's method: a cosine-distributed direction about n."""
    r, phi = torch.sqrt(u1), 2.0 * math.pi * u2
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], -1)
    return frame.to_world(n, local)


def cosine_pdf(n, geo_n, wo):
    return torch.where(dot(geo_n, wo) < 0.0, 0.0, torch.clamp(dot(n, wo), min=0.0) / math.pi)


def diffuse(base, roughness, subsurface, n, geo_n, wi, wo):
    """Burley's diffuse with retro-reflection, blended with his subsurface approximation."""
    h = frame.normalize(wi + wo, eps=1e-12)
    cos_d2 = dot(h, wo) ** 2
    n_i, n_o = dot(n, wi), dot(n, wo)
    fi, fo = schlick_weight(n_i), schlick_weight(n_o)
    f_d90 = 0.5 + 2.0 * roughness * cos_d2
    base_term = (1.0 + (f_d90 - 1.0) * fi) * (1.0 + (f_d90 - 1.0) * fo)
    f_ss90 = roughness * cos_d2
    ss = (1.0 + (f_ss90 - 1.0) * fi) * (1.0 + (f_ss90 - 1.0) * fo)
    ss_term = 1.25 * (ss * (1.0 / torch.clamp(n_i.abs() + n_o.abs(), min=1e-12) - 0.5) + 0.5)
    f = base * (((1.0 - subsurface) * base_term + subsurface * ss_term) * n_o / math.pi)[..., None]
    below = (dot(geo_n, wi) < 0.0) | (dot(geo_n, wo) < 0.0)
    return torch.where(below[..., None], 0.0, f)


# -- metal (disneymetal): anisotropic GGX, Schlick toward the base colour --


def _metal_ok(fr, geo_n, wi, wo):
    return (fr.local(wi)[..., 2] > 0.0) & (fr.local(wo)[..., 2] > 0.0) & (dot(geo_n, wo) > 0.0)


def metal_eval(base, roughness, anisotropic, n, geo_n, wi, wo):
    fr = Frame(n)
    il, ol = fr.local(wi), fr.local(wo)
    h = frame.normalize(wi + wo, eps=1e-20)
    ax, ay = alphas(roughness, anisotropic)
    f0 = base
    fresnel = f0 + (1.0 - f0) * schlick_weight(dot(h, wo))[..., None]
    dg = ggx_d(fr.local(h), ax, ay) * smith_g1(il, ax, ay) * smith_g1(ol, ax, ay)
    f = fresnel * (dg / (4.0 * torch.clamp(il[..., 2], min=COS_FLOOR)))[..., None]
    return torch.where(_metal_ok(fr, geo_n, wi, wo)[..., None], f, 0.0)


def metal_pdf(roughness, anisotropic, n, geo_n, wi, wo):
    fr = Frame(n)
    h = frame.normalize(wi + wo, eps=1e-20)
    ax, ay = alphas(roughness, anisotropic)
    pdf = vndf_pdf(fr.local(wi), fr.local(h), ax, ay) / (4.0 * torch.clamp(dot(h, wo), min=JAC_FLOOR))
    return torch.where(_metal_ok(fr, geo_n, wi, wo), pdf, 0.0)


def metal_sample(roughness, anisotropic, n, geo_n, wi, u1, u2):
    """(wo, pdf): a visible normal, reflected; pdf 0 where wi lies below the geometric surface."""
    fr = Frame(n)
    ax, ay = alphas(roughness, anisotropic)
    wo = reflect(wi, fr.world(vndf_sample(fr.local(wi), ax, ay, u1, u2)))
    pdf = metal_pdf(roughness, anisotropic, n, geo_n, wi, wo)
    return wo, torch.where(dot(geo_n, wi) < 0.0, 0.0, pdf)


# -- clearcoat: GTR1, Smith G at alpha 0.25, Schlick at F0 0.04 --


def clearcoat_alpha(gloss):
    return (1.0 - gloss) * 0.1 + gloss * 0.001


def gtr1(cos_h, alpha):
    a2 = alpha * alpha
    return (a2 - 1.0) / (math.pi * torch.log(a2) * (1.0 + (a2 - 1.0) * cos_h * cos_h))


def clearcoat_eval(gloss, n, geo_n, wi, wo):
    """[..., 3], grey."""
    fr = Frame(n)
    il, ol = fr.local(wi), fr.local(wo)
    h = frame.normalize(wi + wo, eps=1e-20)
    fresnel = 0.04 + 0.96 * schlick_weight(dot(h, wo))
    g = smith_g1(il, 0.25, 0.25) * smith_g1(ol, 0.25, 0.25)
    f = fresnel * gtr1(dot(n, h), clearcoat_alpha(gloss)) * g / (4.0 * torch.clamp(il[..., 2], min=COS_FLOOR))
    return torch.where(_metal_ok(fr, geo_n, wi, wo), f, 0.0)[..., None].expand(wi.shape)


def clearcoat_pdf(gloss, n, geo_n, wi, wo):
    fr = Frame(n)
    h = frame.normalize(wi + wo, eps=1e-20)
    cos_h = dot(n, h)
    pdf = gtr1(cos_h, clearcoat_alpha(gloss)) * torch.clamp(cos_h, min=0.0) / (
        4.0 * torch.clamp(dot(h, wo), min=JAC_FLOOR))
    return torch.where(_metal_ok(fr, geo_n, wi, wo), pdf, 0.0)


def clearcoat_sample(gloss, n, geo_n, wi, u1, u2):
    fr = Frame(n)
    a2 = torch.clamp(clearcoat_alpha(gloss) ** 2, min=1e-12)
    cos2 = torch.clamp((1.0 - a2 ** (1.0 - u1)) / (1.0 - a2), 0.0, 1.0)
    sin_h, phi = torch.sqrt(1.0 - cos2), 2.0 * math.pi * u2
    hl = torch.stack([sin_h * torch.cos(phi), sin_h * torch.sin(phi), torch.sqrt(cos2)], -1)
    wo = reflect(wi, fr.world(hl))
    pdf = clearcoat_pdf(gloss, n, geo_n, wi, wo)
    return wo, torch.where(dot(geo_n, wi) < 0.0, 0.0, pdf)


# -- sheen --


def sheen_eval(base, tint, n, geo_n, wi, wo):
    """Burley's sheen, (1 - h.wo)^5 max(0, n.wo) in the colour lerp(1, hue, tint), at weight 1."""
    h = frame.normalize(wi + wo, eps=1e-20)
    n_o = dot(n, wo)
    colour = (1.0 - tint)[..., None] + tint[..., None] * hue(base)
    f = colour * (schlick_weight(dot(h, wo)) * torch.clamp(n_o, min=0.0))[..., None]
    return torch.where(((n_o > 0.0) & (dot(geo_n, wo) > 0.0))[..., None], f, 0.0)


# -- glass: Walter et al.'s rough dielectric --


def fresnel_dielectric(cos_i, eta):
    """Unpolarised Fresnel reflectance for cos_i in [0, 1] and relative IOR eta; 1 under total internal reflection."""
    sin2_t = (1.0 - cos_i * cos_i) / (eta * eta)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    rs = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-12)
    rp = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-12)
    return torch.where(sin2_t >= 1.0, 1.0, 0.5 * (rs * rs + rp * rp))


def _glass_half(fr, eta, wi, wo):
    """(il, ol, reflecting, the half vector's local form in the upper hemisphere, h.wi, h.wo)."""
    il, ol = fr.local(wi), fr.local(wo)
    reflecting = ol[..., 2] > 0.0
    h = frame.normalize(torch.where(reflecting[..., None], wi + wo, wi + eta[..., None] * wo), eps=1e-20)
    h = torch.where((dot(fr.n, h) < 0.0)[..., None], -h, h)
    return il, ol, reflecting, fr.local(h), dot(h, wi), dot(h, wo)


def _glass_valid(ol, reflecting, hi, ho):
    """Walter et al.'s sidedness: the microfacet faces wi, and wo lies on its
    front for a reflection, on its back for a refraction (off the horizon)."""
    return (ol[..., 2].abs() > 1e-7) & (hi > 0.0) & torch.where(reflecting, ho > 0.0, ho < 0.0)


def glass_eval(base, roughness, anisotropic, eta, n, wi, wo):
    """eta: the relative IOR across the surface seen from wi (inside over outside from the front)."""
    fr = Frame(n)
    il, ol, reflecting, hl, hi, ho = _glass_half(fr, eta, wi, wo)
    ax, ay = alphas(roughness, anisotropic)
    fresnel = fresnel_dielectric(hi.abs().clamp(max=1.0), eta)
    dg = ggx_d(hl, ax, ay) * smith_g1(il, ax, ay) * smith_g1(ol, ax, ay)
    cos_i = torch.clamp(il[..., 2].abs(), min=COS_FLOOR)
    f_r = (fresnel * dg / (4.0 * cos_i))[..., None].expand(wi.shape)
    denom2 = torch.clamp((hi + eta * ho) ** 2, min=1e-12)
    f_t = torch.sqrt(torch.clamp(base, min=0.0)) * ((1.0 - fresnel) * dg * (hi * ho).abs() / (cos_i * denom2))[..., None]
    f = torch.where(reflecting[..., None], f_r, f_t)
    return torch.where(_glass_valid(ol, reflecting, hi, ho)[..., None], f, 0.0)


def glass_pdf(roughness, anisotropic, eta, n, wi, wo):
    fr = Frame(n)
    il, ol, reflecting, hl, hi, ho = _glass_half(fr, eta, wi, wo)
    ax, ay = alphas(roughness, anisotropic)
    fresnel = fresnel_dielectric(hi.abs().clamp(max=1.0), eta)
    ph = vndf_pdf(il, hl, ax, ay)
    p_r = fresnel * ph / torch.clamp(4.0 * ho.abs(), min=1e-12)
    p_t = (1.0 - fresnel) * ph * eta * eta * ho.abs() / torch.clamp((hi + eta * ho) ** 2, min=1e-12)
    return torch.where(_glass_valid(ol, reflecting, hi, ho), torch.where(reflecting, p_r, p_t), 0.0)


def glass_sample(roughness, anisotropic, eta, n, wi, u_choice, u1, u2):
    """(wo, pdf): a visible normal; reflection with probability F (always
    under total internal reflection); a reflection below the surface or a
    refraction above it fails."""
    fr = Frame(n)
    ax, ay = alphas(roughness, anisotropic)
    h = fr.world(vndf_sample(fr.local(wi), ax, ay, u1, u2))
    cos_i = dot(h, wi)
    sin2_t = (1.0 - cos_i * cos_i) / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refracted = frame.normalize(-wi / eta[..., None] + ((cos_i.abs() / eta - cos_t) * torch.sign(cos_i))[..., None] * h,
                                eps=1e-20)
    take = (u_choice <= fresnel_dielectric(cos_i.abs().clamp(max=1.0), eta)) | tir
    wo = torch.where(take[..., None], reflect(wi, h), refracted)
    return wo, torch.where(take == (dot(n, wo) > 0.0), glass_pdf(roughness, anisotropic, eta, n, wi, wo), 0.0)


# -- the composite (disneybsdf) --


def weights(p):
    """(diffuse, metal, glass, clearcoat) weights of the composite."""
    m, t = p["metallic"], p["specTrans"]
    return (1.0 - m) * (1.0 - t), 1.0 - t * (1.0 - m), (1.0 - m) * t, 0.25 * p["clearcoat"]


def lobe_probabilities(p):
    w = weights(p)
    total = torch.clamp(w[0] + w[1] + w[2] + w[3], min=1e-8)
    return tuple(x / total for x in w)


def composite_eval(p, eta, n, geo_n, wi, wo):
    fr = Frame(n)
    il, ol = fr.local(wi), fr.local(wo)
    dw, mw, gw, cw = weights(p)
    base, rough, aniso, m = p["reflectance"], p["roughness"], p["anisotropic"], p["metallic"]
    f_glass = glass_eval(base, rough, aniso, eta, n, wi, wo)
    # the metal lobe's Fresnel: F0 from the IOR, tinted toward the hue, blended toward the base colour by metallic
    ks = (1.0 - p["specularTint"])[..., None] + p["specularTint"][..., None] * hue(base)
    r0 = ((eta - 1.0) / (eta + 1.0)) ** 2
    c0 = (p["specular"] * r0 * (1.0 - m))[..., None] * ks + m[..., None] * base
    h = frame.normalize(wi + wo, eps=1e-20)
    ax, ay = alphas(rough, aniso)
    dg = ggx_d(fr.local(h), ax, ay) * smith_g1(il, ax, ay) * smith_g1(ol, ax, ay)
    f_metal = (c0 + (1.0 - c0) * schlick_weight(dot(h, wo))[..., None]) * (
        dg / (4.0 * torch.clamp(il[..., 2], min=COS_FLOOR)))[..., None]
    f_sheen = sheen_eval(base, p["sheenTint"], n, geo_n, wi, wo) * (p["sheen"] * (1.0 - m))[..., None]
    upper = (dw[..., None] * diffuse(base, rough, p["subsurface"], n, geo_n, wi, wo) + f_sheen
             + mw[..., None] * f_metal + cw[..., None] * clearcoat_eval(p["clearcoatGloss"], n, geo_n, wi, wo)
             + gw[..., None] * f_glass)
    reflecting = (il[..., 2] > 0.0) & (ol[..., 2] > 0.0)
    return torch.where(reflecting[..., None], upper, gw[..., None] * f_glass)


def composite_pdf(p, eta, n, geo_n, wi, wo):
    pd, pm, pg, pc = lobe_probabilities(p)
    rough, aniso = p["roughness"], p["anisotropic"]
    return (pd * cosine_pdf(n, geo_n, wo) + pm * metal_pdf(rough, aniso, n, geo_n, wi, wo)
            + pg * glass_pdf(rough, aniso, eta, n, wi, wo) + pc * clearcoat_pdf(p["clearcoatGloss"], n, geo_n, wi, wo))


def composite_sample(p, eta, n, geo_n, wi, u_lobe, u1, u2, u_aux):
    """(wo, pdf): one lobe picked by u_lobe, sampled with (u1, u2) (glass
    choosing reflection by u_aux), and the composite's pdf of its direction."""
    pd, pm, pg, _ = lobe_probabilities(p)
    rough, aniso = p["roughness"], p["anisotropic"]
    d_diffuse = cosine_sample(n, u1, u2)
    p_diffuse = torch.where(dot(geo_n, wi) < 0.0, 0.0, cosine_pdf(n, geo_n, d_diffuse))
    lobes = [(u_lobe < pd, (d_diffuse, p_diffuse)),
             (u_lobe < pd + pm, metal_sample(rough, aniso, n, geo_n, wi, u1, u2)),
             (u_lobe < pd + pm + pg, glass_sample(rough, aniso, eta, n, wi, u_aux, u1, u2))]
    wo, own = clearcoat_sample(p["clearcoatGloss"], n, geo_n, wi, u1, u2)
    for pick, (d, q) in reversed(lobes):
        wo, own = torch.where(pick[..., None], d, wo), torch.where(pick, q, own)
    # a direction where the lobe that drew it has no density fails: the
    # mixture's pdf there would count only the other lobes' draws
    return wo, torch.where(own > 0.0, composite_pdf(p, eta, n, geo_n, wi, wo), 0.0)


# -- parameters, as a scene file names them --

NAMES = {  # a parameter's names in scene files -> its key in the lanes' parameters
    "baseColor": "reflectance", "base_color": "reflectance", "roughness": "roughness",
    "anisotropic": "anisotropic", "metallic": "metallic", "specular": "specular",
    "specularTint": "specularTint", "specular_tint": "specularTint", "specTint": "specularTint",
    "spec_tint": "specularTint", "sheen": "sheen", "sheenTint": "sheenTint", "sheen_tint": "sheenTint",
    "clearcoat": "clearcoat", "clearcoatGloss": "clearcoatGloss", "clearcoat_gloss": "clearcoatGloss",
    "specTrans": "specTrans", "spec_trans": "specTrans", "specularTransmission": "specTrans",
    "specular_transmission": "specTrans", "eta": "eta", "ior": "eta", "subsurface": "subsurface",
}


def parse(node, parser, defaults):
    """{key: value} of a <bsdf> from `defaults` and the node's <rgb> and <float>
    children. The base colour is kept as `reflectance`, the key under which
    every material of the reference holds its colour."""
    out = dict(defaults)
    for c in node:
        key = NAMES.get(c.get("name"))
        if key is None or (key == "reflectance") != (c.tag == "rgb") or key not in defaults:
            raise ValueError(f"the reference's {node.get('type')} has no parameter <{c.tag} name={c.get('name')!r}>")
        out[key] = parser.rgb(c) if key == "reflectance" else parser.f(c.get("value"))
    return out
