"""Vectorized tagged-dispatch BSDFs (port of take_tpu/materials/bsdf.py).

Every ray batch carries an int tag per lane. Semantics are 1:1 with the
reference .inl files: eval returns BRDF * cos(theta_out), pdf == 0 marks an
invalid sample, and Plastic's "pdf == 1 flags the specular lobe" trick is
kept (plastic.inl:44-45).

Here are diffuse, mirror, plastic, phong, blinn-phong, blinn-phong
microfacet and disney-diffuse; the other Disney tags (metal, glass,
clearcoat, sheen, disneybsdf) dispatch to disney.py, as the JAX package's
disney_mode="full" does (its other modes, the reference's stubs, are not
ported).

On CUDA tensors `bsdf_sample`, `bsdf_eval` and `bsdf_pdf` launch a
hand-written kernel of csrc/bsdf.cu, one launch a call, that runs every
lane of a tag above by the lane's own tag and writes its result once;
under autograd through an autograd Function whose backward is the plain
dispatch's. Each Disney tag the scene uses (SceneMeta.used_material_tags, a
static fact) then runs disney.py's kernel and is selected in with
torch.where. On CPU tensors they run the plain dispatch (`_sample_plain`,
`_eval_plain`, `_pdf_plain`), whose arithmetic the kernels repeat: each
used tag's lobe over the whole batch, the results blended with
torch.where. `LAUNCHES` counts what ran: each kernel launch, and each call
of a plain dispatch. With tracing on, the Disney lobes' work in each
dispatch is phase `disney` (tracing.phase), inside whichever phase called
the dispatch; the Phong, Blinn-Phong and Blinn-Phong microfacet lobes' is
phase `glossy`: on the card each kernel launch of a scene that uses such a
tag, on the CPU each such lobe.
"""

import contextlib
import ctypes
from typing import NamedTuple

import torch

from take_tpu_torch import tracing
from take_tpu_torch.core.math import C_INVPI, C_INVTWOPI, dot, face_forward, gather_rows, normalize, reflect, to_world
from take_tpu_torch.core.sampling import sample_cos_power, sample_hemisphere_cos
from take_tpu_torch.geometry._launch import Field, declare, field, raise_on
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

LAUNCHES = {key: 0 for entry in ("sample", "eval", "pdf") for key in (f"bsdf_{entry}", f"bsdf_{entry}_plain")}
GLOSSY = (MAT_PHONG, MAT_BLINN_PHONG, MAT_BLINN_PHONG_MICROFACET)


def _sample_plain(tags, sp: ShadePoint, dir_in, u_lobe, u1, u2, u3=None):
    """The plain dispatch's sample: each tag of `tags` over every lane,
    selected in by the lane's tag (0 on lanes of no tag in `tags`)."""
    dir_out = torch.zeros_like(dir_in)
    pdf = torch.zeros(dir_in.shape[:-1], dtype=dir_in.dtype, device=dir_in.device)
    for tag in tags:
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


def _eval_plain(tags, sp: ShadePoint, dir_in, dir_out, sample_pdf=None):
    """The plain dispatch's eval, as _sample_plain."""
    if sample_pdf is None:
        sample_pdf = dir_in.new_zeros(dir_in.shape[:-1])
    f = torch.zeros_like(dir_in)
    for tag in tags:
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


def _pdf_plain(tags, sp: ShadePoint, dir_in, dir_out):
    """The plain dispatch's pdf, as _sample_plain."""
    pdf = torch.zeros(dir_in.shape[:-1], dtype=dir_in.dtype, device=dir_in.device)
    for tag in tags:
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


_PLAIN = {"sample": _sample_plain, "eval": _eval_plain, "pdf": _pdf_plain}


# -- The kernels (csrc/bsdf.cu) --


# bsdf.cu's Inputs, field for field: the ShadePoint's fields the lobes read,
# the directions, the sample's pdf, the uniforms and the lane count
_FIELDS = ("tag", "geo_n", "sh_n", "refl", "eta", "exponent", "roughness", "subsurface", "dir_in", "dir_out",
           "sample_pdf", "u_lobe", "u1", "u2")
_VECTORS = ("geo_n", "sh_n", "refl", "dir_in", "dir_out")
# each entry's tensor arguments: the ShadePoint's fields its lobes read, then
# its own arguments from dir_in on (the plain version's, after the ShadePoint)
_ARGS = {
    "sample": ("tag", "geo_n", "sh_n", "eta", "exponent", "dir_in", "u_lobe", "u1", "u2"),
    "eval": ("tag", "geo_n", "sh_n", "refl", "exponent", "roughness", "subsurface", "dir_in", "dir_out",
             "sample_pdf"),
    "pdf": ("tag", "geo_n", "sh_n", "eta", "exponent", "dir_in", "dir_out"),
}
# the arguments that only some tags' lobes read: a gradient reaches one only
# where the scene uses such a tag (the shade point's scalars are columns of
# the material rows, so they require grad together)
_ONLY = {"eta": (MAT_PLASTIC,), "u_lobe": (MAT_PLASTIC,), "sample_pdf": (MAT_PLASTIC,), "exponent": GLOSSY,
         "roughness": (MAT_DISNEY_DIFFUSE,), "subsurface": (MAT_DISNEY_DIFFUSE,)}


class _Inputs(ctypes.Structure):
    _fields_ = [(name, Field) for name in _FIELDS] + [("n", ctypes.c_int64)]


def _launch(entry, *xs):
    """One launch of take_bsdf_<entry> on its arguments (_ARGS; a None is
    left null): (dir_out [N, 3], pdf [N]) for sample, f [N, 3] for eval,
    pdf [N] for pdf. Lanes of a Disney tag read 0. float32 only."""
    args = dict(zip(_ARGS[entry], xs))
    n, dev = args["dir_in"].shape[0], args["dir_in"].device
    ins = _Inputs(n=n)
    for name, x in args.items():
        if x is not None:
            dtype = torch.int32 if name == "tag" else torch.float32
            setattr(ins, name, field(name, x, n, dtype, 3 if name in _VECTORS else 1, dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if entry == "sample":
        d, p = torch.empty((n, 3), dtype=torch.float32, device=dev), torch.empty(n, dtype=torch.float32, device=dev)
        if n:
            raise_on(_lib(), _lib().tt_bsdf_sample(ctypes.byref(ins), d.data_ptr(), p.data_ptr(), stream),
                     "take_bsdf_sample")
        return d, p
    out = torch.empty((n, 3) if entry == "eval" else (n,), dtype=torch.float32, device=dev)
    if n:
        fn = _lib().tt_bsdf_eval if entry == "eval" else _lib().tt_bsdf_pdf
        raise_on(_lib(), fn(ctypes.byref(ins), out.data_ptr(), stream), f"take_bsdf_{entry}")
    return out


def _arguments(entry, sp: ShadePoint, dir_in, *rest):
    """An entry's arguments (_ARGS) from the plain version's: the
    ShadePoint, dir_in and the rest."""
    own = _ARGS[entry][_ARGS[entry].index("dir_in"):]
    args = {**sp._asdict(), **dict(zip(own, (dir_in, *rest)))}
    return tuple(args[name] for name in _ARGS[entry])


def _plain_of(entry, tags, xs):
    """The plain dispatch of `tags` on an entry's arguments (_ARGS)."""
    args = dict(zip(_ARGS[entry], xs))
    sp = ShadePoint(**{name: args.get(name) for name in ShadePoint._fields})
    return _PLAIN[entry](tags, sp, *xs[_ARGS[entry].index("dir_in"):])


class _Dispatch(torch.autograd.Function):
    """take_bsdf_<entry> forward. The backward computes the plain dispatch
    of `tags` (the used tags but the Disney ones) again on detached inputs
    and pulls the cotangents through it, so that gradients through the
    kernel are the plain version's. apply(entry, tags, *its arguments)."""

    @staticmethod
    def forward(ctx, entry, tags, *xs):
        ctx.entry, ctx.tags = entry, tags
        ctx.save_for_backward(*xs)
        return _launch(entry, *xs)

    @staticmethod
    def backward(ctx, *grads):
        xs, need = ctx.saved_tensors, ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if x is None else x.detach().requires_grad_(want) for x, want in zip(xs, need)]
            outs = _plain_of(ctx.entry, ctx.tags, leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pulled = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wanted = [x for x in leaves if x is not None and x.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pulled], wanted, [g for _, g in pulled], allow_unused=True)
                       if pulled and wanted else [None] * len(wanted))
        return (None, None, *[next(got) if want else None for want in need])


def _route(entry, tags, sp: ShadePoint, dir_in, *rest):
    """Every lane of a tag but the Disney ones through the kernel, in phase
    glossy where `tags` hold a glossy tag; one launch counted. CUDA tensors
    only. The autograd Function where a gradient is wanted: grad enabled,
    and an input that the lobes of `tags` read requires grad."""
    xs = _arguments(entry, sp, dir_in, *rest)
    read = [x for name, x in zip(_ARGS[entry], xs) if any(t in _ONLY.get(name, tags) for t in tags)]
    with tracing.phase("glossy") if any(t in GLOSSY for t in tags) else contextlib.nullcontext():
        if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in read):
            out = _Dispatch.apply(entry, tuple(t for t in tags if t not in disney.TAGS), *xs)
        else:
            out = _launch(entry, *xs)
    LAUNCHES[f"bsdf_{entry}"] += 1
    return out


def bsdf_sample(scene: Scene, sp: ShadePoint, dir_in, u_lobe, u1, u2, u3=None):
    """Sample an outgoing direction per ray. Returns (dir_out [N,3], pdf [N]).

    pdf == 0 encodes an invalid sample (material.cpp:76-82). u_lobe is
    Plastic's lobe choice and the Disney composite's; u3 is the composite's
    extra uniform (its glass lobe's reflect/refract choice).
    """
    tags = scene.meta.used_material_tags
    if not dir_in.is_cuda:
        LAUNCHES["bsdf_sample_plain"] += 1
        return _sample_plain(tags, sp, dir_in, u_lobe, u1, u2, u3)
    dir_out, pdf = _route("sample", tags, sp, dir_in, u_lobe, u1, u2)
    for tag in (t for t in tags if t in disney.TAGS):
        with tracing.phase("disney"):
            d, p = disney.sample(tag, sp, dir_in, u_lobe, u1, u2, u3)
        m = sp.tag == tag
        dir_out = torch.where(m[..., None], d, dir_out)
        pdf = torch.where(m, p, pdf)
    return dir_out, pdf


def bsdf_eval(scene: Scene, sp: ShadePoint, dir_in, dir_out, sample_pdf=None):
    """Evaluate BRDF * cos(theta_out) (the reference folds the cosine in).

    `sample_pdf` is the pdf of the sample being evaluated, which Plastic's
    lobe flag reads; None for NEE directions.
    """
    tags = scene.meta.used_material_tags
    if not dir_in.is_cuda:
        LAUNCHES["bsdf_eval_plain"] += 1
        return _eval_plain(tags, sp, dir_in, dir_out, sample_pdf)
    f = _route("eval", tags, sp, dir_in, dir_out, sample_pdf)
    for tag in (t for t in tags if t in disney.TAGS):
        with tracing.phase("disney"):
            v = disney.eval(tag, sp, dir_in, dir_out)
        f = torch.where((sp.tag == tag)[..., None], v, f)
    return f


def bsdf_pdf(scene: Scene, sp: ShadePoint, dir_in, dir_out):
    """Solid-angle pdf of sampling dir_out (get_bsdf_pdf, material.cpp:84-90)."""
    tags = scene.meta.used_material_tags
    if not dir_in.is_cuda:
        LAUNCHES["bsdf_pdf_plain"] += 1
        return _pdf_plain(tags, sp, dir_in, dir_out)
    pdf = _route("pdf", tags, sp, dir_in, dir_out)
    for tag in (t for t in tags if t in disney.TAGS):
        with tracing.phase("disney"):
            p = disney.pdf(tag, sp, dir_in, dir_out)
        pdf = torch.where(sp.tag == tag, p, pdf)
    return pdf


def _warm():
    """Each kernel once, on one diffuse lane, uncounted."""
    dev = torch.device("cuda", torch.cuda.current_device())
    f, v, tag = torch.zeros(1, device=dev), torch.zeros((1, 3), device=dev), torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("sample", tag, v, v, f, f, v, f, f, f)
    _launch("eval", tag, v, v, v, f, f, f, v, v, f)
    _launch("pdf", tag, v, v, f, f, v, v)


_P = ctypes.c_void_p
# bsdf.cu rounds every float operation as torch's separate kernels do: no
# product is contracted into an FMA that the plain version rounds twice
_lib = declare("bsdf", {
    "tt_bsdf_sample": [_P, _P, _P, _P],
    "tt_bsdf_eval": [_P, _P, _P],
    "tt_bsdf_pdf": [_P, _P, _P],
}, launches=LAUNCHES, flags=("--fmad=false",), warm=_warm)
