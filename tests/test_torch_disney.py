"""take_tpu_torch's Disney lobes (materials/disney.py) against take_tpu's on
the CPU: metal, glass, clearcoat, sheen and the disneybsdf composite through
bsdf_sample, bsdf_eval and bsdf_pdf of both packages on the same shade
points, directions and uniforms (numpy, from a seed); then the port's own
mirrors of tests/test_disney.py.

The port departs from take_tpu in two repairs, which the arms expect on
exactly the lanes they touch (`_repaired`): the glass lobe's value and pdf
are 0 where no microfacet scatters dir_in into dir_out (Walter et al.
2007's sidedness), and a sample is failed (pdf 0) where the lobe that drew
it has no density there: a glass reflection below the surface or a
refraction above it, or, in the composite, a lobe's direction that its own
pdf gives 0 (take_tpu weights it by the other lobes' pdfs there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.materials import bsdf as jb
from take_tpu.materials import disney as jd_lobes
from take_tpu.scene.types import Hit as JHit
from take_tpu_torch.materials import bsdf as tb
from take_tpu_torch.materials import disney
from take_tpu_torch.scene import types as tt
from take_tpu_torch.scene.types import Hit as THit
from tests.scenes import cornell_box
from tests.test_torch_materials import DIR_ATOL, DIR_RTOL, _close, _directions, _unit
from tests.torch_parity import port_builder

N = 4096

# Per arm: (tag, materials added to the box, rtol of pdfs and BSDF values
# with an absolute floor of 1e-6, shade-point sides). "both" draws both
# sides of the surface (Hit.front orients glass's eta); "tir" puts every
# lane inside the glass at grazing incidence (cos 0.3), where eta = 1/1.5
# reflects totally off a smooth surface.
#
# XLA contracts a * b + c into one rounding where torch rounds twice, and
# the two packages' float32 sin, cos, log and pow differ in the last bit,
# so 91-97% of the sampled directions are bit-equal and the rest differ by
# an ulp or a few. Every quantity is held at its tolerance on all but
# LANE_ALLOW of the lanes; those few sit where a lobe is ill-conditioned,
# and are held to agree within OUTLIER_RTOL. Measured on these inputs:
# directions beyond 1e-5 relative / 1e-6 absolute on at most 1 lane
# (7.5e-6 absolute); values and pdfs at the same directions within 2.8e-5
# (glass), 3.4e-5 (TIR glass), 8.4e-6 (metal, disneybsdf), exact (sheen),
# except clearcoat at gloss 1 (alpha 0.001), where 1 + (a^2 - 1) h_z^2
# cancels near h_z = 1 and 5 lanes differ by up to 1.3e-2; a sample's pdf
# at an ulp-different direction moves by up to 1.2e-3 on 7 glass lanes and
# by 35% on 2 disneybsdf lanes where the direction sits on a lobe's
# horizon.
LANE_ALLOW = 0.0025
OUTLIER_RTOL = 0.5
ARMS = {
    "metal": (tt.MAT_DISNEY_METAL, [dict(roughness=r, anisotropic=a, tex_value=(0.9, 0.6, 0.3))
                                    for r, a in ((0.05, 0.0), (0.3, 0.0), (0.8, 0.6), (0.5, 0.9))], 1e-4, "front"),
    "glass": (tt.MAT_DISNEY_GLASS, [dict(roughness=r, eta=e, anisotropic=a, tex_value=(0.9, 0.95, 1.0))
                                    for r, e, a in ((0.05, 1.5, 0.0), (0.4, 1.5, 0.5), (0.8, 1.33, 0.0))],
              1e-4, "both"),
    "glass_tir": (tt.MAT_DISNEY_GLASS, [dict(roughness=0.05, eta=1.5), dict(roughness=0.2, eta=1.5)], 1e-4, "tir"),
    "clearcoat": (tt.MAT_DISNEY_CLEARCOAT, [dict(clearcoat_gloss=g) for g in (0.0, 0.7, 1.0)], 1e-4, "front"),
    "sheen": (tt.MAT_DISNEY_SHEEN, [dict(sheen=s, sheen_tint=t, tex_value=(0.7, 0.2, 0.1))
                                    for s, t in ((0.5, 0.0), (1.0, 0.5), (1.0, 1.0))], 1e-5, "front"),
    "disneybsdf": (tt.MAT_DISNEY_BSDF, [
        dict(roughness=0.4, metallic=0.3, clearcoat=0.5, tex_value=(0.7, 0.2, 0.15)),
        dict(roughness=0.5, metallic=0.2, spec_trans=0.4, sheen=0.5, anisotropic=0.3),
        dict(roughness=0.1, metallic=0.9, specular_tint=0.7, clearcoat=1.0, clearcoat_gloss=0.3),
        dict(roughness=0.8, spec_trans=1.0, eta=1.45, subsurface=0.5)], 1e-4, "both"),
}


def _scene_pair(tag, params):
    builders = (cornell_box(8, 8), port_builder(cornell_box, 8, 8))
    for b in builders:
        ids = [b.add_material(tag, **p) for p in params]
    return builders[0].build(), builders[1].build(device="cpu"), np.array(ids)


def _inputs(rng, ids, sides):
    """(shade-point fields, dir_in) for N lanes."""
    geo_n = _unit(rng.normal(size=(N, 3)))
    sh_n = _unit(_unit(rng.normal(size=(N, 3))) * 0.2 + geo_n)
    if sides == "tir":
        sh_n = geo_n
        tangent = _unit(np.cross(geo_n, rng.normal(size=(N, 3))))
        dir_in = _unit(0.3 * geo_n + np.sqrt(1 - 0.09) * tangent)
        front = np.zeros(N, bool)
    else:
        dir_in = _directions(rng, geo_n, N)
        front = rng.random(N) < 0.5 if sides == "both" else np.ones(N, bool)
    fields = dict(valid=np.ones(N, bool), t=np.ones(N, np.float32), pos=np.zeros((N, 3), np.float32),
                  geo_n=geo_n, sh_n=sh_n, uv=np.zeros((N, 2), np.float32),
                  mat_id=rng.choice(ids, N).astype(np.int32), light_id=np.full(N, -1, np.int32),
                  front=front, emit=np.zeros((N, 3), np.float32), light_geom=np.zeros(N, np.float32))
    return fields, dir_in, geo_n


def _close_most(t, j, rtol, atol=1e-6):
    """t within rtol / atol of j on all but LANE_ALLOW of the lanes, and
    within OUTLIER_RTOL on every lane."""
    t, j = t.numpy().reshape(N, -1), np.asarray(j).reshape(N, -1)
    assert np.isfinite(t).all() and np.isfinite(j).all()
    bad = (np.abs(t - j) > atol + rtol * np.abs(j)).any(axis=1)
    assert bad.mean() <= LANE_ALLOW, f"{bad.sum()} of {N} lanes beyond rtol {rtol}"
    np.testing.assert_allclose(t, j, rtol=OUTLIER_RTOL, atol=atol)


def _walter_valid(jsp, dir_in, d):
    """[N] bool, numpy: Walter et al.'s sidedness of the glass lobe at d, off
    the horizon: the half vector (reflection's i + o, refraction's i + eta o,
    turned to the shading side) faces dir_in, and d lies on its front for a
    reflection and on its back for a refraction."""
    sh, front, eta = np.asarray(jsp.sh_n), np.asarray(jsp.front), np.asarray(jsp.eta)
    n = np.where((np.sum(sh * dir_in, -1) < 0)[:, None], -sh, sh)
    eta = np.where(front, eta, 1.0 / np.maximum(eta, 1e-6))
    on = np.sum(n * d, -1)
    h = np.where((on > 0)[:, None], dir_in + d, dir_in + eta[:, None] * d)
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-10)
    h = np.where((np.sum(n * h, -1) < 0)[:, None], -h, h)
    hi, ho = np.sum(h * dir_in, -1), np.sum(h * d, -1)
    return (np.abs(on) > 1e-7) & (hi > 0) & np.where(on > 0, ho > 0, ho < 0)


def _glass_event_reflects(jsp, j_in, u_choice, u1, u2):
    """[N] bool: whether take_tpu's glass sample from these uniforms reflects
    (its own visible normal, Fresnel and total internal reflection)."""
    n, tx, ty = jd_lobes._frame(jsp, j_in)
    ax, ay = jd_lobes._alphas(jsp.roughness, jsp.anisotropic)
    hl = jd_lobes._sample_ggx_vndf(jd_lobes._to_local(n, tx, ty, j_in), ax, ay, u1, u2)
    h = hl[..., 0:1] * tx + hl[..., 1:2] * ty + hl[..., 2:3] * n
    cos_i = jnp.sum(h * j_in, -1)
    eta = jd_lobes._glass_eta(jsp)
    tir = (1.0 - cos_i * cos_i) / (eta * eta) >= 1.0
    return np.asarray((u_choice <= jd_lobes._fresnel_dielectric(jnp.abs(cos_i), eta)) | tir)


def _repaired(tag, jsp, j_in, d, f, p, u=None):
    """take_tpu's value f and pdf p at directions d as the port's repairs
    give them: its glass part (the whole of a glass lobe; gw f_glass and
    pg pdf_glass of the composite) dropped where Walter's sidedness fails,
    and, for samples drawn by u, the pdf 0 where the drawing lobe's own pdf
    is 0 at its direction."""
    dir_in, dn = np.asarray(j_in), np.asarray(d)
    valid = _walter_valid(jsp, dir_in, dn)
    if tag == tt.MAT_DISNEY_GLASS:
        f_glass, p_glass = np.asarray(f), np.asarray(p)
    elif tag == tt.MAT_DISNEY_BSDF:
        gw, pg = np.asarray(jd_lobes._bsdf_weights(jsp)[2]), np.asarray(jd_lobes._bsdf_lobe_probs(jsp)[2])
        f_glass = gw[:, None] * np.asarray(jd_lobes._glass_eval(jsp, j_in, d))
        p_glass = pg * np.asarray(jd_lobes._glass_pdf(jsp, j_in, d))
    else:
        return f, p
    f = np.asarray(f) - np.where(valid[:, None], 0.0, f_glass)
    p = np.asarray(p) - np.where(valid, 0.0, p_glass)
    if u is None:
        return f, p
    above = np.sum(np.asarray(jd_lobes._frame(jsp, j_in)[0]) * dn, -1) > 0
    if tag == tt.MAT_DISNEY_GLASS:
        kept = valid & (_glass_event_reflects(jsp, j_in, *u[:3]) == above)
    else:
        pd, pm, pg, _ = (np.asarray(x) for x in jd_lobes._bsdf_lobe_probs(jsp))
        lobe = np.select([np.asarray(u[0]) < pd, np.asarray(u[0]) < pd + pm, np.asarray(u[0]) < pd + pm + pg],
                         [0, 1, 2], 3)
        own = [np.asarray(jb._cosine_sample(jsp, j_in, u[1], u[2])[1]) > 0,
               np.asarray(jd_lobes._metal_sample(jsp, j_in, u[1], u[2])[1]) > 0,
               valid & (_glass_event_reflects(jsp, j_in, u[3], u[1], u[2]) == above),
               np.asarray(jd_lobes._clearcoat_sample(jsp, j_in, u[1], u[2])[1]) > 0]
        kept = np.choose(lobe, own)
    return f, np.where(kept, p, 0.0)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_disney_arm_matches_jax(arm):
    tag, params, rtol, sides = ARMS[arm]
    rng = np.random.default_rng(200 + tag + len(arm))
    js, ps, ids = _scene_pair(tag, params)
    assert tag in ps.meta.used_material_tags
    fields, dir_in, geo_n = _inputs(rng, ids, sides)
    jsp = jb.make_shade_point(js, JHit(**{k: jnp.asarray(v) for k, v in fields.items()}))
    tsp = tb.make_shade_point(ps, THit(**{k: torch.from_numpy(v) for k, v in fields.items()}))
    j_in, t_in = jnp.asarray(dir_in), torch.from_numpy(dir_in)
    u = rng.random((4, N)).astype(np.float32)

    jd, jp = jb.bsdf_sample(js, jsp, j_in, *map(jnp.asarray, u))
    td, tp = tb.bsdf_sample(ps, tsp, t_in, *map(torch.from_numpy, u))
    _close_most(td, jd, DIR_RTOL, DIR_ATOL)
    f_j, p_j = jb.bsdf_eval(js, jsp, j_in, jd, sample_pdf=jp), jb.bsdf_pdf(js, jsp, j_in, jd)
    _close_most(tp, _repaired(tag, jsp, j_in, jd, f_j, jp, [jnp.asarray(x) for x in u])[1], rtol)
    assert (tp > 0).any()
    # eval at the JAX package's samples, with their pdfs
    jd_t = torch.from_numpy(np.array(jd))
    f_own = tb.bsdf_eval(ps, tsp, t_in, jd_t, sample_pdf=torch.from_numpy(np.array(jp)))
    f_want, p_want = _repaired(tag, jsp, j_in, jd, f_j, p_j)
    _close_most(f_own, f_want, rtol)
    _close_most(tb.bsdf_pdf(ps, tsp, t_in, jd_t), p_want, rtol)
    assert (f_own > 0).any()

    dir_out = _directions(rng, geo_n, N)
    args_j = (js, jsp, j_in, jnp.asarray(dir_out))
    args_t = (ps, tsp, t_in, torch.from_numpy(dir_out))
    f_want, p_want = _repaired(tag, jsp, j_in, jnp.asarray(dir_out), jb.bsdf_eval(*args_j), jb.bsdf_pdf(*args_j))
    _close(tb.bsdf_eval(*args_t), f_want, rtol)
    _close(tb.bsdf_pdf(*args_t), p_want, rtol)
    assert not tb.is_specular(tsp).any()
    if sides == "tir":  # the smoother glass reflects every sample back inside (a rougher one's
        # samples that leave on the wrong side fail, as _repaired expects above)
        smooth = fields["mat_id"] == ids[0]
        assert (tp.numpy()[smooth] > 0).all() and (np.sum(td.numpy() * geo_n, axis=1)[smooth] > 0).all()
    if sides == "both" and tag == tt.MAT_DISNEY_GLASS:  # refraction on both sides
        below = np.sum(td.numpy() * geo_n, axis=1) * np.sum(dir_in * geo_n, axis=1) < 0
        assert below[fields["front"]].any() and below[~fields["front"]].any()


# ---- mirrors of tests/test_disney.py on the port ----


def make_sp(n, refl=(1.0, 1.0, 1.0), roughness=0.5, anisotropic=0.0, eta=1.5, front=True, **kw):
    z, o = torch.zeros(n), torch.ones(n)
    up = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    params = dict(
        tag=torch.zeros(n, dtype=torch.int32), geo_n=up, sh_n=up,
        refl=torch.tensor(refl, dtype=torch.float32).expand(n, 3),
        eta=o * eta, exponent=o * 5.0, roughness=o * roughness, subsurface=z, anisotropic=o * anisotropic,
        metallic=z, spec_trans=z, specular=o * 0.5, specular_tint=z, sheen=z, sheen_tint=o * 0.5,
        clearcoat=z, clearcoat_gloss=o, front=torch.full((n,), front),
    )
    params.update({k: o * v for k, v in kw.items()})
    return tb.ShadePoint(**params)


def incident_dirs(n, cos_theta=0.7):
    return torch.tensor([np.sqrt(1 - cos_theta ** 2), 0.0, cos_theta], dtype=torch.float32).expand(n, 3)


def _u(rng, k, n):
    return [torch.tensor(rng.random(n), dtype=torch.float32) for _ in range(k)]


M = 200_000


@pytest.mark.parametrize("tag,kw", [
    (tt.MAT_DISNEY_METAL, dict(roughness=0.3)),
    (tt.MAT_DISNEY_METAL, dict(roughness=0.8, anisotropic=0.6)),
    (tt.MAT_DISNEY_CLEARCOAT, dict(clearcoat_gloss=0.7)),
    (tt.MAT_DISNEY_SHEEN, dict()),
    (tt.MAT_DISNEY_GLASS, dict(roughness=0.4)),
    (tt.MAT_DISNEY_BSDF, dict(roughness=0.4, metallic=0.3, sheen=0.5, clearcoat=0.6, spec_trans=0.3)),
])
def test_sampling_energy_bound(tag, kw, rng_np):
    """E[eval / pdf] over a lobe's own samples stays <= 1."""
    sp = make_sp(M, **kw)
    dir_in = incident_dirs(M)
    d, p = disney.sample(tag, sp, dir_in, *_u(rng_np, 4, M))
    f = disney.eval(tag, sp, dir_in, d).numpy()
    p = p.numpy()
    ok = p > 1e-8
    ratio = f.sum(-1)[ok] / 3.0 / p[ok]
    assert ratio.mean() * ok.mean() < 1.05 and np.isfinite(ratio).all()


@pytest.mark.parametrize("tag,kw", [
    (tt.MAT_DISNEY_METAL, dict(roughness=0.4)),
    (tt.MAT_DISNEY_CLEARCOAT, dict(clearcoat_gloss=0.0)),
    (tt.MAT_DISNEY_SHEEN, dict()),
    (tt.MAT_DISNEY_GLASS, dict(roughness=0.5)),
    (tt.MAT_DISNEY_BSDF, dict(roughness=0.5, metallic=0.2, spec_trans=0.4)),
])
def test_pdf_integrates_to_one(tag, kw, rng_np):
    sp = make_sp(M, **kw)
    z = 1 - 2 * rng_np.random(M)
    phi = 2 * np.pi * rng_np.random(M)
    s = np.sqrt(np.clip(1 - z * z, 0, 1))
    d = torch.tensor(np.stack([s * np.cos(phi), s * np.sin(phi), z], -1), dtype=torch.float32)
    integral = disney.pdf(tag, sp, incident_dirs(M), d).mean().item() * 4 * np.pi
    assert 0.7 < integral < 1.1


def test_metal_mirror_limit(rng_np):
    n = 10_000
    u = _u(rng_np, 2, n)
    d, _ = disney.sample(tt.MAT_DISNEY_METAL, make_sp(n, roughness=0.05), incident_dirs(n), u[0], u[0], u[1])
    mirror = torch.tensor([-np.sqrt(1 - 0.49), 0.0, 0.7], dtype=torch.float32)
    assert ((d @ mirror) > 0.99).float().mean() > 0.95


def test_glass_refracts(rng_np):
    n = 50_000
    d, _ = disney.sample(tt.MAT_DISNEY_GLASS, make_sp(n, roughness=0.1, eta=1.5), incident_dirs(n, 0.9),
                         *_u(rng_np, 3, n))
    d = d.numpy()
    below = d[:, 2] < 0
    assert 0.8 < below.mean() < 0.99
    sin_out = np.linalg.norm(d[below][:, :2], axis=1)
    assert abs(np.median(sin_out) - np.sqrt(1 - 0.81) / 1.5) < 0.05


def test_glass_eta_flips_with_side(rng_np):
    n = 10_000
    u = _u(rng_np, 3, n)
    dir_in = incident_dirs(n, 0.9)
    sides = []
    for front in (True, False):
        d, _ = disney.sample(tt.MAT_DISNEY_GLASS, make_sp(n, roughness=0.05, front=front), dir_in, *u)
        d = d.numpy()
        sides.append(np.median(np.linalg.norm(d[d[:, 2] < 0][:, :2], axis=1)))
    # entering (eta 1.5) bends toward the normal, leaving (1/1.5) away
    assert sides[0] < np.sqrt(1 - 0.81) < sides[1]
