"""take_tpu_torch's Disney lobes, environment map and spheres against the
benchmark's plain reference (portbench/reference: principled.py, the
`disneybsdf` and `disneymetal` material modules, lights/envmap.py,
shapes/sphere.py), and the reference held to its own mathematics.

The lobes run on both sides in float64 on the same seeded shading points,
directions and uniforms, so the two differ only in the order of their
floating-point operations. The reference's samplers are held to their own
pdfs by a chi-squared test over a binned sphere, and each pdf's integral
over the sphere is at most 1.
"""

import math
import types

import numpy as np
import pytest
import torch
from scipy import stats

from portbench import phases
from portbench.readers import disney_share, envmap_build_s, envmap_share
from portbench.reference import principled, rng as ref_rng
from portbench.reference.lights import envmap as ref_env
from portbench.reference.materials import disneybsdf, disneymetal
from portbench.reference.shapes import sphere as ref_sphere
from take_tpu_torch.core.math import face_forward
from take_tpu_torch.core.sampling import sample_sphere_visible
from take_tpu_torch.geometry.intersect import intersect_scene
from take_tpu_torch.lights import envmap as port_env
from take_tpu_torch.lights.lights import sphere_cap_pdf
from take_tpu_torch.materials import bsdf as port_bsdf
from take_tpu_torch.materials import disney
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.types import MAT_DIFFUSE, MAT_DISNEY_BSDF, MAT_DISNEY_METAL, EnvMap
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
N = 4096
F64 = torch.float64
# Both sides compute in float64 and differ only in the order of operations
# (x * ((x x)(x x)) against x ** 5, a division against a product of
# reciprocals): ~1e-15 relative, but GTR1's 1 + (alpha^2 - 1) cos^2 cancels
# near cos = 1 at gloss 1 (alpha 0.001) by up to 1 / alpha^2 = 1e6, and a
# direction's error carries into the pdfs at it by the lobe's slope there.
RTOL = 1e-7
ATOL = 1e-12


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _shading(seed, n=N):
    """(geo_n, sh_n, dir_in, dir_out): unit geometric normals, shading
    normals tilted off them, arriving directions above the geometric surface
    (as the tracer's geo_n faces the ray) and outgoing ones over the sphere."""
    g = np.random.default_rng(seed)
    geo = _unit(g.normal(size=(n, 3)))
    sh = _unit(geo + 0.3 * _unit(g.normal(size=(n, 3))))
    wi = _unit(g.normal(size=(n, 3)))
    wi = np.where((np.sum(wi * geo, -1) < 0)[:, None], -wi, wi)
    wo = _unit(g.normal(size=(n, 3)))
    return tuple(torch.from_numpy(x) for x in (geo, sh, wi, wo))


def _params(seed, n=N, **fixed):
    """Seeded principled parameters per lane, every lobe's weight above 0
    on some lanes (glass and anisotropic, which ibl.xml leaves at 0,
    included); `fixed` pins some of them."""
    g = np.random.default_rng(seed)
    p = {"reflectance": g.uniform(0.02, 1.0, (n, 3)), "roughness": g.uniform(0.05, 1.0, n),
         "metallic": g.uniform(0.0, 1.0, n), "specular": g.uniform(0.0, 1.0, n),
         "specularTint": g.uniform(0.0, 1.0, n), "sheen": g.uniform(0.0, 1.0, n),
         "sheenTint": g.uniform(0.0, 1.0, n), "clearcoat": g.uniform(0.0, 1.0, n),
         "clearcoatGloss": g.uniform(0.0, 1.0, n), "specTrans": g.uniform(0.0, 1.0, n),
         "eta": g.uniform(1.1, 2.0, n), "anisotropic": g.uniform(0.0, 1.0, n),
         "subsurface": g.uniform(0.0, 1.0, n)}
    p.update({k: np.full_like(p[k], v) for k, v in fixed.items()})
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _shade_point(p, geo, sh, front, tag):
    """The port's ShadePoint of the same lanes, in float64."""
    n = geo.shape[0]
    zero = torch.zeros(n, dtype=F64)
    return port_bsdf.ShadePoint(
        tag=torch.full((n,), tag, dtype=torch.int32), geo_n=geo, sh_n=sh, refl=p["reflectance"], eta=p["eta"],
        exponent=zero, roughness=p["roughness"], subsurface=p["subsurface"], anisotropic=p["anisotropic"],
        metallic=p["metallic"], spec_trans=p["specTrans"], specular=p["specular"],
        specular_tint=p["specularTint"], sheen=p["sheen"], sheen_tint=p["sheenTint"], clearcoat=p["clearcoat"],
        clearcoat_gloss=p["clearcoatGloss"], front=front)


def _uniforms(seed, k, n=N):
    return [torch.from_numpy(u) for u in np.random.default_rng(seed).random((k, n))]


def _close(got, want, rtol=RTOL, atol=ATOL):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


LOBES = ["metal", "clearcoat", "sheen", "glass_front", "glass_back", "diffuse"]


@pytest.mark.parametrize("lobe", LOBES)
def test_lobe_matches_reference(lobe):
    """Each Disney lobe's value, pdf and sample, the port's against the
    reference's written from the published equations."""
    seed = 1900 + LOBES.index(lobe)
    geo, sh, wi, wo = _shading(seed)
    p = _params(seed)
    front = torch.full((N,), lobe != "glass_back")
    sp = _shade_point(p, geo, sh, front, MAT_DISNEY_BSDF)
    n = face_forward(sh, wi)
    eta = torch.where(front, p["eta"], 1.0 / p["eta"])
    u_c, u1, u2 = _uniforms(seed, 3)
    base, rough, aniso = p["reflectance"], p["roughness"], p["anisotropic"]
    if lobe == "metal":
        cases = [(disney._metal_eval(sp, wi, wo), principled.metal_eval(base, rough, aniso, n, geo, wi, wo)),
                 (disney._metal_pdf(sp, wi, wo), principled.metal_pdf(rough, aniso, n, geo, wi, wo))]
        got, want = disney._metal_sample(sp, wi, u1, u2), principled.metal_sample(rough, aniso, n, geo, wi, u1, u2)
    elif lobe == "clearcoat":
        gloss = p["clearcoatGloss"]
        cases = [(disney._clearcoat_eval(sp, wi, wo), principled.clearcoat_eval(gloss, n, geo, wi, wo)),
                 (disney._clearcoat_pdf(sp, wi, wo), principled.clearcoat_pdf(gloss, n, geo, wi, wo))]
        got, want = disney._clearcoat_sample(sp, wi, u1, u2), principled.clearcoat_sample(gloss, n, geo, wi, u1, u2)
    elif lobe == "sheen":
        cases = [(disney._sheen_eval(sp, wi, wo), principled.sheen_eval(base, p["sheenTint"], n, geo, wi, wo))]
        got = want = None
    elif lobe == "diffuse":
        cases = [(port_bsdf._disney_diffuse_eval(sp, wi, wo),
                  principled.diffuse(base, rough, p["subsurface"], n, geo, wi, wo)),
                 (port_bsdf._cosine_pdf(sp, wi, wo), principled.cosine_pdf(n, geo, wo))]
        got = port_bsdf._cosine_sample(sp, wi, u1, u2)[0], None
        want = principled.cosine_sample(n, u1, u2), None
    else:
        cases = [(disney._glass_eval(sp, wi, wo), principled.glass_eval(base, rough, aniso, eta, n, wi, wo)),
                 (disney._glass_pdf(sp, wi, wo), principled.glass_pdf(rough, aniso, eta, n, wi, wo))]
        got = disney._glass_sample(sp, wi, u_c, u1, u2)
        want = principled.glass_sample(rough, aniso, eta, n, wi, u_c, u1, u2)
    for g, w in cases:
        assert torch.isfinite(w).all() and (w > 0).any()
        _close(g, w)
    if got is not None:
        _close(got[0], want[0])
        if got[1] is not None:
            _close(got[1], want[1])
            assert (want[1] > 0).mean(dtype=F64) > 0.3
    if lobe.startswith("glass"):  # both reflection and refraction were drawn
        side = torch.sum(want[0] * n, -1) > 0
        assert side.any() and (~side).any()


COMPOSITES = {
    "random": {},  # every lobe weighted on some lanes
    "ibl_principled": dict(reflectance=[0.7, 0.2, 0.15], roughness=0.4, metallic=0.3, clearcoat=0.5, specTrans=0.0,
                           subsurface=0.0, specular=0.5, specularTint=0.0, anisotropic=0.0, sheen=0.0,
                           sheenTint=0.5, clearcoatGloss=1.0, eta=1.5),
    "glass_anisotropic": dict(specTrans=0.8, anisotropic=0.7, metallic=0.1),
}


def _draw(u):
    """A bounce's draws by dimension, from preset uniforms."""
    return lambda dim: u[dim]


@pytest.mark.parametrize("case", sorted(COMPOSITES))
def test_composite_matches_reference(case):
    """The disneybsdf composite through the port's dispatch (bsdf_sample,
    bsdf_eval, bsdf_pdf) against the reference's module, as the tracer and
    the reference call them: the lobe choice, the lobe's two uniforms and
    glass's draw 7 from the bounce's dimensions."""
    seed = 1950 + sorted(COMPOSITES).index(case)
    geo, sh, wi, wo = _shading(seed)
    fixed = dict(COMPOSITES[case])
    colour = fixed.pop("reflectance", None)
    p = _params(seed, **fixed)
    if colour is not None:
        p["reflectance"] = torch.tensor(colour, dtype=F64).expand(N, 3)
    sp = _shade_point(p, geo, sh, torch.ones(N, dtype=torch.bool), MAT_DISNEY_BSDF)
    scene = types.SimpleNamespace(meta=types.SimpleNamespace(used_material_tags=(MAT_DISNEY_BSDF,)))
    n = face_forward(sh, wi)
    u = dict(zip((ref_rng.LOBE_SELECT, ref_rng.BSDF_U1, ref_rng.BSDF_U2, disneybsdf.AUX), _uniforms(seed, 4)))
    got = port_bsdf.bsdf_sample(scene, sp, wi, u[ref_rng.LOBE_SELECT], u[ref_rng.BSDF_U1], u[ref_rng.BSDF_U2],
                                u[disneybsdf.AUX])
    want = disneybsdf.sample(p, n, geo, wi, _draw(u))
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert (want[1] > 0).any()
    for d in (wo, want[0]):
        f = disneybsdf.eval(p, n, geo, wi, d)
        assert torch.isfinite(f).all() and (f > 0).any()
        _close(port_bsdf.bsdf_eval(scene, sp, wi, d), f)
        _close(port_bsdf.bsdf_pdf(scene, sp, wi, d), disneybsdf.pdf(p, n, geo, wi, d))
    assert not disneybsdf.nee_skip(p, geo, wi, wo).any()


def test_metal_module_matches_port_dispatch():
    """disneymetal through the port's dispatch against the reference's module."""
    seed = 1990
    geo, sh, wi, wo = _shading(seed)
    p = _params(seed)
    sp = _shade_point(p, geo, sh, torch.ones(N, dtype=torch.bool), MAT_DISNEY_METAL)
    scene = types.SimpleNamespace(meta=types.SimpleNamespace(used_material_tags=(MAT_DISNEY_METAL,)))
    n = face_forward(sh, wi)
    u = dict(zip((ref_rng.LOBE_SELECT, ref_rng.BSDF_U1, ref_rng.BSDF_U2), _uniforms(seed, 3)))
    got = port_bsdf.bsdf_sample(scene, sp, wi, u[ref_rng.LOBE_SELECT], u[ref_rng.BSDF_U1], u[ref_rng.BSDF_U2])
    want = disneymetal.sample(p, n, geo, wi, _draw(u))
    _close(got[0], want[0])
    _close(got[1], want[1])
    _close(port_bsdf.bsdf_eval(scene, sp, wi, wo), disneymetal.eval(p, n, geo, wi, wo))
    _close(port_bsdf.bsdf_pdf(scene, sp, wi, wo), disneymetal.pdf(p, n, geo, wi, wo))
    # the tracer traces a metal's light sample wherever the light lies above the geometric surface
    assert torch.equal(disneymetal.nee_skip(p, geo, wi, wo), torch.sum(geo * wo, -1) < 0)


# ---- the environment map ----


def _seeded_map(h=16, w=32, seed=5):
    g = np.random.default_rng(seed)
    return (g.random((h, w, 3)) * g.uniform(0.1, 5.0, (h, 1, 1)) * g.uniform(0.2, 3.0, (1, w, 1))).astype(np.float32)


def _rot(angle):
    m = np.eye(4)
    c, s = np.cos(angle), np.sin(angle)
    m[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    return m


def _envs(to_world=None, scale=1.0):
    """(the port's EnvMap in float64, the reference's device tables in float64) of the seeded map."""
    data = _seeded_map()
    port = port_env.build_envmap(data, to_world, scale)
    ref = ref_env.to_device([ref_env.table(data, to_world, scale)], "cpu", F64)
    return EnvMap(**{k: torch.from_numpy(np.asarray(v)).to(torch.int64 if k == "alias_idx" else F64)
                     for k, v in port.items()}), ref, port


@pytest.mark.parametrize("rotated", [False, True])
def test_envmap_matches_reference(rotated):
    """The alias table bit for bit; sample (texel, direction, pdf), the
    bilinear lookup and the pdf at seeded directions, with a rotated and
    scaled map too. The port's pdf table is rounded to float32 (~6e-8), and
    so is its frame, which moves a rotated map's directions by ~3e-8 and the
    lookups by that times the map's slope."""
    port, ref, tables = _envs(_rot(0.7) if rotated else None, 1.7 if rotated else 1.0)
    dtol = dict(rtol=1e-7, atol=1e-7) if rotated else dict(rtol=1e-12, atol=1e-12)
    ltol = dict(rtol=1e-5, atol=1e-6) if rotated else dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(ref["alias"].numpy(), tables["alias_idx"])
    np.testing.assert_array_equal(ref["prob"].numpy().astype(np.float32), tables["alias_prob"])
    g = np.random.default_rng(31 + rotated)
    u1, u2, u3 = (torch.from_numpy(np.floor(g.random(N) * 2**24) / 2**24) for _ in range(3))  # the RNG's 24 bits
    d_port, pdf_port = port_env.envmap_sample(port, u1, u2, u3)
    uu, vv, texel = ref_env.sample_uv(ref, u1, u2, u3)
    d_ref = ref_env.direction(ref, uu, vv)
    _close(d_port, d_ref, **dtol)
    _close(pdf_port, ref_env._solid_angle(ref, texel, vv), rtol=1e-6, atol=0.0)
    dirs = torch.from_numpy(_unit(g.normal(size=(N, 3))))
    for d in (dirs, d_ref):
        _close(port_env.envmap_eval(port, d), ref_env.radiance(ref, d), **ltol)
        _close(port_env.envmap_pdf(port, d), ref_env.pdf(ref, d), rtol=1e-5 if rotated else 1e-6, atol=0.0)
    s = types.SimpleNamespace(light_data={"envmap": ref})
    le, lp = ref_env.escape(s, dirs, 2)
    _close(le, ref_env.radiance(ref, dirs))
    _close(lp, ref_env.pdf(ref, dirs) / 2)


def test_sky_alias_table_matches_port():
    """sky_2k.exr (2048 x 1024), read by the reference's own EXR reader:
    the image, and the alias table over its 2^21 texels, equal the port's."""
    from portbench.reference import exr
    from take_tpu_torch.io.images import imread3

    path = "scenes/ibl/assets/sky_2k.exr"
    img = exr.read(path)
    np.testing.assert_array_equal(img, imread3(path))
    w = ref_env.weights(img)
    prob, alias = ref_env.alias_table(w)
    port_prob, port_alias = port_env.build_alias_table(w)
    np.testing.assert_array_equal(alias, port_alias)
    np.testing.assert_array_equal(prob, port_prob)


# ---- spheres ----


def test_sphere_matches_port():
    """Closest hits (found, t, normal) of seeded rays against three spheres,
    from outside and from inside, and the emitter's visible-cap sample and
    pdf, the port's (float32 hits, float64 samples) against the reference's."""
    g = np.random.default_rng(77)
    centres = np.array([[-1.6, 0.7, 0.0], [0.0, 0.7, 0.0], [1.6, 0.7, 0.0]])
    radii = np.array([0.7, 0.7, 0.5])
    b = SceneBuilder()
    m = b.add_material(MAT_DIFFUSE)
    for c, r in zip(centres, radii):
        b.add_sphere(c, r, m, None)
    scene = b.build(device="cpu")
    data = {"center": torch.from_numpy(centres), "radius": torch.from_numpy(radii)}
    ro = np.concatenate([g.uniform(-4, 4, (N // 2, 3)) + [0, 0, 5], centres[g.integers(0, 3, N // 2)]])
    target = centres[g.integers(0, 3, N)] + g.normal(scale=0.6, size=(N, 3))
    rd = _unit(target - ro)
    ro32, rd32 = torch.from_numpy(ro).float(), torch.from_numpy(rd).float()
    tmin, tmax = torch.full((N,), 1e-4), torch.full((N,), math.inf)
    hit = intersect_scene(scene, ro32, rd32, tmin, tmax)
    found, t, prim = ref_sphere.closest(data, ro32.double(), rd32.double(), tmin.double(), tmax.double())
    assert torch.equal(hit.valid, found) and found.float().mean() > 0.5
    # float32 roots of the quadratic against float64 ones: the cancellation in -b - sqrt(disc) at grazing rays
    _close(hit.t[found].double(), t[found], rtol=1e-4, atol=1e-5)
    pos = ro32.double() + rd32.double() * t[:, None]
    n = ref_sphere.surface(data, prim, pos)[0]
    facing = torch.where((torch.sum(n * rd32.double(), -1) < 0)[:, None], n, -n)
    # the normal is (p - c) / r: it moves by the hit point's error over the radius
    _close(hit.geo_n[found].double(), facing[found], rtol=0.0, atol=1e-3)
    assert torch.equal(ref_sphere.occluded(data, ro32.double(), rd32.double(), tmin.double(), tmax.double()), found)
    ref_pos = torch.from_numpy(g.uniform(-3, 3, (N, 3)) + [0, 3, 4])
    k = torch.from_numpy(g.integers(0, 3, N))
    u1, u2 = _uniforms(78, 2)
    point, normal, pdf_area = ref_sphere.sample(data, k, ref_pos, u1, u2)
    p_port, n_port = sample_sphere_visible(u1, u2, data["center"][k], data["radius"][k], ref_pos)
    _close(point, p_port, rtol=1e-12, atol=1e-12)
    _close(normal, n_port, rtol=1e-12, atol=1e-12)
    _close(pdf_area, sphere_cap_pdf(data["radius"][k], point, ref_pos))
    _close(ref_sphere.pdf_area(data, k, point, ref_pos), pdf_area)


# ---- the reference held to its own mathematics ----

DRAWS = 200_000
COS_BINS, PHI_BINS, NODES = 24, 48, 8


def _sphere_grid():
    """(directions [B, K, 3], weights [B, K]): the sphere in COS_BINS x PHI_BINS
    bins equal in (cos theta, phi), each with NODES^2 Gauss-Legendre nodes
    whose weights sum to the bin's solid angle."""
    x, w = np.polynomial.legendre.leggauss(NODES)
    dc, dp = 2.0 / COS_BINS, 2.0 * np.pi / PHI_BINS
    c0 = -1.0 + dc * np.arange(COS_BINS)
    p0 = dp * np.arange(PHI_BINS)
    cos = (c0[:, None] + dc * (x + 1) / 2)[:, None, :, None]  # [C, 1, K, 1]
    phi = (p0[:, None] + dp * (x + 1) / 2)[None, :, None, :]  # [1, P, 1, K]
    cos, phi = np.broadcast_arrays(cos, phi)
    sin = np.sqrt(1.0 - cos * cos)
    d = np.stack([sin * np.cos(phi), sin * np.sin(phi), cos], -1).reshape(COS_BINS * PHI_BINS, NODES * NODES, 3)
    wt = (w[:, None] * w[None, :] * dc * dp / 4.0).reshape(1, -1).repeat(COS_BINS * PHI_BINS, 0)
    return torch.from_numpy(d), torch.from_numpy(wt)


def _bin(d):
    cos = torch.clamp(d[:, 2], -1.0, 1.0 - 1e-15)
    c = torch.clamp(((cos + 1.0) / 2.0 * COS_BINS).long(), 0, COS_BINS - 1)
    phi = torch.remainder(torch.atan2(d[:, 1], d[:, 0]), 2.0 * math.pi)
    p = torch.clamp((phi / (2.0 * math.pi) * PHI_BINS).long(), 0, PHI_BINS - 1)
    return c * PHI_BINS + p


def _chi2(observed, expected):
    """The p-value of observed counts against expected ones, bins under 5 expected pooled."""
    small = expected < 5.0
    obs = np.append(observed[~small], observed[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    keep = exp > 0
    stat = float(np.sum((obs[keep] - exp[keep]) ** 2 / exp[keep]))
    return stats.chi2.sf(stat, int(keep.sum()) - 1)


# Moderate roughness and clearcoat gloss 0 (alpha 0.1), so that the fixed
# 8 x 8-node rule integrates each bin's pdf far inside the counts' noise.
BSDF_CASES = {
    "disneymetal": (disneymetal, dict(reflectance=[0.9, 0.6, 0.3], roughness=0.45, anisotropic=0.6)),
    "disneybsdf": (disneybsdf, dict(reflectance=[0.7, 0.2, 0.15], roughness=0.5, metallic=0.3, clearcoat=1.0,
                                    clearcoatGloss=0.0, specTrans=0.0, subsurface=0.2, specular=0.5,
                                    specularTint=0.3, anisotropic=0.4, sheen=0.5, sheenTint=0.5, eta=1.5)),
    "disneybsdf_glass": (disneybsdf, dict(reflectance=[0.9, 0.95, 1.0], roughness=0.55, metallic=0.1,
                                          clearcoat=0.3, clearcoatGloss=0.0, specTrans=0.7, subsurface=0.0,
                                          specular=0.5, specularTint=0.0, anisotropic=0.5, sheen=0.0,
                                          sheenTint=0.5, eta=1.45)),
}


@pytest.mark.parametrize("case", sorted(BSDF_CASES))
def test_bsdf_sampling_follows_its_pdf(case):
    """2e5 seeded float64 samples of a reference BSDF module at one shading
    point fall in the sphere's bins as its pdf says (chi-squared, failed
    samples in a bin of their own), and the pdf integrates to at most 1."""
    mod, fixed = BSDF_CASES[case]
    n_pts = DRAWS
    p = {k: torch.tensor(v, dtype=F64).expand(n_pts, 3) if k == "reflectance"
         else torch.full((n_pts,), float(v), dtype=F64) for k, v in fixed.items()}
    z = torch.tensor([0.0, 0.0, 1.0], dtype=F64).expand(n_pts, 3)
    wi = torch.tensor([math.sin(0.7) * math.cos(0.4), math.sin(0.7) * math.sin(0.4), math.cos(0.7)],
                      dtype=F64).expand(n_pts, 3)
    gen = torch.Generator().manual_seed(4242)
    u = {dim: torch.rand(n_pts, generator=gen, dtype=F64) for dim in range(10)}
    d, pdf = mod.sample(p, z, z, wi, _draw(u))
    ok = pdf > 0
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    _close(pdf[ok], mod.pdf(p, z, z, wi, d)[ok], rtol=1e-9, atol=1e-12)  # the pdf a sample carries is the pdf's
    observed = np.bincount(_bin(d[ok]).numpy(), minlength=COS_BINS * PHI_BINS).astype(np.float64)
    grid, wt = _sphere_grid()
    B, K = wt.shape
    q = {k: v[:1].expand(B * K, *v.shape[1:]) for k, v in p.items()}
    dens = mod.pdf(q, z[:1].expand(B * K, 3), z[:1].expand(B * K, 3), wi[:1].expand(B * K, 3), grid.reshape(-1, 3))
    mass = (dens.reshape(B, K) * wt).sum(1).numpy()
    total = mass.sum()
    assert total <= 1.0 + 1e-3
    expected = np.append(n_pts * mass, n_pts * max(0.0, 1.0 - total))
    observed = np.append(observed, float((~ok).sum()))
    assert _chi2(observed, expected) > 1e-3


def test_envmap_sampling_follows_its_pdf():
    """2e5 seeded float64 samples of the reference's environment map fall in
    its texels as its pdf, integrated over each texel, says (chi-squared
    per texel: the in-texel jitter is not resolved), and the pdf integrates
    to at most 1 over the sphere."""
    data = _seeded_map()
    H, W = data.shape[:2]
    env = ref_env.to_device([ref_env.table(data)], "cpu", F64)
    gen = torch.Generator().manual_seed(99)
    u1, u2, u3 = (torch.rand(DRAWS, generator=gen, dtype=F64) for _ in range(3))
    uu, vv, _ = ref_env.sample_uv(env, u1, u2, u3)
    du, dv = ref_env.uv(env, ref_env.direction(env, uu, vv))
    texel = torch.clamp((dv * H).long(), 0, H - 1) * W + torch.clamp((du * W).long(), 0, W - 1)
    observed = np.bincount(texel.numpy(), minlength=H * W).astype(np.float64)
    x, w = np.polynomial.legendre.leggauss(NODES)
    fu = (x + 1) / 2
    cu = (np.arange(W)[:, None] + fu[None]) / W  # [W, K]
    cv = (np.arange(H)[:, None] + fu[None]) / H  # [H, K]
    u_g = torch.from_numpy(np.broadcast_to(cu[None, :, None, :], (H, W, NODES, NODES)).reshape(-1))
    v_g = torch.from_numpy(np.broadcast_to(cv[:, None, :, None], (H, W, NODES, NODES)).reshape(-1))
    dens = ref_env.pdf(env, ref_env.direction(env, u_g, v_g)) * torch.sin(math.pi * v_g)  # per d theta d phi
    wt = np.outer(w, w).reshape(-1) / 4.0 * (math.pi / H) * (2.0 * math.pi / W)
    mass = (dens.reshape(H * W, NODES * NODES).numpy() * wt).sum(1)
    assert mass.sum() <= 1.0 + 1e-9
    np.testing.assert_allclose(mass, env["p_texel"].numpy(), rtol=1e-9)
    assert _chi2(observed, DRAWS * mass) > 1e-3


# ---- the readers of the new metrics ----


def _ctx(monkeypatch, seg):
    monkeypatch.setattr(phases, "segment", lambda ctx: seg)
    return types.SimpleNamespace()


def test_readers_read_the_new_phases_and_span(monkeypatch):
    """disney_share and envmap_share read their phase's share of the
    segment's device time and None where the segment has no such phase (a
    program without the marks), not 0; envmap_build_s reads the set-up's
    take.scene.envmap seconds and None without the span."""
    seg = {"phases": {"forward.disney": 3.0, "forward.envmap": 0.5, "forward.bsdf": 1.5}, "device_s": 10.0,
           "spans": {"take.scene.envmap": {"count": 1, "total_s": 2.1, "self_s": 2.1, "parent": "take.scene.load"}}}
    ctx = _ctx(monkeypatch, seg)
    assert disney_share.read(ctx, "disney_share.render") == pytest.approx(30.0)
    assert envmap_share.read(ctx, "envmap_share.render") == pytest.approx(5.0)
    assert envmap_build_s.read(ctx, "envmap_build_s.render") == 2.1
    ctx = _ctx(monkeypatch, {"phases": {"forward.bsdf": 1.0}, "device_s": 1.0, "spans": {}})
    assert disney_share.read(ctx, "") is None and envmap_share.read(ctx, "") is None
    assert envmap_build_s.read(ctx, "") is None
    ctx = _ctx(monkeypatch, None)
    assert disney_share.read(ctx, "") is None and envmap_build_s.read(ctx, "") is None
