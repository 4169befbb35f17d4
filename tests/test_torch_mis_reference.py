"""take_tpu_torch's Blinn-Phong microfacet lobe and sphere lights against the
benchmark's plain reference (portbench/reference: the `blinn_microfacet`
material module, shapes/sphere.py), the reference's sampler held to its own
pdf, and scenes/mis/mis.xml rendered at a small size under the `mis.render`
cell's limits (portbench/limits/mis.render.json), with the lobe's masking
term left out as a fault that has to fail them.

The lobe runs on both sides in float64 on the same seeded shading points,
directions and uniforms, so the two differ only in the order of their
floating-point operations.
"""

import dataclasses
import importlib
import math
import os
import types
from unittest import mock

import numpy as np
import pytest
import torch
from scipy import stats

from portbench import checks, phases, run, spec
from portbench.readers import glossy_share
from portbench.reference import rng as ref_rng
from portbench.reference import scene as ref_scene
from portbench.reference import tracer
from portbench.reference.lights import area as ref_area
from portbench.reference.materials import blinn_microfacet
from portbench.reference.shapes import sphere as ref_sphere
from take_tpu_torch import load_scene
from take_tpu_torch.core.camera import Camera
from take_tpu_torch.core.math import face_forward
from take_tpu_torch.integrator import light as port_light
from take_tpu_torch.lights.lights import area_pdf_from_hit_geom
from take_tpu_torch.materials import bsdf as port_bsdf
from take_tpu_torch.scene import types as ST
from take_tpu_torch.scene.types import MAT_BLINN_PHONG_MICROFACET, RenderOptions
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
render = importlib.import_module("take_tpu_torch.render")

MIS = os.path.join(os.path.dirname(__file__), "..", "scenes", "mis", "mis.xml")
EXPONENTS = [20.0, 100.0, 500.0, 3000.0]  # mis.xml's four plates
N = 4096
F64 = torch.float64
# Both sides compute in float64 and differ only in the order of operations
# ((alpha + 1) / (2 pi) / (4 o.h) against (alpha + 1) / 4 / (2 pi) / o.h,
# sqrt(alpha / 2 + 1) against 1 / sqrt(2 / (alpha + 2))): ~1e-16 relative,
# which cos^alpha multiplies by alpha (3e-13 at 3000).
RTOL = 1e-9
ATOL = 1e-12


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _shading(seed, n=N):
    """(geo_n, sh_n, dir_in, dir_out): unit geometric normals; shading normals
    equal to them on half the lanes (mis.xml's rectangles) and tilted off
    them on the rest; arriving directions above the geometric surface, an
    eighth of them grazing it (cos 1e-4 to 1e-2) and a sixteenth below it;
    outgoing ones over the sphere, an eighth of them grazing."""
    g = np.random.default_rng(seed)
    geo = _unit(g.normal(size=(n, 3)))
    tilted = _unit(geo + 0.3 * _unit(g.normal(size=(n, 3))))
    sh = np.where((np.arange(n) % 2 == 0)[:, None], geo, tilted)

    def grazing(d, share):
        """Lanes of `d` moved to within 1e-4 to 1e-2 of the plane of geo, on their own side."""
        flat = _unit(d - np.sum(d * geo, -1, keepdims=True) * geo)
        c = g.uniform(1e-4, 1e-2, n)[:, None] * np.sign(np.sum(d * geo, -1, keepdims=True))
        moved = _unit(flat * np.sqrt(1.0 - c * c) + c * geo)
        return np.where((g.random(n) < share)[:, None], moved, d)

    wi = _unit(g.normal(size=(n, 3)))
    wi = np.where((np.sum(wi * geo, -1) < 0)[:, None], -wi, wi)
    wi = grazing(wi, 1 / 8)
    wi = np.where((g.random(n) < 1 / 16)[:, None], -wi, wi)
    wo = grazing(_unit(g.normal(size=(n, 3))), 1 / 8)
    return tuple(torch.from_numpy(x) for x in (geo, sh, wi, wo))


def _params(alpha, seed, n=N):
    g = np.random.default_rng(seed)
    return {"reflectance": torch.from_numpy(g.uniform(0.02, 1.0, (n, 3))),
            "exponent": torch.full((n,), alpha, dtype=F64)}


def _shade_point(p, geo, sh):
    """The port's ShadePoint of the same lanes, in float64."""
    n = geo.shape[0]
    zero = torch.zeros(n, dtype=F64)
    return port_bsdf.ShadePoint(
        tag=torch.full((n,), MAT_BLINN_PHONG_MICROFACET, dtype=torch.int32), geo_n=geo, sh_n=sh,
        refl=p["reflectance"], eta=zero, exponent=p["exponent"], roughness=zero, subsurface=zero,
        anisotropic=zero, metallic=zero, spec_trans=zero, specular=zero, specular_tint=zero, sheen=zero,
        sheen_tint=zero, clearcoat=zero, clearcoat_gloss=zero, front=torch.ones(n, dtype=torch.bool))


def _draw(u):
    """A bounce's draws by dimension, from preset uniforms."""
    return lambda dim: u[dim]


def _close(got, want, rtol=RTOL, atol=ATOL):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("alpha", EXPONENTS)
def test_lobe_matches_reference(alpha):
    """The port's dispatch (bsdf_sample, bsdf_eval, bsdf_pdf) against the
    reference module, lane by lane: the sample's direction and pdf, and the
    value and pdf at seeded directions and at the sampled ones (a lobe of
    exponent 3000 is ~0 at random directions); every zero where the other
    side has one."""
    seed = 2300 + EXPONENTS.index(alpha)
    geo, sh, wi, wo = _shading(seed)
    p = _params(alpha, seed)
    sp = _shade_point(p, geo, sh)
    scene = types.SimpleNamespace(meta=types.SimpleNamespace(used_material_tags=(MAT_BLINN_PHONG_MICROFACET,)))
    n = face_forward(sh, wi)
    g = np.random.default_rng(seed + 50)
    u = {dim: torch.from_numpy(np.floor(g.random(N) * 2**24) / 2**24) for dim in range(6)}  # the RNG's 24 bits
    got = port_bsdf.bsdf_sample(scene, sp, wi, u[ref_rng.LOBE_SELECT], u[ref_rng.BSDF_U1], u[ref_rng.BSDF_U2])
    want = blinn_microfacet.sample(p, n, geo, wi, _draw(u))
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert torch.equal(got[1] > 0, want[1] > 0)
    kept = want[1] > 0
    assert 0.3 < kept.double().mean() < 1.0  # lanes below the surface and sidedness failures fail
    below = torch.sum(geo * wi, -1) < 0
    assert below.any() and not kept[below].any()
    for d in (wo, want[0]):
        f, pdf = blinn_microfacet.eval(p, n, geo, wi, d), blinn_microfacet.pdf(p, n, geo, wi, d)
        assert torch.isfinite(f).all() and torch.isfinite(pdf).all() and (f > 0).any() and (pdf > 0).any()
        _close(port_bsdf.bsdf_eval(scene, sp, wi, d), f)
        _close(port_bsdf.bsdf_pdf(scene, sp, wi, d), pdf)
        assert torch.equal(port_bsdf.bsdf_eval(scene, sp, wi, d) > 0, f > 0)
    # at the sampled directions the value is the lobe's, not 0: the lobe is where it samples
    f = blinn_microfacet.eval(p, n, geo, wi, want[0])
    assert (f[kept & (torch.sum(sh * geo, -1) > 0.999)] > 0).double().mean() > 0.9
    # the tracer's default light-sample skip holds: no value where either direction is below the surface
    assert not (blinn_microfacet.eval(p, n, geo, wi, wo)[torch.sum(geo * wo, -1) < 0] > 0).any()


def test_parse_defaults_and_names():
    """`parse` reads reflectance and exponent (or alpha), with the port's
    parser's defaults (0.5 grey, exponent 5), and refuses what it does not know."""
    import xml.etree.ElementTree as ET

    parser = ref_scene._Parser(".")
    out = blinn_microfacet.parse(ET.fromstring('<bsdf type="blinn_microfacet"/>'), parser)
    assert out["exponent"] == 5.0 and np.array_equal(out["reflectance"], np.full(3, 0.5))
    node = ET.fromstring('<bsdf type="blinn_microfacet"><rgb name="reflectance" value="0.9, 0.8, 0.7"/>'
                         '<float name="alpha" value="42"/></bsdf>')
    out = blinn_microfacet.parse(node, parser)
    assert out["exponent"] == 42.0 and np.allclose(out["reflectance"], [0.9, 0.8, 0.7])
    with pytest.raises(ValueError):
        blinn_microfacet.parse(ET.fromstring('<bsdf type="blinn_microfacet"><float name="eta" value="1"/></bsdf>'),
                               parser)
    s = ref_scene.load(MIS)
    assert [p["exponent"] for k, p in s.materials if k == "blinn_microfacet"] == EXPONENTS


# ---- the reference held to its own mathematics ----

DRAWS = 200_000
C_BINS, PHI_BINS, NODES = 16, 32, 8


def _half_grid(alpha):
    """(half vectors [B, K, 3], weights [B, K]): the half vector's hemisphere
    in C_BINS x PHI_BINS bins of (c, phi), c = cos^(alpha + 1) theta_h, in
    which the sampler's density of half vectors is uniform, 1 / (2 pi); the
    c edges are squares, fine near c = 0 where a sample starts to fail; each
    bin with NODES^2 Gauss-Legendre nodes whose weights sum to its area in (c, phi)."""
    x, w = np.polynomial.legendre.leggauss(NODES)
    edges = np.linspace(0.0, 1.0, C_BINS + 1) ** 2
    dc = np.diff(edges)
    dp = 2.0 * np.pi / PHI_BINS
    c = (edges[:-1, None] + dc[:, None] * (x + 1) / 2)[:, None, :, None]  # [C, 1, K, 1]
    phi = (dp * np.arange(PHI_BINS)[:, None] + dp * (x + 1) / 2)[None, :, None, :]  # [1, P, 1, K]
    c, phi = np.broadcast_arrays(c, phi)
    cos = c ** (1.0 / (alpha + 1.0))
    sin = np.sqrt(np.clip(1.0 - cos * cos, 0.0, 1.0))
    h = np.stack([sin * np.cos(phi), sin * np.sin(phi), cos], -1).reshape(C_BINS * PHI_BINS, NODES * NODES, 3)
    wt = (w[:, None] * w[None, :] / 4.0 * dp)[None, None] * dc[:, None, None, None]
    wt = np.broadcast_to(wt, (C_BINS, PHI_BINS, NODES, NODES)).reshape(C_BINS * PHI_BINS, NODES * NODES)
    return torch.from_numpy(h), torch.from_numpy(wt.copy()), c.reshape(C_BINS * PHI_BINS, -1)


def _chi2(observed, expected):
    """The p-value of observed counts against expected ones, bins under 5 expected pooled."""
    small = expected < 5.0
    obs = np.append(observed[~small], observed[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    keep = exp > 0
    stat = float(np.sum((obs[keep] - exp[keep]) ** 2 / exp[keep]))
    return stats.chi2.sf(stat, int(keep.sum()) - 1)


@pytest.mark.parametrize("alpha", EXPONENTS)
def test_sampling_follows_its_pdf(alpha):
    """2e5 seeded float64 samples of the reference's lobe at one shading point
    fall in the bins of their half vector as its pdf says: each bin's mass is
    the integral of pdf(wo) over the bin, taken in (c, phi) with the
    Jacobian of wo in them, 4 (wo.h) / ((alpha + 1) cos^alpha theta_h)
    (chi-squared, failed samples in a bin of their own); the pdf a sample
    carries is the pdf's, and the pdf integrates to the share of samples
    kept (at most 1)."""
    n_pts = DRAWS
    p = {"reflectance": torch.tensor([0.9, 0.9, 0.9], dtype=F64).expand(n_pts, 3),
         "exponent": torch.full((n_pts,), alpha, dtype=F64)}
    z = torch.tensor([0.0, 0.0, 1.0], dtype=F64).expand(n_pts, 3)
    wi = torch.tensor([math.sin(0.3) * math.cos(0.4), math.sin(0.3) * math.sin(0.4), math.cos(0.3)],
                      dtype=F64).expand(n_pts, 3)
    gen = torch.Generator().manual_seed(2323)
    u = {dim: torch.rand(n_pts, generator=gen, dtype=F64) for dim in range(6)}
    d, pdf = blinn_microfacet.sample(p, z, z, wi, _draw(u))
    ok = pdf > 0
    _close(pdf[ok], blinn_microfacet.pdf(p, z, z, wi, d)[ok], rtol=1e-9, atol=1e-12)
    h = d[ok] + wi[ok]
    h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    c = torch.clamp(h[:, 2], 0.0, 1.0) ** (alpha + 1.0)
    edges = torch.linspace(0.0, 1.0, C_BINS + 1, dtype=F64) ** 2
    cb = torch.clamp(torch.bucketize(c, edges[1:-1], right=True), 0, C_BINS - 1)
    phi = torch.remainder(torch.atan2(h[:, 1], h[:, 0]), 2.0 * math.pi)
    pb = torch.clamp((phi / (2.0 * math.pi) * PHI_BINS).long(), 0, PHI_BINS - 1)
    observed = np.bincount((cb * PHI_BINS + pb).numpy(), minlength=C_BINS * PHI_BINS).astype(np.float64)
    grid, wt, cg = _half_grid(alpha)
    B, K = wt.shape
    hh = grid.reshape(-1, 3)
    w1 = wi[:1].expand(B * K, 3)
    wo = 2.0 * torch.sum(w1 * hh, -1, keepdim=True) * hh - w1
    q = {k: v[:1].expand(B * K, *v.shape[1:]) for k, v in p.items()}
    dens = blinn_microfacet.pdf(q, z[:1].expand(B * K, 3), z[:1].expand(B * K, 3), w1, wo)
    jac = 4.0 * torch.sum(wo * hh, -1) / ((alpha + 1.0) * torch.from_numpy(cg.reshape(-1)) ** (alpha / (alpha + 1.0)))
    mass = (torch.where(dens > 0, dens * jac, 0.0).reshape(B, K) * wt).sum(1).numpy()
    total = mass.sum()
    assert total <= 1.0 + 1e-6
    assert abs(total - ok.double().mean().item()) < 5.0 * math.sqrt(0.25 / n_pts) + 1e-4
    expected = np.append(n_pts * mass, n_pts * max(0.0, 1.0 - total))
    observed = np.append(observed, float((~ok).sum()))
    assert _chi2(observed, expected) > 1e-3


# ---- the sphere lights ----


def _mis_spheres():
    """(the port's mis scene on the CPU, its light rows in float64, the
    reference's sphere group data from mis.xml)."""
    scene = load_scene(MIS, device="cpu")
    attr = scene.lights.attr.double()
    scene = dataclasses.replace(scene, lights=dataclasses.replace(scene.lights, attr=attr))
    s = ref_scene.to_device(ref_scene.load(MIS), "cpu", F64, F64)
    (group,) = s.groups
    return scene, attr, group.data


def test_sphere_lights_match_port():
    """mis.xml's four emitting spheres: the reference's sphere data equals the
    port's light rows (to their float32 rounding); the reference's cap
    sample and pdf (shapes/sphere.py, lights/area.py's solid angle) against
    the port's plain light path (integrator/light.py `_sample_plain`) at
    seeded shading points, some within a few radii of a light; and the
    arrival's pdf of a point on the sphere (area_pdf_from_hit_geom)."""
    scene, attr, data = _mis_spheres()
    assert scene.meta.n_lights == 4 and not scene.meta.has_envmap
    centres, radii = attr[:4, ST.LATTR_POS:ST.LATTR_POS + 3], attr[:4, ST.LATTR_RADIUS]  # the table's rows past 4 pad it
    # the port's tables are float32: the XML's numbers rounded (relative 6e-8)
    _close(centres, data["center"], rtol=1e-7, atol=1e-7)
    _close(radii, data["radius"], rtol=1e-7, atol=0.0)
    data = {"center": centres, "radius": radii}  # both sides on the same numbers from here
    g = np.random.default_rng(2330)
    pos = g.uniform([-5.0, -4.5, -2.0], [5.0, 0.5, 8.0], (N, 3))
    near = g.integers(0, 4, N)
    offset = _unit(g.normal(size=(N, 3))) * (radii.numpy()[near] * g.uniform(1.05, 3.0, N))[:, None]
    pos = torch.from_numpy(np.where((np.arange(N) % 8 == 0)[:, None], centres.numpy()[near] + offset, pos))
    u_sel, u1, u2 = (torch.from_numpy(np.floor(g.random(N) * 2**24) / 2**24) for _ in range(3))
    got = port_light._sample_plain(scene, u_sel, u1, u2, pos, pos, pos)
    slot = torch.clamp((u_sel * 4).to(torch.int32), 0, 3).long()
    assert torch.equal(got.row.long(), slot)
    point, normal, pdf_area = ref_sphere.sample(data, slot, pos, u1, u2)
    delta = point - pos
    dist = torch.linalg.vector_norm(delta, dim=-1)
    ldir = delta / dist[:, None]
    facing = torch.sum(-normal * ldir, -1)
    lp = ref_area._solid_angle(pdf_area, dist, torch.clamp(facing, min=0.0), 4)
    _close(got.light_dir, ldir)
    _close(got.tmax, tracer.SHADOW_SHORT * dist)
    _close(got.lp, lp)
    assert torch.equal(got.back, facing <= 0.0) and torch.equal(got.lit, facing > 0.0) and got.lit.all()
    # the arrival: a BSDF ray from pos that hits the sphere's sampled point
    _close(area_pdf_from_hit_geom(-radii[slot], point, pos), ref_sphere.pdf_area(data, slot, point, pos))
    assert (lp > 0).all() and torch.isfinite(lp).all()


# ---- whole images under the cell's limits ----

SIZE, SPP, DEPTH = 32, 4, 6
SEEDS = [2**32 + 2323, 23]  # one of more than 32 bits
LIMITS = spec.cell("mis.render")["limits"]["limits"]


def _port_image(seed):
    scene = load_scene(MIS, device="cpu")
    cam = scene.meta.camera
    scene = dataclasses.replace(scene, meta=dataclasses.replace(
        scene.meta, camera=Camera(SIZE, SIZE, cam.lookfrom, cam.lookat, cam.up, cam.vfov)))
    img = render.render_image(scene, RenderOptions(spp=SPP, max_depth=DEPTH, seed=seed, integrator="mis"))
    pix = np.arange(SIZE * SIZE)
    return img[SIZE - 1 - pix // SIZE, pix % SIZE]  # the image is y-flipped; the reference counts y from the bottom


def _reference_image(seed):
    s = ref_scene.to_device(ref_scene.load(MIS).with_resolution(SIZE, SIZE), "cpu")
    return tracer.render_pixels(s, seed, torch.arange(SIZE * SIZE), SPP, DEPTH).double().numpy()


@pytest.fixture(scope="module")
def references():
    return {seed: _reference_image(seed) for seed in SEEDS}


def _masking_one():
    """The lobe's masking term G set to 1 (patched in a test)."""
    return mock.patch.object(port_bsdf, "_blinn_phong_G_hat", lambda w, n, alpha: torch.ones_like(alpha))


def _judge(got, want):
    return checks.judge(checks.image_numbers(got[None], want), LIMITS)


@pytest.mark.parametrize("seed", SEEDS)
def test_mis_image_within_the_cells_limits(references, seed):
    correct, rows = _judge(_port_image(seed), references[seed])
    assert correct, rows
    assert np.isfinite(references[seed]).all() and references[seed].mean() > 0


def test_masking_left_out_fails_a_limit(references):
    """G set to 1 in the port's Blinn-Phong microfacet eval: the image falls outside the cell's limits."""
    with _masking_one():
        got = _port_image(SEEDS[0])
    correct, rows = _judge(got, references[SEEDS[0]])
    assert not correct, rows


def _tiny_cell():
    cell = spec.cell("mis.render")
    cell["config_data"] = {**cell["config_data"], "resolution": [SIZE, SIZE], "spp": SPP}
    cell["limits"] = {**cell["limits"], "pixels": 256}
    return cell


def test_harness_runs_the_cell_cut_small():
    """portbench.run on mis.render at 32 x 32, 4 spp: correct, with its
    end-to-end metrics; and with the masking term left out, not correct."""
    result, rows = run.run("mis.render", SEEDS[0], 0.3, 0, device="cpu", cell=_tiny_cell())
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1, rows
    assert set(result["metrics"]) == {"mrays_per_s", "setup_s"}
    with _masking_one():
        result, rows = run.run("mis.render", SEEDS[0], 0.3, 0, device="cpu", cell=_tiny_cell())
    assert result["correct"] is False, rows


# ---- the reader of the new metric ----


def test_glossy_share_reads_its_phase(monkeypatch):
    """glossy_share reads forward.glossy's share of the segment's device
    time, and None where the segment has no such phase (a program without
    the mark) or no segment at all, not 0."""
    seg = {"phases": {"forward.glossy": 1.5, "forward.bsdf": 2.0}, "device_s": 10.0}
    monkeypatch.setattr(phases, "segment", lambda ctx: seg)
    assert glossy_share.read(types.SimpleNamespace(), "glossy_share.render") == pytest.approx(15.0)
    monkeypatch.setattr(phases, "segment", lambda ctx: {"phases": {"forward.bsdf": 1.0}, "device_s": 1.0})
    assert glossy_share.read(types.SimpleNamespace(), "glossy_share.render") is None
    monkeypatch.setattr(phases, "segment", lambda ctx: None)
    assert glossy_share.read(types.SimpleNamespace(), "glossy_share.render") is None
