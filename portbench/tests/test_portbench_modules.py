"""The reference's module interface: an analytic shape and a light at
infinity added as modules alone (defined here, found by name like the
files under reference/), with the tracer and loader left as they are,
render what a hand calculation gives."""

import math
import types

import numpy as np
import pytest
import torch

from portbench.reference import rng
from portbench.reference import scene as rs
from portbench.reference import tracer
from portbench.reference.frame import normalize

SEED = 2**31 + 4099


def _sphere_module():
    m = types.ModuleType("portbench.reference.shapes.testsphere")

    def load(node, parser):
        c = [c for c in node if c.get("name") == "center"][0]
        r = [c for c in node if c.get("name") == "radius"][0]
        return {"analytic": [{"center": [parser.f(c.get(k)) for k in "xyz"], "radius": parser.f(r.get("value"))}]}

    def _hits(data, ro, rd, tmin, tmax):
        c, r = data["center"], data["radius"]
        o = ro.to(c.dtype)[:, None] - c[None]
        d = rd.to(c.dtype)[:, None]
        b = (o * d).sum(-1)
        disc = b * b - ((o * o).sum(-1) - r * r)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        lo = tmin.to(c.dtype)[:, None]
        t = torch.where(-b - sq >= lo, -b - sq, -b + sq)
        return t, (disc >= 0.0) & (t >= lo) & (t <= tmax.to(c.dtype)[:, None]) & (tmax[:, None] > 0.0)

    def closest(data, ro, rd, tmin, tmax):
        t, ok = _hits(data, ro, rd, tmin, tmax)
        best, prim = torch.where(ok, t, math.inf).min(dim=1)
        found = torch.isfinite(best)
        return found, torch.where(found, best, 0.0), prim

    def surface(data, prim, pos):
        n = normalize(pos - data["center"][prim].to(pos.dtype))
        return n, n

    def sample(data, prim, ref_pos, u1, u2):
        z = 1.0 - 2.0 * u1
        rad = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        d = torch.stack([rad * torch.cos(2 * math.pi * u2), rad * torch.sin(2 * math.pi * u2), z], -1)
        r = data["radius"][prim].to(ref_pos.dtype)
        return data["center"][prim].to(ref_pos.dtype) + r[:, None] * d, d, pdf_area(data, prim, None, ref_pos)

    def pdf_area(data, prim, point, ref_pos):
        r = data["radius"][prim].to(ref_pos.dtype)
        return 1.0 / (4 * math.pi * r * r)

    m.load, m.closest, m.surface, m.sample, m.pdf_area = load, closest, surface, sample, pdf_area
    m.occluded = lambda data, ro, rd, tmin, tmax: _hits(data, ro, rd, tmin, tmax)[1].any(dim=1)
    return m


def _env_module():
    """A uniform light at infinity, sampled uniformly over the sphere."""
    m = types.ModuleType("portbench.reference.lights.testenv")
    m.LAST = True
    m.attach = lambda node, parser: parser.rgb([c for c in node if c.get("name") == "radiance"][0])
    m.to_device = lambda payloads, device, dtype: {
        "radiance": torch.tensor(np.stack(payloads), dtype=dtype, device=device)}

    def sample(s, slot, pos, draw, n_slots, emit):
        u1, u2 = draw(rng.LIGHT_U1), draw(rng.LIGHT_U2)
        z = 1.0 - 2.0 * u1
        rad = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        d = torch.stack([rad * torch.cos(2 * math.pi * u2), rad * torch.sin(2 * math.pi * u2), z], -1)
        return {"dir": d, "dist": torch.full_like(u1, math.inf),
                "radiance": s.light_data["testenv"]["radiance"][s.light_prim[slot]],
                "pdf": torch.full_like(u1, 1.0 / (4 * math.pi * n_slots)), "valid": torch.ones_like(u1, dtype=bool)}

    def escape(s, dirs, n_slots):
        return (s.light_data["testenv"]["radiance"][0].expand(dirs.shape),
                torch.full(dirs.shape[:1], 1.0 / (4 * math.pi * n_slots), dtype=dirs.dtype))

    m.sample, m.escape = sample, escape
    return m


@pytest.fixture
def modules(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "portbench.reference.shapes.testsphere", _sphere_module())
    monkeypatch.setitem(__import__("sys").modules, "portbench.reference.lights.testenv", _env_module())


SENSOR = """<sensor type="perspective"><float name="fov" value="{fov}"/><string name="fovAxis" value="y"/>
    <transform name="toWorld"><lookat origin="{origin}" target="0, 0, 0" up="{up}"/></transform>
    <film type="hdrfilm"><integer name="width" value="{w}"/><integer name="height" value="{w}"/></film></sensor>"""


def test_diffuse_sphere_under_a_uniform_sky(modules, tmp_path):
    """A convex diffuse sphere of reflectance 0.5 in a sky of radiance 1
    reflects 0.5 wherever it is seen; a ray past it sees the sky, 1."""
    (tmp_path / "s.xml").write_text(f"""<scene version="0.6.0">
  {SENSOR.format(fov=30, origin="0, 0, 5", up="0, 1, 0", w=5)}
  <emitter type="testenv"><rgb name="radiance" value="1, 1, 1"/></emitter>
  <bsdf type="diffuse" id="gray"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
  <shape type="testsphere"><point name="center" x="0" y="0" z="0"/><float name="radius" value="0.5"/>
    <ref id="gray"/></shape>
</scene>""")
    host = rs.load(tmp_path / "s.xml")
    assert host.n_tri == 0 and host.lights == [("testenv", None, 0)]
    s = rs.to_device(host, "cpu")
    got = tracer.render_pixels(s, SEED, torch.tensor([12, 0]), 1 << 13, 3).double()
    assert torch.allclose(got[0], torch.full((3,), 0.5, dtype=torch.float64), rtol=0.02)
    assert torch.equal(got[1], torch.ones(3, dtype=torch.float64))


def test_floor_under_a_sphere_light(modules, tmp_path):
    """A diffuse floor of reflectance 0.5 under a sphere of radiance 1 and
    radius r, its centre at height h: the point below shows 0.5 (r / h)^2."""
    (tmp_path / "floor.obj").write_text("v -50 0 -50\nv 50 0 -50\nv 50 0 50\nv -50 0 50\nf 1 4 3\nf 1 3 2\n")
    (tmp_path / "s.xml").write_text(f"""<scene version="0.6.0">
  {SENSOR.format(fov=0.01, origin="0, 0.5, 0.001", up="0, 0, 1", w=1)}
  <bsdf type="diffuse" id="gray"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
  <bsdf type="diffuse" id="black"><rgb name="reflectance" value="0, 0, 0"/></bsdf>
  <shape type="obj"><string name="filename" value="floor.obj"/><ref id="gray"/></shape>
  <shape type="testsphere"><point name="center" x="0" y="1" z="0"/><float name="radius" value="0.25"/>
    <ref id="black"/><emitter type="area"><rgb name="radiance" value="1, 1, 1"/></emitter></shape>
</scene>""")
    host = rs.load(tmp_path / "s.xml")
    assert host.lights == [("area", "testsphere", 0)]
    s = rs.to_device(host, "cpu")
    got = tracer.render_pixels(s, SEED, torch.zeros(1, dtype=torch.int64), 1 << 14, 0)[0].double()
    assert torch.allclose(got, torch.full((3,), 0.5 * 0.25**2, dtype=torch.float64), rtol=0.03)
