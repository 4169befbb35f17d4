"""The plain reference: against itself, against a hand-worked diffuse case,
and against the tracer under test on the CPU (the same paths)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from portbench import loops, spec
from portbench.reference import scene as rs
from portbench.reference import tracer

SEED = 2**31 + 977  # more than 32 signed bits hold


def small(name, res):
    cfg = {**spec.cell(f"{name}.render")["config_data"], "resolution": list(res)}
    return cfg, loops.reference_scene(cfg, "cpu")


def test_same_paths_whatever_the_blocks():
    cfg, s = small("cbox", (8, 8))
    pix = torch.arange(64)
    a = tracer.render_pixels(s, SEED, pix, 3, 4, paths_per_block=1 << 20)
    b = tracer.render_pixels(s, SEED, pix, 3, 4, paths_per_block=7)
    tracer.PAIRS, keep = 40, tracer.PAIRS  # the triangle test in blocks of a ray or two
    try:
        c = tracer.render_pixels(s, SEED, pix, 3, 4)
    finally:
        tracer.PAIRS = keep
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, tracer.render_pixels(s, SEED + 1, pix, 3, 4))


def test_loader_counts():
    for name, tris, lights, mats in (("cbox", 32, 2, 4), ("room", 105998, 2, 2)):
        host = rs.load(spec.ROOT / f"scenes/{name}/{name}.xml")
        assert (host.n_tri, len(host.lights), len(host.materials)) == (tris, lights, mats)
    cbox = rs.load(spec.ROOT / "scenes/cbox/cbox.xml")
    assert np.allclose(cbox.materials[cbox.material_ids["red"]][1]["reflectance"], [0.63, 0.065, 0.05])


def _corner_factor(x, y):
    """Form factor from a point to an x by y rectangle (in units of its
    height) over one corner of it, the rectangle parallel to its surface."""
    a, b = x / math.sqrt(1 + x * x), y / math.sqrt(1 + y * y)
    return (a * math.atan(y / math.sqrt(1 + x * x)) + b * math.atan(x / math.sqrt(1 + y * y))) / (2 * math.pi)


def test_hand_worked_diffuse_plane(tmp_path):
    """A diffuse floor of reflectance 0.5 under a square light of radiance
    2, side 2, at height 1, nothing else: with one bounce the pixel at the
    light's foot shows reflectance x radiance x the form factor."""
    (tmp_path / "floor.obj").write_text("v -50 0 -50\nv 50 0 -50\nv 50 0 50\nv -50 0 50\nf 1 4 3\nf 1 3 2\n")
    (tmp_path / "light.obj").write_text("v -1 1 -1\nv 1 1 -1\nv 1 1 1\nv -1 1 1\nf 1 2 3\nf 1 3 4\n")
    (tmp_path / "s.xml").write_text("""<scene version="0.6.0">
  <sensor type="perspective"><float name="fov" value="0.01"/><string name="fovAxis" value="y"/>
    <transform name="toWorld"><lookat origin="0, 0.5, 0.001" target="0, 0, 0" up="0, 0, 1"/></transform>
    <film type="hdrfilm"><integer name="width" value="1"/><integer name="height" value="1"/></film></sensor>
  <bsdf type="diffuse" id="gray"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
  <bsdf type="diffuse" id="black"><rgb name="reflectance" value="0, 0, 0"/></bsdf>
  <shape type="obj"><string name="filename" value="floor.obj"/><ref id="gray"/></shape>
  <shape type="obj"><string name="filename" value="light.obj"/><ref id="black"/>
    <emitter type="area"><rgb name="radiance" value="2, 2, 2"/></emitter></shape>
</scene>""")
    s = rs.to_device(rs.load(tmp_path / "s.xml"), "cpu")
    got = tracer.render_pixels(s, SEED, torch.zeros(1, dtype=torch.int64), 1 << 14, 0)[0]
    want = 0.5 * 2.0 * 4 * _corner_factor(1.0, 1.0)
    assert torch.allclose(got.double(), torch.full((3,), want, dtype=torch.float64), rtol=0.02)


@pytest.mark.parametrize("name,res,spp,depth", [("cbox", (20, 12), 3, 4), ("room", (10, 6), 1, 6)])
def test_the_same_paths_as_the_tracer(name, res, spp, depth):
    """The tracer under test on the CPU (its plain twins for the kernels) and
    the reference agree pixel for pixel to float rounding."""
    from take_tpu_torch import RenderOptions, render_image

    cfg, s = small(name, res)
    scene = loops.program_scene(cfg, "cpu")
    img = render_image(scene, RenderOptions(spp=spp, max_depth=depth, seed=SEED))
    ref = tracer.render_pixels(s, SEED, torch.arange(res[0] * res[1]), spp, depth).numpy()
    ref = ref.reshape(res[1], res[0], 3)[::-1]
    assert np.allclose(img, ref, rtol=1e-4, atol=1e-6 * float(np.abs(ref).max()))
    assert dataclasses.is_dataclass(scene)
