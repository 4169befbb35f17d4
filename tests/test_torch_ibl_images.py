"""scenes/ibl/ibl.xml rendered by take_tpu_torch against the benchmark's
plain reference (portbench/reference) at a small size on the CPU, under the
`ibl.render` cell's limits (portbench/limits/ibl.render.json): the scene
itself, a variant with seeded random Disney parameters, the harness's run
of the cell cut to that size, and a Disney fault (the composite's clearcoat
lobe left out), which has to fail a limit."""

import dataclasses
import importlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import checks, run, spec
from portbench.reference import scene as ref_scene
from portbench.reference import tracer
from take_tpu_torch import load_scene
from take_tpu_torch.core.camera import Camera
from take_tpu_torch.materials import disney
from take_tpu_torch.scene.types import RenderOptions
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
render = importlib.import_module("take_tpu_torch.render")

IBL = os.path.join(os.path.dirname(__file__), "..", "scenes", "ibl", "ibl.xml")
SKY = os.path.abspath(os.path.join(os.path.dirname(IBL), "assets", "sky_2k.exr"))
SIZE, SPP, DEPTH = 24, 2, 6
SEED = 2**32 + 4321  # more than 32 bits
LIMITS = spec.cell("ibl.render")["limits"]["limits"]


def _port_image(path, seed=SEED):
    scene = load_scene(path, device="cpu")
    cam = scene.meta.camera
    scene = dataclasses.replace(scene, meta=dataclasses.replace(
        scene.meta, camera=Camera(SIZE, SIZE, cam.lookfrom, cam.lookat, cam.up, cam.vfov)))
    img = render.render_image(scene, RenderOptions(spp=SPP, max_depth=DEPTH, seed=seed, integrator="mis"))
    pix = np.arange(SIZE * SIZE)
    return img[SIZE - 1 - pix // SIZE, pix % SIZE]  # the image is y-flipped; the reference counts y from the bottom


def _reference_image(path, seed=SEED):
    s = ref_scene.to_device(ref_scene.load(path).with_resolution(SIZE, SIZE), "cpu")
    return tracer.render_pixels(s, seed, torch.arange(SIZE * SIZE), SPP, DEPTH).double().numpy()


@pytest.fixture(scope="module")
def reference():
    return _reference_image(IBL)


def _random_scene(tmp_path, seed):
    """ibl.xml with seeded random parameters on its two Disney materials. Its
    composite keeps specTrans 0: the reference's BSDF interface has no side
    of the hit, and takes every ray as arriving from outside
    (reference/materials/disneybsdf.py); tests/test_torch_ibl_reference.py
    holds glass on both sides, lobe by lobe."""
    g = np.random.default_rng(seed)
    r = lambda lo=0.0, hi=1.0: f"{g.uniform(lo, hi):.6f}"  # noqa: E731
    rgb = lambda: ", ".join(r(0.05, 1.0) for _ in range(3))  # noqa: E731
    xml = open(IBL).read().replace('value="assets/sky_2k.exr"', f'value="{SKY}"')
    metal = (f'<rgb name="baseColor" value="{rgb()}"/><float name="roughness" value="{r(0.05, 0.9)}"/>'
             f'<float name="anisotropic" value="{r()}"/>')
    names = ("roughness", "metallic", "specular", "specularTint", "sheen", "sheenTint", "clearcoat",
             "clearcoatGloss", "anisotropic", "subsurface")
    principled = (f'<rgb name="baseColor" value="{rgb()}"/>'
                  + "".join(f'<float name="{k}" value="{r(0.05 if k == "roughness" else 0.0)}"/>' for k in names)
                  + f'<float name="eta" value="{r(1.2, 1.8)}"/>')
    start, end = xml.index('<bsdf type="disneymetal"'), xml.index('<bsdf type="diffuse" id="matte">')
    xml = xml[:start] + (f'<bsdf type="disneymetal" id="chrome">{metal}</bsdf>\n'
                         f'    <bsdf type="disneybsdf" id="principled">{principled}</bsdf>\n    ') + xml[end:]
    path = tmp_path / "ibl_random.xml"
    path.write_text(xml)
    return str(path)


def _without_clearcoat():
    """The composite without its clearcoat lobe (its weight 0, so that its
    value, pdf and sampling all leave it out), patched in a test."""
    orig = disney._bsdf_weights
    return mock.patch.object(disney, "_bsdf_weights", lambda sp: (*orig(sp)[:3], torch.zeros_like(sp.clearcoat)))


def _within_limits(got, want):
    correct, rows = checks.judge(checks.image_numbers(got[None], want), LIMITS)
    return correct, rows


def test_ibl_image_within_the_cells_limits(reference):
    correct, rows = _within_limits(_port_image(IBL), reference)
    assert correct, rows
    assert np.isfinite(reference).all() and reference.mean() > 0


@pytest.mark.parametrize("seed", [11, 12])
def test_random_disney_parameters_within_the_cells_limits(tmp_path, seed):
    path = _random_scene(tmp_path, seed)
    correct, rows = _within_limits(_port_image(path), _reference_image(path))
    assert correct, rows


def test_clearcoat_left_out_fails_a_limit(reference):
    """The composite's clearcoat lobe left out: the image falls outside the cell's limits."""
    with _without_clearcoat():
        got = _port_image(IBL)
    correct, rows = _within_limits(got, reference)
    assert not correct, rows


def _tiny_cell():
    cell = spec.cell("ibl.render")
    cell["config_data"] = {**cell["config_data"], "resolution": [SIZE, SIZE], "spp": SPP}
    cell["limits"] = {**cell["limits"], "pixels": 256}
    return cell


def test_harness_runs_the_cell_cut_small():
    """portbench.run on ibl.render at 24 x 24, 2 spp: correct, with its
    end-to-end metrics; and with the clearcoat fault planted, not correct."""
    result, rows = run.run("ibl.render", SEED, 0.3, 0, device="cpu", cell=_tiny_cell())
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1, rows
    assert set(result["metrics"]) == {"mrays_per_s", "setup_s"}
    with _without_clearcoat():
        result, rows = run.run("ibl.render", SEED, 0.3, 0, device="cpu", cell=_tiny_cell())
    assert result["correct"] is False, rows
