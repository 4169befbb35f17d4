"""take_tpu_torch's other integrators (integrator/variants.py: one-sample
MIS, its power-sampled twin, and raw BSDF sampling) against take_tpu's on
the CPU; the light functions they need; the port's mirror of
tests/test_integrator_variants.py's furnace; and the TAKE_TPU_CHECKS guard
of render_image (mirrors of tests/test_checks.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.lights import lights as jl
from take_tpu.render import render_image as j_render
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch.lights import lights as tl
from take_tpu_torch.render import render_image as t_render
from take_tpu_torch.scene.types import RenderOptions as TOptions
from tests.scenes import cornell_box, sphere_furnace
from tests.test_torch_render import _compare
from tests.torch_parity import port_builder

VARIANTS = ["one_sample_mis", "one_sample_mis_power", "raw"]


def _box_pair(lights):
    """cbox at 16x16 in both packages; with lights="mixed", plus a diffuse
    sphere, an emissive sphere (a sphere light) and a point light."""
    builders = (cornell_box(16, 16), port_builder(cornell_box, 16, 16))
    if lights == "mixed":
        for b in builders:
            m = b.add_material(0, tex_value=(0.3, 0.6, 0.9))
            b.add_sphere((0.3, 0.25, -0.3), 0.2, m)
            b.add_sphere((0.7, 0.6, -0.6), 0.1, m, emission=(3.0, 3.0, 3.0))
            b.add_point_light((0.5, 0.8, -0.5), (0.5, 0.5, 0.5))
    return builders[0].build(), builders[1].build(device="cpu")


@pytest.mark.parametrize("lights", ["box", "mixed"])
@pytest.mark.parametrize("integrator", VARIANTS)
def test_variant_matches_jax(integrator, lights):
    """Each variant at 16x16, 8 spp, max_depth 3, over two passes: means
    within 1e-3 relative, 99% of pixels within 1e-3 relative (floor 1e-4),
    as test_torch_render._compare holds the mis renders (an ulp-level flip
    may send a path another way). Measured: every pixel within 1.3e-6
    relative on the box and 2.3e-5 on the mixed scene, means within
    1.2e-7."""
    js, ps = _box_pair(lights)
    kw = dict(spp=8, max_depth=3, seed=3, integrator=integrator, max_rays_per_pass=1024)
    img_j = j_render(js, JOptions(**kw))
    img_t = t_render(ps, TOptions(**kw))
    assert img_t.mean() > 0.01
    _compare(img_t, img_j)


def test_power_selection_and_area_pdf_match_jax(rng_np):
    """select_power, power_pmf and area_pdf on the mixed scene's three
    lights (triangle, sphere, point) for 4096 seeded uniforms and points:
    the picks and pmfs bit for bit, the pdfs within 1e-6 relative (the
    sphere cap's 1 - r/d, ROADMAP queue 3, with points 2 radii off)."""
    js, ps = _box_pair("mixed")
    n = 4096
    u = rng_np.random(n).astype(np.float32)
    jid = jl.select_power(js, jnp.asarray(u))
    tid = tl.select_power(ps, torch.from_numpy(u))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert tid.dtype == torch.int32 and set(np.unique(tid.numpy())) == set(range(ps.meta.n_lights))
    np.testing.assert_array_equal(tl.power_pmf(ps, tid).numpy(), np.asarray(jl.power_pmf(js, jid)))
    ref = rng_np.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    ref[:, 2] -= 1.0
    center = np.array([0.7, 0.6, -0.6], np.float32)
    near = np.linalg.norm(ref - center, axis=1) < 0.2
    ref[near] = center + np.array([0.0, -0.3, 0.0], np.float32)
    pos = rng_np.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    got = tl.area_pdf(ps, tid, torch.from_numpy(pos), torch.from_numpy(ref)).numpy()
    want = np.asarray(jl.area_pdf(js, jid, jnp.asarray(pos), jnp.asarray(ref)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got > 0).any() and (got == 0).any()  # area lights and the point light


def test_variants_furnace():
    """tests/test_integrator_variants.py::test_variants_furnace on the port:
    a diffuse sphere of albedo 0.5 under a white background, 256 spp."""
    scene = port_builder(sphere_furnace, albedo=0.5, width=16, height=16).build(device="cpu")
    for integrator in VARIANTS:
        img = t_render(scene, TOptions(spp=256, max_depth=4, seed=2, integrator=integrator))
        np.testing.assert_allclose(img[6:10, 6:10].mean(), 0.5, rtol=0.08, err_msg=integrator)


def _poisoned_scene():
    """cbox with a NaN background: escaped rays carry it into the image."""
    scene = port_builder(cornell_box, 16, 16).build(device="cpu")
    return dataclasses.replace(scene, background=torch.full((3,), float("nan")))


@pytest.mark.parametrize("integrator", ["mis", "raw"])
def test_checks_flag_injected_nan(monkeypatch, integrator):
    monkeypatch.setenv("TAKE_TPU_CHECKS", "1")
    with pytest.raises(FloatingPointError, match="non-finite"):
        t_render(_poisoned_scene(), TOptions(spp=2, max_depth=2, integrator=integrator))


def test_checks_off_by_default(monkeypatch):
    monkeypatch.delenv("TAKE_TPU_CHECKS", raising=False)
    img = t_render(_poisoned_scene(), TOptions(spp=2, max_depth=2))
    assert np.isnan(img).any()  # propagates silently when unchecked
