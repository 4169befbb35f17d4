"""take_tpu_torch renders against take_tpu's on the CPU, end to end: the same
scene tables, seed and options, through each package's render_image."""

import shutil

import numpy as np
import pytest
import torch

from take_tpu.core.camera import Camera as JCamera
from take_tpu.render import render_image as j_render
from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch import cli
from take_tpu_torch.core.camera import Camera as TCamera
from take_tpu_torch.render import render_image as t_render
from take_tpu_torch.scene.types import RenderOptions as TOptions
from tests.scenes import cornell_box
from tests.torch_parity import CBOX, port_builder, port_scene, with_res


def _compare(img_t, img_j, mean_rtol=1e-3, pixel_rtol=1e-3, floor=1e-4, frac=0.99):
    """Image means within mean_rtol; `frac` of pixels within pixel_rtol,
    with an absolute floor for dark pixels."""
    assert img_t.shape == img_j.shape and img_t.dtype == img_j.dtype
    assert np.isfinite(img_t).all()
    mt, mj = img_t.mean(axis=(0, 1)), img_j.mean(axis=(0, 1))
    np.testing.assert_allclose(mt, mj, rtol=mean_rtol)
    err = np.abs(img_t - img_j) / np.maximum(np.abs(img_j), floor)
    assert (err.max(axis=-1) <= pixel_rtol).mean() >= frac
    return float(err.max())


def test_cbox_render_matches_jax():
    """cbox.xml at 32x32, 8 spp, max_depth 4 (the main path, cut in size).

    Paths could diverge by an ulp-level flip of a hit or a sample, and XLA's
    sin/cos differ from torch's, hence the pixel fraction; measured: every
    pixel within 3.8e-6 relative, means within 1.2e-7.
    """
    js = with_res(jax_parse(CBOX), 32, JCamera)
    ps = with_res(port_scene(jax_parse(CBOX)), 32, TCamera)
    img_j = j_render(js, JOptions(spp=8, max_depth=4, seed=0))
    img_t = t_render(ps, TOptions(spp=8, max_depth=4, seed=0))
    assert _compare(img_t, img_j) < 1e-4


@pytest.mark.parametrize("rr_depth", [-1, 1])
def test_mixed_lights_render_matches_jax(rr_depth):
    """Triangle, sphere and point lights, spheres in the soup, Russian
    roulette on and off, over two passes (max_rays_per_pass < paths).

    Measured: 255 of 256 pixels within 1e-3 relative; in the other one a
    path takes another branch (6.5% off), the ulp-level flip allowed for.
    """
    builders = (cornell_box(16, 16), port_builder(cornell_box, 16, 16))
    for b in builders:
        m = b.add_material(0, tex_value=(0.3, 0.6, 0.9))
        b.add_sphere((0.3, 0.25, -0.3), 0.2, m)
        b.add_sphere((0.7, 0.6, -0.6), 0.1, m, emission=(3.0, 3.0, 3.0))
        b.add_point_light((0.5, 0.8, -0.5), (0.5, 0.5, 0.5))
    kw = dict(spp=4, max_depth=3, seed=11, rr_depth=rr_depth, max_rays_per_pass=512)
    img_j = j_render(builders[0].build(), JOptions(**kw))
    img_t = t_render(builders[1].build(device="cpu"), TOptions(**kw))
    _compare(img_t, img_j)


def test_query_counts_match_jax():
    import jax.numpy as jnp

    from take_tpu.core import rng as jrng
    from take_tpu.core.camera import generate_rays as jgen
    from take_tpu.integrator.path_tracer import trace_query_counts as jcounts
    from take_tpu_torch.core import rng as trng
    from take_tpu_torch.core.camera import generate_rays as tgen
    from take_tpu_torch.integrator.path_tracer import trace_query_counts as tcounts

    js = with_res(jax_parse(CBOX), 16, JCamera)
    ps = with_res(port_scene(jax_parse(CBOX)), 16, TCamera)
    opts = dict(spp=1, max_depth=4, seed=0)
    pix = np.arange(256, dtype=np.int32)
    px, py = (pix % 16).astype(np.float32), (pix // 16).astype(np.float32)
    jst = jrng.make_stream(0, jnp.asarray(pix), jnp.zeros(256, jnp.int32))
    tst = trng.make_stream(0, torch.from_numpy(pix), torch.zeros(256, dtype=torch.int32))
    jj = [jrng.uniform(jst, jrng.camera_counter(d)) for d in (0, 1)]
    tj = [trng.uniform(tst, trng.camera_counter(d)) for d in (0, 1)]
    jnom, jact, _ = jcounts(js, JOptions(**opts), *jgen(js.meta.camera, jnp.asarray(px), jnp.asarray(py), *jj), jst)
    with torch.inference_mode():
        tnom, tact = tcounts(ps, TOptions(**opts), *tgen(ps.meta.camera, torch.from_numpy(px),
                                                         torch.from_numpy(py), *tj), tst)
    assert (tnom, tact) == (int(jnom), int(jact))
    assert 0.3 < tact / tnom < 0.9


def test_refuses_what_later_slices_bring():
    """Every integrator of the JAX package renders (since the gradients
    slice, "mis_replay" too, to the "mis" image bit for bit); an unknown
    name raises ValueError, as in take_tpu."""
    ps = with_res(port_scene(jax_parse(CBOX)), 4, TCamera)
    assert np.array_equal(t_render(ps, TOptions(spp=1, max_depth=2, integrator="mis_replay")),
                          t_render(ps, TOptions(spp=1, max_depth=2, integrator="mis")))
    with pytest.raises(ValueError, match="unknown integrator"):
        t_render(ps, TOptions(spp=1, max_depth=2, integrator="bogus"))
    for integrator in ("mis", "mis_scan", "mis_wavefront", "one_sample_mis", "one_sample_mis_power", "raw"):
        img = t_render(ps, TOptions(spp=1, max_depth=2, integrator=integrator))
        assert img.shape == (4, 4, 3) and np.isfinite(img).all(), integrator


def test_cli_renders_on_cpu(tmp_path):
    scene_dir = tmp_path / "cbox"
    shutil.copytree(CBOX.rsplit("/", 1)[0] + "/meshes", scene_dir / "meshes")
    xml = open(CBOX).read().replace('name="res" value="256"', 'name="res" value="8"')
    (scene_dir / "cbox.xml").write_text(xml)
    out = tmp_path / "out.exr"
    assert cli.main([str(scene_dir / "cbox.xml"), "-max_depth", "2", "-spp", "2",
                     "-o", str(out), "-device", "cpu"]) == 0
    from take_tpu_torch.io.exr import read_exr

    img = read_exr(str(out))
    assert img.shape[:2] == (8, 8) and np.isfinite(img).all() and img.mean() > 0


def test_cli_renders_ibl_with_raw_on_cpu(tmp_path):
    """`-integrator` reaches the render: ibl (the environment map, Disney
    lobes) at 8x8, d6, through raw BSDF sampling."""
    import os

    shutil.copytree(os.path.join(os.path.dirname(CBOX), "..", "ibl"), tmp_path / "ibl")
    xml = tmp_path / "ibl" / "ibl.xml"
    xml.write_text(xml.read_text().replace('value="1024"', 'value="8"'))
    out = tmp_path / "out.exr"
    assert cli.main([str(xml), "-max_depth", "6", "-spp", "2", "-integrator", "raw", "-o", str(out),
                     "-device", "cpu"]) == 0
    from take_tpu_torch.io.exr import read_exr

    img = read_exr(str(out))
    assert img.shape[:2] == (8, 8) and np.isfinite(img).all() and img.mean() > 0


@pytest.mark.parametrize("name", ["mis", "textured"])
def test_cli_renders_mis_and_textured_on_cpu(tmp_path, name):
    """The CLI renders mis (blinn_microfacet plates, brute path) and
    textured (an open BVH scene with an image texture) at 8x8 and their
    published max_depth 6."""
    import os

    src = os.path.join(os.path.dirname(CBOX), "..", name)
    shutil.copytree(src, tmp_path / name)
    xml = tmp_path / name / f"{name}.xml"
    xml.write_text(xml.read_text().replace('name="width" value="512"', 'name="width" value="8"')
                   .replace('name="height" value="512"', 'name="height" value="8"'))
    out = tmp_path / "out.exr"
    assert cli.main([str(xml), "-max_depth", "6", "-spp", "2", "-o", str(out), "-device", "cpu"]) == 0
    from take_tpu_torch.io.exr import read_exr

    img = read_exr(str(out))
    assert img.shape[:2] == (8, 8) and np.isfinite(img).all() and img.mean() > 0
