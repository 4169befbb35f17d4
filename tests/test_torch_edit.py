"""take_tpu_torch's scene edits (scene/edit.py) against take_tpu's, mirroring
test_edit_cli.py: the edited tables equal take_tpu's bit for bit, renders
move as the edit says, the gradient reaches the value passed in, derived
fields are kept; and the port's CLI end to end with -integrator mis_replay."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.scene import edit as jedit
from take_tpu_torch.geometry import brute
from take_tpu_torch.render import render_image
from take_tpu_torch.scene import edit
from take_tpu_torch.scene import types as T
from take_tpu_torch.scene.types import RenderOptions
from tests.scenes import cornell_box, sphere_furnace
from tests.torch_parity import CBOX, port_scene, tables, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _same_tables(ours, theirs):
    a, b = tables(ours), tables(theirs)
    assert set(a) == set(b)
    for key in a:
        assert np.array_equal(a[key], b[key]), key


def test_reflectance_edit_changes_render():
    js = sphere_furnace(albedo=0.5, width=8, height=8).build()
    scene = port_scene(js)
    bright = edit.with_material_reflectance(scene, 0, torch.tensor([0.9, 0.9, 0.9]))
    _same_tables(bright, jedit.with_material_reflectance(js, 0, jnp.array([0.9, 0.9, 0.9])))
    a = render_image(scene, RenderOptions(spp=32, max_depth=3, seed=1))
    b = render_image(bright, RenderOptions(spp=32, max_depth=3, seed=1))
    assert b[3:5, 3:5].mean() > a[3:5, 3:5].mean() * 1.5
    np.testing.assert_allclose(bright.materials.attr[0, T.MATTR_TEX_VALUE : T.MATTR_TEX_VALUE + 3].numpy(),
                               [0.9, 0.9, 0.9])
    assert scene.materials.attr[0, T.MATTR_TEX_VALUE] == np.float32(0.5)  # the input is untouched


def test_material_param_edit():
    js = cornell_box(width=8, height=8).build()
    s2 = edit.with_material_param(port_scene(js), 0, "roughness", 0.77)
    assert float(s2.materials.attr[0, T.MATTR_ROUGHNESS]) == np.float32(0.77)
    _same_tables(s2, jedit.with_material_param(js, 0, "roughness", 0.77))


def test_light_scale_write_through():
    """lights.attr, tri_attr and sph_attr scaled as take_tpu scales them,
    bit for bit; the render doubles; the derived rows are the input's; the
    gradient reaches the scale; the edited tri_attr passes the kernels'
    input checks."""
    js = cornell_box(width=8, height=8).build()
    scene = port_scene(js)
    s2 = edit.with_light_intensity_scale(scene, 2.0)
    _same_tables(s2, jedit.with_light_intensity_scale(js, 2.0))
    a = render_image(scene, RenderOptions(spp=16, max_depth=2, seed=3))
    b = render_image(s2, RenderOptions(spp=16, max_depth=2, seed=3))
    np.testing.assert_allclose(b, a * 2.0, rtol=1e-5, atol=1e-6)
    assert s2.geometry.tri_rows is scene.geometry.tri_rows

    scale = torch.tensor(1.5, requires_grad=True)
    s3 = edit.with_light_intensity_scale(scene, scale)
    s3.geometry.tri_attr[:, T.ATTR_EMIT].sum().backward()
    assert float(scale.grad) == float(scene.geometry.tri_attr[:, T.ATTR_EMIT].sum())
    n = 4
    ro, rd = torch.zeros(n, 3), torch.ones(n, 3)
    assert brute._check(s3.geometry.tri_rows, s3.geometry.tri_attr.detach(), scene.meta.n_tri, ro, rd,
                        torch.zeros(n), torch.ones(n)) == n


def test_cli_end_to_end_mis_replay(tmp_path):
    """The port's CLI on cbox.xml (its res default cut to 32) with
    -integrator mis_replay -spp 2 -max_depth 2 on the CPU: a finite EXR,
    bit for bit -integrator mis's."""
    from take_tpu_torch import cli
    from take_tpu_torch.io.exr import read_exr

    scene_dir = tmp_path / "cbox"
    shutil.copytree(os.path.join(os.path.dirname(CBOX), "meshes"), scene_dir / "meshes")
    (scene_dir / "cbox.xml").write_text(open(CBOX).read().replace('name="res" value="256"', 'name="res" value="32"'))
    imgs = []
    for integrator in ("mis_replay", "mis"):
        out = tmp_path / f"{integrator}.exr"
        assert cli.main([str(scene_dir / "cbox.xml"), "-max_depth", "2", "-spp", "2", "-o", str(out),
                         "-integrator", integrator, "-device", "cpu"]) == 0
        imgs.append(read_exr(str(out)))
    assert imgs[0].shape == (32, 32, 3) and np.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    assert np.array_equal(imgs[0], imgs[1])
