"""take_tpu_torch's gradients on a BVH scene with an image texture, on the
CPU through K3's plain twin, mirroring test_grad_textured_bvh.py (its 16^2
scene, built by take_tpu and handed over as numpy): a texel block's
gradient against central FD and against take_tpu's jax.grad, Disney
roughness gradients finite and equal between replay and autograd, and a
DisneyDiffuse roughness gradient against FD."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.grad import render_radiance as j_radiance
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch.grad import render_radiance
from take_tpu_torch.scene import types as T
from take_tpu_torch.scene.types import RenderOptions
from tests.test_grad_textured_bvh import _textured_bvh_scene
from tests.torch_parity import port_scene, one_torch_thread  # noqa: F401 (fixture)

PIX = torch.arange(16 * 16, dtype=torch.int32)


@pytest.fixture(scope="module")
def scenes():
    js = _textured_bvh_scene(np.random.default_rng(2))
    assert js.bvh is not None and js.meta.n_tri >= 124
    return js, port_scene(js)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _grad(f, *args):
    d = torch.zeros((), requires_grad=True)
    f(d, *args).backward()
    return float(d.grad)


def _with_material_col(scene, mat, col, d):
    attr = scene.materials.attr.clone()
    attr[mat, col] = attr[mat, col] + d
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, attr=attr))


def test_texture_texel_grad_matches_fd_and_jax(scenes):
    """A 4x4 texel block of texture 0 at 96 samples a pixel: against central
    FD (rtol 0.05, atol 1e-5, test_grad_textured_bvh.py's); and at 16
    samples (JAX's BVH traversal is slow on the CPU) against take_tpu's
    gradient (rtol 1e-3)."""
    js, scene = scenes
    options = RenderOptions(spp=1, max_depth=3, seed=5)
    mask = np.zeros(tuple(scene.textures.data.shape), np.float32)
    mask[0, 2:6, 2:6, :] = 1.0
    tmask = torch.as_tensor(mask)

    def f(d, n=96):
        tex = dataclasses.replace(scene.textures, data=scene.textures.data + d * tmask)
        return render_radiance(dataclasses.replace(scene, textures=tex), options, PIX, 0, n).mean()

    g = _grad(f)
    eps = 5e-3
    with torch.no_grad():
        fd = (float(f(torch.tensor(eps))) - float(f(torch.tensor(-eps)))) / (2 * eps)
    assert fd > 1e-4, "the block must be visible"
    np.testing.assert_allclose(g, fd, rtol=0.05, atol=1e-5)

    jmask = jnp.asarray(mask)

    def jf(d):
        tex = dataclasses.replace(js.textures, data=js.textures.data + d * jmask)
        o = JOptions(spp=1, max_depth=3, seed=5)
        return j_radiance(dataclasses.replace(js, textures=tex), o, jnp.asarray(PIX.numpy()), jnp.int32(0), 16).mean()

    np.testing.assert_allclose(_grad(f, 16), float(jax.grad(jf)(jnp.float32(0.0))), rtol=1e-3)


def test_disney_bsdf_roughness_grad_finite_and_consistent(scenes):
    """The full Disney BSDF's roughness under detached sampling: finite on
    this grazing and TIR-prone scene, and replay's equal to autograd's
    (rtol 1e-4, atol 1e-6), at 32 samples a pixel (the JAX test's 96 make
    no difference to an equality of two modes on the same paths)."""
    _, scene = scenes

    def f(d, mode):
        s = _with_material_col(scene, 1, T.MATTR_ROUGHNESS, d)
        return render_radiance(s, RenderOptions(spp=1, max_depth=2, seed=9, grad_mode=mode), PIX, 0, 32).mean()

    g_ad = _grad(f, "ad")
    assert np.isfinite(g_ad)
    np.testing.assert_allclose(_grad(f, "replay"), g_ad, rtol=1e-4, atol=1e-6)


def _disney_diffuse_scene():
    """test_grad_textured_bvh.py's DisneyDiffuse scene, built by take_tpu."""
    from take_tpu.core.camera import Camera
    from take_tpu.scene.build import SceneBuilder
    from take_tpu.scene.types import MAT_DIFFUSE, MAT_DISNEY_DIFFUSE

    rng = np.random.default_rng(4)
    b = SceneBuilder()
    b.camera = Camera(16, 16, (0.0, 2.5, 6.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0), 45.0)
    m = b.add_material(MAT_DISNEY_DIFFUSE, tex_value=(0.6, 0.5, 0.4), roughness=0.5, subsurface=0.3)
    s6 = 6.0
    verts = np.array([[-s6, 0, -s6], [s6, 0, -s6], [s6, 0, s6], [-s6, 0, s6]], np.float32)
    b.add_mesh(verts, np.array([[0, 2, 1], [0, 3, 2]]), m)
    centers = rng.uniform(-3, 3, (80, 3)) * np.array([1, 0.3, 1])
    centers[:, 1] += 0.8
    for c in centers:
        v = c + rng.uniform(-0.25, 0.25, (3, 3))
        b.add_mesh(v.astype(np.float32), np.array([[0, 1, 2]]), m)
    m_l = b.add_material(MAT_DIFFUSE, tex_value=(0.0, 0.0, 0.0))
    lv = np.array([[-1, 4, -1], [1, 4, -1], [1, 4, 1], [-1, 4, 1]], np.float32)
    b.add_mesh(lv, np.array([[0, 1, 2], [0, 2, 3]]), m_l, emission=(20.0, 20.0, 20.0))
    return b.build(build_bvh=True)


def test_disney_diffuse_roughness_grad_matches_fd():
    """DisneyDiffuse samples the cosine hemisphere, so roughness never
    moves a sample and the detached estimator's gradient is the full
    derivative: against central FD (rtol 0.05, atol 1e-5)."""
    scene = port_scene(_disney_diffuse_scene())
    assert scene.bvh is not None
    options = RenderOptions(spp=1, max_depth=2, seed=9)

    def f(d):
        return render_radiance(_with_material_col(scene, 0, T.MATTR_ROUGHNESS, d), options, PIX, 0, 96).mean()

    g = _grad(f)
    eps = 1e-2
    with torch.no_grad():
        fd = (float(f(torch.tensor(eps))) - float(f(torch.tensor(-eps)))) / (2 * eps)
    assert abs(fd) > 1e-5, "roughness must be visible"
    np.testing.assert_allclose(g, fd, rtol=0.05, atol=1e-5)
