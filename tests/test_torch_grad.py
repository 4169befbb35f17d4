"""take_tpu_torch's gradients (grad.py) on the CPU, mirroring test_grad.py:
the furnace's analytic albedo gradient, cbox albedo and emission against
central finite differences with common random numbers, finite gradients
everywhere, the BVH emission flow, and the whole gradient Scene on cbox 8^2
table by table against take_tpu's jax.grad on the same numpy tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.grad import render_loss_grad as j_loss_grad
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch.grad import render_loss_grad, render_radiance
from take_tpu_torch.scene import edit
from take_tpu_torch.scene import types as T
from take_tpu_torch.scene.types import RenderOptions, float_tables
from tests.scenes import cornell_box, sphere_furnace
from tests.torch_parity import port_scene, tables, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _center_pixels(scene, k=2):
    cam = scene.meta.camera
    W, H = cam.width, cam.height
    ys, xs = np.meshgrid(np.arange(H // 2 - k, H // 2 + k), np.arange(W // 2 - k, W // 2 + k))
    return torch.as_tensor((ys * W + xs).ravel(), dtype=torch.int32)


def _value_and_grad(f, x0):
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    val = f(x)
    val.backward()
    return float(val.detach()), float(x.grad)


def test_furnace_albedo_grad_analytic():
    """Furnace sphere: the centre's radiance is albedo * background, so
    d/d(albedo) = 1 (rtol 0.08, test_grad.py's)."""
    scene = port_scene(sphere_furnace(albedo=0.5, width=16, height=16).build())
    pix = _center_pixels(scene, k=1)
    options = RenderOptions(spp=1, max_depth=6, seed=3)

    def f(a):
        s = edit.with_material_reflectance(scene, 0, torch.stack([a, a, a]))
        return render_radiance(s, options, pix, 0, 64).mean()

    val, g = _value_and_grad(f, 0.5)
    np.testing.assert_allclose(val, 0.5, rtol=0.05)
    np.testing.assert_allclose(g, 1.0, rtol=0.08)


@pytest.mark.parametrize("mode", ["ad", "replay"])
def test_cbox_albedo_grad_matches_fd(mode):
    """The white walls' albedo gradient against central FD with common
    random numbers (rtol 0.03, atol 1e-4, test_grad.py's), through each
    gradient mode."""
    scene = port_scene(cornell_box(width=16, height=16).build())
    pix = _center_pixels(scene, k=2)
    options = RenderOptions(spp=1, max_depth=3, seed=11, grad_mode=mode)
    base = scene.materials.attr[0, T.MATTR_TEX_VALUE : T.MATTR_TEX_VALUE + 3]

    def f(d):
        s = edit.with_material_reflectance(scene, 0, base + d)
        return render_radiance(s, options, pix, 0, 128).mean()

    _, g = _value_and_grad(f, 0.0)
    eps = 3e-3
    with torch.no_grad():
        fd = (float(f(torch.tensor(eps))) - float(f(torch.tensor(-eps)))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=0.03, atol=1e-4)


def test_emission_grad_matches_fd():
    """Radiance is linear in emission at depth 2 (a path sees the light
    once): f(s) = s f(1), so f'(1) = f(1) (rtol 1e-3); and f(1 + eps) -
    f(1 - eps) over 2 eps agrees."""
    scene = port_scene(cornell_box(width=16, height=16).build())
    pix = _center_pixels(scene, k=2)
    options = RenderOptions(spp=1, max_depth=2, seed=7)

    def f(scale):
        return render_radiance(edit.with_light_intensity_scale(scene, scale), options, pix, 0, 64).mean()

    val, g = _value_and_grad(f, 1.0)
    np.testing.assert_allclose(g, val, rtol=1e-3)
    with torch.no_grad():
        fd = (float(f(torch.tensor(1.01))) - float(f(torch.tensor(0.99)))) / 0.02
    np.testing.assert_allclose(g, fd, rtol=1e-3)


def test_grad_finite_everywhere():
    """No NaN or inf in the gradient of any float table."""
    scene = port_scene(cornell_box(width=8, height=8).build())
    pix = torch.arange(64, dtype=torch.int32)
    options = RenderOptions(spp=1, max_depth=3, seed=1)
    _, grads = render_loss_grad(scene, options, pix, torch.zeros(64, 3), 8)
    for key, g in float_tables(grads).items():
        assert torch.isfinite(g).all(), key


def test_param_grads_is_the_loss_vjp():
    """param_grads with the L2 loss's image cotangent, 2 (img - target) /
    img.numel(), gives render_loss_grad's gradient Scene (within 1e-6 of
    each table's scale)."""
    from take_tpu_torch.grad import param_grads

    scene = port_scene(cornell_box(width=8, height=8).build())
    pix = torch.arange(64, dtype=torch.int32)
    options = RenderOptions(spp=1, max_depth=2, seed=3)
    target = torch.full((64, 3), 0.1)
    _, want = render_loss_grad(scene, options, pix, target, 2)
    with torch.no_grad():
        img = render_radiance(scene, options, pix, 0, 2)
    got = float_tables(param_grads(scene, options, pix, 2 * (img - target) / img.numel(), 2))
    for key, w in float_tables(want).items():
        torch.testing.assert_close(got[key], w, rtol=0, atol=1e-6 * max(float(w.abs().max()), 1e-30), msg=key)


def test_bvh_scene_grads_flow():
    """A BVH scene is differentiable: the traversal is detached, emission
    flows through the attribute gather; linear in emission at depth 2, so
    f'(1) = f(1) > 0 (rtol 1e-3)."""
    scene = port_scene(cornell_box(width=8, height=8).build(build_bvh=True))
    assert scene.bvh is not None
    pix = _center_pixels(scene, k=2)
    options = RenderOptions(spp=1, max_depth=2, seed=7)

    def f(scale):
        return render_radiance(edit.with_light_intensity_scale(scene, scale), options, pix, 0, 32).mean()

    val, g = _value_and_grad(f, 1.0)
    assert val > 0
    np.testing.assert_allclose(g, val, rtol=1e-3)


@pytest.fixture(scope="module")
def cbox8_jax():
    """take_tpu's loss and gradient Scene on cbox 8^2, 1 spp, d3, 4 samples
    a pixel, against a fixed random target: (jax scene, pixels, target,
    loss, {table path: gradient})."""
    js = cornell_box(width=8, height=8).build()
    pix = np.arange(64, dtype=np.int32)
    target = np.random.default_rng(0).uniform(0.0, 0.5, (64, 3)).astype(np.float32)
    loss, g = j_loss_grad(js, JOptions(spp=1, max_depth=3, seed=5), jnp.asarray(pix), jnp.asarray(target), 4)
    grads = {k: v for k, v in tables(g).items() if np.issubdtype(v.dtype, np.floating)}
    return js, pix, target, float(loss), grads


@pytest.mark.parametrize("mode", ["ad", "replay"])
def test_gradient_scene_matches_jax(cbox8_jax, mode):
    """Every float table of the port's gradient Scene against take_tpu's
    jax.grad(..., allow_int=True) on the same tables: within 1e-3 of the
    table's largest magnitude, and exactly zero where JAX's table is (a
    missing detach would show there). Integer tables and derived fields are
    None."""
    js, pix, target, j_loss, j_grads = cbox8_jax
    scene = port_scene(js)
    loss, grads = render_loss_grad(scene, RenderOptions(spp=1, max_depth=3, seed=5, grad_mode=mode),
                                   torch.as_tensor(pix), torch.as_tensor(target), 4)
    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    ours = float_tables(grads)
    assert set(ours) == set(j_grads)
    nonzero = []
    for key, jg in j_grads.items():
        g = ours[key].numpy()
        assert g.shape == jg.shape, key
        scale = np.abs(jg).max()
        if scale == 0.0:
            assert not g.any(), f"{key}: take_tpu's gradient is 0, the port's is not"
            continue
        nonzero.append(key)
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-3 * scale, err_msg=key)
    assert {"geometry.tri_attr", "materials.attr", "lights.attr"} <= set(nonzero)
    assert grads.geometry.tri_mat is None and grads.geometry.tri_rows is None
    assert grads.materials.tag is None


def test_envmap_texel_grad_matches_fd_and_closed_form():
    """Environment-map texels, which take_tpu never checked against FD: on
    test_ibl_analytic.py's floor under an azimuth-only environment (radiance
    rho * mean(texels) at every pixel), raising 4 of the 32 texel columns by
    d moves the radiance by rho * 4/32 * d. The estimator is linear in the
    texels (the sampling tables stay), so its gradient equals central FD
    (rtol 1e-4) and the closed form within the estimate's noise (rtol
    0.05)."""
    from chip_smoke import azimuth_env_scene

    scene, _ = azimuth_env_scene("cpu", rho=0.6)
    mask = torch.zeros_like(scene.envmap.data)
    mask[:, 8:12] = 1.0
    pix = torch.arange(64, dtype=torch.int32)
    options = RenderOptions(spp=1, max_depth=2, seed=4)

    def f(d):
        s = edit.with_envmap_data(scene, scene.envmap.data + d * mask)
        return render_radiance(s, options, pix, 0, 64).mean()

    _, g = _value_and_grad(f, 0.0)
    eps = 1e-2
    with torch.no_grad():
        fd = (float(f(torch.tensor(eps))) - float(f(torch.tensor(-eps)))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-4)
    np.testing.assert_allclose(g, 0.6 * 4 / 32, rtol=0.05)
