"""The gradient scope of take_tpu_torch's scene tables on the CPU: K1's
autograd Function (`intersect._BruteClosest`) against autograd through
`closest_plain` restricted to the EMIT columns, and, on a scene with
triangle, sphere and point lights, the gradient Scene through the brute
and the BVH routes: tri_attr only in ATTR_EMIT:+3, sph_attr only in
SATTR_EMIT:+3, lights.attr only in LATTR_INTENSITY:+3, every table
against take_tpu's jax.grad on the same tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.grad import render_loss_grad as j_loss_grad
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch.geometry import brute, intersect
from take_tpu_torch.grad import render_loss_grad
from take_tpu_torch.scene import types as T
from take_tpu_torch.scene.types import RenderOptions, float_tables
from tests.scenes import cornell_box
from tests.torch_parity import CBOX, port_scene, tables, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cbox_rays(n, seed):
    """Rays from inside cbox.xml's box in random directions; a tenth dead."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform([50.0, 50.0, 50.0], [500.0, 500.0, 500.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    rd = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.uniform(size=n) < 0.1, -3.4e38, np.inf).astype(np.float32)
    return (torch.as_tensor(ro, dtype=torch.float32).requires_grad_(True),
            torch.as_tensor(rd, dtype=torch.float32).requires_grad_(True),
            torch.full((n,), 1e-4), torch.as_tensor(tmax))


def test_k1_function_grads_emit_columns_only():
    """The Function's tri_attr gradient equals autograd through closest_plain
    with every column but EMIT zeroed, bit for bit; the other 29 columns
    and the rays get none."""
    from take_tpu.scene.parse_xml import parse_scene_file

    scene = port_scene(parse_scene_file(CBOX))
    g, n_tri = scene.geometry, scene.meta.n_tri
    ro, rd, tmin, tmax = _cbox_rays(4096, 0)
    w = torch.as_tensor(np.random.default_rng(1).normal(size=(4096, T.ATTR_DIM)), dtype=torch.float32)

    attr = g.tri_attr.clone().requires_grad_(True)
    attrs, t, u, v, found, prim = intersect._BruteClosest.apply(g.tri_rows, attr, n_tri, ro, rd, tmin, tmax)
    assert not (t.requires_grad or u.requires_grad or v.requires_grad)
    (attrs * w).sum().backward()

    ref_attr = g.tri_attr.clone().requires_grad_(True)
    ref = brute.closest_plain(g.tri_rows, ref_attr, n_tri, ro.detach(), rd.detach(), tmin, tmax)
    for a, b in zip((attrs, t, u, v, found, prim), ref):
        assert torch.equal(a.detach(), b)
    (ref[0] * w).sum().backward()
    want = torch.zeros_like(ref_attr.grad)
    want[:, T.ATTR_EMIT : T.ATTR_EMIT + 3] = ref_attr.grad[:, T.ATTR_EMIT : T.ATTR_EMIT + 3]
    assert int(found.sum()) > 1000 and want.abs().max() > 0
    torch.testing.assert_close(attr.grad, want, rtol=1e-6, atol=1e-5)
    others = torch.ones(T.ATTR_DIM, dtype=torch.bool)
    others[T.ATTR_EMIT : T.ATTR_EMIT + 3] = False
    assert not attr.grad[:, others].any()
    assert ro.grad is None and rd.grad is None


def _mixed_scene(bvh):
    """cornell_box 8^2 with a diffuse sphere, a sphere light and a point
    light (test_torch_render.py's mix), built by take_tpu."""
    b = cornell_box(8, 8)
    m = b.add_material(0, tex_value=(0.3, 0.6, 0.9))
    b.add_sphere((0.3, 0.25, -0.3), 0.2, m)
    b.add_sphere((0.7, 0.6, -0.6), 0.1, m, emission=(3.0, 3.0, 3.0))
    b.add_point_light((0.5, 0.8, -0.5), (0.5, 0.5, 0.5))
    return b.build(build_bvh=bvh)


def _only(g, lo, hi):
    cols = torch.zeros(g.shape[1], dtype=torch.bool)
    cols[lo:hi] = True
    return g[:, lo:hi].abs().max() > 0 and not g[:, ~cols].any()


@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
def test_gradient_scope_per_route(bvh):
    """Each attribute table's gradient lies in its emission or intensity
    columns alone, and every table agrees with take_tpu's within 1e-3 of
    its largest magnitude, but the sphere geometry: take_tpu's sph_center
    and sph_radius gradients are NaN (the sphere quadratic's sqrt at a
    clamped 0), the port's 0 (geometry is constant)."""
    js = _mixed_scene(bvh)
    assert (js.bvh is not None) == bvh
    scene = port_scene(js)
    pix = np.arange(64, dtype=np.int32)
    target = np.full((64, 3), 0.1, np.float32)
    loss, grads = render_loss_grad(scene, RenderOptions(spp=1, max_depth=3, seed=5), torch.as_tensor(pix),
                                   torch.as_tensor(target), 4)
    gt = grads.geometry
    assert _only(gt.tri_attr, T.ATTR_EMIT, T.ATTR_EMIT + 3)
    assert _only(gt.sph_attr, T.SATTR_EMIT, T.SATTR_EMIT + 3)
    assert _only(grads.lights.attr, T.LATTR_INTENSITY, T.LATTR_INTENSITY + 3)

    j_loss, jg = j_loss_grad(js, JOptions(spp=1, max_depth=3, seed=5), jnp.asarray(pix), jnp.asarray(target), 4)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    jt = tables(jg)
    for key, g in float_tables(grads).items():
        jv = jt[key]
        if key in ("geometry.sph_center", "geometry.sph_radius"):
            assert np.isnan(jv).any() and not g.any(), key
            continue
        scale = np.abs(jv).max()
        np.testing.assert_allclose(g.numpy(), jv, rtol=0, atol=1e-3 * scale, err_msg=key)
