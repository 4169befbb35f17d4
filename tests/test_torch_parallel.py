"""take_tpu_torch/parallel on the CPU, mirroring test_sharding.py,
test_overlap.py and test_multihost.py: the sharded render bit for bit the
single-device one at any device count, against take_tpu's sharded render,
the sharded and banded gradients against the monolithic one and against
take_tpu's banded gradient, scene_to, and a real two-process gloo group."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from take_tpu.parallel.overlap import banded_loss_grad as j_banded
from take_tpu.parallel.sharding import AXIS as J_AXIS
from take_tpu.parallel.sharding import make_mesh as j_make_mesh
from take_tpu.parallel.sharding import render_image_sharded as j_render_sharded
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch import grad
from take_tpu_torch.parallel import distributed, overlap, sharding
from take_tpu_torch.render import render_image
from take_tpu_torch.scene.types import HOST_TABLES, RenderOptions, float_tables, scene_to
from tests import torch_dist_worker as worker
from tests.scenes import cornell_box
from tests.test_torch_render import _compare
from tests.torch_parity import one_torch_thread, port_scene, port_soup, tables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jscene():
    return cornell_box(width=16, height=16).build()


@pytest.fixture(scope="module")
def scene(jscene):
    return port_scene(jscene)


def _grad_inputs():
    """test_overlap.py's pixels and target: every pixel of 16x16."""
    return worker.grad_inputs(256)


def test_sharded_render_matches_single_device(scene):
    """Eight devices, k saturated at spp in both: bit for bit."""
    opts = RenderOptions(spp=8, max_depth=3, seed=21)
    np.testing.assert_array_equal(sharding.render_image_sharded(scene, opts, CPU8), render_image(scene, opts))


@pytest.mark.parametrize("n_dev", [2, 3])
def test_device_count_invariance(scene, n_dev):
    """Two (and three, with padded lanes) against eight devices."""
    opts = RenderOptions(spp=4, max_depth=2, seed=5)
    np.testing.assert_array_equal(sharding.render_image_sharded(scene, opts, ["cpu"] * n_dev),
                                  sharding.render_image_sharded(scene, opts, CPU8))


def test_sharded_render_matches_jax(jscene, scene):
    """The port's sharded image against take_tpu's on make_mesh(8), within
    test_torch_render.py's image tolerance."""
    opts = dict(spp=8, max_depth=3, seed=21)
    img_j = j_render_sharded(jscene, JOptions(**opts), j_make_mesh(8))
    img_t = sharding.render_image_sharded(scene, RenderOptions(**opts), CPU8)
    assert _compare(img_t, img_j) < 1e-4


def test_sharded_gradients_match(scene):
    """sharded_loss_grad over eight devices against render_loss_grad, table
    by table (test_sharding.py's tolerances)."""
    opts = RenderOptions(spp=1, max_depth=2, seed=3)
    pix, target = _grad_inputs()
    loss_ref, g_ref = grad.render_loss_grad(scene, opts, pix, target, 4)
    loss, g = sharding.sharded_loss_grad(scene, opts, pix, target, 4, CPU8)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    ref = float_tables(g_ref)
    for key, t in float_tables(g).items():
        assert t.device == ref[key].device, key
        np.testing.assert_allclose(t.numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-7, err_msg=key)
    assert float(ref["materials.attr"].abs().max()) > 0


def test_sharded_bvh_soup_matches_single_device():
    """A BVH scene (test_sharding.py's 700-triangle soup, past take_tpu's
    wavefront depth gate) over eight devices against one."""
    scene = port_soup(700, build_bvh=True)
    assert scene.bvh is not None
    opts = RenderOptions(spp=2, max_depth=9, seed=5)
    np.testing.assert_array_equal(sharding.render_image_sharded(scene, opts, CPU8), render_image(scene, opts))


@pytest.fixture(scope="module")
def banded(scene):
    """The port's banded gradient at world size 1, 4 bands, and the
    monolithic one, on test_overlap.py's problem."""
    opts = RenderOptions(**worker.GRAD)
    pix, target = _grad_inputs()
    n = worker.GRAD_SAMPLES
    return (overlap.banded_loss_grad(scene, opts, pix, target, 4, n_samples=n),
            grad.render_loss_grad(scene, opts, pix, target, n))


def test_banded_grad_matches_monolithic(banded):
    (loss_b, g_b), (loss_ref, g_ref) = banded
    np.testing.assert_allclose(float(loss_b), float(loss_ref), rtol=1e-5)
    ref = float_tables(g_ref)
    for key, t in float_tables(g_b).items():
        assert t.device == ref[key].device, key
        np.testing.assert_allclose(t.numpy(), ref[key].numpy(), rtol=2e-4, atol=1e-6, err_msg=key)


def test_banded_grad_matches_jax(jscene, banded):
    """Against take_tpu's banded_loss_grad on a 1-device mesh: the loss
    within 1e-5, each table within 1e-3 of its scale (test_torch_grad.py's
    tolerance), zero where JAX's is."""
    (loss_b, g_b), _ = banded
    pix, target = _grad_inputs()
    mesh = Mesh(np.array(jax.devices()[:1]), (J_AXIS,))
    sh = NamedSharding(mesh, P(J_AXIS))
    loss_j, g_j = j_banded(jax.device_put(jscene, NamedSharding(mesh, P())), JOptions(**worker.GRAD),
                           jax.device_put(jnp.asarray(pix.numpy()), sh),
                           jax.device_put(jnp.asarray(target.numpy()), sh), 4, mesh, worker.GRAD_SAMPLES)
    np.testing.assert_allclose(float(loss_b), float(loss_j), rtol=1e-5)
    ours = float_tables(g_b)
    j_grads = {k: v for k, v in tables(g_j).items() if np.issubdtype(v.dtype, np.floating)}
    assert set(ours) == set(j_grads)
    for key, jg in j_grads.items():
        g, scale = ours[key].numpy(), np.abs(jg).max()
        if scale == 0.0:
            assert not g.any(), key
        np.testing.assert_allclose(g, jg, rtol=0, atol=1e-3 * scale, err_msg=key)
    assert np.abs(j_grads["materials.attr"]).max() > 0


def test_scene_to_moves_every_table():
    """Every table and derived layout moves, tri_rows stays bvh.tris,
    tri_sweep stays on the CPU, depth and meta carry over."""
    scene = port_soup(700, build_bvh=True)
    assert scene.geometry.tri_rows is scene.bvh.tris
    moved = scene_to(scene, "meta")
    assert moved.geometry.tri_rows is moved.bvh.tris
    assert moved.bvh.depth == scene.bvh.depth and moved.meta is scene.meta
    n = 0
    for group in ("geometry", "materials", "lights", "textures", "bvh"):
        for name, x in vars(getattr(moved, group)).items():
            if torch.is_tensor(x):
                n += 1
                assert x.device.type == ("cpu" if f"{group}.{name}" in HOST_TABLES else "meta"), (group, name)
    assert n > 30 and moved.background.device.type == "meta"
    assert moved.bvh.qnodes.device.type == "meta" and moved.geometry.tri_sweep.device.type == "cpu"


def test_entry_points_default_to_the_card(scene):
    """No card here: make_mesh and a mesh-less render raise torch's error,
    and nothing runs on the CPU in their place."""
    for call in (sharding.make_mesh, lambda: sharding.render_image_sharded(scene, RenderOptions(spp=1)),
                 distributed.local_device):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group(jscene, scene, tmp_path, banded):
    """Two ranks over localhost TCP (gloo), each building the scene from the
    numpy tables written here: both frames equal, bit for bit the port's
    render_image; the banded gradient at 2 ranks and 2 bands against world
    size 1's (4 bands)."""
    scene_npz = tmp_path / "scene.npz"
    np.savez(scene_npz, meta=worker.meta_to_json(scene.meta), **tables(jscene))
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"), str(r), "2",
                               port, str(scene_npz), str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{outs[r]}"
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    np.testing.assert_array_equal(ranks[0]["img"], ranks[1]["img"])
    np.testing.assert_array_equal(ranks[0]["img"], render_image(scene, RenderOptions(**worker.RENDER)))
    (loss_1, g_1), _ = banded
    for z in ranks:
        np.testing.assert_allclose(float(z["loss"]), float(loss_1), rtol=1e-5)
        for key, t in float_tables(g_1).items():
            np.testing.assert_allclose(z[f"grad/{key}"], t.numpy(), rtol=2e-4, atol=1e-6, err_msg=key)
        assert set(json.loads(str(z["stats"]))) == {"pass_seconds", "assemble_seconds"}
