"""Entry points for an outside caller: the port's counterpart of the repo's
__graft_entry__.py.

entry() -> (fn, example_args): one forward step on the flagship path
(trace_mis on a small box's camera rays), on the card.

dryrun_multichip(n_devices): the pixel axis split over an n-device mesh,
the scene replicated, and one training step three ways: the full-table SGD
step (sharded_loss_grad), the banded gradient (banded_loss_grad, whose loss
must agree with the monolithic one) and the primal-only step (a parameter
vector mapped into the scene through scene/edit.py inside the loss).
"""

import numpy as np
import torch

from take_tpu_torch import grad
from take_tpu_torch.core import rng
from take_tpu_torch.core.camera import Camera, generate_rays
from take_tpu_torch.integrator.path_tracer import trace_mis
from take_tpu_torch.parallel.overlap import banded_loss_grad
from take_tpu_torch.parallel.sharding import device_scope, make_mesh, shard_scene, sharded_loss_grad
from take_tpu_torch.scene import edit
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.types import MAT_DIFFUSE, RenderOptions, float_tables, replace_tables


def _tiny_scene(device="cuda"):
    """A 32x32 view of the Cornell box's floor, ceiling and light (six
    triangles), on `device`."""
    b = SceneBuilder()
    b.camera = Camera(
        width=32, height=32, lookfrom=(278, 273, -800), lookat=(278, 273, 0),
        up=(0, 1, 0), vfov=39.3077,
    )
    b.background = np.zeros(3)
    white = b.add_material(MAT_DIFFUSE, tex_value=(0.73, 0.73, 0.73))
    black = b.add_material(MAT_DIFFUSE, tex_value=(0.0, 0.0, 0.0))
    quad = np.array([[0, 0, 0], [555, 0, 0], [555, 0, 555], [0, 0, 555]], float)
    idx = np.array([[0, 1, 2], [0, 2, 3]])
    b.add_mesh(quad, idx, white)  # floor
    b.add_mesh(quad + [0, 555, 0], idx, white)  # ceiling
    light = np.array([[213, 548, 227], [343, 548, 227], [343, 548, 332], [213, 548, 332]], float)
    b.add_mesh(light, idx, black, emission=(15.0, 12.0, 5.0))
    return b.build(device=device)


def entry(device="cuda"):
    """A forward step and its example arguments: fn(ro, rd, hi, lo) traces
    the scene's camera rays (1 spp, d3) to [1024, 3] radiance."""
    scene = _tiny_scene(device)
    options = RenderOptions(spp=1, max_depth=3)
    cam = scene.meta.camera
    pixel_idx = torch.arange(cam.width * cam.height, dtype=torch.int32, device=scene.background.device)
    px = (pixel_idx % cam.width).to(torch.float32)
    py = torch.div(pixel_idx, cam.width, rounding_mode="floor").to(torch.float32)
    streams = rng.make_stream(0, pixel_idx, torch.zeros_like(pixel_idx))
    jx = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
    jy = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
    ro, rd = generate_rays(cam, px, py, jx, jy)

    def fn(ro, rd, hi, lo):
        return trace_mis(scene, options, ro, rd, (hi, lo))

    return fn, (ro, rd, streams[0], streams[1])


def _finite(what, *tensors):
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise FloatingPointError(f"dryrun_multichip: {what} is not finite")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One training step over an n-device mesh: the CUDA devices in turn
    (["cuda:0"] * n on one card), or ["cpu"] * n when device="cpu". Raises
    if anything is not finite, or if the banded loss is not the monolithic
    one within 1e-4 (1 + |loss|). Returns the three steps' losses."""
    if torch.device(device).type == "cpu":
        mesh = [torch.device("cpu")] * n_devices
    else:
        cards = make_mesh()
        mesh = [cards[i % len(cards)] for i in range(n_devices)]
    scene = _tiny_scene(mesh[0])
    options = RenderOptions(spp=1, max_depth=2)
    cam = scene.meta.camera
    n = cam.width * cam.height  # 1024 paths, divisible by any 2^k mesh
    pix = torch.arange(n, dtype=torch.int32, device=mesh[0])
    target = torch.full((n, 3), 0.5, dtype=torch.float32, device=mesh[0])

    # the full-table SGD step. Every float table moves, derived ones too: a
    # one-step finiteness check; a real optimiser updates primal parameters
    # and recomputes the derived tables (scene/edit.py, as below)
    loss, g = sharded_loss_grad(scene, options, pix, target, 1, mesh)
    gt = float_tables(g)
    new_scene = replace_tables(scene, {k: t - 1e-2 * gt[k] for k, t in float_tables(scene).items()})
    _finite("the SGD step", loss, *float_tables(new_scene).values())

    # the banded, overlapped reduction (one process: no collective)
    loss_b, g_b = banded_loss_grad(scene, options, pix, target, n_bands=4)
    _finite("the banded gradient", loss_b, *float_tables(g_b).values())
    if not abs(float(loss_b) - float(loss)) < 1e-4 * (1 + abs(float(loss))):
        raise RuntimeError(f"dryrun_multichip: banded loss {float(loss_b)} vs monolithic {float(loss)}")

    # the primal-only step: four parameters (a sigmoid reflectance, a log
    # light scale) mapped into each device's replica inside the loss, the
    # shards' losses summed onto the first device
    params = torch.zeros(4, dtype=torch.float32, device=mesh[0], requires_grad=True)
    replicas = shard_scene(scene, mesh)
    lp = 0.0
    for d, p, t in zip(mesh, pix.tensor_split(len(mesh)), target.tensor_split(len(mesh))):
        with device_scope(d):
            q = params.to(d)
            s = edit.with_material_reflectance(replicas[d], 0, torch.sigmoid(q[:3]))
            s = edit.with_light_intensity_scale(s, torch.exp(q[3]))
            img = grad.render_radiance(s, options, p.to(d), 0, 1)
            lp = lp + (torch.sum((img - t.to(d)) ** 2) / target.numel()).to(mesh[0])
    lp.backward()
    lp = lp.detach()
    new_params = params.detach() - 1e-2 * params.grad
    _finite("the primal-only step", lp, new_params)
    return {"loss": float(loss), "banded_loss": float(loss_b), "primal_loss": float(lp)}


if __name__ == "__main__":
    fn, args = entry()
    print(fn(*args).shape)
    print("dryrun_multichip", dryrun_multichip(4))
