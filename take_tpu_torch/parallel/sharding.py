"""Several devices in one process: the pixel axis split over a list of
devices, the scene replicated. Port of take_tpu/parallel/sharding.py.

A mesh here is a list of torch devices, in the order their shards are
assembled; repeats are allowed (two shards on one card, or eight on the
CPU, as the JAX tests use eight virtual CPU devices). Rays never talk to
each other, so the forward needs no communication: each device renders its
contiguous shard of the pixel axis against its own replica of the scene,
and the shards are concatenated in order. A gradient sums the devices'
Scene-shaped gradients onto the first device (GSPMD's psum, made explicit).

Determinism: the counter-based RNG keys by (pixel, sample), not by device,
so a render is bit for bit the same at any device count with the same
samples per pass (tests/test_torch_parallel.py).
"""

import contextlib

import torch

from take_tpu_torch import grad
from take_tpu_torch.render import render_pass
from take_tpu_torch.scene.types import RenderOptions, Scene, float_tables, replace_tables, scene_to

AXIS = "rays"


def make_mesh(n_devices=None):
    """The CUDA devices (the first `n_devices` of them, or all) as a mesh.
    Without a card this raises torch's error; pass a list such as
    ["cpu"] * 8 to split over the CPU."""
    torch.cuda.init()
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devices if n_devices is None else devices[:n_devices]


def device_scope(device):
    """Make `device` the current CUDA device (kernels launch on the current
    device's streams); nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _devices(mesh):
    return [torch.device(d) for d in (make_mesh() if mesh is None else mesh)]


def shard_scene(scene: Scene, mesh) -> dict:
    """{device: the scene on it}, one replica per distinct device of the mesh."""
    return {d: scene_to(scene, d) for d in dict.fromkeys(_devices(mesh))}


def render_image_sharded(scene: Scene, options: RenderOptions = RenderOptions(), mesh=None):
    """Full-frame render with the pixel axis split over the mesh (every
    CUDA device by default).

    The pixel axis is padded to a multiple of the mesh size (padded lanes
    render pixel 0 and are discarded); each device renders its contiguous
    shard in passes of k = max(1, min(spp, max_rays_per_pass x devices /
    padded pixels)) samples. Returns [H, W, 3] float32 numpy (y-flipped),
    bit for bit render_image's when k is the same in both.
    """
    mesh = _devices(mesh)
    replicas = shard_scene(scene, mesh)
    cam = scene.meta.camera
    W, H = cam.width, cam.height
    n_pixels, n_dev = W * H, len(mesh)
    n_pad = -(-n_pixels // n_dev) * n_dev
    pix = torch.arange(n_pad, dtype=torch.int32)
    pix[n_pixels:] = 0  # padded lanes render pixel 0, discarded below
    shards = [p.to(d) for p, d in zip(pix.view(n_dev, -1), mesh)]
    k = max(1, min(options.spp, options.max_rays_per_pass * n_dev // max(n_pad, 1)))
    acc = [None] * n_dev
    with torch.inference_mode():
        for s in range(0, options.spp, k):  # devices in turn, so that several cards overlap
            ns = min(k, options.spp - s)
            for i, d in enumerate(mesh):
                with device_scope(d):
                    out = render_pass(replicas[d], options, shards[i], s, W, ns)
                    acc[i] = out if acc[i] is None else acc[i] + out
    img = torch.cat([a.cpu() for a in acc]).numpy()[:n_pixels].reshape(H, W, 3) / options.spp
    return img[::-1]


def sharded_loss_grad(scene: Scene, options: RenderOptions, pixel_idx, target, n_samples: int = 1, mesh=None):
    """grad.render_loss_grad with the pixel batch split over the mesh: each
    device runs the pass loop on its contiguous shard against its replica,
    and the losses and Scene-shaped gradients are summed onto the mesh's
    first device. The mode is resolved over the whole batch, as
    render_loss_grad resolves it; the loss is the monolithic mean.

    Returns:
        (loss, grads) on mesh[0].
    """
    mesh = _devices(mesh)
    replicas = shard_scene(scene, mesh)
    mode = grad.resolve_mode(options, pixel_idx.shape[0] * n_samples)
    parts = []
    for d, p, t in zip(mesh, pixel_idx.tensor_split(len(mesh)), target.tensor_split(len(mesh))):
        with device_scope(d):
            parts.append(grad.partial_loss_grad(replicas[d], options, p.to(d), t.to(d), n_samples, mode,
                                                target.numel()))
    loss = sum(l.to(mesh[0]) for l, _ in parts)
    tables = [float_tables(g) for _, g in parts]  # the first on mesh[0], HOST_TABLES' on the CPU
    summed = {key: sum(t[key].to(x.device) for t in tables) for key, x in tables[0].items()}
    return loss, replace_tables(parts[0][1], summed, drop_rest=True)
