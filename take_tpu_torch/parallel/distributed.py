"""Several processes, one device each, over torch.distributed. Port of
take_tpu/parallel/distributed.py.

  * `init_distributed(...)`: call once per process before rendering. A
    no-op when launched as one process, so one process and N share every
    line of rendering code.
  * `render_image_multihost(scene, options)`: each rank renders only its
    shard of the padded pixel axis (tile ownership) through the same
    `render_pass` as render_image, and the frame is assembled on every
    rank with an all-gather.

Launch recipe (N processes, on one machine or several; rank 0's host
reachable on a free port):

    # in process i of N:
    from take_tpu_torch.parallel import distributed as D
    D.init_distributed("host0:29500", num_processes=N, process_id=i, backend="nccl")
    scene = take_tpu_torch.load_scene(path, device=D.local_device())
    img = D.render_image_multihost(scene, options)  # the full frame, on every rank

NCCL wants one card per rank; "gloo" runs the CPU tests, and two ranks
that share one card. The collective's tensors live where the backend takes
them: on the card under NCCL, on the host under any other backend (one copy
of the rank's accumulated shard a render, as JAX's process_allgather
returns host arrays). The render itself stays on the scene's device.

Not ported: take_tpu's per-pass cap on BVH scenes (config.BVH_PASS_CAP) and
its per-pass retry (render.py:210-223), both workarounds for a TPU runtime
fault; the port's render_image has neither.
"""

import time

import torch
import torch.distributed as dist

from take_tpu_torch.render import render_pass
from take_tpu_torch.scene.types import RenderOptions, Scene


def init_distributed(coordinator_address=None, num_processes=None, process_id=None, local_device_ids=None,
                     backend="nccl"):
    """Join the process group: world size `num_processes`, this process's
    rank `process_id`, rank 0 listening at `coordinator_address`
    ("host:port"; without one, torch's env:// variables, as torchrun sets
    them). A no-op for num_processes <= 1. Where there is a card, it sets
    this rank's device: cuda:<local_device_ids[0]>, else
    cuda:<rank % device count>."""
    if num_processes is not None and num_processes <= 1:
        return
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    if torch.cuda.is_available():
        ids = local_device_ids or [dist.get_rank() % torch.cuda.device_count()]
        torch.cuda.set_device(ids[0])


def local_device():
    """This rank's card (set by init_distributed; cuda:0 in one process).
    Without a card this raises torch's error."""
    torch.cuda.init()
    return torch.device("cuda", torch.cuda.current_device())


def world(group=None):
    """(rank, world size) in `group`; (0, 1) without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def collective_device(device, group=None):
    """Where a collective's tensors go: `device` under NCCL, the host under
    any other backend (gloo reduces and gathers host tensors)."""
    return device if dist.get_backend(group) == "nccl" else torch.device("cpu")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_image_multihost(scene: Scene, options: RenderOptions = RenderOptions(), mesh=None, stats: dict = None):
    """Full-frame render over every rank of the process group `mesh` (the
    default group; one process when none is initialised); returns the
    complete [H, W, 3] numpy image on every rank (y-flipped).

    Rank r renders the r-th contiguous shard of the pixel axis, padded to a
    multiple of the world size, in passes of k = max(1, min(spp,
    max_rays_per_pass x world / padded pixels)) samples: the shards and k of
    render_image_sharded over as many devices, so the frame is bit for bit
    that render's, and render_image's where k is the same.

    Pass stats={} to collect pass_seconds (the rank's passes, synchronised
    after each) and assemble_seconds (the all-gather and its copies). Adds
    one device sync a pass.
    """
    rank, n_ranks = world(mesh)
    device = scene.background.device
    cam = scene.meta.camera
    W, H = cam.width, cam.height
    n_pixels = W * H
    n_pad = -(-n_pixels // n_ranks) * n_ranks
    per = n_pad // n_ranks
    pix = torch.arange(rank * per, (rank + 1) * per, dtype=torch.int32, device=device)
    pix[pix >= n_pixels] = 0  # padded lanes render pixel 0, discarded below
    k = max(1, min(options.spp, options.max_rays_per_pass * n_ranks // max(n_pad, 1)))

    acc, t_pass = None, 0.0
    with torch.inference_mode():
        for s in range(0, options.spp, k):
            t0 = time.perf_counter()
            out = render_pass(scene, options, pix, s, W, min(k, options.spp - s))
            if stats is not None:
                _sync(device)
            t_pass += time.perf_counter() - t0
            acc = out if acc is None else acc + out

    t0 = time.perf_counter()
    if dist.is_available() and dist.is_initialized():
        acc = acc.to(collective_device(device, mesh))
        shards = [torch.empty_like(acc) for _ in range(n_ranks)]
        dist.all_gather(shards, acc, group=mesh)
        acc = torch.cat(shards)
    full = acc.cpu().numpy()
    if stats is not None:
        stats["pass_seconds"] = t_pass
        stats["assemble_seconds"] = time.perf_counter() - t0
    img = full[:n_pixels].reshape(H, W, 3) / options.spp
    return img[::-1]
