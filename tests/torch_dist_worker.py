"""One rank of a two-process torch.distributed group (gloo, localhost TCP)
for tests/test_torch_parallel.py. Builds the scene from the numpy tables
the parent wrote, renders the frame through render_image_multihost and
takes the banded gradient, and saves both with the rank's stats. Imports no
JAX.

Usage: python tests/torch_dist_worker.py <rank> <world> <port> <scene.npz> <outdir>
"""

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RENDER = dict(spp=8, max_depth=3, seed=21)  # the frame
GRAD = dict(spp=1, max_depth=2, seed=3)  # the banded gradient (test_overlap.py's): every pixel, 1 sample,
N_BANDS, GRAD_SAMPLES, TARGET_SEED = 2, 1, 0  # 2 bands, a uniform target from seed 0


def meta_to_json(meta) -> str:
    return json.dumps(dataclasses.asdict(meta))


def meta_from_json(text):
    from take_tpu_torch.core.camera import Camera
    from take_tpu_torch.scene.types import SceneMeta

    fields = json.loads(text)
    cam = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.pop("camera").items()}
    fields["used_material_tags"] = tuple(fields["used_material_tags"])
    return SceneMeta(camera=Camera(**cam), **fields)


def grad_inputs(n_pixels):
    """(pixels, target) of the banded gradient, the same in every process."""
    import numpy as np
    import torch

    target = np.random.default_rng(TARGET_SEED).uniform(0.0, 1.0, (n_pixels, 3))
    return torch.arange(n_pixels, dtype=torch.int32), torch.as_tensor(target, dtype=torch.float32)


def main():
    rank, n_ranks, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    scene_path, outdir = sys.argv[4], sys.argv[5]

    import numpy as np
    import torch
    import torch.distributed as dist

    from take_tpu_torch.parallel.distributed import init_distributed, render_image_multihost
    from take_tpu_torch.parallel.overlap import banded_loss_grad
    from take_tpu_torch.scene.types import RenderOptions, float_tables, scene_from_numpy

    torch.set_num_threads(1)
    with np.load(scene_path) as z:
        tables = {k: z[k] for k in z.files if k != "meta"}
        meta = meta_from_json(str(z["meta"]))
    scene = scene_from_numpy(tables, meta, "cpu")

    init_distributed(f"localhost:{port}", n_ranks, rank, backend="gloo")
    try:
        stats = {}
        img = render_image_multihost(scene, RenderOptions(**RENDER), stats=stats)
        pix, target = grad_inputs(meta.camera.width * meta.camera.height)
        loss, g = banded_loss_grad(scene, RenderOptions(**GRAD), pix, target, N_BANDS, n_samples=GRAD_SAMPLES)
        grads = {f"grad/{k}": v.numpy() for k, v in float_tables(g).items()}
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), img=img, loss=loss.numpy(),
                 stats=json.dumps(stats), **grads)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
