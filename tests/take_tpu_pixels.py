"""take_tpu's render of a seeded set of one config's pixels, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.take_tpu_pixels NAME N [--port] [--write]

Renders the first N of run_configs.subset_ids's pixels of config NAME (at its
full spp, camera and resolution) with take_tpu in float32 (XLA on the CPU
computes every matmul in float32; the TPU ran the envmap's direction
transforms at bfloat16 operands) and prints run_configs.pixel_agreement of
them, rounded to half floats, against take_tpu's TPU image
(benchmarks/out/NAME.exr); with --port also the port's pixels on the CPU
against that image and against take_tpu's. --write saves take_tpu's pixels
to take_tpu_torch/data/NAME_take_tpu_f32.npz (ids, radiance, spec): for ibl,
the reference run_configs holds the port's image against
(run_configs.TAKE_TPU_IBL); tests/test_torch_configs.py re-renders a prefix
of its pixels with take_tpu and checks the file.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from take_tpu.core.camera import Camera
from take_tpu.render import render_pass
from take_tpu.scene.parse_xml import parse_scene_file
from take_tpu.scene.types import RenderOptions
from take_tpu_torch import run_configs

BATCH = 1 << 15  # paths a jitted call


def config(name):
    return next(c for c in run_configs.CONFIGS if c[0] == name)


def take_tpu_scene(name):
    _, rel, res, _, _ = config(name)
    scene = parse_scene_file(str(run_configs.SCENES / rel))
    if res is None:
        return scene
    cam = scene.meta.camera
    camera = Camera(res, res, cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(scene, meta=dataclasses.replace(scene.meta, camera=camera))


def take_tpu_pixels(name, ids):
    """take_tpu's mean radiance at the pixels `ids` of config `name`: every
    sample of a pixel in one render_pass, BATCH paths a call. [N, 3]."""
    _, _, _, spp, depth = config(name)
    scene = take_tpu_scene(name)
    options = RenderOptions(spp=spp, max_depth=depth, seed=0)
    per = max(1, min(BATCH // spp, len(ids)))
    ids = np.asarray(ids, np.int32)
    pad = -len(ids) % per  # whole batches: one compiled shape
    padded = np.concatenate([ids, np.zeros(pad, np.int32)])
    out = [np.asarray(render_pass(scene, options, jnp.asarray(padded[i:i + per]), 0, scene.meta.camera.width, spp))
           for i in range(0, len(padded), per)]
    return (np.concatenate(out)[:len(ids)] / spp).astype(np.float32)


def main(argv):
    name, n = argv[0], int(argv[1])
    _, rel, res, spp, depth = config(name)
    cam = take_tpu_scene(name).meta.camera
    ids = run_configs.subset_ids(cam.width * cam.height, n)
    ours = take_tpu_pixels(name, ids)
    exr = run_configs.image_pixels(run_configs.read_reference(run_configs.TAKE_TPU_OUT / f"{name}.exr",
                                                              (cam.height, cam.width, 3)), ids)
    print(f"{name}, {n} pixels: take_tpu (CPU) vs the TPU image",
          run_configs.pixel_agreement(ours.astype(np.float16), exr))
    if "--port" in argv:
        from take_tpu_torch.scene.types import RenderOptions as PortOptions

        port = run_configs.render_pixels(run_configs.config_scene(rel, res, "cpu"),
                                         PortOptions(spp=spp, max_depth=depth, seed=0), ids)
        print("the port (CPU) vs the TPU image", run_configs.pixel_agreement(port.astype(np.float16), exr))
        print("the port vs take_tpu (CPU)", run_configs.pixel_agreement(port, ours))
    if "--write" in argv:
        path = Path(run_configs.TAKE_TPU_IBL).parent / f"{name}_take_tpu_f32.npz"
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, ids=ids, radiance=ours,
                            spec=np.array([cam.width, cam.height, spp, depth, 0], np.int32))
        print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:])
