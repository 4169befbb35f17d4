"""Checkpoint and resume for long renders. Port of
take_tpu/utils/checkpoint.py, in the same file format, so that a checkpoint
written by either package resumes in the other.

The state is small and exact: the per-pixel radiance sums and the number
of samples done. The RNG is counter-based and keyed by (pixel, sample), so
resuming at sample k continues the identical sample stream: a resumed
render is bit for bit an uninterrupted one.
"""

import json
import os

import numpy as np
import torch

from take_tpu_torch.render import render_pass


def save_accumulator(path, acc, spp_done, seed, meta=None):
    """Atomically write accumulator state. acc: [n_pixels, 3] radiance SUM."""
    tmp = str(path) + ".tmp"
    np.savez_compressed(
        tmp,
        acc=np.asarray(acc, np.float32),
        spp_done=np.int64(spp_done),
        seed=np.int64(seed),
        meta=json.dumps(meta or {}),
    )
    os.replace(tmp + ".npz", path)


def load_accumulator(path):
    """Returns (acc, spp_done, seed, meta) or None if absent."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return (
            z["acc"],
            int(z["spp_done"]),
            int(z["seed"]),
            json.loads(str(z["meta"])),
        )


def render_image_resumable(scene, options, checkpoint_path, checkpoint_every=4, progress=None):
    """render_image on the scene's device, checkpointing every
    `checkpoint_every` passes and resuming from the checkpoint at
    `checkpoint_path` when there is one; the last checkpoint records
    {"complete": true}. Passes cover every pixel with k = max(1, min(spp,
    max_rays_per_pass / pixels)) samples each, so the image is bit for bit
    render_image's where render_image renders one band. `progress(s, spp)`
    is called after each pass. Raises ValueError when the checkpoint's seed
    or pixel count differs from this render's."""
    cam = scene.meta.camera
    W, H = cam.width, cam.height
    n_pixels = W * H
    device = scene.background.device

    state = load_accumulator(checkpoint_path)
    if state is not None:
        acc, spp_done, seed, _ = state
        if seed != options.seed or acc.shape[0] != n_pixels:
            raise ValueError(
                "checkpoint does not match render configuration "
                f"(seed {seed} vs {options.seed}, pixels {acc.shape[0]})"
            )
        acc = torch.from_numpy(acc).to(device)
    else:
        acc = torch.zeros((n_pixels, 3), dtype=torch.float32, device=device)
        spp_done = 0

    pix = torch.arange(n_pixels, dtype=torch.int32, device=device)
    k = max(1, min(options.spp, options.max_rays_per_pass // max(n_pixels, 1)))
    since_ckpt = 0
    s = spp_done
    with torch.inference_mode():
        while s < options.spp:
            ns = min(k, options.spp - s)
            acc = acc + render_pass(scene, options, pix, s, W, ns)
            s += ns
            since_ckpt += 1
            if progress is not None:
                progress(s, options.spp)
            if since_ckpt >= checkpoint_every and s < options.spp:
                save_accumulator(checkpoint_path, acc.cpu().numpy(), s, options.seed)
                since_ckpt = 0

    acc = acc.cpu().numpy()
    img = acc.reshape(H, W, 3) / options.spp
    save_accumulator(checkpoint_path, acc, options.spp, options.seed, meta={"complete": True})
    return img[::-1]
