"""Observability: the scene summary and profiler traces. Port of
take_tpu/utils/metrics.py (the reference's print_scene), with
torch.profiler in place of jax.profiler. Spans and phase timing are
take_tpu_torch/tracing.py's.
"""

import contextlib
import os
import time

import torch


def scene_summary(scene):
    """Structured scene statistics (debug_log / print_scene parity)."""
    meta = scene.meta
    info = {
        "triangles": meta.n_tri,
        "spheres": meta.n_sph,
        "materials": meta.n_mat,
        "material_tags": list(meta.used_material_tags),
        "lights": meta.n_lights,
        "textures": meta.n_tex,
        "has_envmap": meta.has_envmap,
        "background": [float(x) for x in scene.background],
        "bvh": None,
    }
    if meta.camera is not None:
        info["camera"] = {
            "resolution": [meta.camera.width, meta.camera.height],
            "vfov": meta.camera.vfov,
            "lookfrom": list(meta.camera.lookfrom),
        }
    if scene.bvh is not None:
        info["bvh"] = {
            "nodes": int(scene.bvh.node_child.shape[0]),
            "width": int(scene.bvh.node_child.shape[1]),
        }
    return info


@contextlib.contextmanager
def profiler_trace(logdir=None, device="cuda"):
    """torch.profiler over the block, its Chrome trace (view it in Perfetto
    or chrome://tracing) written into `logdir` as trace_<pid>_<ns>.json;
    nothing without a logdir. CPU activity, and the card's when `device`
    is a CUDA device (the default; pass "cpu" for a render on the CPU).
    Yields the profiler (None without a logdir)."""
    if logdir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
