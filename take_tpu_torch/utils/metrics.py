"""Observability: phase timers, progress, throughput counters, scene
summary, profiler traces. Port of take_tpu/utils/metrics.py (the reference's
Timer, timer.h:68-78; ProgressReporter, progressreporter.h:8-38;
print_scene), with torch.profiler in place of jax.profiler.
"""

import contextlib
import os
import sys
import time

import torch


class PhaseTimer:
    """Wall-clock phase timing with a report, like the reference's
    tick(timer) bracketing of parse/BVH/render (render.cpp:25-83)."""

    def __init__(self, log=True):
        self.phases = {}
        self._log = log

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.time()
        yield
        dt = time.time() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt
        if self._log:
            print(f"[take-tpu] {name}: {dt:.3f}s", flush=True)

    def report(self):
        return dict(self.phases)


class ProgressReporter:
    """Single-line progress display (progressreporter.h semantics)."""

    def __init__(self, total, stream=sys.stdout):
        self.total = total
        self.done = 0
        self._stream = stream
        self._t0 = time.time()

    def update(self, num=1):
        self.done += num
        pct = 100.0 * self.done / max(self.total, 1)
        elapsed = time.time() - self._t0
        eta = elapsed / max(self.done, 1) * (self.total - self.done)
        self._stream.write(
            f"\r {pct:.2f}% done ({self.done} / {self.total}), ETA {eta:.0f}s "
        )
        self._stream.flush()
        if self.done >= self.total:
            self._stream.write("\n")


class ThroughputMeter:
    """Accumulates path/ray counts; reports Mrays/s and Mpaths/s."""

    def __init__(self):
        self.paths = 0
        self.rays = 0
        self.seconds = 0.0

    def add(self, n_paths, n_rays, seconds):
        self.paths += n_paths
        self.rays += n_rays
        self.seconds += seconds

    @property
    def mrays_per_sec(self):
        return self.rays / max(self.seconds, 1e-9) / 1e6

    @property
    def mpaths_per_sec(self):
        return self.paths / max(self.seconds, 1e-9) / 1e6

    def report(self):
        return {
            "paths": self.paths,
            "rays": self.rays,
            "seconds": round(self.seconds, 3),
            "Mrays/s": round(self.mrays_per_sec, 2),
            "Mpaths/s": round(self.mpaths_per_sec, 2),
        }


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
