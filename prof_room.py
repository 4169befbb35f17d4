#!/usr/bin/env python3
"""Room on one CUDA card: render times by route, and a device profile.

`python3 prof_room.py` renders scenes/room/room.xml with
take_tpu_torch (1920x1080, 4 spp, max_depth 6, seed 0, as chip_smoke.py's
room cell) after one warm-up render that builds the kernels, and prints:

  1. the card: nvidia-smi's name and power limit;
  2. routes: RENDERS renders through K3, then one through K4/K5
     (traverse.FORCE_CLUSTER), each timed on the host clock up to a
     synchronise, with the SM clock and power drawn after it, and the
     median and range of the K3 renders;
  3. profile: a 1-spp render under torch.profiler: device busy share of the
     profiled span, kernel time by kind (K3, K4/K5, gathers, ...), the
     largest kernels, and the gathers (aten::index) by input shape.

Times are Mrays/s by bench.py's metric, rays = W * H * spp * (1 + 2 (d + 1)).
"""

import contextlib
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
ROOM = ROOT / "scenes" / "room" / "room.xml"
SPP, DEPTH, SEED = 4, 6, 0
RENDERS = 6  # K3-route renders, for the median and the spread


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def kind(name):
    low = name.lower()
    if "packet_kernel" in low:
        return "K3"
    if "cluster_kernel" in low:
        return "K4/K5"
    if "index" in low or "gather" in low or "scatter" in low:
        return "gather/scatter"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "reduce" in low:
        return "reductions"
    if "copy" in low or "cast" in low:
        return "copies/casts"
    return "elementwise/other"


def profile_render(torch, render_image, scene, options, label):
    """Profile one render: busy share of the device span, kernel time by
    kind and by kernel, host launches, and aten::index by input shape."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        render_image(scene, options)
        torch.cuda.synchronize()
    intervals, by_name, launches = [], defaultdict(float), 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            by_name[e.name] += e.time_range.end - e.time_range.start
        elif e.name == "cudaLaunchKernel":
            launches += 1
    intervals.sort()
    busy, cur = 0.0, None
    for s, t in intervals:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    busy += cur[1] - cur[0]
    span = max(t for _, t in intervals) - intervals[0][0]
    total = sum(by_name.values())
    print(f"[profile {label}] device span {span / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms = "
          f"{busy / span:.4f}; kernel time {total / 1e3:.3f} ms; cudaLaunchKernel {launches}")
    cat = defaultdict(float)
    for n, v in by_name.items():
        cat[kind(n)] += v
    for k, v in sorted(cat.items(), key=lambda x: -x[1]):
        print(f"  {k}: {v / 1e3:.3f} ms = {v / total:.4f}")
    for n, v in sorted(by_name.items(), key=lambda x: -x[1])[:10]:
        print(f"    {v / 1e3:9.3f} ms  {n[:110]}")
    rows = [a for a in prof.key_averages(group_by_input_shape=True) if a.key == "aten::index"]
    rows.sort(key=lambda a: -a.device_time_total)
    for a in rows[:8]:
        print(f"    aten::index {a.device_time_total / 1e3:9.3f} ms  x{a.count}  {a.input_shapes}")
    sys.stdout.flush()


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from take_tpu_torch.geometry import traverse
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    print(f"[card] {smi('name,power.limit')}", flush=True)
    room = parse_scene_file(str(ROOM), device="cuda")
    cam = room.meta.camera
    opts = RenderOptions(spp=SPP, max_depth=DEPTH, seed=SEED)
    rays = cam.width * cam.height * SPP * (1 + 2 * (DEPTH + 1))
    render_image(room, RenderOptions(spp=1, max_depth=DEPTH, seed=SEED))  # builds the kernels

    def timed(label, ctx=contextlib.nullcontext()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            render_image(room, opts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[render] {label}: {dt:.4f} s = {rays / dt / 1e6:.3f} Mrays/s; "
              f"clock, power {smi('clocks.sm,power.draw')}", flush=True)
        return dt

    k3 = [timed("K3 route") for _ in range(RENDERS)]
    k45 = timed("K4/K5 route", mock.patch.object(traverse, "FORCE_CLUSTER", True))
    m = statistics.median(k3)
    print(f"[routes] K3 median {m:.4f} s = {rays / m / 1e6:.3f} Mrays/s ({min(k3):.4f}-{max(k3):.4f} s "
          f"over {len(k3)}); K4/K5 {k45:.4f} s = {rays / k45 / 1e6:.3f} Mrays/s", flush=True)

    profile_render(torch, render_image, room, RenderOptions(spp=1, max_depth=DEPTH, seed=SEED), "1 spp")


if __name__ == "__main__":
    main()
