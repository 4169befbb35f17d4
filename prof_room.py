#!/usr/bin/env python3
"""Room and textured on one CUDA card: render times, and device profiles.

`python3 prof_room.py` renders scenes/room/room.xml with take_tpu_torch
(1920x1080, 4 spp, max_depth 6, seed 0, as chip_smoke.py's room cell) after
a 1-spp warm-up render on each route, which builds its kernels, and prints:

  1. the card: nvidia-smi's name and power limit;
  2. routes: RENDERS renders through K3, then one through K4/K5
     (traverse.FORCE_CLUSTER) and one through K6 (traverse.FORCE_SWEEP),
     each timed on the host clock up to a synchronise, with the SM clock
     and power drawn after it, and the median and range of the K3 renders;
  3. profile: a 1-spp render under torch.profiler, on the K3 route and on
     the K6 route: device busy share of the profiled span, kernel time by
     kind (K3, K4/K5, K6, gathers, ...), the largest kernels, and the
     gathers (aten::index) by input shape.

`python3 prof_room.py --textured` renders scenes/textured/textured.xml
(512x512, 64 spp, max_depth 6, the default policy: the wavefront-refill
loop) and prints:

  1. the card;
  2. loops: renders through the refill loop at each of WAVES lanes
     (integrator/wavefront.py WAVE_SIZE) and through the scan loop
     (integrator "mis_scan"), interleaved (2^16, 2^18, 2^20, scan, scan,
     2^20, 2^18, 2^16), and the median of each;
  3. profile: one pass of 2^20 paths through trace_wavefront under
     torch.profiler at each wave size: busy share, kernel time by kind,
     launches, and the loop's iterations and launches per iteration.

Times are Mrays/s by bench.py's metric, rays = W * H * spp * (1 + 2 (d + 1)).
"""

import contextlib
import dataclasses
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
ROOM = ROOT / "scenes" / "room" / "room.xml"
TEXTURED = ROOT / "scenes" / "textured" / "textured.xml"
SPP, DEPTH, SEED = 4, 6, 0
RENDERS = 6  # K3-route renders, for the median and the spread
TEX_SPP = 64
WAVES = (1 << 16, 1 << 18, 1 << 20)


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def kind(name):
    low = name.lower()
    if "packet_kernel" in low:
        return "K3"
    if "cluster_kernel" in low:
        return "K4/K5"
    if "sweep_kernel" in low:
        return "K6"
    if "index" in low or "gather" in low or "scatter" in low:
        return "gather/scatter"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "reduce" in low:
        return "reductions"
    if "copy" in low or "cast" in low:
        return "copies/casts"
    return "elementwise/other"


def profile_call(torch, fn, label):
    """Profile one call of `fn`: busy share of the device span, kernel time
    by kind and by kernel, host launches, and aten::index by input shape.
    Returns (fn's result, kernel launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        result = fn()
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
    return result, launches


def timed(torch, render_image, scene, opts, label, ctx=None):
    """Seconds of one render on the host clock, up to a synchronise."""
    cam = scene.meta.camera
    rays = cam.width * cam.height * opts.spp * (1 + 2 * (opts.max_depth + 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ctx or contextlib.nullcontext():
        render_image(scene, opts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[render] {label}: {dt:.4f} s = {rays / dt / 1e6:.3f} Mrays/s; "
          f"clock, power {smi('clocks.sm,power.draw')}", flush=True)
    return dt, rays


def room(torch, render_image, parse_scene_file, RenderOptions):
    from take_tpu_torch.geometry import traverse

    scene = parse_scene_file(str(ROOM), device="cuda")
    opts = RenderOptions(spp=SPP, max_depth=DEPTH, seed=SEED)
    one = RenderOptions(spp=1, max_depth=DEPTH, seed=SEED)
    for switch in (None, "FORCE_CLUSTER", "FORCE_SWEEP"):  # build each route's kernels untimed
        with mock.patch.object(traverse, switch, True) if switch else contextlib.nullcontext():
            render_image(scene, one)
    k3 = [timed(torch, render_image, scene, opts, "K3 route") for _ in range(RENDERS)]
    rays = k3[0][1]
    k3 = [dt for dt, _ in k3]
    k45, _ = timed(torch, render_image, scene, opts, "K4/K5 route",
                   mock.patch.object(traverse, "FORCE_CLUSTER", True))
    k6, _ = timed(torch, render_image, scene, opts, "K6 route (K3 any hit)",
                  mock.patch.object(traverse, "FORCE_SWEEP", True))
    m = statistics.median(k3)
    print(f"[routes] K3 median {m:.4f} s = {rays / m / 1e6:.3f} Mrays/s ({min(k3):.4f}-{max(k3):.4f} s "
          f"over {len(k3)}); K4/K5 {k45:.4f} s = {rays / k45 / 1e6:.3f} Mrays/s; K6 {k6:.4f} s = "
          f"{rays / k6 / 1e6:.3f} Mrays/s", flush=True)
    profile_call(torch, lambda: render_image(scene, one), "1 spp")
    with mock.patch.object(traverse, "FORCE_SWEEP", True):
        profile_call(torch, lambda: render_image(scene, one), "1 spp, K6 route")


def textured(torch, render_image, parse_scene_file, RenderOptions):
    from take_tpu_torch.integrator import wavefront

    scene = parse_scene_file(str(TEXTURED), device="cuda")
    cam = scene.meta.camera
    opts = RenderOptions(spp=TEX_SPP, max_depth=DEPTH, seed=SEED)
    render_image(scene, RenderOptions(spp=1, max_depth=DEPTH, seed=SEED))  # builds the kernel
    times = defaultdict(list)
    scan = dataclasses.replace(opts, integrator="mis_scan")
    for wave in WAVES + ("scan", "scan") + WAVES[::-1]:
        if wave == "scan":
            dt, rays = timed(torch, render_image, scene, scan, "scan loop")
        else:
            with mock.patch.object(wavefront, "WAVE_SIZE", wave):
                dt, rays = timed(torch, render_image, scene, opts, f"wave {wave}")
        times[wave].append(dt)
    print("[waves] " + "; ".join(
        f"{w}: median {statistics.median(t):.4f} s = {rays / statistics.median(t) / 1e6:.3f} Mrays/s "
        f"({', '.join(f'{x:.4f}' for x in t)})" for w, t in times.items()), flush=True)
    # one pass as render_pass lays it out: 2^20 paths, pixel-major, 4 samples each
    k = (1 << 20) // (cam.width * cam.height)
    pix = torch.arange(cam.width * cam.height, dtype=torch.int32, device="cuda").repeat_interleave(k)
    samp = torch.arange(k, dtype=torch.int32, device="cuda").repeat(cam.width * cam.height)
    for wave in WAVES:
        with mock.patch.object(wavefront, "WAVE_SIZE", wave), torch.inference_mode():
            (_, nominal, active), launches = profile_call(
                torch, lambda: wavefront.trace_wavefront(scene, opts, pix, samp, cam.width, with_counts=True),
                f"one pass, wave {wave}")
        iterations = nominal // (2 * min(wave, pix.shape[0]))
        print(f"[pass] wave {wave}: {iterations} iterations, {launches} launches = "
              f"{launches / iterations:.1f} per iteration; active_fraction {active / nominal:.6f}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    print(f"[card] {smi('name,power.limit')}", flush=True)
    run = textured if "--textured" in sys.argv[1:] else room
    run(torch, render_image, parse_scene_file, RenderOptions)


if __name__ == "__main__":
    main()
