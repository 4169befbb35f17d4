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

`python3 prof_room.py --k3 [--check]` holds K3 (csrc/traverse.cu) against
the kernel it replaced and against staged variants, in one call, on the
card. Stage them first, under the ignored build/ directory:

    mkdir -p build/k3_ab/parent
    git show <parent>:take_tpu_torch/csrc/traverse.cu > build/k3_ab/parent/traverse.cu

(with the parent's csrc/geometry.cuh beside it where this tree's differs),
or put a variant of the current source at build/k3_ab/<name>.cu. Each is
built with nvcc beside the package's own; a source that names `qnodes`
reads the quantised nodes, any other (the parent) the exact node rows
(bvh.nodes). It prints:

  1. the card, and ptxas's report of every variant;
  2. check: each variant once on 2^20 room rays of chip_smoke's mix, both
     modes, held against packet_plain by chip_smoke's gates (--check stops
     here);
  3. batches: per-pass sums of each variant's time (CUDA events, 10 calls
     after 3 warm-ups per batch) on chip_smoke's mix and on the captured
     batches of one pass of room (1920x1080, d6) and of textured (512x512,
     64 spp, d6, refill loop), the variants in turn and back (old, new,
     new, old), and each batch's time for the parent and the package's
     kernel;
  4. renders: room and textured through each variant, in the same order.

`python3 prof_room.py --brute [--check]` holds K1/K2 (csrc/brute.cu) against
the kernel they replaced and against staged variants in the same way:

    mkdir -p build/brute_ab/parent
    git show <parent>:take_tpu_torch/csrc/brute.cu > build/brute_ab/parent/brute.cu

or a variant of the current source at build/brute_ab/<name>.cu. Each is
built with nvcc in parallel, beside the package's own source ("new"), and
called the same way; the package's wrappers run too, and its K2 over rows
sorted by triangle area, both ways. It prints:

  1. the card, and ptxas's report of every variant;
  2. check: every variant on chip_smoke's 2^20 cbox rays and on the
     captured batches of one pass of cbox (1024x1024, 16 spp, d4) and of
     mis (512x512, 128 spp, d6), held against the plain twins by
     chip_smoke's gates, and the rays whose outputs differ in any bit from
     the parent's (--check stops here);
  3. batches: per-pass sums of each variant's time on the three sets (CUDA
     events, 10 calls after 3 warm-ups per batch), the variants in turn and
     back, each batch's time for the parent and the package, and the
     per-pass bounds (chip_smoke.brute_bounds);
  4. renders: cbox and mis through each variant, in the same order;
  5. profile: one pass of mis (4 spp of 512x512) under torch.profiler.

`python3 prof_room.py --cluster [--check]` holds K4/K5 (csrc/cluster.cu)
against the kernel they replaced and against staged variants in the same
way:

    mkdir -p build/cluster_ab/parent
    git show <parent>:take_tpu_torch/csrc/cluster.cu > build/cluster_ab/parent/cluster.cu

or a variant of the current source at build/cluster_ab/<name>.cu. Each is
built with nvcc in parallel beside the package's own source ("new"); a
source that names `cl_aabb` takes the cluster boxes, any other (the parent)
only the supercluster boxes. It prints:

  1. the card, and ptxas's report of every variant;
  2. check: every variant on chip_smoke's 2^20 room rays and on the batches
     of one pass of room (1920x1080, d6) under traverse.FORCE_CLUSTER, held
     against cluster_plain by chip_smoke's gates (the package must pass; a
     staged variant that fails is reported), and the rays whose outputs
     differ from the parent's and from the twin's in any bit; the counted
     work per live ray (chip_smoke.cluster_counts) on each set (--check
     stops here);
  3. batches: per-pass sums of each variant's time on both sets (CUDA
     events, 10 calls after 3 warm-ups per batch), the variants in turn and
     back (old, new, new, old), each batch's time for the parent and the
     package, and the per-pass bounds (chip_smoke.bvh_bound);
  4. renders: room (1920x1080, 4 spp, d6) under FORCE_CLUSTER through each
     variant, in the same order.

`python3 prof_room.py --sweep [--check]` holds K6 (csrc/sweep.cu) against the
kernel it replaced and against variants in the same way:

    mkdir -p build/sweep_ab/parent
    git show <parent>:take_tpu_torch/csrc/sweep.cu > build/sweep_ab/parent/sweep.cu

or a variant of the current source at build/sweep_ab/<name>.cu; two more
are made from the current source by SWEEP_PATCHES ("cull_only": no sweep
phase, so the walk's time; "no_groups": every ray tests every cluster box,
without the group boxes). Each is built with nvcc in parallel beside the
package's own source ("new"). It prints:

  1. the card, and ptxas's report of every variant;
  2. check: every variant on chip_smoke's 2^20 room rays (closest and any
     hit) and on the batches of one pass of room (1920x1080, d6) under
     traverse.FORCE_SWEEP (K6's closest-hit batches and the pass's any-hit
     batches), the rays whose outputs differ from the parent's and from
     sweep_plain's in any bit (the package and no_groups must differ from
     the twin in none), and the counted work per live ray
     (chip_smoke.sweep_counts) on each set (--check stops here);
  3. batches: per-pass sums of each variant's time on both sets (CUDA
     events, 10 calls after 3 warm-ups per batch), the variants in turn and
     back (old, new, new, old), each batch's time for the parent and the
     package, and the per-pass bounds (chip_smoke.bvh_bound);
  4. renders: room (1920x1080, 4 spp, d6) through K3, then under
     FORCE_SWEEP through each variant but cull_only, in the same order,
     then through K3 again.

`python3 prof_room.py --grad` times the two gradient modes of grad.py on
scenes/cbox/cbox.xml at 1024x1024 (GRAD_SPP samples, max_depth 4, the L2
loss of render_loss_grad against a GRAD_SPP-spp target) and prints:

  1. the card;
  2. modes: one render_loss_grad pass of each size in GRAD_PASSES paths
     under grad_mode "ad" and "replay", interleaved ad, replay, replay, ad,
     each on the host clock up to a synchronise with its peak memory
     (torch.cuda.max_memory_allocated);
  3. profile: one replay pass of 2^20 paths and one AD pass of 2^18 under
     torch.profiler, the forward (radiance and loss) alone and then with
     its backward: busy share, kernel time by kind, launches, and the
     forward and the backward on the host clock.
Each pass takes its pixels from the middle rows of the image.

`python3 prof_room.py --policy` times the two bounce loops of integrator
"mis" against each other in each arm of the JAX package's policy for the
refill loop: ibl (scenes/ibl/ibl.xml, 1024x1024, POLICY_IBL_SPP spp, d6; an
envmap scene), textured (512x512, 64 spp, d6; an open BVH scene) and room
(1920x1080, 4 spp, d8; a BVH scene at d >= 8). It prints:

  1. the card;
  2. renders: per scene, after a 1-spp warm-up of each loop, the refill
     loop ("mis_wavefront") and the scan loop ("mis_scan") interleaved
     refill, scan, scan, refill, twice, and the median of each; the two
     images must be equal (no scene uses Russian roulette);
  3. profile: one pass of ibl (2^20 paths, 1 spp of 1024x1024) through
     each loop under torch.profiler, with the device time of the envmap
     lookups (envmap_eval/sample/pdf) and of the Disney lobes (disney.py)
     beside K1 + K2.

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

import numpy as np

ROOT = Path(__file__).resolve().parent
ROOM = ROOT / "scenes" / "room" / "room.xml"
TEXTURED = ROOT / "scenes" / "textured" / "textured.xml"
CBOX = ROOT / "scenes" / "cbox" / "cbox.xml"
MIS = ROOT / "scenes" / "mis" / "mis.xml"
SPP, DEPTH, SEED = 4, 6, 0
RENDERS = 6  # K3-route renders, for the median and the spread
TEX_SPP = 64
WAVES = (1 << 16, 1 << 18, 1 << 20)
IBL = ROOT / "scenes" / "ibl" / "ibl.xml"
POLICY_IBL_SPP = 16
GRAD_SPP, GRAD_PASSES = 4, (1 << 16, 1 << 18, 1 << 20)


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def kind(name):
    low = name.lower()
    if "closest_kernel" in low or "anyhit_kernel" in low:
        return "K1/K2"
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


def profile_call(torch, fn, label, ranges=()):
    """Profile one call of `fn`: busy share of the device span, kernel time
    by kind and by kernel, host launches, aten::index by input shape, and
    the device time of the kernels launched inside each record_function
    range named in `ranges`. Returns (fn's result, kernel launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        result = fn()
        torch.cuda.synchronize()
    intervals, by_name, launches = [], defaultdict(float), 0
    for e in prof.events():
        if e.name in ranges:
            continue
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
    for a in prof.key_averages():
        if a.key in ranges:
            print(f"  range {a.key}: x{a.count}, device {a.device_time_total / 1e3:.3f} ms = "
                  f"{a.device_time_total / total:.4f} of kernel time")
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


def variants(torch, packet, _build):
    """{name: (closest(bvh, *rays), occluded(bvh, *rays))}: the staged
    sources under build/k3_ab, then the package's kernel ("package")."""
    import ctypes

    P, I = ctypes.c_void_p, ctypes.c_int
    out = {}
    staged = ROOT / "build" / "k3_ab"
    for src in sorted([*staged.glob("*.cu"), *staged.glob("*/traverse.cu")]):
        name = src.stem if src.parent == staged else src.parent.name
        lib_path = staged / f"{name}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib_path),
                               str(src)], capture_output=True, text=True)
        print(f"[ptxas {name}] exit {proc.returncode}\n{proc.stderr}{proc.stdout}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}")
        lib = ctypes.CDLL(str(lib_path))
        table = "qnodes" if "qnodes" in src.read_text() else "nodes"
        lib.tt_packet_closest.argtypes = [P] * 6 + [I] + [P] * 5
        lib.tt_packet_occluded.argtypes = [P] * 6 + [I] + [P] * 2

        def make(lib, table):
            def args(bvh, ro, rd, tmin, tmax):
                return [getattr(bvh, table).data_ptr(), bvh.tris.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                        tmin.data_ptr(), tmax.data_ptr(), ro.shape[0]]

            def closest(bvh, *rays):
                n = rays[0].shape[0]
                t, u, v = (torch.empty(n, device="cuda") for _ in range(3))
                prim = torch.empty(n, dtype=torch.int32, device="cuda")
                code = lib.tt_packet_closest(*args(bvh, *rays), t.data_ptr(), u.data_ptr(), v.data_ptr(),
                                             prim.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
                return t, u, v, prim

            def occluded(bvh, *rays):
                occ = torch.empty(rays[0].shape[0], dtype=torch.bool, device="cuda")
                code = lib.tt_packet_occluded(*args(bvh, *rays), occ.data_ptr(),
                                              torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
                return occ
            return closest, occluded

        out[name] = make(lib, table)
    out["package"] = (packet.closest, packet.occluded)
    print(f"[ptxas package]\n{_build.build('traverse')[2]}", flush=True)
    return out


def k3(torch, render_image, parse_scene_file, RenderOptions):
    import chip_smoke as cs
    from take_tpu_torch.geometry import _build, packet

    room = parse_scene_file(str(ROOM), device="cuda")
    tex = parse_scene_file(str(TEXTURED), device="cuda")
    ks = variants(torch, packet, _build)
    names = list(ks)
    bvh = room.bvh
    lo = bvh.node_min[0].amin(dim=0).cpu().numpy().astype(np.float64)
    hi = bvh.node_max[0].amax(dim=0).cpu().numpy().astype(np.float64)
    pad = 0.02 * (hi - lo)
    mix, dead = cs.make_rays(torch, room, np.random.default_rng(SEED), 1 << 20, lo + pad, hi - pad)
    want_c = packet.packet_plain(bvh, *mix)
    want_o = packet.packet_plain(bvh, *mix, any_hit=True)
    for name, (closest, occluded) in ks.items():
        got_c, got_o = closest(bvh, *mix), occluded(bvh, *mix)
        torch.cuda.synchronize()
        _, _, line = cs.closest_gate(torch, f"{name} closest", room, got_c, want_c, mix, dead)
        print(f"[check] {line}", flush=True)
        print(f"[check] {cs.anyhit_gate(torch, f'{name} any-hit', room, got_o, want_o, mix, dead)[1]}", flush=True)
    if "--check" in sys.argv[1:]:
        return
    room_opts = RenderOptions(spp=SPP, max_depth=DEPTH, seed=SEED)
    tex_opts = RenderOptions(spp=TEX_SPP, max_depth=DEPTH, seed=SEED)
    sets = {
        "mix": (bvh, [("closest", mix), ("anyhit", mix)]),
        "room": (bvh, cs.capture_queries(torch, room, dataclasses.replace(room_opts, spp=1))),
        "textured": (tex.bvh, cs.capture_queries(torch, tex, tex_opts)),
    }
    order = names + names[::-1]
    per_batch = defaultdict(lambda: defaultdict(list))
    for label, (b, calls) in sets.items():
        sums = defaultdict(lambda: defaultdict(list))
        for name in order:
            closest, occluded = ks[name]
            tot = defaultdict(float)
            for j, (kind, rays) in enumerate(calls):
                fn = closest if kind == "closest" else occluded
                ms = cs.time_call(torch, lambda: fn(b, *rays), iters=10)
                tot[kind] += ms
                per_batch[(label, name)][j].append(ms)
            for kind, v in tot.items():
                sums[kind][name].append(v)
        for kind, by in sums.items():
            print(f"[batches {label}] {kind} per pass, ms (in order {order}): " + "; ".join(
                f"{n} {', '.join(f'{x:.4f}' for x in v)} (mean {statistics.mean(v):.4f})" for n, v in by.items()),
                flush=True)
        for name in ("parent", "package"):
            if (label, name) in per_batch:
                rows = per_batch[(label, name)]
                print(f"[per batch {label} {name}] " + "; ".join(
                    f"{j}:{calls[j][0]} {statistics.mean(v):.4f}" for j, v in sorted(rows.items())), flush=True)
    for label, scene, opts in (("room", room, room_opts), ("textured", tex, tex_opts)):
        render_image(scene, dataclasses.replace(opts, spp=1))  # warm-up
        times = defaultdict(list)
        for name in order:
            closest, occluded = ks[name]
            with mock.patch.object(packet, "closest", closest), mock.patch.object(packet, "occluded", occluded):
                dt, _ = timed(torch, render_image, scene, opts, f"{label} through {name}")
            times[name].append(dt)
        print(f"[renders {label}] " + "; ".join(f"{n} {', '.join(f'{x:.4f}' for x in v)} s" for n, v in times.items()),
              flush=True)


def brute_variants(torch, brute, _build):
    """{name: (closest(g, n_tri, *rays) -> (attrs, t, u, v, prim), occluded(g,
    n_tri, *rays) -> occ)}: the staged sources under build/brute_ab and the
    package's own source ("new"), built with nvcc in parallel and called
    alike (a source whose entry points take `aff_o`, the parent, reads the
    axis-major affine tables; any other the rows `geometry.tri_rows`), then
    the package's wrappers ("package", which also compute `found`) and the
    package's K2 over rows sorted by triangle area, increasing
    ("small_first": a room's enclosing walls last) and decreasing
    ("big_first")."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    P, I = ctypes.c_void_p, ctypes.c_int
    staged = ROOT / "build" / "brute_ab"
    staged.mkdir(parents=True, exist_ok=True)
    srcs = sorted([*staged.glob("*.cu"), *staged.glob("*/brute.cu")]) + [_build.CSRC / "brute.cu"]

    def build(src):
        name = "new" if src.parent == _build.CSRC else src.stem if src.parent == staged else src.parent.name
        lib_path = staged / f"{name}.so"
        return name, src, lib_path, subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], capture_output=True, text=True)

    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(build, srcs))
    out = {}
    for name, src, lib_path, proc in built:
        print(f"[ptxas {name}] exit {proc.returncode}\n{proc.stderr}{proc.stdout}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}")
        lib = ctypes.CDLL(str(lib_path))
        parent = "aff_o" in src.read_text()
        head = [P, P, I, I] if parent else [P, I]
        lib.tt_brute_closest.argtypes = head + [P] * 5 + [I] + [P] * 6
        lib.tt_brute_occluded.argtypes = head + [P] * 4 + [I, P, P]

        def make(lib, parent):
            def tables(g, n_tri):
                if parent:
                    return [g.tri_affine_o.data_ptr(), g.tri_affine_d.data_ptr(), g.tri_attr.shape[0], n_tri]
                return [g.tri_rows.data_ptr(), n_tri]

            def closest(g, n_tri, *rays):
                attrs, t, u, v, prim = brute._outputs(rays[0].shape[0], rays[0].device)
                code = lib.tt_brute_closest(*tables(g, n_tri), g.tri_attr.data_ptr(), *(r.data_ptr() for r in rays),
                                            rays[0].shape[0], attrs.data_ptr(), t.data_ptr(), u.data_ptr(),
                                            v.data_ptr(), prim.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
                return attrs, t, u, v, prim

            def occluded(g, n_tri, *rays):
                occ = torch.empty(rays[0].shape[0], dtype=torch.bool, device=rays[0].device)
                code = lib.tt_brute_occluded(*tables(g, n_tri), *(r.data_ptr() for r in rays), rays[0].shape[0],
                                             occ.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
                return occ
            return closest, occluded

        out[name] = make(lib, parent)

    k1, k2 = brute.closest, brute.occluded  # the package's, also while a render patches them

    def closest(g, n_tri, *rays):
        attrs, t, u, v, _, prim = k1(g.tri_rows, g.tri_attr, n_tri, *rays)
        return attrs, t, u, v, prim

    out["package"] = (closest, lambda g, n_tri, *rays: k2(g.tri_rows, n_tri, *rays))
    for name, descending in (("small_first", False), ("big_first", True)):
        by_area = {}

        def occluded_by_area(g, n_tri, *rays, by_area=by_area, descending=descending):
            if id(g) not in by_area:
                area = torch.linalg.cross(g.tri_e1[:n_tri], g.tri_e2[:n_tri]).norm(dim=1)
                rows = g.tri_rows.clone()
                rows[:n_tri] = g.tri_rows[:n_tri][area.argsort(descending=descending, stable=True)]
                by_area[id(g)] = rows
            return k2(by_area[id(g)], n_tri, *rays)

        out[name] = (closest, occluded_by_area)
    print(f"[ptxas package]\n{_build.build('brute')[2]}", flush=True)
    return out


def brute_ab(torch, render_image, parse_scene_file, RenderOptions):
    """K1/K2: the staged variants against the package's kernel (see the
    module docstring)."""
    import chip_smoke as cs
    from take_tpu_torch.geometry import brute, _build

    cbox = cs.with_res(parse_scene_file(str(CBOX), device="cuda"), 1024)
    mis = parse_scene_file(str(MIS), device="cuda")
    ks = brute_variants(torch, brute, _build)
    names = list(ks)
    mix, _ = cs.make_rays(torch, cbox, np.random.default_rng(SEED), 1 << 20,
                          np.array([1.0, 1.0, 1.0]), np.array([555.0, 547.0, 558.0]))
    opts = {"cbox": RenderOptions(spp=16, max_depth=4, seed=SEED), "mis": RenderOptions(spp=128, max_depth=6, seed=SEED)}
    sets = {
        "mix": (cbox, [("closest", mix), ("anyhit", mix)]),
        "cbox": (cbox, cs.capture_queries(torch, cbox, opts["cbox"])),
        "mis": (mis, cs.capture_queries(torch, mis, opts["mis"])),
    }
    ref = "parent" if "parent" in ks else "package"
    for label, (scene, calls) in sets.items():
        g, n_tri = scene.geometry, scene.meta.n_tri
        diff = defaultdict(lambda: defaultdict(int))
        for j, (kind, rays) in enumerate(calls):
            dead = rays[3] <= 0
            if kind == "closest":
                a_p, t_p, u_p, v_p, _, p_p = brute.closest_plain(g.tri_rows, g.tri_attr, n_tri, *rays)
                want = ks[ref][0](g, n_tri, *rays)
                for name, (closest, _) in ks.items():
                    got = closest(g, n_tri, *rays)
                    torch.cuda.synchronize()
                    _, both, _ = cs.closest_gate(torch, f"{label} {j} {name} K1", scene, got[1:],
                                                 (t_p, u_p, v_p, p_p), rays, dead)
                    if not torch.equal(got[0][both], a_p[both]):
                        raise RuntimeError(f"{name}: K1's attribute rows disagree with closest_plain's")
                    same = torch.ones_like(p_p, dtype=torch.bool)
                    for x, y in zip(got[1:], want[1:]):
                        same &= x.view(torch.int32) == y.view(torch.int32)
                    same &= (got[0].view(torch.int32) == want[0].view(torch.int32)).all(1)
                    diff[name]["closest"] += int((~same).sum())
                diff["rays"]["closest"] += rays[0].shape[0]
            else:
                o_p = brute.occluded_plain(g.tri_rows, n_tri, *rays)
                want = ks[ref][1](g, n_tri, *rays)
                for name, (_, occluded) in ks.items():
                    got = occluded(g, n_tri, *rays)
                    torch.cuda.synchronize()
                    cs.anyhit_gate(torch, f"{label} {j} {name} K2", scene, got, o_p, rays, dead)
                    diff[name]["anyhit"] += int((got != want).sum())
                diff["rays"]["anyhit"] += rays[0].shape[0]
        print(f"[check {label}] every variant within the twin gates on {len(calls)} batches; rays whose outputs "
              f"differ from {ref}'s in any bit (K1: attrs, t, u, v, prim; K2: occ): " + "; ".join(
                  f"{n} {dict(v)}" for n, v in diff.items()), flush=True)
    if "--check" in sys.argv[1:]:
        return
    order = names + names[::-1]
    for label, (scene, calls) in sets.items():
        g, n_tri = scene.geometry, scene.meta.n_tri
        sums, per_batch = defaultdict(lambda: defaultdict(list)), defaultdict(lambda: defaultdict(list))
        for name in order:
            closest, occluded = ks[name]
            tot = defaultdict(float)
            for j, (kind, rays) in enumerate(calls):
                fn = closest if kind == "closest" else occluded
                ms = cs.time_call(torch, lambda: fn(g, n_tri, *rays), iters=10)
                tot[kind] += ms
                per_batch[name][j].append(ms)
            for kind, v in tot.items():
                sums[kind][name].append(v)
        for kind, by in sums.items():
            print(f"[batches {label}] {kind} per pass, ms (in order {order}): " + "; ".join(
                f"{n} {', '.join(f'{x:.4f}' for x in v)} (mean {statistics.mean(v):.4f})" for n, v in by.items()),
                flush=True)
        for name in (ref, "package"):
            print(f"[per batch {label} {name}] " + "; ".join(
                f"{j}:{calls[j][0]} {statistics.mean(v):.4f}" for j, v in sorted(per_batch[name].items())), flush=True)
        if label != "mix":
            bounds = defaultdict(float)
            for kind, rays in calls:
                bounds[kind] += cs.brute_bounds(torch, scene, rays)[kind][0]
            print(f"[bounds {label}] per pass: " + ", ".join(f"{k} {v:.4f} ms" for k, v in bounds.items()), flush=True)
    for label in ("cbox", "mis"):
        scene = sets[label][0]
        render_image(scene, dataclasses.replace(opts[label], spp=4))  # warm-up
        times = defaultdict(list)
        for name in order:
            closest, occluded = ks[name]

            def k1(rows, attr, n_tri, *rays):
                attrs, t, u, v, prim = closest(scene.geometry, n_tri, *rays)
                return attrs, t, u, v, prim >= 0, prim

            with mock.patch.object(brute, "closest", k1), \
                    mock.patch.object(brute, "occluded", lambda rows, n_tri, *r: occluded(scene.geometry, n_tri, *r)):
                dt, _ = timed(torch, render_image, scene, opts[label], f"{label} through {name}")
            times[name].append(dt)
        print(f"[renders {label}] " + "; ".join(f"{n} {', '.join(f'{x:.4f}' for x in v)} s" for n, v in times.items()),
              flush=True)
    # one pass of mis (2^20 paths: 4 spp of 512x512) through the package's kernels
    profile_call(torch, lambda: render_image(mis, dataclasses.replace(opts["mis"], spp=4)), "mis, one pass")


def cluster_variants(torch, cluster, _build):
    """{name: (closest(bvh, *rays), occluded(bvh, *rays))}: the staged
    sources under build/cluster_ab and the package's own source ("new"),
    built with nvcc in parallel and called alike (a source whose entry
    points take `cl_aabb` is given the cluster boxes), then the package's
    wrappers ("package")."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    P, I = ctypes.c_void_p, ctypes.c_int
    staged = ROOT / "build" / "cluster_ab"
    staged.mkdir(parents=True, exist_ok=True)
    srcs = sorted([*staged.glob("*.cu"), *staged.glob("*/cluster.cu")]) + [_build.CSRC / "cluster.cu"]

    def build(src):
        name = "new" if src.parent == _build.CSRC else src.stem if src.parent == staged else src.parent.name
        lib_path = staged / f"{name}.so"
        return name, src, lib_path, subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib_path), str(src)],
            capture_output=True, text=True)

    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(build, srcs))
    out = {}
    for name, src, lib_path, proc in built:
        print(f"[ptxas {name}] exit {proc.returncode}\n{proc.stderr}{proc.stdout}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}")
        lib = ctypes.CDLL(str(lib_path))
        two_level = "cl_aabb" in src.read_text()
        head = [P, I, P, I, P, I] if two_level else [P, I, P, I]
        lib.tt_cluster_closest.argtypes = head + [P] * 4 + [I] + [P] * 5
        lib.tt_cluster_occluded.argtypes = head + [P] * 4 + [I, P, P]

        def make(lib, two_level):
            def tables(bvh):
                boxes = [bvh.sup_aabb.data_ptr(), bvh.sup_aabb.shape[0]]
                if two_level:
                    boxes += [bvh.cl_aabb.data_ptr(), bvh.cl_aabb.shape[0]]
                return boxes + [bvh.tris.data_ptr(), bvh.tris.shape[0]]

            def closest(bvh, *rays):
                n = rays[0].shape[0]
                t, u, v = (torch.empty(n, device="cuda") for _ in range(3))
                prim = torch.empty(n, dtype=torch.int32, device="cuda")
                code = lib.tt_cluster_closest(*tables(bvh), *(r.data_ptr() for r in rays), n, t.data_ptr(),
                                              u.data_ptr(), v.data_ptr(), prim.data_ptr(),
                                              torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
                return t, u, v, prim

            def occluded(bvh, *rays):
                occ = torch.empty(rays[0].shape[0], dtype=torch.bool, device="cuda")
                code = lib.tt_cluster_occluded(*tables(bvh), *(r.data_ptr() for r in rays), rays[0].shape[0],
                                               occ.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
                return occ
            return closest, occluded

        out[name] = make(lib, two_level)
    k4, k5 = cluster.closest, cluster.occluded  # the package's, also while a render patches them
    out["package"] = (lambda bvh, *rays: k4(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *rays),
                      lambda bvh, *rays: k5(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *rays))
    print(f"[ptxas package]\n{_build.build('cluster')[2]}", flush=True)
    return out


def cluster_ab(torch, render_image, parse_scene_file, RenderOptions):
    """K4/K5: the staged variants against the package's kernel (see the
    module docstring)."""
    import chip_smoke as cs
    from take_tpu_torch.geometry import _build, cluster, packet, traverse

    room = parse_scene_file(str(ROOM), device="cuda")
    bvh = room.bvh
    ks = cluster_variants(torch, cluster, _build)
    names = list(ks)
    lo = bvh.node_min[0].amin(dim=0).cpu().numpy().astype(np.float64)
    hi = bvh.node_max[0].amax(dim=0).cpu().numpy().astype(np.float64)
    pad = 0.02 * (hi - lo)
    mix, _ = cs.make_rays(torch, room, np.random.default_rng(SEED), 1 << 20, lo + pad, hi - pad)
    opts = RenderOptions(spp=SPP, max_depth=DEPTH, seed=SEED)
    sets = {
        "mix": [("closest", mix), ("anyhit", mix)],
        "room": cs.capture_queries(torch, room, dataclasses.replace(opts, spp=1), cluster_route=True),
    }
    ref = "parent" if "parent" in ks else "package"

    def gate(fn, *args):
        """chip_smoke's gate; a staged variant that fails it is reported, the package's own source raises."""
        try:
            fn(*args)
            return 0
        except RuntimeError as err:
            if any(name in args[1] for name in (" new ", " package ")):
                raise
            print(f"[check] gate failed: {err}", flush=True)
            return 1

    for label, calls in sets.items():
        diff = defaultdict(lambda: defaultdict(int))
        work = defaultdict(lambda: np.zeros(4))
        for j, (kind, rays) in enumerate(calls):
            dead = rays[3] < rays[2]
            if kind == "closest":
                want = cluster.cluster_plain(bvh.sup_aabb, bvh.tris, *rays)
                base = ks[ref][0](bvh, *rays)
                for name, (closest, _) in ks.items():
                    got = closest(bvh, *rays)
                    torch.cuda.synchronize()
                    diff[name]["failed gates"] += gate(cs.closest_gate, torch, f"{label} {j} {name} K4", room, got,
                                                       want, rays, dead)
                    same = torch.ones_like(want[3], dtype=torch.bool)
                    twin = torch.ones_like(want[3], dtype=torch.bool)
                    for x, y, z in zip(got, base, want):
                        same &= x.view(torch.int32) == y.view(torch.int32)
                        twin &= x.view(torch.int32) == z.view(torch.int32)
                    diff[name]["closest"] += int((~same).sum())
                    diff[name]["closest vs twin"] += int((~twin).sum())
            else:
                want = cluster.cluster_plain(bvh.sup_aabb, bvh.tris, *rays, any_hit=True)
                base = ks[ref][1](bvh, *rays)
                for name, (_, occluded) in ks.items():
                    got = occluded(bvh, *rays)
                    torch.cuda.synchronize()
                    diff[name]["failed gates"] += gate(cs.anyhit_gate, torch, f"{label} {j} {name} K5", room, got,
                                                       want, rays, dead)
                    diff[name]["anyhit"] += int((got != base).sum())
                    diff[name]["anyhit vs twin"] += int((got != want).sum())
            diff["rays"][kind] += rays[0].shape[0]
            work[kind] += np.array(cs.cluster_counts(torch, cluster, bvh, rays, kind == "anyhit", seed=j))
        print(f"[check {label}] the package within the twin gates on {len(calls)} batches; per variant the gates "
              f"it failed and the rays whose outputs differ from {ref}'s and from the twin's in any bit (K4: t, u, "
              f"v, prim; K5: occ): " + "; ".join(f"{n} {dict(v)}" for n, v in diff.items()), flush=True)
        per = {kind: [kind for kind, _ in calls].count(kind) for kind in work}
        print(f"[work {label}] per live ray, mean over the batches: " + "; ".join(
            f"{kind} {w[0] / per[kind]:.3f} superclusters, {w[1] / per[kind]:.3f} clusters, "
            f"{w[2] / per[kind]:.1f} triangle rows (the parent kernel {w[3] / per[kind]:.0f})"
            for kind, w in work.items()), flush=True)
    if "--check" in sys.argv[1:]:
        return
    order = names + names[::-1]
    for label, calls in sets.items():
        sums, per_batch = defaultdict(lambda: defaultdict(list)), defaultdict(lambda: defaultdict(list))
        for name in order:
            closest, occluded = ks[name]
            tot = defaultdict(float)
            for j, (kind, rays) in enumerate(calls):
                fn = closest if kind == "closest" else occluded
                ms = cs.time_call(torch, lambda: fn(bvh, *rays), iters=10)
                tot[kind] += ms
                per_batch[name][j].append(ms)
            for kind, v in tot.items():
                sums[kind][name].append(v)
        for kind, by in sums.items():
            print(f"[batches {label}] {kind} per pass, ms (in order {order}): " + "; ".join(
                f"{n} {', '.join(f'{x:.4f}' for x in v)} (mean {statistics.mean(v):.4f})" for n, v in by.items()),
                flush=True)
        for name in (ref, "package"):
            print(f"[per batch {label} {name}] " + "; ".join(
                f"{j}:{calls[j][0]} {statistics.mean(v):.4f}" for j, v in sorted(per_batch[name].items())), flush=True)
        bounds = defaultdict(float)
        for j, (kind, rays) in enumerate(calls):
            bounds[kind] += cs.bvh_bound(torch, packet, bvh, rays, kind == "anyhit", seed=j)[0]
        print(f"[bounds {label}] per pass: " + ", ".join(f"{k} {v:.4f} ms" for k, v in bounds.items()), flush=True)
    with mock.patch.object(traverse, "FORCE_CLUSTER", True):
        render_image(room, dataclasses.replace(opts, spp=1))  # warm-up
        times = defaultdict(list)
        for name in order:
            closest, occluded = ks[name]
            with mock.patch.object(cluster, "closest", lambda s, c, t, *r: closest(bvh, *r)), \
                    mock.patch.object(cluster, "occluded", lambda s, c, t, *r: occluded(bvh, *r)):
                dt, _ = timed(torch, render_image, room, opts, f"room under FORCE_CLUSTER through {name}")
            times[name].append(dt)
    print("[renders room, FORCE_CLUSTER] " + "; ".join(f"{n} {', '.join(f'{x:.4f}' for x in v)} s"
                                                      for n, v in times.items()), flush=True)


# variants made from csrc/sweep.cu by one replacement each
SWEEP_PATCHES = {
    # no sweep phase: every pair is listed, none is tested, so no range shrinks (an upper bound of the walk)
    "cull_only": ("const int items = min(sh.npair[parity], kPairs) * kWin;",
                  "const int items = 0 * min(sh.npair[parity], kPairs) * kWin;"),
    # every ray tests every cluster box: the walk without its group boxes (they are still built)
    "no_groups": ("if (kAnyHit ? !slab_nan(ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, r, r.tmax) : !widened_hit(ga, gb, r, cap)) {",
                  "if (false) {"),
}


def sweep_variants(torch, sweep, _build):
    """{name: (closest(cl_aabb, tris, n_tri, *rays), occluded(...))}: the
    staged sources under build/sweep_ab, the package's source patched by
    each of SWEEP_PATCHES ("cull_only": an empty sweep phase, so no range
    shrinks, an upper bound of the walk's time; "no_groups": every ray
    tests every cluster box), and the package's own source ("new"), built
    with nvcc in parallel and called alike, then the package's wrappers
    ("package")."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    P, I = ctypes.c_void_p, ctypes.c_int
    staged = ROOT / "build" / "sweep_ab"
    staged.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "sweep.cu").read_text()
    generated = staged / "gen"
    generated.mkdir(exist_ok=True)
    for name, (old, new) in SWEEP_PATCHES.items():
        if source.count(old) != 1:
            raise RuntimeError(f"csrc/sweep.cu does not hold the line the {name} variant replaces")
        (generated / f"{name}.cu").write_text(source.replace(old, new))
    srcs = (sorted([*staged.glob("*.cu"), *staged.glob("*/sweep.cu")])
            + [generated / f"{name}.cu" for name in SWEEP_PATCHES] + [_build.CSRC / "sweep.cu"])

    def build(src):
        name = "new" if src.parent == _build.CSRC else src.stem if src.parent in (staged, generated) \
            else src.parent.name
        lib_path = staged / f"{name}.so"
        return name, src, lib_path, subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib_path), str(src)],
            capture_output=True, text=True)

    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(build, srcs))
    out = {}
    for name, src, lib_path, proc in built:
        print(f"[ptxas {name}] exit {proc.returncode}\n{proc.stderr}{proc.stdout}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}")
        lib = ctypes.CDLL(str(lib_path))
        lib.tt_sweep_closest.argtypes = [P, I, P, I, I] + [P] * 4 + [I] + [P] * 5
        lib.tt_sweep_occluded.argtypes = [P, I, P, I, I] + [P] * 4 + [I, P, P]

        def make(lib):
            def closest(cl, tris, n_tri, *rays):
                n = rays[0].shape[0]
                t, u, v = (torch.empty(n, device="cuda") for _ in range(3))
                prim = torch.empty(n, dtype=torch.int32, device="cuda")
                code = lib.tt_sweep_closest(cl.data_ptr(), cl.shape[0], tris.data_ptr(), tris.shape[0], n_tri,
                                            *(r.data_ptr() for r in rays), n, t.data_ptr(), u.data_ptr(),
                                            v.data_ptr(), prim.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
                return t, u, v, prim

            def occluded(cl, tris, n_tri, *rays):
                occ = torch.empty(rays[0].shape[0], dtype=torch.bool, device="cuda")
                code = lib.tt_sweep_occluded(cl.data_ptr(), cl.shape[0], tris.data_ptr(), tris.shape[0], n_tri,
                                             *(r.data_ptr() for r in rays), rays[0].shape[0], occ.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream)
                assert code == 0, code
                return occ
            return closest, occluded

        out[name] = make(lib)
    out["package"] = (sweep.closest, sweep.occluded)
    print(f"[ptxas package]\n{_build.build('sweep')[2]}", flush=True)
    return out


def sweep_ab(torch, render_image, parse_scene_file, RenderOptions):
    """K6: the staged variants against the package's kernel (see the module
    docstring)."""
    import chip_smoke as cs
    from take_tpu_torch.geometry import _build, packet, sweep, traverse

    room = parse_scene_file(str(ROOM), device="cuda")
    bvh, n_tri = room.bvh, room.meta.n_tri
    tables = (bvh.cl_aabb, bvh.tris, n_tri)
    ks = sweep_variants(torch, sweep, _build)
    names = list(ks)
    lo = bvh.node_min[0].amin(dim=0).cpu().numpy().astype(np.float64)
    hi = bvh.node_max[0].amax(dim=0).cpu().numpy().astype(np.float64)
    pad = 0.02 * (hi - lo)
    mix, _ = cs.make_rays(torch, room, np.random.default_rng(SEED), 1 << 20, lo + pad, hi - pad)
    opts = RenderOptions(spp=SPP, max_depth=DEPTH, seed=SEED)
    sets = {
        "mix": [("closest", mix), ("anyhit", mix)],
        "room": cs.capture_queries(torch, room, dataclasses.replace(opts, spp=1), sweep_route=True),
    }
    ref = "parent" if "parent" in ks else "package"
    exact = {"new", "package", "no_groups"}  # must equal the twin bit for bit; cull_only answers nothing

    for label, calls in sets.items():
        diff = defaultdict(lambda: defaultdict(int))
        work = defaultdict(lambda: np.zeros(4))
        for j, (kind, rays) in enumerate(calls):
            want = sweep.sweep_plain(*tables, *rays, any_hit=kind == "anyhit")
            base = (ks[ref][0] if kind == "closest" else ks[ref][1])(*tables, *rays)
            for name, fns in ks.items():
                got = (fns[0] if kind == "closest" else fns[1])(*tables, *rays)
                torch.cuda.synchronize()
                if kind == "closest":
                    same = torch.stack([x.view(torch.int32) == y.view(torch.int32) for x, y in zip(got, base)])
                    twin = torch.stack([x.view(torch.int32) == y.view(torch.int32) for x, y in zip(got, want)])
                    same, twin = same.all(dim=0), twin.all(dim=0)
                else:
                    same, twin = got == base, got == want
                diff[name][kind] += int((~same).sum())
                diff[name][f"{kind} vs twin"] += int((~twin).sum())
                if name in exact and not twin.all():
                    raise RuntimeError(f"{label} batch {j}: K6 {kind} ({name}) differs from sweep_plain on "
                                       f"{int((~twin).sum())} rays")
            diff["rays"][kind] += rays[0].shape[0]
            if hasattr(sweep, "sweep_work"):
                work[kind] += np.array(cs.sweep_counts(torch, sweep, room, rays, kind == "anyhit", seed=j))
        print(f"[check {label}] the package equals sweep_plain bit for bit on {len(calls)} batches; per variant "
              f"the rays whose outputs differ from {ref}'s and from the twin's in any bit (closest: t, u, v, prim; "
              f"any hit: occ): " + "; ".join(f"{n} {dict(v)}" for n, v in diff.items()), flush=True)
        per = {kind: [kind for kind, _ in calls].count(kind) for kind in work}
        if work:
            print(f"[work {label}] per live ray, mean over the batches: " + "; ".join(
                f"{kind} {w[0] / per[kind]:.1f} boxes walked, {w[1] / per[kind]:.3f} clusters entered, "
                f"{w[2] / per[kind]:.1f} triangle rows (the parent kernel {w[3] / per[kind]:.0f})"
                for kind, w in work.items()), flush=True)
    if "--check" in sys.argv[1:]:
        return
    order = names + names[::-1]
    for label, calls in sets.items():
        sums, per_batch = defaultdict(lambda: defaultdict(list)), defaultdict(lambda: defaultdict(list))
        for name in order:
            closest, occluded = ks[name]
            tot = defaultdict(float)
            for j, (kind, rays) in enumerate(calls):
                fn = closest if kind == "closest" else occluded
                ms = cs.time_call(torch, lambda: fn(*tables, *rays), iters=10)
                tot[kind] += ms
                per_batch[name][j].append(ms)
            for kind, v in tot.items():
                sums[kind][name].append(v)
        for kind, by in sums.items():
            print(f"[batches {label}] {kind} per pass, ms (in order {order}): " + "; ".join(
                f"{n} {', '.join(f'{x:.4f}' for x in v)} (mean {statistics.mean(v):.4f})" for n, v in by.items()),
                flush=True)
        for name in (ref, "package"):
            print(f"[per batch {label} {name}] " + "; ".join(
                f"{j}:{calls[j][0]} {statistics.mean(v):.4f}" for j, v in sorted(per_batch[name].items())), flush=True)
        bounds = defaultdict(float)
        for j, (kind, rays) in enumerate(calls):
            bounds[kind] += cs.bvh_bound(torch, packet, bvh, rays, kind == "anyhit", seed=j)[0]
        print(f"[bounds {label}] per pass: " + ", ".join(f"{k} {v:.4f} ms" for k, v in bounds.items()), flush=True)
    render_image(room, dataclasses.replace(opts, spp=1))  # warm-up, K3 route
    with mock.patch.object(traverse, "FORCE_SWEEP", True):
        render_image(room, dataclasses.replace(opts, spp=1))
    times = defaultdict(list)
    for name in ["K3 route"] + [n for n in order if n != "cull_only"] + ["K3 route"]:  # cull_only misses
        if name == "K3 route":
            dt, _ = timed(torch, render_image, room, opts, "room through K3")
        else:
            closest = ks[name][0]
            with mock.patch.object(traverse, "FORCE_SWEEP", True), mock.patch.object(sweep, "closest", closest):
                dt, _ = timed(torch, render_image, room, opts, f"room under FORCE_SWEEP through {name}")
        times[name].append(dt)
    print("[renders room, FORCE_SWEEP] " + "; ".join(f"{n} {', '.join(f'{x:.4f}' for x in v)} s"
                                                    for n, v in times.items()), flush=True)


def policy(torch, render_image, parse_scene_file, RenderOptions):
    from take_tpu_torch.integrator import path_tracer
    from take_tpu_torch.materials import disney

    for path, spp, depth in ((IBL, POLICY_IBL_SPP, DEPTH), (TEXTURED, TEX_SPP, DEPTH), (ROOM, SPP, 8)):
        scene = parse_scene_file(str(path), device="cuda")
        loops = {name: RenderOptions(spp=spp, max_depth=depth, seed=SEED, integrator=name)
                 for name in ("mis_wavefront", "mis_scan")}
        images = {name: render_image(scene, dataclasses.replace(o, spp=1)) for name, o in loops.items()}
        if not np.array_equal(*images.values()):
            raise RuntimeError(f"{path.name}: the refill and scan loops differ")
        times = defaultdict(list)
        for name in ("mis_wavefront", "mis_scan", "mis_scan", "mis_wavefront") * 2:
            dt, rays = timed(torch, render_image, scene, loops[name], f"{path.stem} {name}")
            times[name].append(dt)
        print(f"[policy {path.stem}] " + "; ".join(
            f"{n}: median {statistics.median(t):.4f} s = {rays / statistics.median(t) / 1e6:.3f} Mrays/s "
            f"({', '.join(f'{x:.4f}' for x in t)})" for n, t in times.items()), flush=True)

    def ranged(module, name, label):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return mock.patch.object(module, name, wrapped)

    scene = parse_scene_file(str(IBL), device="cuda")
    ranges = ("envmap", "disney")
    with contextlib.ExitStack() as stack:
        for name in ("envmap_eval", "envmap_sample", "envmap_pdf"):
            stack.enter_context(ranged(path_tracer, name, "envmap"))
        for name in ("sample", "eval", "pdf"):
            stack.enter_context(ranged(disney, name, "disney"))
        for name in ("mis_wavefront", "mis_scan"):
            opts = RenderOptions(spp=1, max_depth=DEPTH, seed=SEED, integrator=name)
            profile_call(torch, lambda: render_image(scene, opts), f"ibl one pass, {name}", ranges)


def grad_modes(torch, render_image, parse_scene_file, RenderOptions):
    import chip_smoke as cs
    from take_tpu_torch import grad

    scene = cs.with_res(parse_scene_file(str(CBOX), device="cuda"), 1024)
    cam = scene.meta.camera
    n = cam.width * cam.height
    img = render_image(scene, RenderOptions(spp=GRAD_SPP, max_depth=4, seed=3))
    target = torch.as_tensor(img[::-1].copy(), device="cuda").reshape(n, 3)
    pix = torch.arange(n, dtype=torch.int32, device="cuda")
    opts = RenderOptions(spp=GRAD_SPP, max_depth=4, seed=11)
    for mode in ("ad", "replay"):  # warm-up
        grad.render_loss_grad(scene, dataclasses.replace(opts, grad_mode=mode), pix[:1024], target[:1024], GRAD_SPP)

    def centre(paths):  # the pass's pixels from the middle rows, as a pass of the full image sees the box
        k = paths // GRAD_SPP
        return slice((n - k) // 2, (n + k) // 2)

    for paths in GRAD_PASSES:
        sl = centre(paths)
        rows = []
        for mode in ("ad", "replay", "replay", "ad"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            grad.render_loss_grad(scene, dataclasses.replace(opts, grad_mode=mode), pix[sl], target[sl], GRAD_SPP)
            torch.cuda.synchronize()
            rows.append(f"{mode} {time.perf_counter() - t0:.4f} s peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        print(f"[grad {paths} paths] " + "; ".join(rows), flush=True)

    def one_pass(paths, mode, backward=True):
        """One pass: the radiance and loss, then (with `backward`) the
        backward, each on the host clock up to a synchronise."""
        s, _ = grad._leaves(scene)
        sl = centre(paths)
        host = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = grad._radiance(s, opts, pix[sl], 0, GRAD_SPP, mode)
        loss = torch.sum((img - target[sl]) ** 2) / target[sl].numel()
        torch.cuda.synchronize()
        host["forward"] = time.perf_counter() - t0
        if backward:
            t0 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            host["backward"] = time.perf_counter() - t0
            print(f"[grad {mode} pass of {paths} paths] host: forward {host['forward']:.4f} s, backward "
                  f"{host['backward']:.4f} s = {host['backward'] / sum(host.values()):.4f} of the pass", flush=True)

    # the backward runs on autograd's thread, out of a record_function range
    # on this one, so the forward is profiled alone and the backward's share
    # is the difference
    for paths, mode in ((1 << 20, "replay"), (1 << 18, "ad")):
        for backward in (False, True):
            profile_call(torch, lambda: one_pass(paths, mode, backward),
                         f"cbox 1024x1024 {mode} gradient pass of {paths} paths, "
                         + ("forward and backward" if backward else "forward alone"))


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    print(f"[card] {smi('name,power.limit')}", flush=True)
    args = sys.argv[1:]
    run = (textured if "--textured" in args else k3 if "--k3" in args else brute_ab if "--brute" in args
           else cluster_ab if "--cluster" in args else sweep_ab if "--sweep" in args else policy if "--policy" in args
           else grad_modes if "--grad" in args else room)
    run(torch, render_image, parse_scene_file, RenderOptions)


if __name__ == "__main__":
    main()
