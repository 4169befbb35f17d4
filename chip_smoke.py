#!/usr/bin/env python3
"""Smoke check of take_tpu_torch on one CUDA card: `python3 chip_smoke.py`.

Drives the port's main paths on the card, in phases; each phase prints one
line and any failure raises, so the exit code is non-zero. Every render pass
of the scan integrators and mis_replay replays one captured CUDA graph per
compile key (take_tpu_torch/render.py), and every gradient pass one graph
per pass key holding its forward and backward (take_tpu_torch/grad.py), so
the renders, gradients and times of phases 4-16, 19 and 22-24 are graph
passes (a key's first pass also runs a warm-up pass, whose launches count);
renders and gradients through the plain twins and the passes that
capture_queries records run op by op (render.eager()), and phases 25 and 26
hold the two modes against each other:

  1. device: the card's name and nvidia-smi's name and power limit;
  2. build: compiles the CUDA kernels from take_tpu_torch/csrc, one nvcc per
     source declared with the kernel runtime (geometry/_launch.py), all
     started together, and prints each kernel's registers, shared memory,
     stack frame and spills (every kernel, K1-K6, the RNG's, the Disney
     lobes', the light phase's, the BSDF dispatch's and the marks, must
     have no stack frame and no spills);
  rng, disney, light, bsdf: the counter RNG's kernels (csrc/rng.cu), the
     Disney lobes' (csrc/disney.cu: sample, eval and pdf at ibl's chrome
     and composite), the light phase's (csrc/light.cu: sample, nee and
     arrival on every kind of light slot) and the BSDF dispatch's
     (csrc/bsdf.cu: sample, eval and pdf of every non-Disney tag, at
     random parameters and at mis's exponents, and mixed) on 2^20 lanes
     against their plain versions (the RNG bit for bit; the others bit for
     bit on all but a handful of lanes), each timed from a captured graph
     beside its bytes bound and the plain version's time (the dispatch's on
     lanes all diffuse and all blinn_microfacet, with its kernels'
     registers, stack frame and spills); every render on the card below
     must run the light phase and the BSDF dispatch through their kernels
     alone;
  cbox (scenes/cbox/cbox.xml, 1024x1024, 16 spp, max_depth 4, seed 0; the
  brute-force path, K1/K2):
  3. parity: K1 (closest hit) and K2 (any hit) against their plain twins on
     2^20 rays made from a numpy seed;
  4. main: render_image through the kernels (launch counters must show
     kernels only), then at 256x256 through the plain twins;
  5. times: the render's Mrays/s (bench.py's metric), active_fraction, and
     each kernel's per-call time beside its twin's and its bound; then K1
     and K2 on the batches they get in one pass of the render, captured,
     each held against the twins and timed beside its bound;
  room (scenes/room/room.xml, 1920x1080, 4 of the published 1024 spp,
  max_depth 6, seed 0; the wide-BVH path, K3 and, forced, K4/K5 and K6):
  6. room build: parse, BVH build, nodes (exact and quantised), wide depth,
     stack entries, table bytes on the card;
  7. parity: K3 (closest and any hit), K4, K5 and K6 (closest and any hit)
     against their plain twins on 2^20 room rays (camera, incoherent from
     inside the room, shadow rays toward the light, dead lanes, a padded
     tail); K6 must equal sweep_plain bit for bit;
  8. main: render_image through K3 alone, then under traverse.FORCE_SWEEP
     through K6 (closest hits) and K3 (any hits) alone, and under
     traverse.FORCE_CLUSTER through K4/K5 alone (launch counters); at
     192x108 through K3, K4/K5, K6 and the plain twins, whose image means
     must agree;
  9. times: as in 5, for the three room renders and K3/K4/K5/K6 (one bound
     for the closest-hit query and one for the any-hit query, whichever
     kernel answers it), K4/K5's and K6's counted work per live ray on the
     2^20 rays, then K3 on the batches it gets in one pass of the 1920x1080
     render, K4/K5 on those of one pass under FORCE_CLUSTER, and K6 on
     those of one pass under FORCE_SWEEP (closest hit on its own batches,
     any hit on the pass's any-hit batches), captured, each beside its
     bound (K4/K5's and K6's also held to their twin bit for bit, and
     counted);
  mis (scenes/mis/mis.xml at its published 512x512, 128 spp, max_depth 6;
  blinn_microfacet plates and sphere lights on the brute path, K1/K2):
  10. main: render_image through K1/K2 alone, then at 128x128 against the
      plain twins; times, and K1/K2 on the captured batches of one pass,
      as in 5;
  textured (scenes/textured/textured.xml at its published 512x512, 64 spp,
  max_depth 6; an open BVH scene with an image texture, on K3):
  11. main: render_image through the default (scan) loop and K3 alone, then
      at 128x128 the wavefront-refill loop (integrator "mis_wavefront")
      against it, and at 64x64 through K3 against the plain twins; times of
      both loops with their active_fraction, and K3 on the captured batches
      of one pass;
  reference (the published specs against take_tpu's own TPU renders of them,
  benchmarks/out/*.exr, by take_tpu_torch/run_configs.py's pixel_agreement
  and gates):
      the mis and textured images of 10 and 11, and new renders of cbox at
      256x256, 16 spp, d4 and of room at 1920x1080, 64 spp, d6 through the
      kernels alone, each rounded to half floats as its EXR would hold it:
      channel means within 1e-4 relative, at most the config's share of
      pixels beyond 1e-3 x max(pixel, 1e-2); one line each, a miss raises;
  ibl (scenes/ibl/ibl.xml at its published 1024x1024 and max_depth 6, 64 of
  the published 256 spp; an environment map, Disney metal and composite,
  on the brute path, K1/K2):
  12. ibl build: parse, with the envmap's alias-table build timed, and the
      envmap's bytes on the card;
  13. main: render_image through K1/K2 alone with the default (scan) loop; at
      128x128 against the plain twins, and the scan loop against the refill
      loop (bit-equal without Russian roulette); the closed-form azimuth
      environment of tests/test_ibl_analytic.py under mis, one_sample_mis
      and raw; the three integrators against each other on the real map at
      96x96; times, and K1/K2 on the captured batches of one pass, whose
      shadow rays toward the map carry tmax = +inf (K2 there also equal to
      brute.reference bit for bit).

  grad (scenes/cbox/cbox.xml at 1024x1024; gradients through K1/K2, and K3
  on a BVH scene):
  14. the replay primal: render_image with integrator "mis_replay" at the
      cbox cell's settings through K1/K2 alone, through graphs and op by
      op, each equal to the cbox image bit for bit, the two timed in turns
      (G E E G) beside the scan loop;
  15. card-side gradients at 64x64: every table of render_loss_grad's
      gradient Scene through the kernels against the same with brute's
      closest/occluded patched to the plain twins, replay against AD, the
      red wall's albedo against central FD, and the texel gradient of
      tests/test_grad_textured_bvh.py's BVH scene through K3 against FD;
  16. inverse: a 16-spp target at the true red wall and light, then 4 Adam
      steps from gray walls and half the light (a sigmoid and a log, as in
      benchmarks/inverse_demo.py) at 1024x1024, 4 spp, d4, grad_mode
      "auto" (replay at this size), a fresh sample window each step: the
      loss and seconds per gradient (forward and backward, synchronised)
      each step, K1/K2 alone launched, every gradient finite, the loss
      falling, both parameters moving toward the truth, peak memory; then
      one pass of GRAD_AB_PATHS paths under "ad" and "replay", each timed
      with its peak memory.

  parallel (cbox at the cbox cell's settings; several devices, processes
  and the utilities, through K1/K2 alone in every phase):
  17. sharded: render_image_sharded over [cuda:0] * 2 (two shards on the
      card, 2 samples a pass), against the cbox image: each pixel within
      SUM_REL of it (the same samples summed in another grouping) and the
      means within MEAN_REL, timed in turns with render_image; over
      [cuda:0] bit for bit the cbox image;
  18. multihost: render_image_multihost at one NCCL rank in this process,
      bit for bit the cbox image, then at two gloo ranks on the card (two
      processes started with spawn), whose frames must equal each other
      and phase 17's two-way image bit for bit; each rank's pass and
      assemble seconds;
  19. banded: banded_loss_grad (4 bands) on the grad cell's step-0 scene
      (1024x1024, 4 spp, d4, seed 11) at one rank and at the two gloo
      ranks, against render_loss_grad (loss within 1e-5, every table
      within rtol 2e-4, atol 1e-6: tests/test_overlap.py's), timed in turns
      with it, with peak memory;
  20. checkpoint: render_image_resumable stopped one pass after its first
      checkpoint and resumed, bit for bit the cbox image; an uninterrupted
      checkpointed render timed in turns with render_image;
  21. entry: entry.dryrun_multichip(2) over [cuda:0] * 2 and entry()'s step.

  the repo's last measurement entry points (take_tpu_torch/bench.py,
  room_grad_fd.py, inverse_demo.py; bench.py's flagship is phase 5):
  22. bench: the refill loop over cbox at 1024x1024, 1 spp, max_depth 50,
      with a wave of 2^14 lanes (active_fraction_d50_wavefront, iterations,
      seconds), then the replay gradient of cbox at 1920x1080, 1 spp, d4, in
      bands of 2^18 pixels (seconds, Mrays/s, finite), both through K1/K2
      alone, and the soup check: K3, K4, K6 closest and K3, K5, K6 any hit
      against brute.closest_plain's winner on 1024 rays into a 3000-triangle
      soup with a BVH, each kernel launched once;
  23. room grad: room_grad_fd's full band (2^16 pixels x 4 samples, d6,
      seed 17) on the room cell's scene: the albedo of room's two materials
      and the lights' emission scale, replay and AD against central FD
      (< 0.05) and each other (< 1e-3), AD against take_tpu's recorded
      gradients (within 1e-2, or the script raises), times and peak memory
      by mode, K3 alone; then K3's launches in one gradient of each mode;
  24. inverse: inverse_demo cut to INVERSE_STEPS Adam steps (64x64, 32 spp a
      step, d4, a 512-spp target): the loss falls, every parameter moves
      toward the truth, every gradient is finite, K1/K2 alone.

  graph (the pass as one captured CUDA graph per key against the pass op by
  op, render.eager()):
  25. cbox 1024x1024 16 spp d4, mis 512x512 128 spp d6, room 1920x1080 4
      spp d6 (through K3, under FORCE_SWEEP and under FORCE_CLUSTER),
      textured 512x512 64 spp d6 and ibl 1024x1024 d6 at GRAPH_IBL_SPP spp:
      a warm render in each mode, then eager and graph in turns (E G E G),
      each graph image equal to the eager image bit for bit and each
      render's launches equal, or the script raises; seconds, Mrays/s and
      their ratio, the capture and instantiate seconds of each key, peak
      memory allocated in each mode and the bytes the graphs' pools hold;
      then one pass of cbox and of ibl under torch.profiler in each mode
      (busy share of the device span, host launches), and render.PASSES.

  grad graph (each gradient pass as one captured CUDA graph per key, forward
  and backward, against the pass op by op, render.eager()):
  26. the grad cell's step (1024x1024, 4 spp, d4, replay, carried into its
      raw parameters), bench's 1080p banded replay gradient (phase 22), one
      pass of GRAD_AB_PATHS paths under "ad" and under "replay", room_grad_fd's
      band (2^16 pixels x 4 samples, d6, K3) under "ad" and "replay", and
      inverse_demo's step (64x64, 32 spp, d4, AD): a first graph call (the
      captures), a warm eager call, then in turns E G E G, each graph loss
      equal to the eager loss bit for bit, each table (and raw parameter;
      the inverse step's raw parameters alone, its op-by-op step
      differentiating them alone) within max(2 x its eager-eager
      difference, 1e-5 x its largest magnitude), launches equal and no
      later capture, or the script raises; seconds and their ratio,
      capture and instantiate seconds a key, peak allocated memory in each
      mode, the graphs' pool bytes and captures per cell; op by op, the
      trips each replay loop (forward, pass 1, pass 2) skips by its early
      exit; then one replay pass of 2^20 paths of the grad cell under
      torch.profiler in each mode, and grad.PASSES.

It then prints each cell's launches, the kernels' JSON line (with each
kernel's bound_ms and bound_by; K1 and K2 also carry their per-pass times
and bounds in cbox, mis and ibl, and their launches in mis and ibl; K4 and
K5 their counted work, per-pass times and bounds, launches and the render
time under FORCE_CLUSTER; K6 the same under FORCE_SWEEP; K1 and K2 their
launches in one gradient step, `launches_grad_step`, in each phase of
the parallel cell, `launches_parallel`, and in one inverse demo step,
`launches_inverse_step`; every kernel its launches in phase 22,
`launches_bench`, and in phase 23, `launches_room_grad`) and, last, the
device JSON line. It fails without a CUDA device, and when run outside a
checkout of the repo.
"""

import contextlib
import dataclasses
import importlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "scenes" / "cbox" / "cbox.xml"
ROOM = ROOT / "scenes" / "room" / "room.xml"
MIS = ROOT / "scenes" / "mis" / "mis.xml"
TEXTURED = ROOT / "scenes" / "textured" / "textured.xml"
IBL = ROOT / "scenes" / "ibl" / "ibl.xml"
RES, SPP, MAX_DEPTH, SEED = 1024, 16, 4, 0
ROOM_SPP, ROOM_DEPTH = 4, 6  # room at its published 1920x1080; spp cut from 1024
ROOM_SMALL = (192, 108)  # the four-way render's resolution
MIS_SPP, MIS_DEPTH, MIS_SMALL = 128, 6, 128  # mis and textured at their published
TEX_SPP, TEX_DEPTH, TEX_SMALL = 64, 6, 128  # 512x512, spp and depth
TEX_TWIN = 64  # the resolution of textured's kernel-vs-twin render
IBL_SPP, IBL_DEPTH, IBL_SMALL = 64, 6, 128  # ibl at its published 1024x1024 and d6; spp cut from 256
REF_ROOM_SPP = 64  # room's reference render, held against take_tpu's room_1080p_64spp.exr
# the closed-form azimuth environment of tests/test_ibl_analytic.py: (spp, rtol) per integrator
AZIMUTH = {"mis": (512, 0.02), "one_sample_mis": (512, 0.04), "raw": (1024, 0.08)}
# the grad cell: an inverse-rendering loop on cbox at 1024x1024 (4 spp, d4,
# Adam on the red wall's reflectance and the light scale), its target at
# 16 spp; the card-side gradient checks at 64x64; the AD/replay pass size
GRAD_SPP, GRAD_TARGET_SPP, GRAD_STEPS, GRAD_LR, GRAD_SEED = 4, 16, 4, 0.1, 11
GRAD_SMALL, GRAD_AB_PATHS = 64, 1 << 18
GRAD_TABLE_TOL = 1e-3  # per-table gradients, kernels vs twins, of the table's largest magnitude
GRAD_REPLAY_TOL = 1e-5  # replay vs AD, of max(the table's largest magnitude, 1)
GRAD_FD_RTOL = 0.03  # the red wall's albedo gradient vs central FD (tests/test_grad.py's rtol)
# the parallel cell: the banded gradient's bands and tolerances (tests/test_overlap.py's),
# the checkpointed render's passes between checkpoints, the gloo ranks' time limit
BANDS, BANDED_LOSS_RTOL, BANDED_RTOL, BANDED_ATOL = 4, 1e-5, 2e-4, 1e-6
CKPT_EVERY, RANK_TIMEOUT = 4, 600
INVERSE_STEPS = 100  # the inverse demo's Adam steps (its published 800 cut)
GRAPH_IBL_SPP = 16  # ibl's spp in the graph phase, eager and graph in turns (cut from 256 for time)
# a pixel regrouped from k = 1 to k = 2 sums the same 16 nonnegative float32
# samples in another order: within 15 roundings, 15 x 2^-24 = 9e-7 of the pixel
SUM_REL = 1e-5
N_RAYS = 1 << 20
PRIM_AGREE_MIN = 0.9999  # fraction of rays whose winner index must agree
# t/u/v of agreeing hits must lie within the float32 rounding bound of
# fp32_bounds; the share within these flat tolerances is reported beside it
REL_T = 1e-5  # t, relative; also the near-tie gap
ABS_UV = 1e-5  # u, v (barycentrics in [0, 1]), absolute
EDGE = 1e-5  # a near-edge ray: min(u, v, 1-u-v) within this of 0
MEAN_REL = 1e-3  # per-channel image means, kernels vs plain twins
BIG = 3.4e38
DEVICE = "cuda"


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def device_phase(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def ptxas_report(log):
    """[(kernel, registers and shared memory, stack frame and spills)] from
    nvcc's -Xptxas -v output, one entry per compiled kernel."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            mangled = line.split("Function properties for")[-1].strip()
            name, pos = mangled, 3 if mangled.startswith("_ZN") else 2
            while pos < len(mangled) and mangled[pos].isdigit():  # length-prefixed scopes, kernel last
                m = re.match(r"\d+", mangled[pos:])
                pos += m.end()
                name, pos = mangled[pos:pos + int(m.group())], pos + int(m.group())
            rest = mangled[pos:]
            name += "<true>" if rest.startswith("ILb1E") else "<false>" if rest.startswith("ILb0E") else ""
        elif "bytes stack frame" in line:
            frame = line.strip()
        elif "Used" in line and name is not None:
            out.append((name, line.split("Used")[-1].strip(), frame))
            name, frame = None, ""
    return out


def build_phase(_build, _launch):
    """nvcc for every declared source at once, then load each library. Every
    kernel (K1-K6, the RNG's, the Disney lobes', the light phase's, the BSDF
    dispatch's and the marks) must report 0 bytes of stack frame and no
    spills. Returns each source's ptxas report."""
    t0 = time.perf_counter()
    sources = _launch.SOURCES
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(lambda name: _build.build(name, sources[name].flags), sources)))
    for source in sources.values():
        source.lib()
    reports = {}
    for name, (lib, nvcc_s, log) in built.items():
        report = reports[name] = ptxas_report(log)
        phase("build", f"{lib.name}: nvcc {nvcc_s:.2f} s; "
              + "; ".join(f"{k}: {used}; {frame}" for k, used, frame in report))
        if not report or any(
                frame != "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" for _, _, frame in report):
            raise RuntimeError(f"{lib.name}'s kernels use local memory: {report}")
    phase("build", f"{len(sources)} sources built in parallel and loaded in {time.perf_counter() - t0:.2f} s")
    return reports


# The bound of a kernel call: the larger of its bytes over the memory rate
# and its FLOPs over the float32 rate (H100 SXM published peaks, at a 700 W
# power limit), with the FLOPs of the tests in csrc/geometry.cuh: slab_hit
# 6 subtractions and 6 products; tri_test 18 for s_u, s_v, s_w, 15 for
# d_u, d_v, d_w, the reciprocal, t, 2 each for u and v, and u + v.
HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12
SLAB_FLOPS, TRI_FLOPS = 12, 40
RAY_BYTES = 32  # ro, rd, tmin, tmax
HIT_BYTES, OCC_BYTES, ATTR_BYTES = 16, 1, 128  # t, u, v, prim; the occlusion byte; K1's attribute row
WORK_SAMPLE = 1 << 16  # rays per batch whose traversal work the twin counts


def bound(nbytes, flops):
    """(ms, "bytes" or "operations")."""
    b, f = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOPS_S * 1e3
    return (b, "bytes") if b >= f else (f, "operations")


RNG_LANES, RNG_SEED = 1 << 20, 7  # a pass's paths
RNG_SETS = 8  # input sets the timed calls cycle through: 8 x 16 MB of streams, more than the 50 MB L2
# bytes a lane moves: a stream reads two int32 indices and writes hi and lo
# (int64); a draw reads hi and lo and writes a float, and reads an int64
# counter more in the per-lane form
RNG_STREAM_BYTES, RNG_DRAW_BYTES, RNG_COUNTER_BYTES = 24, 20, 8

# the Disney lobes' kernels (csrc/disney.cu): lanes a call (a pass's paths),
# input sets the timed calls cycle through (each ~150 MB with its material
# rows, more than the 50 MB L2), ibl's two materials (scenes/ibl/ibl.xml)
DISNEY_LANES, DISNEY_SETS = 1 << 20, 2
IBL_COMPOSITE = dict(tex_value=(0.7, 0.2, 0.15), roughness=0.4, metallic=0.3, clearcoat=0.5)
IBL_CHROME = dict(tex_value=(0.95, 0.95, 0.95), roughness=0.1)
# bytes a lane needs, each input read once and each output written once:
# the tag (4), the front flag (1, glass and the composite), the normals and
# dir_in (36), dir_out (12, eval and pdf), refl (12, eval), the material's
# scalars the lobes read (metal 2; the composite's eval 12, its pdf and
# sample 7), the uniforms (sample: metal 2, the composite 4), and the output
# (dir_out and pdf 16, f 12, pdf 4)
DISNEY_BYTES = {("metal", "sample"): 4 + 36 + 8 + 8 + 16, ("metal", "eval"): 4 + 48 + 12 + 8 + 12,
                ("metal", "pdf"): 4 + 48 + 8 + 4, ("disneybsdf", "sample"): 4 + 1 + 36 + 28 + 16 + 16,
                ("disneybsdf", "eval"): 4 + 1 + 48 + 12 + 48 + 12, ("disneybsdf", "pdf"): 4 + 1 + 48 + 28 + 4}
# the kernels against the plain version: lanes bit-equal at least, lanes
# more than 4 ulps apart at most (a last-bit difference that flips a
# decision at a threshold), lanes whose pdf is 0 on one side only at most;
# each a handful of a 2^20-lane call (every lane was bit-equal on the
# card's 7 cases x 3 entries x 2^20 lanes: PERF.md)
DISNEY_BIT_SHARE, DISNEY_ULP_LANES, DISNEY_ZERO_FLIPS = 1 - 1e-5, 1e-5, 1e-5
DISNEY_COLUMNS = {name: 10 + k for k, name in enumerate((  # scene/types.py's MATTR_ETA ... MATTR_CLEARCOAT_GLOSS
    "eta", "exponent", "roughness", "subsurface", "anisotropic", "metallic", "spec_trans", "specular",
    "specular_tint", "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss"))}


def graph_ms(torch, fn, calls=64, replays=5):
    """Milliseconds per call of fn(k), k = 0 .. calls - 1, replayed from one
    captured CUDA graph: the card's time alone, as inside a pass graph,
    without the host's work of each launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(calls):
            fn(k)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def rng_cell(torch, dev):
    """The counter RNG's kernels (csrc/rng.cu) on RNG_LANES lanes as a pass
    draws: a stream from int32 pixel and sample indices, a uniform at a
    bounce counter, and one at per-lane counters (the refill loop's). Each
    must equal its plain version (core/rng.py) bit for bit, and is timed
    (graph_ms, cycling through RNG_SETS input sets, so that the inputs come
    from device memory) beside its bound and the plain version's time;
    returns {name: times}."""
    from take_tpu_torch.core import rng

    n = RNG_LANES
    pix = [torch.randint(0, 1 << 31, (n,), device=dev, dtype=torch.int32) for _ in range(RNG_SETS)]
    samp = [torch.randint(0, 1 << 16, (n,), device=dev, dtype=torch.int32) for _ in range(RNG_SETS)]
    st = [rng.make_stream(RNG_SEED, p, s) for p, s in zip(pix, samp)]
    lane_c = [rng.bounce_counter(torch.randint(-1, 51, (n,), device=dev), rng.DIM_BSDF_U1) for _ in range(RNG_SETS)]
    c = rng.bounce_counter(2, rng.DIM_LIGHT_U1)
    cases = {
        "stream": (lambda k: rng.make_stream(RNG_SEED, pix[k % RNG_SETS], samp[k % RNG_SETS]),
                   lambda k: rng._make_stream_plain(RNG_SEED, pix[k % RNG_SETS], samp[k % RNG_SETS]), RNG_STREAM_BYTES),
        "uniform": (lambda k: rng.uniform(st[k % RNG_SETS], c), lambda k: rng._uniform_plain(st[k % RNG_SETS], c),
                    RNG_DRAW_BYTES),
        "uniform_lanes": (lambda k: rng.uniform(st[k % RNG_SETS], lane_c[k % RNG_SETS]),
                          lambda k: rng._uniform_plain(st[k % RNG_SETS], lane_c[k % RNG_SETS]),
                          RNG_DRAW_BYTES + RNG_COUNTER_BYTES),
    }
    out, rows = {}, []
    for name, (kernel, plain, nbytes) in cases.items():
        for k in range(RNG_SETS):
            got, want = kernel(k), plain(k)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"rng {name}: the kernel differs from the plain version")
        ms, plain_ms = graph_ms(torch, kernel), graph_ms(torch, plain, calls=16)
        bound_ms, _ = bound(nbytes * n, 0)
        out[name] = {"ms": ms, "bound_ms": bound_ms, "plain_ms": plain_ms}
        rows.append(f"{name} {ms * 1e3:.2f} us (bound {bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}%), "
                    f"plain {plain_ms * 1e3:.1f} us ({plain_ms / ms:.1f}x)")
    phase("rng", f"{n} lanes, each equal to its plain version bit for bit, times from a graph: " + "; ".join(rows))
    return out


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def disney_directions(g, geo_n):
    """Unit directions: a third in front of geo_n, a third behind it, a
    third grazing it (within ~1e-3 of its plane, either side)."""
    n = geo_n.shape[0]
    d = _unit(g.normal(size=(n, 3)))
    side = np.sign(np.sum(d * geo_n, axis=1, keepdims=True))
    third = n // 3
    d[:third] *= side[:third]
    d[third:2 * third] *= -side[third:2 * third]
    tangent = _unit(np.cross(geo_n[2 * third:], d[2 * third:]))
    return np.concatenate([d[:2 * third], _unit(tangent + g.uniform(-1e-3, 1e-3, (n - 2 * third, 1))
                                                * geo_n[2 * third:])])


def disney_lanes(tag, n, seed, device, params=None):
    """(ShadePoint, dir_in, u_lobe, u1, u2, u3) for n lanes drawn with numpy:
    a tenth of the lanes of other tags (diffuse and the other Disney tags),
    both sides (`front`), the material's scalars columns of one [n, 24] row
    tensor as make_shade_point gathers them (`params` fixes them, as a
    scene's material does; else each lane draws its own, specTrans > 0
    included, with edge values), shading normals tilted off the geometric
    ones, dir_in in front, behind and grazing, and 24-bit uniforms as the
    counter RNG draws them."""
    import torch

    from take_tpu_torch.materials import bsdf, disney
    from take_tpu_torch.scene import types as ST

    g = np.random.default_rng(seed)
    rows = np.zeros((n, ST.MATTR_DIM), np.float32)
    rows[:, ST.MATTR_TAG] = np.where(g.random(n) < 0.1, g.choice([0] + [t for t in disney.TAGS if t != tag], n), tag)
    if params is None:
        for col in DISNEY_COLUMNS.values():
            rows[:, col] = g.random(n)
        rows[:, ST.MATTR_TEX_VALUE:ST.MATTR_TEX_VALUE + 3] = g.random((n, 3))
        rows[:, ST.MATTR_ETA] = g.uniform(1.0, 2.5, n)
        for col in (ST.MATTR_ROUGHNESS, ST.MATTR_METALLIC, ST.MATTR_SPEC_TRANS, ST.MATTR_CLEARCOAT_GLOSS,
                    ST.MATTR_ANISOTROPIC):
            edge = g.random(n) < 0.05
            rows[edge, col] = g.choice([0.0, 1.0], int(edge.sum()))
    else:
        rows[:, ST.MATTR_ETA] = 1.5
        for name, value in params.items():
            if name == "tex_value":
                rows[:, ST.MATTR_TEX_VALUE:ST.MATTR_TEX_VALUE + 3] = value
            else:
                rows[:, DISNEY_COLUMNS[name]] = value
    geo_n = _unit(g.normal(size=(n, 3)))
    sh_n = _unit(_unit(g.normal(size=(n, 3))) * 0.2 + geo_n)
    dir_in = disney_directions(g, geo_n)
    p = torch.from_numpy(rows).to(device)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    sp = bsdf.ShadePoint(
        tag=p[:, ST.MATTR_TAG].to(torch.int32), geo_n=f32(geo_n), sh_n=f32(sh_n),
        refl=p[:, ST.MATTR_TEX_VALUE:ST.MATTR_TEX_VALUE + 3], front=torch.from_numpy(g.random(n) < 0.5).to(device),
        **{name: p[:, col] for name, col in DISNEY_COLUMNS.items()})
    u = [f32(np.floor(g.random(n) * (1 << 24)) / (1 << 24)) for _ in range(4)]
    return sp, f32(dir_in), *u


def disney_dir_out(tag, sp, dir_in, u, seed):
    """dir_out for eval and pdf: on even lanes the plain version's own
    samples (so that sharp lobes are hit), on odd lanes directions in
    front, behind and grazing."""
    import torch

    from take_tpu_torch.materials import disney

    n, dev = dir_in.shape[0], dir_in.device
    d, _ = disney._sample_plain(tag, sp, dir_in, *u)
    other = torch.from_numpy(disney_directions(np.random.default_rng(seed + 1), sp.geo_n.cpu().numpy())
                             .astype(np.float32)).to(dev)
    return torch.where((torch.arange(n, device=dev) % 2 == 0)[:, None], d, other)


def _ordered(x):
    """float32 bits as integers in the floats' order (for ulp distances)."""
    import torch

    b = x.contiguous().view(torch.int32).long()
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


def agreement(got, want):
    """(share of lanes equal in every component, NaN to NaN; the largest ulp
    distance of a lane; lanes more than 4 ulps apart)."""
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    same = (got == want) | (got.isnan() & want.isnan())
    lane = (_ordered(got) - _ordered(want)).abs().masked_fill(same, 0).amax(1)
    return float((lane == 0).double().mean()), int(lane.max()) if lane.numel() else 0, int((lane > 4).sum())


def disney_cell(torch, dev):
    """The Disney lobes' kernels (csrc/disney.cu) on DISNEY_LANES lanes at
    ibl's two materials (chrome `disneymetal`, the `disneybsdf` composite),
    each of sample, eval and pdf: held against the plain version (bit for
    bit on at least DISNEY_BIT_SHARE of the lanes, more than 4 ulps apart on
    at most DISNEY_ULP_LANES, the pdf's zero decisions flipped on at most
    DISNEY_ZERO_FLIPS; lanes of other tags 0), and timed from a captured
    graph cycling through DISNEY_SETS input sets (graph_ms: the inputs come
    from device memory) beside its bytes bound and the plain version's
    time; returns {name: times}."""
    from take_tpu_torch.materials import disney
    from take_tpu_torch.scene import types as ST

    n, out, rows = DISNEY_LANES, {}, []
    for name, tag, params in (("metal", ST.MAT_DISNEY_METAL, IBL_CHROME),
                              ("disneybsdf", ST.MAT_DISNEY_BSDF, IBL_COMPOSITE)):
        sets = []
        for k in range(DISNEY_SETS):
            sp, dir_in, *u = disney_lanes(tag, n, 40 + 2 * tag + k, dev, params)
            sets.append((sp, dir_in, u, disney_dir_out(tag, sp, dir_in, u, 40 + 2 * tag + k)))
        for entry in ("sample", "eval", "pdf"):
            def call(fn, k, entry=entry):
                sp, dir_in, u, dir_out = sets[k % DISNEY_SETS]
                return fn(entry, tag, sp, dir_in, *(u if entry == "sample" else [dir_out]))

            share, ulps, flips = 1.0, 0, 0
            for k in range(DISNEY_SETS):
                got, want = call(disney._launch, k), call(lambda e, *a: disney._PLAIN[e](*a), k)
                got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                mine = sets[k][0].tag == tag
                for a, b in zip(got, want):
                    same, most, far = agreement(a[mine], b[mine])
                    if bool((a[~mine] != 0).any()) or same < DISNEY_BIT_SHARE or far > DISNEY_ULP_LANES * n:
                        raise RuntimeError(f"disney {name} {entry}: the kernel differs from the plain version "
                                           f"(bit-equal {same:.6f}, lanes beyond 4 ulps {far}, largest {most})")
                    share, ulps = min(share, same), max(ulps, most)
                if entry != "eval":  # the pdf: zero on one side only
                    flips = max(flips, int(((got[-1][mine] > 0) != (want[-1][mine] > 0)).sum()))
                    if flips > DISNEY_ZERO_FLIPS * n:
                        raise RuntimeError(f"disney {name} {entry}: {flips} lanes' pdf is 0 on one side only")
            ms = graph_ms(torch, lambda k: call(disney._launch, k))
            plain_ms = graph_ms(torch, lambda k: call(lambda e, *a: disney._PLAIN[e](*a), k), calls=4, replays=3)
            bound_ms, _ = bound(DISNEY_BYTES[name, entry] * n, 0)
            key = f"{name}_{entry}"
            out[key] = {"ms": ms, "bound_ms": bound_ms, "plain_ms": plain_ms, "bit_equal": share, "max_ulps": ulps,
                        "zero_flips": flips}
            rows.append(f"{key} {ms * 1e3:.2f} us (bound {bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}%), "
                        f"plain {plain_ms * 1e3:.1f} us ({plain_ms / ms:.1f}x), bit-equal {100 * share:.4f}% "
                        f"of lanes, largest {ulps} ulps, pdf zero flips {flips}")
    phase("disney", f"{n} lanes at ibl's materials, times from a graph: " + "; ".join(rows))
    return out


# the light phase's kernels (csrc/light.cu): lanes a call (a pass's paths),
# input sets the timed calls cycle through (each ~100 MB, more than the 50
# MB L2), the slot kinds of light_lanes, and the kernels against the plain
# version: lanes bit-equal in every output at least, as DISNEY_BIT_SHARE
LIGHT_LANES, LIGHT_SETS = 1 << 20, 2
LIGHT_CASES = ("triangle", "sphere", "point", "env", "mixed")
LIGHT_BIT_SHARE = 1 - 1e-5
# bytes a lane needs at cbox's kind ("triangle": area lights, no environment
# map), each input read once and each output written once: sample reads 3
# uniforms and the hit point (24) and writes light_dir, tmax, back, row,
# is_env, is_area, lit, lp, inv_d2 (32); nee reads row, the three flags, lp,
# FG, bp, occluded, spec, active (30) and writes C1 (12); arrival reads both
# vertices, dir_out, FG, bpdf, the four flags, light_id, geo_n, light_geom
# and emit (88; the flat background is one row, read once) and writes three
# [N, 3] terms (36)
LIGHT_BYTES = {"sample": 24 + 32, "nee": 30 + 12, "arrival": 88 + 36}


def light_lanes(case, n, seed, device):
    """(scene, sample's arguments, nee's vertex arguments, arrival's
    arguments) of integrator/light.py for n lanes drawn with numpy. The scene
    holds the light table and meta of `case`: "triangle" (two triangle
    lights, one with corner normals that flip its normal), "sphere" (a
    sphere light), "point", "env" (the environment map alone, as ibl) or
    "mixed" (all four and the environment map). The lanes: hit points
    around the lights, on a triangle light's sampled corner (d = 0 at
    u1 = 0), at the point light (d = 0), on the sphere, in the triangle
    light's plane (grazing) and behind it; 24-bit uniforms; FG, bp (0 on a
    tenth, 1e18 on some), the shadow answer, specular and dead lanes; the
    arrival's hits on emitters, misses, back faces, bpdf 0 and above the
    1e18 clamp."""
    import types

    import torch

    from take_tpu_torch.scene import types as ST

    g = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    unit = lambda k: _unit(g.normal(size=(k, 3)))

    def row(tag, kind, **cols):
        r = np.zeros(ST.LATTR_DIM, np.float32)
        r[ST.LATTR_TAG], r[ST.LATTR_KIND] = tag, kind
        r[ST.LATTR_INTENSITY:ST.LATTR_INTENSITY + 3] = g.uniform(0.5, 20.0, 3)
        for name, value in cols.items():
            col = getattr(ST, f"LATTR_{name.upper()}")
            r[col:col + np.size(value)] = value
        return r

    quad = np.array([[-0.25, 1.0, -0.25], [0.25, 1.0, -0.25], [0.25, 1.0, 0.25]], np.float32)  # faces down
    tilt = np.array([[-0.8, 0.2, -0.5], [-0.5, 0.9, -0.6], [-0.7, 0.4, 0.1]], np.float32)
    tri = lambda v, **k: row(ST.LIGHT_AREA, ST.SHAPE_TRI, v0=v[0], e1=v[1] - v[0], e2=v[2] - v[0],
                             inv_area=2.0 / np.linalg.norm(np.cross(v[1] - v[0], v[2] - v[0])), **k)
    center, radius, point = np.array([0.6, 0.5, 0.0], np.float32), 0.15, np.array([-0.6, 0.7, 0.2], np.float32)
    lights = {
        "tri": tri(quad),
        "tilt": tri(tilt, n0=(0, 1, 0), n1=(0.2, 0.9, 0.1), n2=(0, 1, 0)),  # corner normals against the face's
        "sphere": row(ST.LIGHT_AREA, ST.SHAPE_SPHERE, pos=center, radius=radius,
                      inv_area=1.0 / (4 * np.pi * radius * radius)),
        "point": row(ST.LIGHT_POINT, ST.SHAPE_TRI, pos=point),
    }
    names, has_env = {"triangle": (("tri", "tilt"), False), "sphere": (("sphere",), False),
                      "point": (("point",), False), "env": ((), True),
                      "mixed": (("tri", "tilt", "sphere", "point"), True)}[case]
    table = np.zeros((8, ST.LATTR_DIM), np.float32)
    for k, name in enumerate(names):
        table[k] = lights[name]
    meta = types.SimpleNamespace(n_lights=len(names), n_sph=int("sphere" in names), has_envmap=has_env,
                                 has_area_lights=any(nm != "point" for nm in names),
                                 has_point_lights="point" in names)
    scene = types.SimpleNamespace(meta=meta, lights=types.SimpleNamespace(attr=f32(table)))

    u = [np.floor(g.random(n) * (1 << 24)) / (1 << 24) for _ in range(3)]
    u[0][g.random(n) < 0.01], u[1][g.random(n) < 0.01] = 0.0, 1.0 - 2.0 ** -24
    pos = g.uniform(-1.0, 1.0, (n, 3))
    kind = g.integers(0, 8, n)  # 0-2 the general lanes; then the special ones
    corner = kind == 3  # on the quad's corner v0 + e1, sampled at u1 = 0
    pos[corner] = (quad[0] + np.float32(1.0) * (quad[1] - quad[0])).astype(np.float32)
    u[1][corner] = 0.0
    pos[kind == 4] = point  # at the point light
    on_sph = kind == 5
    pos[on_sph] = center + radius * unit(int(on_sph.sum())) * g.uniform(1.0, 1.0 + 1e-5, (int(on_sph.sum()), 1))
    grazing = kind == 6
    pos[grazing, 1] = 1.0 + g.uniform(-1e-6, 1e-6, int(grazing.sum()))
    behind = kind == 7
    pos[behind, 1] = g.uniform(1.0, 1.5, int(behind.sum()))
    env_pdf = g.uniform(0.0, 5.0, n) * (g.random(n) > 0.1)
    env_pdf[g.random(n) < 0.01] = 1e20
    sample = [f32(x) for x in u] + [f32(pos), f32(unit(n)), f32(unit(n)) if has_env else None]

    bp = g.uniform(0.0, 3.0, n) * (g.random(n) > 0.1)
    bp[g.random(n) < 0.01] = 1e18
    fg = g.uniform(0.0, 1.0, (n, 3)) * (g.random((n, 1)) > 0.05)
    flag = lambda p: torch.from_numpy(g.random(n) < p).to(device)
    env = (f32(g.uniform(0.0, 4.0, (n, 3))), f32(env_pdf)) if has_env else (None, None)
    nee = (f32(fg), f32(bp), flag(0.3), flag(0.1), flag(0.9), *env)

    prev = g.uniform(-1.0, 1.0, (n, 3))
    dir_out = unit(n)
    hit_pos = prev + dir_out * g.uniform(0.0, 2.0, (n, 1))
    same = g.random(n) < 0.05  # d = 0
    hit_pos[same] = prev[same]
    geo_n = unit(n)
    side = g.random(n) < 0.05  # grazing: the normal in the plane of dir_out
    geo_n[side] = _unit(np.cross(dir_out[side], unit(int(side.sum()))))
    emitter = g.random(n) < 0.4 if names else np.zeros(n, bool)
    light_id = np.where(emitter, g.integers(0, max(len(names), 1), n), -1)
    sph = emitter & (g.random(n) < 0.5) & ("sphere" in names)
    light_geom = np.where(emitter, np.where(sph, -radius, g.uniform(0.5, 8.0, n)), 0.0)
    bpdf = g.uniform(0.0, 3.0, n) * (g.random(n) > 0.1)
    bpdf[g.random(n) < 0.02] = 1e25
    background = f32(g.uniform(0.0, 2.0, (n, 3))) if has_env else f32(g.uniform(0.0, 2.0, 3))
    arrival = (f32(prev), f32(dir_out), f32(g.uniform(0.0, 1.0, (n, 3))), f32(bpdf), flag(0.1), flag(0.9),
               flag(0.9), flag(0.7), torch.from_numpy(light_id.astype(np.int32)).to(device), f32(hit_pos),
               f32(geo_n), f32(light_geom), f32(g.uniform(0.0, 10.0, (n, 3))),
               torch.broadcast_tensors(background, torch.empty((n, 3), device=device))[0],
               f32(g.uniform(0.0, 5.0, n) * (g.random(n) > 0.1)) if has_env else None)
    return scene, sample, nee, arrival


def light_args(entry, lanes):
    """The tensor arguments of light.py's `entry` (as its _launch and plain
    version take them) for lanes of light_lanes: nee's light fields are the
    plain sample's of the same lanes."""
    from take_tpu_torch.integrator import light

    scene, sample, nee, arrival = lanes
    if entry == "sample":
        return tuple(sample)
    if entry == "arrival":
        return arrival
    ls = light._sample_plain(scene, *sample)
    return (scene.lights.attr, *ls[3:], *nee)


def light_cell(torch, dev):
    """The light phase's kernels (csrc/light.cu) on LIGHT_LANES lanes of each
    of LIGHT_CASES: each output held against the plain version (bit for bit
    on at least LIGHT_BIT_SHARE of the lanes); then each kernel timed from
    a captured graph cycling through LIGHT_SETS input sets at cbox's kind
    (graph_ms: the inputs come from device memory) beside its bytes bound
    and the plain version's time; returns {name: times}."""
    from take_tpu_torch.integrator import light

    n, out, rows, agree = LIGHT_LANES, {}, [], []
    for case in LIGHT_CASES:
        lanes = light_lanes(case, n, 70 + len(case), dev)
        for entry in ("sample", "nee", "arrival"):
            args = light_args(entry, lanes)
            got, want = light._launch(entry, lanes[0], *args), light._PLAIN[entry](lanes[0], *args)
            want = want if isinstance(want, tuple) else (want,)
            for k, (a, b) in enumerate(zip(got, want)):
                same, most, _ = agreement(a.float(), b.float())
                if a.shape != b.shape or a.dtype != b.dtype or same < LIGHT_BIT_SHARE:
                    raise RuntimeError(f"light {case} {entry} output {k}: the kernel differs from the plain version "
                                       f"(bit-equal {same:.6f}, largest {most} ulps)")
                agree.append(same)
    sets = [light_lanes("triangle", n, 90 + k, dev) for k in range(LIGHT_SETS)]
    for entry in ("sample", "nee", "arrival"):
        args = [light_args(entry, lanes) for lanes in sets]
        ms = graph_ms(torch, lambda k: light._launch(entry, sets[k % LIGHT_SETS][0], *args[k % LIGHT_SETS]))
        plain_ms = graph_ms(torch, lambda k: light._PLAIN[entry](sets[k % LIGHT_SETS][0], *args[k % LIGHT_SETS]),
                            calls=4, replays=3)
        bound_ms, _ = bound(LIGHT_BYTES[entry] * n, 0)
        out[entry] = {"ms": ms, "bound_ms": bound_ms, "plain_ms": plain_ms}
        rows.append(f"{entry} {ms * 1e3:.2f} us (bound {bound_ms * 1e3:.2f} us, {100 * bound_ms / ms:.1f}%), "
                    f"plain {plain_ms * 1e3:.1f} us ({plain_ms / ms:.1f}x)")
    phase("light", f"{n} lanes of {', '.join(LIGHT_CASES)}: every output bit-equal on at least "
          f"{100 * min(agree):.4f}% of lanes; times from a graph at cbox's kind: " + "; ".join(rows))
    return out


# the BSDF dispatch's kernels (csrc/bsdf.cu): lanes a call (a pass's paths),
# input sets the timed calls cycle through (each ~100 MB, more than the 50
# MB L2), the cases of bsdf_lanes (each non-Disney tag at random parameters,
# the glossy tags also at mis's exponents, and every tag mixed), and the
# kernels against the plain dispatch: lanes bit-equal in every output at
# least, as DISNEY_BIT_SHARE
BSDF_LANES, BSDF_SETS = 1 << 20, 2
BSDF_TAGS = {"diffuse": 0, "mirror": 1, "plastic": 2, "phong": 3, "blinnphong": 4, "blinn_microfacet": 5,
             "disneydiffuse": 6}  # scene/types.py's MAT_*
MIS_EXPONENTS = (20.0, 100.0, 500.0, 3000.0)  # scenes/mis/mis.xml's plates
BSDF_CASES = (*BSDF_TAGS, "phong_mis", "blinnphong_mis", "blinn_microfacet_mis", "mixed")
BSDF_BIT_SHARE, BSDF_ZERO_FLIPS = 1 - 1e-5, 1e-5
# bytes a lane needs, each input read once and each output written once:
# the tag (4), the normals and dir_in (36), dir_out (12, eval and pdf), refl
# (12, eval), the exponent (4, blinn_microfacet), the uniforms (8, sample),
# and the output (dir_out and pdf 16, f 12, pdf 4)
BSDF_BYTES = {("diffuse", "sample"): 4 + 36 + 8 + 16, ("diffuse", "eval"): 4 + 48 + 12 + 12,
              ("diffuse", "pdf"): 4 + 48 + 4, ("blinn_microfacet", "sample"): 4 + 36 + 4 + 8 + 16,
              ("blinn_microfacet", "eval"): 4 + 48 + 12 + 4 + 12, ("blinn_microfacet", "pdf"): 4 + 48 + 4 + 4}


def bsdf_lanes(case, n, seed, device):
    """(used tags, ShadePoint, dir_in, u_lobe, u1, u2, u3, sample_pdf) of
    materials/bsdf.py's dispatch for n lanes drawn with numpy. `case` names
    a tag of BSDF_TAGS (nine lanes in ten of it, the rest of the other
    tags, Disney ones included), a glossy tag at mis's exponents (`_mis`),
    or "mixed" (every tag alike); the used tags are those of the lanes. The
    material's scalars are columns of one [n, 24] row tensor as
    make_shade_point gathers them, each lane's own: refl, eta in [1, 2.5],
    exponents log-uniform in [1, 5000] with edge values 0 and 1, roughness
    and subsurface in [0, 1]. Shading normals tilted off the geometric ones,
    on some lanes against them (a backface) or at +-z (to_world's singular
    branch); dir_in in front, behind and grazing, on some lanes along the
    shading normal; zero normals (a dead lane's miss) and a zero dir_in on a
    few lanes; 24-bit uniforms with both edges; sample_pdf (Plastic's flag)
    1 on a tenth of the lanes."""
    import torch

    from take_tpu_torch.materials import bsdf, disney
    from take_tpu_torch.scene import types as ST

    g = np.random.default_rng(seed)
    every = [*BSDF_TAGS.values(), *disney.TAGS]
    own = BSDF_TAGS.get(case.removesuffix("_mis"))
    rows = np.zeros((n, ST.MATTR_DIM), np.float32)
    if case == "mixed":
        rows[:, ST.MATTR_TAG] = g.choice(every, n)
    else:
        rows[:, ST.MATTR_TAG] = np.where(g.random(n) < 0.1, g.choice(every, n), own)
    for col in DISNEY_COLUMNS.values():
        rows[:, col] = g.random(n)
    rows[:, ST.MATTR_TEX_VALUE:ST.MATTR_TEX_VALUE + 3] = g.random((n, 3))
    rows[:, ST.MATTR_ETA] = g.uniform(1.0, 2.5, n)
    expo = np.exp(g.uniform(0.0, np.log(5000.0), n))
    edge = g.random(n) < 0.02
    expo[edge] = g.choice([0.0, 1.0], int(edge.sum()))
    rows[:, ST.MATTR_EXPONENT] = g.choice(MIS_EXPONENTS, n) if case.endswith("_mis") else expo
    geo_n = _unit(g.normal(size=(n, 3)))
    sh_n = _unit(_unit(g.normal(size=(n, 3))) * 0.2 + geo_n)
    dir_in = disney_directions(g, geo_n)
    kind = g.integers(0, 100, n)
    sh_n[kind == 0] = -sh_n[kind == 0]  # the shading normal against the geometric one
    pole = (kind == 1) | (kind == 2)
    sh_n[pole] = geo_n[pole] = np.where(kind[pole, None] == 1, [0.0, 0.0, -1.0], [0.0, 0.0, 1.0])
    along = kind == 3
    dir_in[along] = sh_n[along]
    dead = kind == 4
    geo_n[dead] = sh_n[dead] = 0.0
    dir_in[kind == 5] = 0.0
    p = torch.from_numpy(rows).to(device)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    sp = bsdf.ShadePoint(
        tag=p[:, ST.MATTR_TAG].to(torch.int32), geo_n=f32(geo_n), sh_n=f32(sh_n),
        refl=p[:, ST.MATTR_TEX_VALUE:ST.MATTR_TEX_VALUE + 3], front=torch.from_numpy(g.random(n) < 0.5).to(device),
        **{name: p[:, col] for name, col in DISNEY_COLUMNS.items()})
    u = [np.floor(g.random(n) * (1 << 24)) / (1 << 24) for _ in range(4)]
    for x in u:
        x[g.random(n) < 0.01], x[g.random(n) < 0.01] = 0.0, 1.0 - 2.0 ** -24
    sample_pdf = g.uniform(0.0, 3.0, n) * (g.random(n) > 0.1)
    sample_pdf[g.random(n) < 0.1] = 1.0
    tags = tuple(sorted(set(rows[:, ST.MATTR_TAG].astype(int).tolist())))
    return (tags, sp, f32(dir_in), *(f32(x) for x in u), f32(sample_pdf))


def bsdf_dir_out(tags, sp, dir_in, u, seed):
    """dir_out for eval and pdf: on even lanes the plain dispatch's own
    samples (so that sharp lobes are hit), on odd lanes directions in front,
    behind and grazing, and a zero direction on a few lanes."""
    import torch

    from take_tpu_torch.materials import bsdf

    n, dev = dir_in.shape[0], dir_in.device
    d, _ = bsdf._sample_plain(tags, sp, dir_in, *u)
    g = np.random.default_rng(seed + 1)
    with np.errstate(invalid="ignore"):  # the dead lanes' zero normals give NaN directions
        other = disney_directions(g, sp.geo_n.cpu().numpy())
    other[g.random(n) < 0.01] = 0.0
    other = torch.from_numpy(other.astype(np.float32)).to(dev)
    return torch.where((torch.arange(n, device=dev) % 2 == 0)[:, None], d, other)


def bsdf_args(entry, lanes, dir_out):
    """The kernel's arguments (bsdf._ARGS) and the plain dispatch's of the
    tags but the Disney ones: (tags, kernel arguments, plain arguments)."""
    from take_tpu_torch.materials import bsdf, disney

    tags, sp, dir_in, u_lobe, u1, u2, u3, sample_pdf = lanes
    own = {"sample": (u_lobe, u1, u2), "eval": (dir_out, sample_pdf), "pdf": (dir_out,)}[entry]
    return (tuple(t for t in tags if t not in disney.TAGS), bsdf._arguments(entry, sp, dir_in, *own),
            (sp, dir_in, *own))


def bsdf_cell(torch, dev, ptxas):
    """The BSDF dispatch's kernels (csrc/bsdf.cu) on BSDF_LANES lanes of
    each of BSDF_CASES, each of sample, eval and pdf: every output held
    against the plain dispatch of the same tags (bit for bit on at least
    BSDF_BIT_SHARE of the lanes, the pdf's zero decisions flipped on at most
    BSDF_ZERO_FLIPS; Disney lanes 0); then each kernel timed from a captured
    graph cycling through BSDF_SETS input sets on lanes all diffuse (cbox's
    and room's dispatch) and all blinn_microfacet at mis's exponents (mis's
    plates; the plain dispatch of mis's two tags), beside its bytes bound
    and the plain dispatch's time, with `ptxas`, the kernels' registers,
    stack frame and spills; returns {name: times}."""
    from take_tpu_torch.materials import bsdf

    n, out, rows, agree = BSDF_LANES, {}, [], []
    for case in BSDF_CASES:
        lanes = bsdf_lanes(case, n, 110 + len(case), dev)
        dir_out = bsdf_dir_out(lanes[0], lanes[1], lanes[2], lanes[3:6], 110 + len(case))
        for entry in ("sample", "eval", "pdf"):
            tags, kargs, pargs = bsdf_args(entry, lanes, dir_out)
            got, want = bsdf._launch(entry, *kargs), bsdf._PLAIN[entry](tags, *pargs)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            for k, (a, b) in enumerate(zip(got, want)):
                same, most, _ = agreement(a, b)
                if a.shape != b.shape or same < BSDF_BIT_SHARE:
                    raise RuntimeError(f"bsdf {case} {entry} output {k}: the kernel differs from the plain dispatch "
                                       f"(bit-equal {same:.6f}, largest {most} ulps)")
                agree.append(same)
            if entry != "eval":
                flips = int(((got[-1] > 0) != (want[-1] > 0)).sum())
                if flips > BSDF_ZERO_FLIPS * n:
                    raise RuntimeError(f"bsdf {case} {entry}: {flips} lanes' pdf is 0 on one side only")
    for name, plain_tags in (("diffuse", (0,)), ("blinn_microfacet", (0, 5))):
        sets = []
        for k in range(BSDF_SETS):
            lanes = bsdf_lanes(f"{name}_mis" if name != "diffuse" else name, n, 130 + k, dev)
            mine = lanes[1]._replace(tag=torch.full_like(lanes[1].tag, BSDF_TAGS[name]))
            lanes = (plain_tags, mine, *lanes[2:])
            sets.append((lanes, bsdf_dir_out(plain_tags, mine, lanes[2], lanes[3:6], 130 + k)))
        for entry in ("sample", "eval", "pdf"):
            every = [bsdf_args(entry, lanes, dir_out) for lanes, dir_out in sets]
            ms = graph_ms(torch, lambda k: bsdf._launch(entry, *every[k % BSDF_SETS][1]))
            plain_ms = graph_ms(torch, lambda k: bsdf._PLAIN[entry](plain_tags, *every[k % BSDF_SETS][2]),
                                calls=4, replays=3)
            bound_ms, _ = bound(BSDF_BYTES[name, entry] * n, 0)
            out[f"{name}_{entry}"] = {"ms": ms, "bound_ms": bound_ms, "plain_ms": plain_ms}
            rows.append(f"{name} {entry} {ms * 1e3:.2f} us (bound {bound_ms * 1e3:.2f} us, "
                        f"{100 * bound_ms / ms:.1f}%), plain {plain_ms * 1e3:.1f} us ({plain_ms / ms:.1f}x)")
    phase("bsdf", f"{n} lanes of {', '.join(BSDF_CASES)}: every output bit-equal on at least "
          f"{100 * min(agree):.4f}% of lanes; times from a graph: " + "; ".join(rows) + "; ptxas: "
          + "; ".join(f"{k}: {used}; {frame}" for k, used, frame in ptxas))
    out["ptxas"] = [list(r) for r in ptxas]
    return out


def bvh_bound(torch, packet, bvh, rays, any_hit, seed=0):
    """The bound of one BVH query (K3, K4 or K6 answer the same one): the
    twin's slab and triangle tests, counted on WORK_SAMPLE random rays of
    the batch and scaled to all of it; the rays read, the answers written
    and the kernel's tables (qnodes, tris) read once. Returns (ms, by,
    work per ray: node visits, slabs, triangles)."""
    n = rays[0].shape[0]
    pick = torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:WORK_SAMPLE].to(rays[0].device)
    work = packet.packet_work(bvh, *(r[pick] for r in rays), any_hit=any_hit).sum(0).double()
    work = work * n / pick.numel()
    tables = bvh.qnodes.nbytes + bvh.tris.nbytes
    ms, by = bound(n * (RAY_BYTES + (OCC_BYTES if any_hit else HIT_BYTES)) + tables,
                   work[1].item() * SLAB_FLOPS + work[2].item() * TRI_FLOPS)
    return ms, by, (work / n).tolist()


def block_sample(torch, rays, size, seed):
    """WORK_SAMPLE rays of a batch taken as whole blocks of `size` rays,
    the blocks picked at random, in order."""
    n = rays[0].shape[0]
    pick = torch.randperm(-(-n // size), generator=torch.Generator().manual_seed(seed))[:WORK_SAMPLE // size]
    idx = (pick.sort().values[:, None] * size + torch.arange(size)).view(-1)
    idx = idx[idx < n].to(rays[0].device)
    return [r[idx] for r in rays]


def cluster_counts(torch, cluster, bvh, rays, any_hit, seed=0):
    """K4's (K5's with any_hit) work per live ray, cluster.cluster_work on
    WORK_SAMPLE rays of the batch taken as whole blocks of the kernel's
    cluster.THREADS rays, picked at random: [superclusters entered, clusters
    entered, triangle rows tested, rows the parent kernel tested (512 for
    each supercluster the ray's block voted for)]."""
    sample = block_sample(torch, rays, cluster.THREADS, seed)
    work = cluster.cluster_work(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *sample, any_hit=any_hit).double()
    m = work[sample[3] >= sample[2]].mean(dim=0)
    return [m[0].item(), m[1].item(), m[2].item(), cluster.SUPT * m[3].item()]


def sweep_counts(torch, sweep, scene, rays, any_hit, seed=0):
    """K6's work per live ray, sweep.sweep_work on WORK_SAMPLE rays of the
    batch taken as whole blocks of the kernel's sweep.THREADS rays, picked
    at random: [boxes walked, clusters entered, triangle rows tested, rows
    the parent kernel's block-wide cull left each live ray]."""
    sample = block_sample(torch, rays, sweep.THREADS, seed)
    bvh = scene.bvh
    work = sweep.sweep_work(bvh.cl_aabb, bvh.tris, scene.meta.n_tri, *sample, any_hit=any_hit).double()
    return work[sample[3] >= sample[2]].mean(dim=0).tolist()


def capture_queries(torch, scene, options, cluster_route=False, sweep_route=False):
    """The inputs of the scene's intersection kernels, copied, from the first
    pass of a render of `scene`: K3's (packet.closest/occluded) for a BVH
    scene, or with cluster_route K4/K5's (cluster.closest/occluded, under
    traverse.FORCE_CLUSTER), or with sweep_route K6's closest hits
    (sweep.closest, under traverse.FORCE_SWEEP) and K3's any hits, else
    K1/K2's (brute.closest/occluded). The pass runs op by op
    (render.eager()): the recording clones each batch in Python, which a
    replayed graph would not run. Returns [("closest" or "anyhit",
    [ro, rd, tmin, tmax])] in launch order."""
    from take_tpu_torch.geometry import brute, cluster, packet, sweep, traverse

    render = importlib.import_module("take_tpu_torch.render")  # the package's `render` is a function
    module = brute if scene.bvh is None else cluster if cluster_route else packet
    closest_module = sweep if sweep_route else module
    calls, one_pass = [], render.render_pass

    class FirstPass(Exception):
        pass

    def recording(kind, fn):
        def wrapped(*args):  # the rays are the last four arguments of each
            calls.append((kind, [r.clone() for r in args[-4:]]))
            return fn(*args)
        return wrapped

    def first_pass(*a, **k):
        one_pass(*a, **k)
        raise FirstPass

    with mock.patch.object(closest_module, "closest", recording("closest", closest_module.closest)), \
            mock.patch.object(module, "occluded", recording("anyhit", module.occluded)), \
            mock.patch.object(traverse, "FORCE_CLUSTER", cluster_route), \
            mock.patch.object(traverse, "FORCE_SWEEP", sweep_route), \
            mock.patch.object(render, "render_pass", first_pass), render.eager():
        try:
            render.render_image(scene, options)
        except FirstPass:
            pass
    return calls


def captured_times(torch, packet, bvh, calls, label):
    """K3 per captured batch (CUDA events, 10 calls after 3 warm-ups) beside
    the batch's bound. Returns (kernel ms, bound ms) summed per kind."""
    sums = {"closest": [0.0, 0.0], "anyhit": [0.0, 0.0]}
    rows = []
    for j, (kind, rays) in enumerate(calls):
        fn = packet.closest if kind == "closest" else packet.occluded
        ms = time_call(torch, lambda: fn(bvh, *rays), iters=10)
        b_ms, by, work = bvh_bound(torch, packet, bvh, rays, kind == "anyhit", seed=j)
        live = (rays[3] >= rays[2]).float().mean().item()
        sums[kind][0] += ms
        sums[kind][1] += b_ms
        rows.append(f"{j}:{kind} n={rays[0].shape[0]} live {live:.3f} {ms:.4f} ms (bound {b_ms:.4f} ms, {by}; "
                    f"per ray {work[0]:.2f} nodes {work[1]:.2f} slabs {work[2]:.2f} tris)")
    phase("times", f"{label} K3 on the captured batches of one pass: " + "; ".join(rows)
          + "; per pass " + ", ".join(f"{k} {v[0]:.4f} ms (bound {v[1]:.4f} ms)" for k, v in sums.items()))
    return sums


def cluster_captured(torch, cluster, packet, scene, calls, label):
    """K4/K5 on the batches captured from one pass of a render under
    traverse.FORCE_CLUSTER: each held against cluster_plain by closest_gate /
    anyhit_gate, its rays that differ from the twin's in any bit counted,
    timed (CUDA events, 10 calls after 3 warm-ups), bounded by bvh_bound and
    its work counted by cluster_counts. Returns ({kind: [kernel ms, bound
    ms]} summed over the pass, {kind: work per live ray, the batches'
    mean})."""
    bvh = scene.bvh
    tables = (bvh.sup_aabb, bvh.cl_aabb, bvh.tris)
    sums = {"closest": [0.0, 0.0], "anyhit": [0.0, 0.0]}
    work = {"closest": np.zeros(4), "anyhit": np.zeros(4)}
    rows = []
    for j, (kind, rays) in enumerate(calls):
        dead = rays[3] < rays[2]
        if kind == "closest":
            def fn():
                return cluster.closest(*tables, *rays)
            k, p = fn(), cluster.cluster_plain(bvh.sup_aabb, bvh.tris, *rays)
            torch.cuda.synchronize()
            closest_gate(torch, f"{label} batch {j} K4", scene, k, p, rays, dead)
            differ = bits_differ(torch, k, p)
            note = f"{int((k[3] >= 0).sum())} hits"
        else:
            def fn():
                return cluster.occluded(*tables, *rays)
            k, p = fn(), cluster.cluster_plain(bvh.sup_aabb, bvh.tris, *rays, any_hit=True)
            torch.cuda.synchronize()
            anyhit_gate(torch, f"{label} batch {j} K5", scene, k, p, rays, dead)
            differ = bits_differ(torch, k, p)
            note = f"{int(k.sum())} occluded"
        ms = time_call(torch, fn, iters=10)
        b_ms, by, _ = bvh_bound(torch, packet, bvh, rays, kind == "anyhit", seed=j)
        w = cluster_counts(torch, cluster, bvh, rays, kind == "anyhit", seed=j)
        sums[kind][0] += ms
        sums[kind][1] += b_ms
        work[kind] += np.array(w) / sum(1 for c, _ in calls if c == kind)
        rows.append(f"{j}:{kind} n={rays[0].shape[0]} live {(~dead).float().mean().item():.3f} {note}, "
                    f"{differ} rays differ from the twin in any bit; {ms:.4f} ms (bound {b_ms:.4f} ms, "
                    f"{by}); per live ray {w[0]:.3f} superclusters {w[1]:.3f} clusters {w[2]:.1f} rows "
                    f"(parent {w[3]:.0f})")
    phase("times", f"{label} K4/K5 on the captured batches of one pass under FORCE_CLUSTER, each within the "
          "twin gates: " + "; ".join(rows) + "; per pass "
          + ", ".join(f"{k} {v[0]:.4f} ms (bound {v[1]:.4f} ms)" for k, v in sums.items()))
    return sums, {k: v.tolist() for k, v in work.items()}


def sweep_captured(torch, sweep, packet, scene, calls, label):
    """K6 on the batches captured from one pass of a render under
    traverse.FORCE_SWEEP: closest hit on the sweep route's own batches, any
    hit on the pass's any-hit batches (K3's there), each equal to
    sweep_plain bit for bit, timed (CUDA events, 10 calls after 3 warm-ups),
    bounded by bvh_bound and its work counted by sweep_counts. Returns
    ({kind: [kernel ms, bound ms]} summed over the pass, {kind: work per
    live ray, the batches' mean})."""
    bvh, n_tri = scene.bvh, scene.meta.n_tri
    tables = (bvh.cl_aabb, bvh.tris, n_tri)
    sums = {"closest": [0.0, 0.0], "anyhit": [0.0, 0.0]}
    work = {"closest": np.zeros(4), "anyhit": np.zeros(4)}
    rows = []
    for j, (kind, rays) in enumerate(calls):
        any_hit = kind == "anyhit"
        fn = sweep.occluded if any_hit else sweep.closest
        k, p = fn(*tables, *rays), sweep.sweep_plain(*tables, *rays, any_hit=any_hit)
        torch.cuda.synchronize()
        differ = bits_differ(torch, k, p)
        if differ:
            raise RuntimeError(f"{label} batch {j}: K6 {kind} differs from sweep_plain on {differ} rays")
        note = f"{int(k.sum())} occluded" if any_hit else f"{int((k[3] >= 0).sum())} hits"
        ms = time_call(torch, lambda: fn(*tables, *rays), iters=10)
        b_ms, by, _ = bvh_bound(torch, packet, bvh, rays, any_hit, seed=j)
        w = sweep_counts(torch, sweep, scene, rays, any_hit, seed=j)
        sums[kind][0] += ms
        sums[kind][1] += b_ms
        work[kind] += np.array(w) / sum(1 for c, _ in calls if c == kind)
        rows.append(f"{j}:{kind} n={rays[0].shape[0]} live {(rays[3] >= rays[2]).float().mean().item():.3f} "
                    f"{note}, equal to the twin bit for bit; {ms:.4f} ms (bound {b_ms:.4f} ms, {by}); per live "
                    f"ray {w[0]:.1f} boxes {w[1]:.3f} clusters {w[2]:.1f} rows (parent {w[3]:.0f})")
    phase("times", f"{label} K6 on the captured batches of one pass under FORCE_SWEEP (any hit on the pass's "
          "any-hit batches): " + "; ".join(rows) + "; per pass "
          + ", ".join(f"{k} {v[0]:.4f} ms (bound {v[1]:.4f} ms)" for k, v in sums.items()))
    return sums, {k: v.tolist() for k, v in work.items()}


def make_rays(torch, scene, rng, n, lo, hi):
    """n rays: camera rays, rays from inside the box [lo, hi], finite-tmax
    shadow rays toward the triangle lights, ~10% dead lanes
    (tmax = -3.4e38), and padded rays (tmax = -1) appended the way the JAX
    package pads its Pallas grid. Returns (rays, dead mask)."""
    from take_tpu_torch.core.camera import generate_rays
    from take_tpu_torch.geometry.intersect import _pad_rays
    from take_tpu_torch.scene.types import LATTR_E1, LATTR_E2, LATTR_V0

    n_pad = 100
    n_cam, n_box = 4 * n // 10, 3 * n // 10
    n_shadow = n - n_pad - n_cam - n_box
    cam = scene.meta.camera
    pix = rng.integers(0, cam.width * cam.height, n_cam)
    px = torch.tensor(pix % cam.width, dtype=torch.float32)
    py = torch.tensor(pix // cam.width, dtype=torch.float32)
    jx, jy = (torch.tensor(rng.random(n_cam), dtype=torch.float32) for _ in range(2))
    ro_c, rd_c = generate_rays(cam, px, py, jx, jy)

    ro_b = rng.uniform(lo, hi, (n_box + n_shadow, 3))
    d = rng.normal(size=(n_box, 3))
    rd_b = d / np.linalg.norm(d, axis=1, keepdims=True)
    la = scene.lights.attr.cpu().numpy()
    lid = rng.integers(0, scene.meta.n_lights, n_shadow)
    b1 = np.sqrt(rng.random(n_shadow))
    b2 = rng.random(n_shadow)
    target = (la[lid, LATTR_V0:LATTR_V0 + 3] + (1 - b1)[:, None] * la[lid, LATTR_E1:LATTR_E1 + 3]
              + (b1 * b2)[:, None] * la[lid, LATTR_E2:LATTR_E2 + 3])
    delta = target - ro_b[n_box:]
    dist = np.linalg.norm(delta, axis=1)
    rd_s = delta / dist[:, None]

    ro = torch.cat([ro_c, torch.tensor(ro_b, dtype=torch.float32)])
    rd = torch.cat([rd_c, torch.tensor(np.concatenate([rd_b, rd_s]), dtype=torch.float32)])
    m = n - n_pad
    tmin = torch.full((m,), 1e-4)
    tmax = torch.cat([torch.full((n_cam + n_box,), float("inf")),
                      torch.tensor(0.999 * dist, dtype=torch.float32)])
    dead = torch.tensor(rng.random(m) < 0.1)
    tmax = torch.where(dead, -BIG, tmax)
    _, ro, rd, tmin, tmax = _pad_rays(ro, rd, tmin, tmax, 1024)
    if ro.shape[0] != n:
        raise RuntimeError(f"padded ray count {ro.shape[0]} != {n}")
    dev = scene.background.device
    return [x.to(dev).contiguous() for x in (ro, rd, tmin, tmax)], (tmax <= 0).to(dev)


def near_boundary(torch, g, n_tri, ro, rd, tmin, tmax, prims):
    """[M] bool: the ray lies within tolerance of a decision boundary for
    one of the triangles `prims` ([M, k] candidate indices, -1 = none):
    an edge (min(u, v, 1-u-v) within EDGE of 0) or an end of [tmin, tmax]
    (within REL_T relative), while being a hit within those tolerances."""
    from take_tpu_torch.geometry.brute import tri_uvt

    t, u, v, _ = tri_uvt(g.tri_rows, n_tri, ro, rd, tmin, tmax)
    e = torch.minimum(torch.minimum(u, v), 1.0 - (u + v))
    slack = REL_T * torch.clamp(t.abs(), min=1.0)
    r = torch.minimum(t - tmin[:, None], tmax[:, None] - t)
    hit_tol = (e >= -EDGE) & (r >= -slack)
    close = (e.abs() <= EDGE) | (r.abs() <= slack)
    cand = hit_tol & close
    if prims is None:  # any triangle
        return cand.any(dim=1)
    out = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    for j in range(prims.shape[1]):
        p = prims[:, j].long()
        ok = p >= 0
        out |= ok & cand.gather(1, p.clamp(min=0)[:, None])[:, 0]
    return out


def fp32_bounds(torch, g, prim, ro, rd):
    """Per-ray bounds on |t, u, v (kernel) - t, u, v (twin)| for hits on
    triangles `prim`, from float32 rounding alone.

    Kernel and twin round the same affine sums differently (FMA or not), so
    each sum differs by at most ~8 eps times the sum of its terms' magnitudes
    (4 terms, rounded on both sides); t = -s_w / d_w divides that by |d_w|,
    which is small for grazing rays, and u = s_u + t d_u carries t's error.
    The bounds are twice that first-order estimate.
    """
    eps = 2.0 ** -24
    rows = g.tri_rows[prim.long()]
    oh = torch.cat([ro, torch.ones_like(ro[:, :1])], dim=1)
    ao = [rows[:, 4 * k:4 * k + 4] for k in range(3)]  # [M, 4]
    ad = [rows[:, 12 + 3 * k:15 + 3 * k] for k in range(3)]  # [M, 3]
    s = [(a * oh).sum(1) for a in ao]
    d = [(a * rd).sum(1) for a in ad]
    S = [(a * oh).abs().sum(1) for a in ao]
    D = [(a * rd).abs().sum(1) for a in ad]
    t = (-s[2] / d[2]).abs()
    et = 8 * eps * (S[2] + t * D[2]) / d[2].abs() + 2 * eps * t
    eu = 8 * eps * (S[0] + t * D[0]) + d[0].abs() * et + 4 * eps * (s[0].abs() + t * d[0].abs())
    ev = 8 * eps * (S[1] + t * D[1]) + d[1].abs() * et + 4 * eps * (s[1].abs() + t * d[1].abs())
    return 2 * et, 2 * eu, 2 * ev


def bits_differ(torch, k, p):
    """How many rays have answers that differ in any bit: (t, u, v, prim) or
    occlusion masks."""
    if isinstance(k, torch.Tensor):
        return int((k != p).sum())
    same = torch.stack([a.view(torch.int32) == b.view(torch.int32) for a, b in zip(k, p)]).all(dim=0)
    return int((~same).sum())


def closest_gate(torch, label, scene, k, p, rays, dead):
    """Hold a closest-hit kernel's (t, u, v, prim) against its twin's:
    winner index equal on >= PRIM_AGREE_MIN of the rays, every mismatch at
    a near-tie, an edge or a range end; t/u/v of agreeing hits within the
    float32 rounding bound; dead and padded lanes miss. Returns the max
    |t, u, v difference| over agreeing hits, the mask of agreeing hits, and
    the line to print."""
    g, n_tri = scene.geometry, scene.meta.n_tri
    ro, rd, tmin, tmax = rays
    t_k, u_k, v_k, p_k = k
    t_p, u_p, v_p, p_p = p
    f_k, f_p = p_k >= 0, p_p >= 0
    agree = p_k == p_p
    frac = agree.float().mean().item()
    bad = ~agree
    n_bad = int(bad.sum())
    if frac < PRIM_AGREE_MIN:
        raise RuntimeError(f"{label}: prim agrees on {frac:.6f} of rays only")
    if n_bad:
        idx = bad.nonzero()[:, 0]
        tie = f_k[idx] & f_p[idx] & ((t_k[idx] - t_p[idx]).abs() <= REL_T * t_p[idx].abs())
        edge = near_boundary(torch, g, n_tri, ro[idx], rd[idx], tmin[idx], tmax[idx],
                             torch.stack([p_k[idx], p_p[idx]], dim=1))
        unexplained = int((~(tie | edge)).sum())
    else:
        unexplained = 0
    both = agree & f_k
    dt = (t_k - t_p).abs()[both]
    du = (u_k - u_p).abs()[both]
    dv = (v_k - v_p).abs()[both]
    t_rel = dt / t_p[both].abs().clamp(min=1e-30)
    flat_ok = (t_rel <= REL_T) & (du <= ABS_UV) & (dv <= ABS_UV)
    flat_frac = flat_ok.float().mean().item()
    bt, bu, bv = fp32_bounds(torch, g, p_k[both], ro[both], rd[both])
    over_bound = int(((dt > bt) | (du > bu) | (dv > bv)).sum())
    err = max(dt.max().item(), du.max().item(), dv.max().item())  # t in world units
    dead_miss = bool((p_k[dead] == -1).all() and (p_p[dead] == -1).all() and (t_k[dead] == BIG).all())
    worst = int(t_rel.argmax())
    line = (f"{label}: prim agrees on {frac:.6f} of {ro.shape[0]} rays, "
            f"{n_bad} mismatches, {unexplained} not at a near-tie/edge/range end; "
            f"agreeing hits {int(both.sum())}: {flat_frac:.6f} within rel t {REL_T} and abs u/v {ABS_UV} "
            f"(max rel t {t_rel.max().item():.3e} at t={t_p[both][worst].item():.4g}, "
            f"max abs u {du.max().item():.3e} v {dv.max().item():.3e}), "
            f"{over_bound} beyond the float32 rounding bound; dead+padded lanes miss {dead_miss}")
    if unexplained or over_bound or not dead_miss:
        phase("parity", line)
        raise RuntimeError(f"{label} disagrees with its plain twin")
    return err, both, line


def anyhit_gate(torch, label, scene, o_k, o_p, rays, dead):
    """Hold an any-hit kernel's occlusion against its twin's: equal on
    >= PRIM_AGREE_MIN of the rays, every mismatch near a decision boundary,
    dead and padded lanes clear. Returns (error, line): the error is 1 when
    a mismatch is not near a boundary (max |occ_kernel - occ_plain| over
    the rays away from one), else 0."""
    g, n_tri = scene.geometry, scene.meta.n_tri
    ro, rd, tmin, tmax = rays
    obad = o_k != o_p
    ofrac = 1.0 - obad.float().mean().item()
    if ofrac < PRIM_AGREE_MIN:
        raise RuntimeError(f"{label}: occlusion agrees on {ofrac:.6f} of rays only")
    n_obad = int(obad.sum())
    if n_obad:
        idx = obad.nonzero()[:, 0]
        explained = near_boundary(torch, g, n_tri, ro[idx], rd[idx], tmin[idx], tmax[idx], None)
        o_unexplained = int((~explained).sum())
    else:
        o_unexplained = 0
    odead = bool((~o_k[dead]).all() and (~o_p[dead]).all())
    line = (f"{label}: occ agrees on {ofrac:.6f} of rays ({int(o_k.sum())} occluded), "
            f"{n_obad} mismatches, {o_unexplained} not near a boundary; dead+padded lanes clear {odead}")
    if o_unexplained or not odead:
        phase("parity", line)
        raise RuntimeError(f"{label} disagrees with its plain twin")
    return float(o_unexplained > 0), line


def cbox_parity(torch, brute, scene, rays, dead):
    g, n_tri = scene.geometry, scene.meta.n_tri
    a_k, t_k, u_k, v_k, _, p_k = brute.closest(g.tri_rows, g.tri_attr, n_tri, *rays)
    a_p, t_p, u_p, v_p, _, p_p = brute.closest_plain(g.tri_rows, g.tri_attr, n_tri, *rays)
    torch.cuda.synchronize()
    err_closest, both, line = closest_gate(torch, "K1 closest", scene, (t_k, u_k, v_k, p_k),
                                           (t_p, u_p, v_p, p_p), rays, dead)
    attrs_equal = bool(torch.equal(a_k[both], a_p[both]))
    phase("parity", f"{line}; attrs equal {attrs_equal}")
    if not attrs_equal:
        raise RuntimeError("K1 disagrees with closest_plain")
    o_k = brute.occluded(g.tri_rows, n_tri, *rays)
    o_p = brute.occluded_plain(g.tri_rows, n_tri, *rays)
    torch.cuda.synchronize()
    err_anyhit, line = anyhit_gate(torch, "K2 any-hit", scene, o_k, o_p, rays, dead)
    phase("parity", line)
    return err_closest, err_anyhit


def room_parity(torch, packet, cluster, sweep, scene, rays, dead):
    """K3 (closest, any hit), K4, K5 and K6 (closest, any hit) against their
    twins. Returns the max error of each, keyed by _launch.LAUNCHES name."""
    bvh, n_tri = scene.bvh, scene.meta.n_tri
    err = {}
    for label, key, kernel, twin in (
        ("K3 closest", "packet_closest", lambda: packet.closest(bvh, *rays),
         lambda: packet.packet_plain(bvh, *rays)),
        ("K4 cluster closest", "cluster_closest",
         lambda: cluster.closest(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *rays),
         lambda: cluster.cluster_plain(bvh.sup_aabb, bvh.tris, *rays)),
        ("K6 sweep closest", "sweep_closest", lambda: sweep.closest(bvh.cl_aabb, bvh.tris, n_tri, *rays),
         lambda: sweep.sweep_plain(bvh.cl_aabb, bvh.tris, n_tri, *rays)),
    ):
        k, p = kernel(), twin()
        torch.cuda.synchronize()
        err[key], _, line = closest_gate(torch, label, scene, k, p, rays, dead)
        if key == "sweep_closest":  # K6 equals its twin bit for bit
            line += f"; {bits_differ(torch, k, p)} rays differ from the twin in any bit"
            if bits_differ(torch, k, p):
                raise RuntimeError(f"{label} differs from sweep_plain: {line}")
        phase("parity", line)
    for label, key, kernel, twin in (
        ("K3 any-hit", "packet_anyhit", lambda: packet.occluded(bvh, *rays),
         lambda: packet.packet_plain(bvh, *rays, any_hit=True)),
        ("K5 cluster any-hit", "cluster_anyhit",
         lambda: cluster.occluded(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *rays),
         lambda: cluster.cluster_plain(bvh.sup_aabb, bvh.tris, *rays, any_hit=True)),
        ("K6 sweep any-hit", "sweep_anyhit", lambda: sweep.occluded(bvh.cl_aabb, bvh.tris, n_tri, *rays),
         lambda: sweep.sweep_plain(bvh.cl_aabb, bvh.tris, n_tri, *rays, any_hit=True)),
    ):
        o_k, o_p = kernel(), twin()
        torch.cuda.synchronize()
        err[key], line = anyhit_gate(torch, label, scene, o_k, o_p, rays, dead)
        if key == "sweep_anyhit" and bits_differ(torch, o_k, o_p):
            raise RuntimeError(f"{label} differs from sweep_plain on {bits_differ(torch, o_k, o_p)} rays")
        phase("parity", line)
    return err


def with_res(scene, width, height=None):
    from take_tpu_torch.core.camera import Camera

    cam = scene.meta.camera
    new = Camera(width, height or width, cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(scene, meta=dataclasses.replace(scene.meta, camera=new))


def time_call(torch, fn, warmup=3, iters=20):
    """Milliseconds per call by CUDA events, after `warmup` calls. The card
    first spins for ~5 ms, so that the host has queued the timed calls
    before they run: a call shorter than its wrapper's host work (~0.1 ms)
    is timed on the card, not at the host's rate."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)  # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernels_only(launches, want, what):
    """Raise unless the kernels in `want` were launched and nothing else ran."""
    if any(launches[k] == 0 for k in want) or any(v for k, v in launches.items() if k not in want):
        raise RuntimeError(f"{what} did not run on {want} alone: {launches}")
    return {k: launches[k] for k in want}


def render_counted(torch, _launch, render_image, scene, options, want, what):
    """Render with every launch count set to 0 just before; the counts read
    just after must be > 0 for the kernels in `want` and 0 for all other
    scene queries, and the light phase and the BSDF dispatch must have run
    their kernels alone."""
    from take_tpu_torch.integrator import light
    from take_tpu_torch.materials import bsdf

    torch.cuda.synchronize()
    _launch.reset_launches()
    img = render_image(scene, options)
    torch.cuda.synchronize()
    launches = kernels_only(dict(_launch.LAUNCHES), want, what)
    kernels_only(light.LAUNCHES, ("light_sample", "light_nee", "light_arrival"), f"{what}'s light phase")
    kernels_only(bsdf.LAUNCHES, ("bsdf_sample", "bsdf_eval", "bsdf_pdf"), f"{what}'s BSDF dispatch")
    if not np.isfinite(img).all():
        raise RuntimeError(f"{what}: the image is not finite")
    return img, launches


def mean_rel(img, ref):
    m, r = img.mean(axis=(0, 1)), ref.mean(axis=(0, 1))
    return float(np.max(np.abs(m - r) / np.abs(r))), m


def active_fraction(torch, scene, options, spp):
    """Queries on live lanes over queries launched (trace_query_counts),
    over `spp` samples of every pixel, in batches of <= 2^20 paths
    (take_tpu_torch/bench.py's count)."""
    from take_tpu_torch.bench import query_counts

    nom, act = query_counts(scene, options, spp)
    return act / nom


def wavefront_active_fraction(torch, scene, options):
    """Queries on occupied lanes over queries launched by the refill loop
    (trace_wavefront's counts) over one pass of the render: its first
    max_rays_per_pass paths, pixel-major as render_pass lays them out."""
    from take_tpu_torch.integrator.wavefront import trace_wavefront

    cam = scene.meta.camera
    n_pix = cam.width * cam.height
    k = max(1, min(options.spp, options.max_rays_per_pass // n_pix))
    rows = max(1, options.max_rays_per_pass // (cam.width * k))
    pix = torch.arange(min(rows * cam.width, n_pix), dtype=torch.int32, device=scene.background.device)
    samp = torch.arange(k, dtype=torch.int32, device=pix.device)
    with torch.inference_mode():
        _, nom, act = trace_wavefront(scene, options, pix.repeat_interleave(k), samp.repeat(pix.shape[0]),
                                      cam.width, with_counts=True)
    return act / nom


def timed_render(torch, render_image, scene, options):
    """(seconds, Mrays/s) of a render by bench.py's metric:
    rays = W * H * spp * (1 + 2 (max_depth + 1))."""
    cam = scene.meta.camera
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_image(scene, options)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rays = cam.width * cam.height * options.spp * (1 + 2 * (options.max_depth + 1))
    return dt, rays / dt / 1e6


def cbox_cell(torch, dev, out_dir):
    """cbox: K1/K2 parity, the 1024x1024 render through K1/K2 alone, the
    256x256 kernels-vs-twins check, times, and K1/K2 on the batches of one
    pass. Returns the kernels' entries, the render's launches, its image and
    its time in seconds."""
    from take_tpu_torch.geometry import _launch, brute
    from take_tpu_torch.io.exr import write_exr
    from take_tpu_torch.render import eager, render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    scene = with_res(parse_scene_file(str(SCENE), device=dev), RES)
    rays, dead = make_rays(torch, scene, np.random.default_rng(SEED), N_RAYS,
                           np.array([1.0, 1.0, 1.0]), np.array([555.0, 547.0, 558.0]))
    err_closest, err_anyhit = cbox_parity(torch, brute, scene, rays, dead)

    options = RenderOptions(spp=SPP, max_depth=MAX_DEPTH, seed=SEED)
    img, launches = render_counted(torch, _launch, render_image, scene, options,
                                   ("closest", "anyhit"), "cbox main path")
    phase("main", f"render {RES}x{RES} {SPP} spp d{MAX_DEPTH}: shape {img.shape}, "
          f"mean {img.mean(axis=(0, 1)).tolist()}, launches {launches}")
    if img.shape != (RES, RES, 3):
        raise RuntimeError("main-path image has the wrong shape")
    out = out_dir / "cbox_1024.exr"
    write_exr(str(out), img)

    small = with_res(scene, 256)
    img_k = render_image(small, options)
    with mock.patch.object(brute, "closest", brute.closest_plain), \
            mock.patch.object(brute, "occluded", brute.occluded_plain), eager():
        img_p = render_image(small, options)
    torch.cuda.synchronize()
    rel, mk = mean_rel(img_k, img_p)
    phase("main", f"256x256 kernels vs plain twins on the card: means {mk.tolist()} vs "
          f"{img_p.mean(axis=(0, 1)).tolist()}, max rel {rel:.3e} (limit {MEAN_REL}); "
          f"wrote {out.relative_to(ROOT)}")
    if not np.isfinite(img_p).all() or rel > MEAN_REL:
        raise RuntimeError("kernel render disagrees with the plain-twin render")

    dt, mrays = timed_render(torch, render_image, scene, options)
    af = active_fraction(torch, scene, options, 2)
    g, n_tri = scene.geometry, scene.meta.n_tri
    args_c = (g.tri_rows, g.tri_attr, n_tri, *rays)
    args_o = (g.tri_rows, n_tri, *rays)
    ms = {
        "closest": time_call(torch, lambda: brute.closest(*args_c)),
        "closest_plain": time_call(torch, lambda: brute.closest_plain(*args_c)),
        "anyhit": time_call(torch, lambda: brute.occluded(*args_o)),
        "anyhit_plain": time_call(torch, lambda: brute.occluded_plain(*args_o)),
    }
    bounds = brute_bounds(torch, scene, rays)
    phase("times", f"cbox render {dt:.4f} s = {mrays:.3f} Mrays/s; active_fraction {af:.6f}; "
          f"per call at N={N_RAYS}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + "; bounds " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]}, {v[2]})" for k, v in bounds.items()))
    passes = brute_captured(torch, brute, scene, capture_queries(torch, scene, options),
                            f"cbox {RES}x{RES} d{MAX_DEPTH}")
    return [
        dict(name=key, route="cuda", source="take_tpu_torch/csrc/brute.cu",
             replaces=f"take_tpu/geometry/pallas_brute.py:{line}", launches=launches[key],
             max_abs_err=err, ms=ms[key], plain_ms=ms[f"{key}_plain"],
             bound_ms=bounds[key][0], bound_by=bounds[key][1], library_ms=None,
             cbox_pass_ms=passes[key][0], cbox_pass_bound_ms=passes[key][1])
        for key, line, err in (("closest", 77, err_closest), ("anyhit", 129, err_anyhit))
    ], launches, img, dt


def brute_bounds(torch, scene, rays):
    """K1 and K2's bounds on these rays: K1 tests every triangle for each
    live ray and writes (t, u, v, prim) and the winner's attribute row; K2
    tests, for each live ray, the triangles up to its first hit in index
    order (all of them when none hits) and writes one byte. Both read the
    rays and their triangle tables once. Returns {kernel: (ms, by, what)}."""
    from take_tpu_torch.geometry.brute import tri_uvt

    g, n_tri = scene.geometry, scene.meta.n_tri
    ro, rd, tmin, tmax = rays
    n, live = ro.shape[0], int((tmax >= tmin).sum())
    tests = 0
    for s in range(0, n, 1 << 16):
        sl = slice(s, s + (1 << 16))
        ok = tri_uvt(g.tri_rows, n_tri, ro[sl], rd[sl], tmin[sl], tmax[sl])[3]
        first = torch.where(ok.any(1), ok.to(torch.int8).argmax(1) + 1, n_tri)
        tests += int(torch.where(tmax[sl] >= tmin[sl], first, 0).sum())
    tables = g.tri_rows.nbytes
    return {
        "closest": (*bound(n * (RAY_BYTES + HIT_BYTES + ATTR_BYTES) + tables + g.tri_attr.nbytes,
                           live * n_tri * TRI_FLOPS), f"{live} live rays x {n_tri} triangles"),
        "anyhit": (*bound(n * (RAY_BYTES + OCC_BYTES) + tables, tests * TRI_FLOPS),
                   f"{tests / max(live, 1):.2f} triangles per live ray"),
    }


def brute_captured(torch, brute, scene, calls, label):
    """K1/K2 on the batches captured from one pass of a render: each held
    against its plain twin by closest_gate / anyhit_gate (the attribute rows
    of agreeing hits equal), timed (CUDA events, 10 calls after 3 warm-ups)
    and bounded by brute_bounds on that batch. Returns {kind: [kernel ms,
    bound ms]} summed over the pass."""
    g, n_tri = scene.geometry, scene.meta.n_tri
    sums = {"closest": [0.0, 0.0], "anyhit": [0.0, 0.0]}
    rows = []
    for j, (kind, rays) in enumerate(calls):
        dead = rays[3] <= 0
        if kind == "closest":
            def fn():
                return brute.closest(g.tri_rows, g.tri_attr, n_tri, *rays)
            a_k, t_k, u_k, v_k, _, p_k = fn()
            a_p, t_p, u_p, v_p, _, p_p = brute.closest_plain(g.tri_rows, g.tri_attr, n_tri, *rays)
            torch.cuda.synchronize()
            _, both, _ = closest_gate(torch, f"{label} batch {j} K1", scene, (t_k, u_k, v_k, p_k),
                                      (t_p, u_p, v_p, p_p), rays, dead)
            if not torch.equal(a_k[both], a_p[both]):
                raise RuntimeError(f"{label} batch {j}: K1's attribute rows disagree with closest_plain's")
            note = f"{int((p_k >= 0).sum())} hits"
        else:
            def fn():
                return brute.occluded(g.tri_rows, n_tri, *rays)
            o_k = fn()
            o_p = brute.occluded_plain(g.tri_rows, n_tri, *rays)
            torch.cuda.synchronize()
            anyhit_gate(torch, f"{label} batch {j} K2", scene, o_k, o_p, rays, dead)
            note = f"{int(o_k.sum())} occluded"
            n_inf = int(torch.isinf(rays[3]).sum())
            if n_inf:  # shadow rays toward an environment map: also bit for bit the reference kernel's
                if not torch.equal(o_k, brute.reference(g.tri_rows, g.tri_attr, n_tri, *rays, any_hit=True)):
                    raise RuntimeError(f"{label} batch {j}: K2 differs from the reference kernel")
                note += f", {n_inf} lanes of tmax = +inf (K2 equal to brute.reference)"
        ms = time_call(torch, fn, iters=10)
        b_ms, by, what = brute_bounds(torch, scene, rays)[kind]
        sums[kind][0] += ms
        sums[kind][1] += b_ms
        rows.append(f"{j}:{kind} n={rays[0].shape[0]} live {(rays[3] > 0).float().mean().item():.3f} {note} "
                    f"{ms:.4f} ms (bound {b_ms:.4f} ms, {by}, {what})")
    phase("times", f"{label} K1/K2 on the captured batches of one pass, each within the twin gates: "
          + "; ".join(rows) + "; per pass "
          + ", ".join(f"{k} {v[0]:.4f} ms (bound {v[1]:.4f} ms)" for k, v in sums.items()))
    return sums


def room_cell(torch, dev, out_dir):
    """room: build, K3/K4/K5/K6 parity, the 1920x1080 renders through K3
    alone, through K6 (FORCE_SWEEP) with K3's any hit and through K4/K5
    (FORCE_CLUSTER), the 192x108 four-way check, times, and the captured
    batches of one pass of K3 and of K4/K5. Returns the kernels' entries,
    the render's launches and the room scene."""
    from take_tpu_torch.geometry import _launch, cluster, packet, sweep, traverse
    from take_tpu_torch.geometry import bvh as bvh_build
    from take_tpu_torch.scene.types import scene_from_numpy
    from take_tpu_torch.io.exr import write_exr
    from take_tpu_torch.render import eager, render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    t0 = time.perf_counter()
    builder = parse_scene_file(str(ROOM), build=False)
    t_parse = time.perf_counter() - t0
    bvh_s = []
    build_bvh = bvh_build.build_bvh

    def timed_bvh(*a):
        t = time.perf_counter()
        out = build_bvh(*a)
        bvh_s.append(time.perf_counter() - t)
        return out

    t0 = time.perf_counter()
    with mock.patch.object(bvh_build, "build_bvh", timed_bvh):
        tables, meta = builder.build_tables()
    t_tables = time.perf_counter() - t0
    t0 = time.perf_counter()
    room = scene_from_numpy(tables, meta, dev)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    bvh = room.bvh
    groups = (room.geometry, room.materials, room.lights, room.textures)
    tensors = [getattr(grp, f.name) for grp in groups for f in dataclasses.fields(grp) if f.compare]
    table_bytes = sum(x.nbytes for x in tensors if x.is_cuda)
    host_bytes = sum(x.nbytes for x in tensors if not x.is_cuda)
    bvh_bytes = sum(getattr(bvh, n).nbytes for n in ("node_min", "node_max", "node_child", "node_count",
                                                       "cl_aabb", "sup_aabb", "nodes", "tris", "qnodes"))
    need, have = packet.entry_bound(bvh.depth), packet._lib().tt_packet_stack_size()
    phase("room build", f"{meta.n_tri} triangles, {meta.n_lights} lights: parse {t_parse:.2f} s, "
          f"BVH build {bvh_s[0]:.2f} s (tables {t_tables:.2f} s in all), upload + kernel layout "
          f"{t_upload:.2f} s; {bvh.node_child.shape[0]} nodes ({bvh.qnodes.nbytes / 2**20:.3f} MiB quantised, "
          f"{bvh.nodes.nbytes / 2**20:.3f} MiB exact), wide depth {bvh.depth}, stack of {need} (base, mask) "
          f"entries of the kernel's {have} (the twin's per-node stack: {packet.stack_bound(bvh.depth)}); "
          f"{bvh.cl_aabb.shape[0]} clusters, {bvh.sup_aabb.shape[0]} superclusters; on the card "
          f"{table_bytes / 2**20:.2f} MiB of scene tables + {bvh_bytes / 2**20:.2f} MiB of BVH tables; "
          f"kept on the host {host_bytes / 2**20:.2f} MiB (geometry.tri_sweep, which K4/K5 no longer read: "
          f"{(table_bytes + host_bytes) / 2**20:.2f} MiB of scene tables on the card when they did)")
    if need > have:
        raise RuntimeError("room's BVH does not fit the kernel's stack")

    lo = bvh.node_min[0].amin(dim=0).cpu().numpy().astype(np.float64)
    hi = bvh.node_max[0].amax(dim=0).cpu().numpy().astype(np.float64)
    pad = 0.02 * (hi - lo)
    rays, dead = make_rays(torch, room, np.random.default_rng(SEED), N_RAYS, lo + pad, hi - pad)
    t0 = time.perf_counter()
    errs = room_parity(torch, packet, cluster, sweep, room, rays, dead)
    t_parity = time.perf_counter() - t0

    room_opts = RenderOptions(spp=ROOM_SPP, max_depth=ROOM_DEPTH, seed=SEED)
    cam = room.meta.camera
    img, launches_room = render_counted(torch, _launch, render_image, room, room_opts,
                                        ("packet_closest", "packet_anyhit"), "room main path")
    if img.shape != (cam.height, cam.width, 3) or not img.mean() > 0:
        raise RuntimeError(f"room image has shape {img.shape} and mean {img.mean()}")
    out = out_dir / f"room_{cam.width}x{cam.height}.exr"
    write_exr(str(out), img)
    phase("main", f"room {cam.width}x{cam.height} {ROOM_SPP} spp d{ROOM_DEPTH}: shape {img.shape}, "
          f"mean {img.mean(axis=(0, 1)).tolist()}, launches {launches_room}; wrote {out.relative_to(ROOT)}")
    with mock.patch.object(traverse, "FORCE_SWEEP", True):
        img_s, launches_sweep = render_counted(torch, _launch, render_image, room, room_opts,
                                               ("sweep_closest", "packet_anyhit"), "room K6 path")
    rel_s, _ = mean_rel(img_s, img)
    phase("main", f"room {cam.width}x{cam.height} {ROOM_SPP} spp d{ROOM_DEPTH} under FORCE_SWEEP: mean "
          f"{img_s.mean(axis=(0, 1)).tolist()}, max rel vs the K3 route {rel_s:.3e}, launches {launches_sweep}")
    if rel_s > MEAN_REL:
        raise RuntimeError("room K6 render disagrees with the K3 render")
    with mock.patch.object(traverse, "FORCE_CLUSTER", True):
        img_c, launches_cluster = render_counted(torch, _launch, render_image, room, room_opts,
                                                 ("cluster_closest", "cluster_anyhit"), "room K4/K5 path")
    rel_c, _ = mean_rel(img_c, img)
    phase("main", f"room {cam.width}x{cam.height} {ROOM_SPP} spp d{ROOM_DEPTH} under FORCE_CLUSTER: mean "
          f"{img_c.mean(axis=(0, 1)).tolist()}, max rel vs the K3 route {rel_c:.3e}, launches {launches_cluster}")
    if rel_c > MEAN_REL:
        raise RuntimeError("room K4/K5 render disagrees with the K3 render")

    small = with_res(room, *ROOM_SMALL)
    img_k, _ = render_counted(torch, _launch, render_image, small, room_opts,
                              ("packet_closest", "packet_anyhit"), "room K3 render")
    with mock.patch.object(traverse, "FORCE_CLUSTER", True):
        img_c, _ = render_counted(torch, _launch, render_image, small, room_opts,
                                  ("cluster_closest", "cluster_anyhit"), "room K4/K5 render")
    with mock.patch.object(traverse, "FORCE_SWEEP", True):
        img_6, _ = render_counted(torch, _launch, render_image, small, room_opts,
                                  ("sweep_closest", "packet_anyhit"), "room K6 render")
    with mock.patch.object(packet, "closest", lambda b, *r: packet.packet_plain(b, *r)), \
            mock.patch.object(packet, "occluded", lambda b, *r: packet.packet_plain(b, *r, any_hit=True)), eager():
        img_p, _ = render_counted(torch, _launch, render_image, small, room_opts,
                                  ("packet_closest_plain", "packet_anyhit_plain"), "room twin render")
    rel = {k: mean_rel(im, img_p) for k, im in (("K3", img_k), ("K4/K5", img_c), ("K6", img_6))}
    phase("main", f"room {ROOM_SMALL[0]}x{ROOM_SMALL[1]} {ROOM_SPP} spp d{ROOM_DEPTH} means: "
          + ", ".join(f"{k} {v[1].tolist()}" for k, v in rel.items())
          + f", plain twins {img_p.mean(axis=(0, 1)).tolist()}; max rel vs "
          f"twins " + ", ".join(f"{k} {v[0]:.3e}" for k, v in rel.items()) + f" (limit {MEAN_REL})")
    if any(v[0] > MEAN_REL for v in rel.values()):
        raise RuntimeError("room kernel renders disagree with the plain-twin render")

    dt_room, mrays_room = timed_render(torch, render_image, room, room_opts)
    with mock.patch.object(traverse, "FORCE_SWEEP", True):
        dt_sweep, mrays_sweep = timed_render(torch, render_image, room, room_opts)
    with mock.patch.object(traverse, "FORCE_CLUSTER", True):
        dt_cluster, mrays_cluster = timed_render(torch, render_image, room, room_opts)
    af_room = active_fraction(torch, room, room_opts, 1)
    sup, tris, cl, n_tri = bvh.sup_aabb, bvh.tris, bvh.cl_aabb, room.meta.n_tri
    ms = {
        "packet_closest": time_call(torch, lambda: packet.closest(bvh, *rays), iters=10),
        "packet_closest_plain": time_call(torch, lambda: packet.packet_plain(bvh, *rays), 1, 2),
        "packet_anyhit": time_call(torch, lambda: packet.occluded(bvh, *rays), iters=10),
        "packet_anyhit_plain": time_call(torch, lambda: packet.packet_plain(bvh, *rays, any_hit=True), 1, 2),
        "cluster_closest": time_call(torch, lambda: cluster.closest(sup, cl, tris, *rays), iters=10),
        "cluster_closest_plain": time_call(torch, lambda: cluster.cluster_plain(sup, tris, *rays), 1, 2),
        "cluster_anyhit": time_call(torch, lambda: cluster.occluded(sup, cl, tris, *rays), iters=10),
        "cluster_anyhit_plain": time_call(torch, lambda: cluster.cluster_plain(sup, tris, *rays, any_hit=True),
                                          1, 2),
        "sweep_closest": time_call(torch, lambda: sweep.closest(cl, tris, n_tri, *rays), iters=10),
        "sweep_closest_plain": time_call(torch, lambda: sweep.sweep_plain(cl, tris, n_tri, *rays), 1, 2),
        "sweep_anyhit": time_call(torch, lambda: sweep.occluded(cl, tris, n_tri, *rays), iters=10),
        "sweep_anyhit_plain": time_call(torch, lambda: sweep.sweep_plain(cl, tris, n_tri, *rays, any_hit=True),
                                        1, 2),
    }
    bounds = {kind: bvh_bound(torch, packet, bvh, rays, kind == "anyhit") for kind in ("closest", "anyhit")}
    work = {kind: cluster_counts(torch, cluster, bvh, rays, kind == "anyhit") for kind in ("closest", "anyhit")}
    work6 = {kind: sweep_counts(torch, sweep, room, rays, kind == "anyhit") for kind in ("closest", "anyhit")}
    phase("times", f"room render {dt_room:.4f} s = {mrays_room:.3f} Mrays/s, under FORCE_SWEEP "
          f"{dt_sweep:.4f} s = {mrays_sweep:.3f} Mrays/s, under FORCE_CLUSTER {dt_cluster:.4f} s = "
          f"{mrays_cluster:.3f} Mrays/s; active_fraction {af_room:.6f} (1 spp); parity "
          f"{t_parity:.1f} s; per call at N={N_RAYS}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + "; bound of the query (K3, K4/K5 and K6 alike) " + ", ".join(
              f"{k} {v[0]:.4f} ms ({v[1]}; per ray {v[2][0]:.2f} nodes {v[2][1]:.2f} slabs {v[2][2]:.2f} tris)"
              for k, v in bounds.items())
          + "; K4/K5 work per live ray " + ", ".join(
              f"{k} {v[0]:.3f} superclusters {v[1]:.3f} clusters {v[2]:.1f} triangle rows (the parent kernel "
              f"{v[3]:.0f})" for k, v in work.items())
          + "; K6 work per live ray " + ", ".join(
              f"{k} {v[0]:.1f} boxes walked {v[1]:.3f} clusters entered {v[2]:.1f} triangle rows (the parent "
              f"kernel's block-wide cull {v[3]:.0f})" for k, v in work6.items()))
    one_pass = dataclasses.replace(room_opts, spp=1)
    calls = capture_queries(torch, room, one_pass)
    captured_times(torch, packet, bvh, calls, f"room {cam.width}x{cam.height} d{ROOM_DEPTH}")
    passes, pass_work = cluster_captured(torch, cluster, packet, room,
                                         capture_queries(torch, room, one_pass, cluster_route=True),
                                         f"room {cam.width}x{cam.height} d{ROOM_DEPTH}")
    passes6, pass_work6 = sweep_captured(torch, sweep, packet, room,
                                         capture_queries(torch, room, one_pass, sweep_route=True),
                                         f"room {cam.width}x{cam.height} d{ROOM_DEPTH}")
    launches = {**launches_room, **launches_cluster, **launches_sweep, "sweep_anyhit": 0}
    entries = []
    for key, src, line in (
        ("packet_closest", "traverse.cu", "pallas_traverse.py:88"),
        ("packet_anyhit", "traverse.cu", "pallas_traverse.py:88"),
        ("cluster_closest", "cluster.cu", "pallas_cluster.py:200"),
        ("cluster_anyhit", "cluster.cu", "pallas_cluster.py:263"),
        ("sweep_closest", "sweep.cu", "pallas_sweep.py:69"),
        ("sweep_anyhit", "sweep.cu", "pallas_sweep.py:69"),
    ):
        kind = "anyhit" if key.endswith("anyhit") else "closest"
        b_ms, by, _ = bounds[kind]
        entries.append(dict(name=key, route="cuda", source=f"take_tpu_torch/csrc/{src}",
                            replaces=f"take_tpu/geometry/{line}", launches=launches[key],
                            max_abs_err=errs[key], ms=ms[key], plain_ms=ms[f"{key}_plain"],
                            bound_ms=b_ms, bound_by=by, library_ms=None))
        if key.startswith("cluster"):  # K4/K5: the FORCE_CLUSTER render is their path
            names = ("superclusters", "clusters", "triangle_rows", "parent_rows")
            entries[-1].update(work_per_live_ray=dict(zip(names, work[kind])),
                               room_pass_ms=passes[kind][0], room_pass_bound_ms=passes[kind][1],
                               room_pass_work_per_live_ray=dict(zip(names, pass_work[kind])),
                               force_cluster_render_s=dt_cluster)
        if key.startswith("sweep"):  # K6: the FORCE_SWEEP render is its closest hits' path
            names = ("boxes_walked", "clusters", "triangle_rows", "parent_rows")
            entries[-1].update(work_per_live_ray=dict(zip(names, work6[kind])),
                               room_pass_ms=passes6[kind][0], room_pass_bound_ms=passes6[kind][1],
                               room_pass_work_per_live_ray=dict(zip(names, pass_work6[kind])),
                               force_sweep_render_s=dt_sweep)
    return entries, launches_room, room


def mis_cell(torch, dev, out_dir):
    """mis (blinn_microfacet plates, sphere lights; the brute path): the
    published 512x512, 128 spp, d6 render through K1/K2 alone, the 128x128
    kernels-vs-twins check, times, and K1/K2 on the batches of one pass.
    Returns (launches, per-pass sums of brute_captured, the image)."""
    from take_tpu_torch.geometry import _launch, brute
    from take_tpu_torch.io.exr import write_exr
    from take_tpu_torch.render import eager, render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    scene = parse_scene_file(str(MIS), device=dev)
    cam = scene.meta.camera
    options = RenderOptions(spp=MIS_SPP, max_depth=MIS_DEPTH, seed=SEED)
    if scene.bvh is not None:
        raise RuntimeError("mis should take the brute path")
    img, launches = render_counted(torch, _launch, render_image, scene, options,
                                   ("closest", "anyhit"), "mis main path")
    if img.shape != (cam.height, cam.width, 3) or not img.mean() > 0:
        raise RuntimeError(f"mis image has shape {img.shape} and mean {img.mean()}")
    out = out_dir / f"mis_{cam.width}.exr"
    write_exr(str(out), img)
    phase("main", f"mis {cam.width}x{cam.height} {MIS_SPP} spp d{MIS_DEPTH}: mean "
          f"{img.mean(axis=(0, 1)).tolist()}, launches {launches}; wrote {out.relative_to(ROOT)}")
    small = with_res(scene, MIS_SMALL)
    img_k = render_image(small, options)
    with mock.patch.object(brute, "closest", brute.closest_plain), \
            mock.patch.object(brute, "occluded", brute.occluded_plain), eager():
        img_p, _ = render_counted(torch, _launch, render_image, small, options,
                                  ("closest_plain", "anyhit_plain"), "mis twin render")
    rel, mk = mean_rel(img_k, img_p)
    phase("main", f"mis {MIS_SMALL}x{MIS_SMALL} kernels vs plain twins: means {mk.tolist()} vs "
          f"{img_p.mean(axis=(0, 1)).tolist()}, max rel {rel:.3e} (limit {MEAN_REL})")
    if rel > MEAN_REL:
        raise RuntimeError("mis kernel render disagrees with the plain-twin render")
    dt, mrays = timed_render(torch, render_image, scene, options)
    af = active_fraction(torch, scene, options, 1)
    phase("times", f"mis render {dt:.4f} s = {mrays:.3f} Mrays/s; active_fraction {af:.6f} (1 spp)")
    passes = brute_captured(torch, brute, scene, capture_queries(torch, scene, options),
                            f"mis {cam.width}x{cam.height} d{MIS_DEPTH}")
    return launches, passes, img


def textured_cell(torch, dev, out_dir):
    """textured (an open BVH scene, image texture): the published 512x512,
    64 spp, d6 render with the default loop (the scan loop) through K3
    alone; a reduced-resolution check of the refill loop against it; the
    K3-vs-twins check; times of both loops. Returns the launches and the
    image."""
    from take_tpu_torch.geometry import _launch, packet
    from take_tpu_torch.io.exr import write_exr
    from take_tpu_torch.render import eager, render_image, use_wavefront_policy
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    scene = parse_scene_file(str(TEXTURED), device=dev)
    cam = scene.meta.camera
    options = RenderOptions(spp=TEX_SPP, max_depth=TEX_DEPTH, seed=SEED)
    refill = dataclasses.replace(options, integrator="mis_wavefront")
    if use_wavefront_policy(scene, options) or not use_wavefront_policy(scene, refill):
        raise RuntimeError("the default loop should be the scan loop, and mis_wavefront the refill loop")
    img, launches = render_counted(torch, _launch, render_image, scene, options,
                                   ("packet_closest", "packet_anyhit"), "textured main path")
    if img.shape != (cam.height, cam.width, 3) or not img.mean() > 0:
        raise RuntimeError(f"textured: image {img.shape}, mean {img.mean()}")
    out = out_dir / f"textured_{cam.width}.exr"
    write_exr(str(out), img)
    phase("main", f"textured {cam.width}x{cam.height} {TEX_SPP} spp d{TEX_DEPTH} through the scan loop: mean "
          f"{img.mean(axis=(0, 1)).tolist()}, launches {launches}; wrote {out.relative_to(ROOT)}")
    small = with_res(scene, TEX_SMALL)
    img_s = render_image(small, options)
    img_w = render_image(small, refill)
    rel, mw = mean_rel(img_w, img_s)
    phase("main", f"textured {TEX_SMALL}x{TEX_SMALL} refill loop vs scan loop: means {mw.tolist()} vs "
          f"{img_s.mean(axis=(0, 1)).tolist()}, max rel {rel:.3e} (limit {MEAN_REL})")
    if not np.isfinite(img_w).all() or rel > MEAN_REL:
        raise RuntimeError("the refill loop disagrees with the scan loop")
    tiny = with_res(scene, TEX_TWIN)
    img_k, _ = render_counted(torch, _launch, render_image, tiny, options,
                              ("packet_closest", "packet_anyhit"), "textured K3 render")
    with mock.patch.object(packet, "closest", lambda b, *r: packet.packet_plain(b, *r)), \
            mock.patch.object(packet, "occluded", lambda b, *r: packet.packet_plain(b, *r, any_hit=True)), eager():
        img_p, _ = render_counted(torch, _launch, render_image, tiny, options,
                                  ("packet_closest_plain", "packet_anyhit_plain"), "textured twin render")
    rel, mk = mean_rel(img_k, img_p)
    phase("main", f"textured {TEX_TWIN}x{TEX_TWIN} K3 vs plain twins: means {mk.tolist()} vs "
          f"{img_p.mean(axis=(0, 1)).tolist()}, max rel {rel:.3e} (limit {MEAN_REL})")
    if rel > MEAN_REL:
        raise RuntimeError("textured kernel render disagrees with the plain-twin render")
    dt, mrays = timed_render(torch, render_image, scene, options)
    dt_w, mrays_w = timed_render(torch, render_image, scene, refill)
    phase("times", f"textured render {dt:.4f} s = {mrays:.3f} Mrays/s (scan loop), active_fraction "
          f"{active_fraction(torch, scene, options, 1):.6f} (1 spp); refill loop {dt_w:.4f} s = {mrays_w:.3f} "
          f"Mrays/s, active_fraction {wavefront_active_fraction(torch, scene, refill):.6f} (one pass)")
    calls = capture_queries(torch, scene, options)
    captured_times(torch, packet, scene.bvh, calls, f"textured {cam.width}x{cam.height} d{TEX_DEPTH}")
    return launches, img


def azimuth_env_scene(dev, rho=0.6, w=32, h=16, seed=5):
    """tests/test_ibl_analytic.py's scene on the port: a diffuse floor of
    albedo rho under an environment whose texels depend on the azimuth
    alone, seen from above at 8x8. Its exact radiance is rho * mean(texels)
    at every pixel. Returns (scene, expected)."""
    from take_tpu_torch.core.camera import Camera
    from take_tpu_torch.lights.envmap import build_envmap
    from take_tpu_torch.scene.build import SceneBuilder
    from take_tpu_torch.scene.types import MAT_DIFFUSE

    col = np.random.default_rng(seed).uniform(0.2, 2.0, (1, w, 1)).astype(np.float32)
    b = SceneBuilder()
    b.camera = Camera(8, 8, (0.0, 3.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 45.0)
    m = b.add_material(MAT_DIFFUSE, tex_value=(rho,) * 3)
    s = 50.0
    verts = np.array([[-s, 0.0, -s], [s, 0.0, -s], [s, 0.0, s], [-s, 0.0, s]], np.float32)
    b.add_mesh(verts, np.array([[0, 2, 1], [0, 3, 2]]), m)
    b.envmap = build_envmap(np.broadcast_to(col, (h, w, 3)).copy())
    return b.build(device=dev), rho * float(col.mean())


def cross_integrators(scene):
    """tests/test_ibl_analytic.py::test_ibl_scene_cross_integrator_agreement
    on the port: ibl has no golden image (the reference renderer has no
    environment light), so three estimators that share no weighting code
    are held to each other on the real map at 96x96, d4, seed 11: mis at 128
    spp, one-sample MIS at 128 and raw at 256; image means within 3%, and
    the 95th percentile of 8x8 block means within 10% (of mis + 0.05)."""
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.types import RenderOptions

    small = with_res(scene, 96)
    imgs = {integ: render_image(small, RenderOptions(spp=spp, max_depth=4, seed=11, integrator=integ))
            for integ, spp in (("mis", 128), ("one_sample_mis", 128), ("raw", 256))}
    m = imgs["mis"]
    b = m.shape[0] // 8
    mb = m[: 8 * b, : 8 * b].reshape(8, b, 8, b, 3).mean((1, 3)).sum(-1)
    rows, ok = [], True
    for other in ("one_sample_mis", "raw"):
        o = imgs[other]
        rel = float(np.max(np.abs(o.mean(axis=(0, 1)) / m.mean(axis=(0, 1)) - 1.0)))
        ob = o[: 8 * b, : 8 * b].reshape(8, b, 8, b, 3).mean((1, 3)).sum(-1)
        q95 = float(np.quantile(np.abs(ob - mb) / (mb + 0.05), 0.95))
        rows.append(f"{other} vs mis: means rel {rel:.3e} (limit 0.03), block q95 {q95:.3e} (limit 0.1)")
        ok = ok and np.isfinite(o).all() and rel <= 0.03 and q95 < 0.1
    phase("main", "ibl 96x96 d4 across integrators on the real map: " + "; ".join(rows))
    if not ok:
        raise RuntimeError("ibl: the integrators disagree on the real map")


def ibl_cell(torch, dev, out_dir):
    """ibl (an environment map, Disney metal and composite, 2 triangles and
    3 spheres; the brute path): parse with the alias-table build timed, the
    published 1024x1024, d6 render through K1/K2 alone, at 128x128 the
    kernels against the twins and the scan loop against the refill loop,
    the closed-form azimuth environment for three integrators, times, and
    K1/K2 on the batches of one pass (their shadow rays toward the map have
    tmax = +inf). Returns (launches, per-pass sums of brute_captured)."""
    from take_tpu_torch.geometry import _launch, brute
    from take_tpu_torch.io.exr import write_exr
    from take_tpu_torch.lights import envmap
    from take_tpu_torch.render import eager, render_image, use_wavefront_policy
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    alias_s = []
    build_alias_table = envmap.build_alias_table

    def timed_alias(*a):
        t = time.perf_counter()
        out = build_alias_table(*a)
        alias_s.append(time.perf_counter() - t)
        return out

    t0 = time.perf_counter()
    with mock.patch.object(envmap, "build_alias_table", timed_alias):
        builder = parse_scene_file(str(IBL), build=False)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = builder.build(device=dev)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    env, meta, cam = scene.envmap, scene.meta, scene.meta.camera
    env_bytes = sum(getattr(env, f.name).nbytes for f in dataclasses.fields(env))
    phase("ibl build", f"{meta.n_tri} triangles, {meta.n_sph} spheres, materials {meta.used_material_tags}, "
          f"{meta.n_lights} lights; envmap {tuple(env.data.shape)}: parse {t_parse:.2f} s of which the alias "
          f"table over {env.alias_prob.numel()} texels {alias_s[0]:.2f} s (a Python loop); upload {t_upload:.2f} s; "
          f"{env_bytes / 2**20:.2f} MiB of envmap tables on the card")
    if scene.bvh is not None or not meta.has_envmap or meta.n_lights:
        raise RuntimeError("ibl should take the brute path with an envmap and no other light")

    options = RenderOptions(spp=IBL_SPP, max_depth=IBL_DEPTH, seed=SEED)
    if use_wavefront_policy(scene, options):
        raise RuntimeError("the default loop should be the scan loop")
    img, launches = render_counted(torch, _launch, render_image, scene, options, ("closest", "anyhit"),
                                   "ibl main path")
    if img.shape != (cam.height, cam.width, 3) or not img.mean() > 0:
        raise RuntimeError(f"ibl image has shape {img.shape} and mean {img.mean()}")
    out = out_dir / f"ibl_{cam.width}.exr"
    write_exr(str(out), img)
    phase("main", f"ibl {cam.width}x{cam.height} {IBL_SPP} spp d{IBL_DEPTH} (reduced: {IBL_SPP} of the published "
          f"256 spp) through the scan loop: mean {img.mean(axis=(0, 1)).tolist()}, "
          f"launches {launches}; wrote {out.relative_to(ROOT)}")

    small = with_res(scene, IBL_SMALL)
    img_k = render_image(small, options)
    with mock.patch.object(brute, "closest", brute.closest_plain), \
            mock.patch.object(brute, "occluded", brute.occluded_plain), eager():
        img_p, _ = render_counted(torch, _launch, render_image, small, options,
                                  ("closest_plain", "anyhit_plain"), "ibl twin render")
    rel, mk = mean_rel(img_k, img_p)
    phase("main", f"ibl {IBL_SMALL}x{IBL_SMALL} kernels vs plain twins: means {mk.tolist()} vs "
          f"{img_p.mean(axis=(0, 1)).tolist()}, max rel {rel:.3e} (limit {MEAN_REL})")
    if rel > MEAN_REL:
        raise RuntimeError("ibl kernel render disagrees with the plain-twin render")
    img_w = render_image(small, dataclasses.replace(options, integrator="mis_wavefront"))
    phase("main", f"ibl {IBL_SMALL}x{IBL_SMALL} scan loop vs refill loop (no Russian roulette): bit-equal "
          f"{np.array_equal(img_k, img_w)}, max abs diff {np.abs(img_k - img_w).max():.3e}")
    if not np.array_equal(img_k, img_w):
        raise RuntimeError("the scan and refill loops differ on ibl without Russian roulette")

    az, expected = azimuth_env_scene(dev)
    rows = []
    for integrator, (spp, rtol) in AZIMUTH.items():
        img_a = render_image(az, RenderOptions(spp=spp, max_depth=3, seed=7, integrator=integrator))
        err = abs(float(img_a.mean()) / expected - 1.0)
        pix = float(np.abs(img_a.mean(axis=2) / expected - 1.0).max())
        rows.append(f"{integrator} {spp} spp: mean {img_a.mean():.6f} (rel {err:.2e}, limit {rtol}), "
                    f"worst pixel rel {pix:.2e} (limit {5 * rtol})")
        if not np.isfinite(img_a).all() or err > rtol or pix > 5 * rtol:
            phase("main", "; ".join(rows))
            raise RuntimeError(f"the azimuth environment's closed form fails under {integrator}")
    phase("main", f"azimuth environment, closed form {expected:.6f}: " + "; ".join(rows))
    cross_integrators(scene)

    dt, mrays = timed_render(torch, render_image, scene, options)
    af = active_fraction(torch, scene, options, 1)
    phase("times", f"ibl render {dt:.4f} s = {mrays:.3f} Mrays/s; active_fraction {af:.6f} (1 spp)")
    passes = brute_captured(torch, brute, scene, capture_queries(torch, scene, options),
                            f"ibl {cam.width}x{cam.height} d{IBL_DEPTH}")
    return launches, passes


def reference_phase(torch, dev, mis_img, tex_img, room):
    """The card's images at published specs against take_tpu's TPU renders
    of the same spec (benchmarks/out/*.exr), by run_configs' pixel_agreement
    and gates (each image rounded to half floats, as its EXR would hold it):
    the mis and textured cells' images, and new renders of cbox at 256x256,
    16 spp, d4 and of room at 1920x1080, REF_ROOM_SPP spp, d6, through the
    kernels alone. One line each; any miss raises."""
    from take_tpu_torch import run_configs
    from take_tpu_torch.geometry import _launch
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    cbox = with_res(parse_scene_file(str(SCENE), device=dev), 256)
    cbox_img, _ = render_counted(torch, _launch, render_image, cbox, RenderOptions(spp=16, max_depth=4, seed=SEED),
                                 ("closest", "anyhit"), "cbox 256x256 reference render")
    t0 = time.perf_counter()
    room_img, _ = render_counted(torch, _launch, render_image, room,
                                 RenderOptions(spp=REF_ROOM_SPP, max_depth=ROOM_DEPTH, seed=SEED),
                                 ("packet_closest", "packet_anyhit"), "room reference render")
    t_room = time.perf_counter() - t0
    misses = []
    for name, img in (("cbox_256_16spp", cbox_img), ("mis_512_128spp", mis_img),
                      ("textured_512_64spp", tex_img), (f"room_1080p_{REF_ROOM_SPP}spp", room_img)):
        path = run_configs.TAKE_TPU_OUT / f"{name}.exr"
        agreement = run_configs.pixel_agreement(img.astype(np.float16), run_configs.read_reference(path, img.shape))
        miss = run_configs.agreement_misses(name, agreement)
        phase("reference", f"{name} on the card vs {path.relative_to(ROOT)} (take_tpu's TPU render): channel means "
              f"differ by {agreement['mean_rel']} (limit {run_configs.MEAN_REL}); {agreement['n_beyond']} of "
              f"{agreement['n_pixels']} pixels ({agreement['share_beyond']:.4%}) beyond {run_configs.PIXEL_REL} x "
              f"max(pixel, {run_configs.PIXEL_FLOOR}) (limit {run_configs.share_limit(name):.2%}); largest "
              f"difference {agreement['max_abs']:.4e} at {agreement['max_abs_pixel']}"
              + (f"; room rendered in {t_room:.2f} s" if name.startswith("room") else ""))
        misses += miss
    if misses:
        raise RuntimeError("the card's images disagree with take_tpu's: " + "; ".join(misses))


def table_grads_close(torch, label, got, want, tol, floor=0.0):
    """Every float table of two gradient Scenes: |got - want| within
    tol * max(the table's largest |want|, floor), and got exactly zero
    where want is. Returns the largest error over the scale."""
    from take_tpu_torch.scene.types import float_tables

    worst, got, want = 0.0, float_tables(got), float_tables(want)
    for key, w in want.items():
        g = got[key].to(w.device)
        if not torch.isfinite(g).all() or not torch.isfinite(w).all():
            raise RuntimeError(f"{label}: {key} has a non-finite gradient")
        scale = max(float(w.abs().max()), floor)
        if scale == 0.0:
            if g.any():
                raise RuntimeError(f"{label}: {key} is 0 in the reference, not here")
            continue
        err = float((g - w).abs().max()) / scale
        worst = max(worst, err)
        if err > tol:
            raise RuntimeError(f"{label}: {key} differs by {err:.3e} of its scale (limit {tol})")
    return worst


def textured_bvh_scene(dev):
    """tests/test_grad_textured_bvh.py's 16x16 scene (a textured floor, 120
    Disney triangles, an area light; BVH), built by the port from its seed."""
    from take_tpu_torch.core.camera import Camera
    from take_tpu_torch.scene.build import SceneBuilder
    from take_tpu_torch.scene.types import MAT_DIFFUSE, MAT_DISNEY_BSDF

    rng = np.random.default_rng(2)
    b = SceneBuilder()
    b.camera = Camera(16, 16, (0.0, 2.5, 6.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0), 45.0)
    tex_id = b.add_texture_image(rng.uniform(0.2, 0.9, (8, 8, 3)).astype(np.float32))
    m_floor = b.add_material(MAT_DIFFUSE, tex_image=tex_id, tex_kind=1)
    s = 6.0
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32)
    uvs = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
    b.add_mesh(verts, np.array([[0, 2, 1], [0, 3, 2]]), m_floor, uvs=uvs)
    m_disney = b.add_material(MAT_DISNEY_BSDF, tex_value=(0.6, 0.4, 0.3), roughness=0.5, metallic=0.3)
    centers = rng.uniform(-3, 3, (120, 3)) * np.array([1, 0.3, 1])
    centers[:, 1] += 0.8
    for c in centers:
        v = c + rng.uniform(-0.25, 0.25, (3, 3))
        b.add_mesh(v.astype(np.float32), np.array([[0, 1, 2]]), m_disney)
    m_l = b.add_material(MAT_DIFFUSE, tex_value=(0.0, 0.0, 0.0))
    lv = np.array([[-1, 4, -1], [1, 4, -1], [1, 4, 1], [-1, 4, 1]], np.float32)
    b.add_mesh(lv, np.array([[0, 1, 2], [0, 2, 3]]), m_l, emission=(20.0, 20.0, 20.0))
    return b.build(device=dev, build_bvh=True)


def scalar_grad_and_fd(torch, f, eps):
    """(d f / d d at 0 by autograd, central FD of f with step eps)."""
    d = torch.zeros((), device=DEVICE, requires_grad=True)
    f(d).backward()
    with torch.no_grad():
        fd = (float(f(torch.tensor(eps, device=DEVICE))) - float(f(torch.tensor(-eps, device=DEVICE)))) / (2 * eps)
    return float(d.grad), fd


def grad_parity(torch, scene, red):
    """The card-side gradient checks at 64x64 (through K1/K2 unless
    patched): per-table gradients through the kernels against the twins'
    and replay against AD; the red wall's albedo against central FD; the
    textured BVH scene's texel block through K3 against FD."""
    from take_tpu_torch import grad
    from take_tpu_torch.geometry import _launch, brute
    from take_tpu_torch.render import eager
    from take_tpu_torch.scene import edit
    from take_tpu_torch.scene.types import RenderOptions

    small = with_res(scene, GRAD_SMALL)
    n = GRAD_SMALL * GRAD_SMALL
    pix = torch.arange(n, dtype=torch.int32, device=DEVICE)
    target = torch.as_tensor(np.random.default_rng(SEED).uniform(0.0, 0.5, (n, 3)), dtype=torch.float32,
                             device=DEVICE)
    opts = RenderOptions(spp=1, max_depth=MAX_DEPTH, seed=SEED, grad_mode="ad")
    _launch.reset_launches()
    loss_k, g_k = grad.render_loss_grad(small, opts, pix, target, GRAD_SPP)
    torch.cuda.synchronize()
    launches = dict(_launch.LAUNCHES)
    if not (launches["closest"] and launches["anyhit"]) or launches["closest_plain"] or launches["anyhit_plain"]:
        raise RuntimeError(f"the 64x64 gradient did not run on K1/K2 alone: {launches}")
    with mock.patch.object(brute, "closest", brute.closest_plain), \
            mock.patch.object(brute, "occluded", brute.occluded_plain), eager():
        loss_p, g_p = grad.render_loss_grad(small, opts, pix, target, GRAD_SPP)
    err_twin = table_grads_close(torch, "kernels vs twins", g_k, g_p, GRAD_TABLE_TOL)
    loss_r, g_r = grad.render_loss_grad(small, dataclasses.replace(opts, grad_mode="replay"), pix, target, GRAD_SPP)
    err_replay = table_grads_close(torch, "replay vs AD", g_r, g_k, GRAD_REPLAY_TOL, floor=1.0)
    phase("grad", f"{GRAD_SMALL}x{GRAD_SMALL} {GRAD_SPP} samples d{MAX_DEPTH}: loss {float(loss_k):.6f} (twins "
          f"{float(loss_p):.6f}, replay {float(loss_r):.6f}); every table through K1/K2 ({launches['closest']} "
          f"K1, {launches['anyhit']} K2 launches) vs the twins within {err_twin:.3e} of its scale (limit "
          f"{GRAD_TABLE_TOL}); replay vs AD within {err_replay:.3e} (limit {GRAD_REPLAY_TOL})")

    base = small.materials.attr[red, 7:10]
    g, fd = scalar_grad_and_fd(torch, lambda d: grad.render_radiance(
        edit.with_material_reflectance(small, red, base + d), opts, pix, 0, GRAD_SPP).mean(), 3e-3)
    phase("grad", f"red wall albedo: autograd {g:.6e}, central FD {fd:.6e} (rtol {GRAD_FD_RTOL})")
    if not abs(g - fd) <= GRAD_FD_RTOL * abs(fd) + 1e-4 or abs(fd) < 1e-4:
        raise RuntimeError("the red wall's albedo gradient disagrees with FD")

    tex = textured_bvh_scene(DEVICE)
    tpix = torch.arange(16 * 16, dtype=torch.int32, device=DEVICE)
    mask = torch.zeros_like(tex.textures.data)
    mask[0, 2:6, 2:6, :] = 1.0
    topts = RenderOptions(spp=1, max_depth=3, seed=5)

    def f(d):
        t = dataclasses.replace(tex.textures, data=tex.textures.data + d * mask)
        return grad.render_radiance(dataclasses.replace(tex, textures=t), topts, tpix, 0, 96).mean()

    _launch.reset_launches()
    g_t, fd_t = scalar_grad_and_fd(torch, f, 5e-3)
    launches_t = {k: v for k, v in _launch.LAUNCHES.items() if v}
    phase("grad", f"textured BVH 16x16 texel block: autograd {g_t:.6e}, central FD {fd_t:.6e} (rtol 0.05; "
          f"launches {launches_t})")
    if set(launches_t) != {"packet_closest", "packet_anyhit"}:
        raise RuntimeError(f"the textured gradient did not run on K3 alone: {launches_t}")
    if fd_t <= 1e-4 or not abs(g_t - fd_t) <= 0.05 * abs(fd_t) + 1e-5:
        raise RuntimeError("the texel gradient through K3 disagrees with FD")


def grad_cell(torch, dev, out_dir, mis_img, mis_dt):
    """grad: the replay primal at 1024x1024 against the mis image, the
    card-side gradient checks, the inverse-rendering loop (Adam, 4 steps at
    1024x1024, 4 spp, d4, grad_mode "auto" = replay) and AD against replay on
    one pass of GRAD_AB_PATHS paths. Returns K1/K2's launches in one step."""
    from take_tpu_torch import grad
    from take_tpu_torch.geometry import _launch
    from take_tpu_torch.render import eager, render_image
    from take_tpu_torch.scene import edit
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions, float_tables

    scene = with_res(parse_scene_file(str(SCENE), device=dev), RES)
    options = RenderOptions(spp=SPP, max_depth=MAX_DEPTH, seed=SEED, integrator="mis_replay")
    img, launches = render_counted(torch, _launch, render_image, scene, options, ("closest", "anyhit"),
                                   "cbox mis_replay")
    with eager():
        img_e = render_image(scene, options)
    if not (np.array_equal(img, mis_img) and np.array_equal(img_e, mis_img)):
        raise RuntimeError("the mis_replay image (graph or eager) differs from the mis image")

    def eager_render(s, o):
        with eager():
            return render_image(s, o)

    secs = in_turns(torch, {"graph": render_image, "eager": eager_render}, scene, options)
    dt = float(np.median(secs["graph"]))
    phase("grad", f"mis_replay {RES}x{RES} {SPP} spp d{MAX_DEPTH} through K1/K2 alone ({launches}): graph and eager "
          f"images equal to the mis image bit for bit; in turns G E E G graph {secs['graph']} s, eager "
          f"{secs['eager']} s, graph/eager speed {float(np.median(secs['eager'])) / dt:.3f}x; graph "
          f"{RES * RES * SPP * (1 + 2 * (MAX_DEPTH + 1)) / dt / 1e6:.3f} Mrays/s (the scan loop {mis_dt:.4f} s)")

    red = red_material(scene)
    true_rgb = scene.materials.attr[red, 7:10].cpu().numpy().astype(np.float64)
    grad_parity(torch, scene, red)

    n = RES * RES
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    target_img = render_image(scene, RenderOptions(spp=GRAD_TARGET_SPP, max_depth=MAX_DEPTH, seed=3))
    target = torch.as_tensor(target_img[::-1].copy(), device=dev).reshape(n, 3)  # rows back to y order
    phase("grad", f"target {RES}x{RES} {GRAD_TARGET_SPP} spp at the true red wall {true_rgb.tolist()} and light "
          f"scale 1.0 in {time.perf_counter() - t0:.3f} s")

    def logit(x):
        return torch.tensor(np.log(x / (1.0 - x)), dtype=torch.float32, device=dev)

    wall = logit(np.full(3, 0.5)).requires_grad_(True)
    log_light = torch.tensor(np.log(0.5), dtype=torch.float32, device=dev).requires_grad_(True)
    opt = torch.optim.Adam([wall, log_light], lr=GRAD_LR)
    opts = RenderOptions(spp=GRAD_SPP, max_depth=MAX_DEPTH, seed=GRAD_SEED, grad_mode="auto")
    if grad.resolve_mode(opts, n * GRAD_SPP) != "replay":
        raise RuntimeError("grad_mode 'auto' did not pick replay at this size")

    def errors():
        with torch.no_grad():
            return (float(np.linalg.norm(torch.sigmoid(wall).cpu().numpy() - true_rgb)),
                    abs(float(torch.exp(log_light)) - 1.0))

    err0 = errors()
    losses, secs, step_launches = [], [], None
    torch.cuda.reset_peak_memory_stats()
    for step in range(GRAD_STEPS):
        opt.zero_grad()
        s = edit.with_material_reflectance(scene, red, torch.sigmoid(wall))
        s = edit.with_light_intensity_scale(s, torch.exp(log_light))
        torch.cuda.synchronize()
        _launch.reset_launches()
        t0 = time.perf_counter()
        loss, g = grad.render_loss_grad(s, opts, pix, target, GRAD_SPP, sample0=step * GRAD_SPP)
        grad.backward(s, g)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        step_launches = kernels_only(dict(_launch.LAUNCHES), ("closest", "anyhit"), f"gradient step {step}")
        bad = [k for k, v in float_tables(g).items() if not torch.isfinite(v).all()]
        if bad or not (torch.isfinite(wall.grad).all() and torch.isfinite(log_light.grad)):
            raise RuntimeError(f"gradient step {step}: non-finite gradients in {bad or 'the parameters'}")
        losses.append(float(loss))
        phase("grad", f"step {step}: loss {losses[-1]:.6e}, {secs[-1]:.4f} s, d/dwall_logit "
              f"{wall.grad.tolist()}, d/dlog_light {float(log_light.grad):.6e}, launches {step_launches}")
        opt.step()
    peak = torch.cuda.max_memory_allocated()
    err1 = errors()
    wall, log_light = wall.detach(), log_light.detach()
    phase("grad", f"inverse {RES}x{RES} {GRAD_SPP} spp d{MAX_DEPTH}, {GRAD_STEPS} Adam steps (lr {GRAD_LR}, replay): "
          f"losses {losses}; s per gradient {secs} (median {float(np.median(secs)):.4f}); peak memory "
          f"{peak / 2**30:.3f} GiB; red wall {torch.sigmoid(wall).tolist()} (distance to the truth {err0[0]:.4f} -> "
          f"{err1[0]:.4f}), light scale {float(torch.exp(log_light)):.4f} ({err0[1]:.4f} -> {err1[1]:.4f})")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the loss did not fall over the steps")
    if not (err1[0] < err0[0] and err1[1] < err0[1]):
        raise RuntimeError("a parameter did not move toward the truth")

    k = GRAD_AB_PATHS // GRAD_SPP
    ab = slice((n - k) // 2, (n + k) // 2)  # the middle rows: the box fills them
    rows = []
    for mode in ("ad", "replay", "replay", "ad"):
        o = dataclasses.replace(opts, grad_mode=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        grad.render_loss_grad(scene, o, pix[ab], target[ab], GRAD_SPP)
        torch.cuda.synchronize()
        rows.append(f"{mode} {time.perf_counter() - t0:.4f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    phase("grad", f"one pass of {GRAD_AB_PATHS} paths (the middle rows, d{MAX_DEPTH}), in order: " + "; ".join(rows))
    return step_launches


def red_material(scene):
    """The index of cbox's red wall material (its reflectance 0.63, 0.065, 0.05)."""
    attr = scene.materials.attr.cpu().numpy()
    return int(np.argmin(np.abs(attr[:, 7:10] - np.array([0.63, 0.065, 0.05])).sum(axis=1)))


def step0_scene(torch, scene, red):
    """The grad cell's scene at its step-0 parameters: gray red wall
    (sigmoid(logit 0.5)) and half the light (exp(log 0.5))."""
    from take_tpu_torch.scene import edit

    dev = scene.background.device
    s = edit.with_material_reflectance(scene, red, torch.sigmoid(torch.zeros(3, dtype=torch.float32, device=dev)))
    return edit.with_light_intensity_scale(s, torch.exp(torch.tensor(np.log(0.5), dtype=torch.float32, device=dev)))


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_main(rank, n_ranks, port, work, device, res):
    """One rank of phases 18 and 19's gloo group, in a process of its own
    (started with spawn): the cbox frame through render_image_multihost
    (a first call warms up, the second is kept with its stats), then the
    banded gradient on the grad cell's step-0 scene against the target in
    `work` (the same: the second call is kept); writes work/rank<r>.npz."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from take_tpu_torch.geometry import _launch
    from take_tpu_torch.parallel import distributed, overlap
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions, float_tables

    distributed.init_distributed(f"localhost:{port}", n_ranks, rank, backend="gloo")
    try:
        dev = distributed.local_device() if device == "cuda" else torch.device(device)
        scene = with_res(parse_scene_file(str(SCENE), device=dev), res)
        options = RenderOptions(spp=SPP, max_depth=MAX_DEPTH, seed=SEED)
        distributed.render_image_multihost(scene, options)
        stats = {}
        _launch.reset_launches()
        img = distributed.render_image_multihost(scene, options, stats=stats)
        launches = dict(_launch.LAUNCHES)
        s0 = step0_scene(torch, scene, red_material(scene))
        target = torch.as_tensor(np.load(Path(work) / "target.npy"), device=dev)
        pix = torch.arange(res * res, dtype=torch.int32, device=dev)
        opts = RenderOptions(spp=GRAD_SPP, max_depth=MAX_DEPTH, seed=GRAD_SEED, grad_mode="auto")
        banded_s = []
        for _ in range(2):  # the second call is kept
            if dev.type == "cuda":
                torch.cuda.synchronize()
            _launch.reset_launches()
            t0 = time.perf_counter()
            loss, g = overlap.banded_loss_grad(s0, opts, pix, target, BANDS, n_samples=GRAD_SPP)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            banded_s.append(time.perf_counter() - t0)
        grads = {f"grad/{k}": v.cpu().numpy() for k, v in float_tables(g).items()}
        np.savez(Path(work) / f"rank{rank}.npz", img=img, loss=float(loss), banded_s=banded_s,
                 info=json.dumps({"stats": stats, "launches": launches, "launches_banded": dict(_launch.LAUNCHES)}),
                 **grads)
    finally:
        dist.destroy_process_group()


def run_ranks(n_ranks, work, device, res):
    """Start n_ranks processes of rank_main (spawn: CUDA does not survive
    fork), wait for them, and return their results; a rank that fails or
    hangs fails the phase (its output is on this script's)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, n_ranks, port, str(work), device, res)) for r in range(n_ranks)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + RANK_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * n_ranks:
        raise RuntimeError(f"the gloo ranks exited with {codes} (None: killed after {RANK_TIMEOUT} s)")
    out = []
    for r in range(n_ranks):
        with np.load(Path(work) / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
        out[-1]["info"] = json.loads(str(out[-1]["info"]))
    return out


def grads_allclose(label, got, want):
    """Every float table of `got` ({key: numpy}) against `want` (a gradient
    Scene): tests/test_overlap.py's rtol 2e-4, atol 1e-6. Returns the
    largest error over each table's scale."""
    from take_tpu_torch.scene.types import float_tables

    worst = 0.0
    for key, w in float_tables(want).items():
        w = w.cpu().numpy()
        g = got[key]
        if not np.isfinite(g).all():
            raise RuntimeError(f"{label}: {key} has a non-finite gradient")
        np.testing.assert_allclose(g, w, rtol=BANDED_RTOL, atol=BANDED_ATOL, err_msg=f"{label}: {key}")
        scale = float(np.abs(w).max())
        if scale > 0:
            worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


def checkpoint_phase(torch, scene, options, out_dir, cbox_img, smi):
    """Phase 20: render_image_resumable stopped one pass after its first
    checkpoint and resumed, bit for bit `cbox_img`; an uninterrupted
    checkpointed render timed in turns with render_image. Returns the launches of
    the stopped and resumed render."""
    from take_tpu_torch.geometry import _launch
    from take_tpu_torch.render import render_image
    from take_tpu_torch.utils import checkpoint

    path = out_dir / "cbox_1024.ckpt"
    path.unlink(missing_ok=True)

    class Stop(Exception):
        pass

    def stop(s, spp):
        if s > CKPT_EVERY:  # one pass past the first checkpoint
            raise Stop

    _launch.reset_launches()
    try:
        checkpoint.render_image_resumable(scene, options, str(path), CKPT_EVERY, progress=stop)
        raise RuntimeError("the checkpointed render was not stopped")
    except Stop:
        pass
    spp_done = checkpoint.load_accumulator(str(path))[1]
    img_c = checkpoint.render_image_resumable(scene, options, str(path), CKPT_EVERY)
    torch.cuda.synchronize()
    launches = kernels_only(dict(_launch.LAUNCHES), ("closest", "anyhit"), "the stopped and resumed render")
    complete = checkpoint.load_accumulator(str(path))[3]

    def fresh(scene, options):
        path.unlink(missing_ok=True)
        return checkpoint.render_image_resumable(scene, options, str(path), CKPT_EVERY)

    secs = in_turns(torch, {"render_image": render_image, "checkpointed": fresh}, scene, options)
    phase("parallel", f"checkpoint: {RES}x{RES} {SPP} spp d{MAX_DEPTH} stopped at sample {CKPT_EVERY + 1} (the "
          f"checkpoint holds {spp_done}), resumed: equal to render_image's image bit for bit "
          f"{np.array_equal(img_c, cbox_img)}, last checkpoint {complete}, launches {launches}; "
          f"uninterrupted with a checkpoint every {CKPT_EVERY} passes, s a render in turns {secs}; "
          f"card: {smi}")
    if spp_done != CKPT_EVERY or complete != {"complete": True} or not np.array_equal(img_c, cbox_img):
        raise RuntimeError("the resumed render differs from render_image's")
    return launches


def in_turns(torch, fns, scene, options):
    """{name: [seconds, seconds]} of two renderers timed in turns (a, b, b, a)."""
    (a, fa), (b, fb) = fns.items()
    secs = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        secs[name].append(timed_render(torch, fn, scene, options)[0])
    return secs


def parallel_cell(torch, dev, out_dir, cbox_img, smi):
    """parallel: the sharded render (two shards on the card, then one),
    render_image_multihost at one NCCL rank in process and at two gloo
    ranks on the card, the banded gradient at one and two ranks against
    render_loss_grad, a checkpointed render stopped and resumed, and the
    entry point's dry run. Returns K1/K2's launches in each phase."""
    import functools

    import torch.distributed as dist

    from take_tpu_torch import entry, grad
    from take_tpu_torch.geometry import _launch
    from take_tpu_torch.parallel import distributed, overlap, sharding
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions, float_tables

    want = ("closest", "anyhit")
    scene = with_res(parse_scene_file(str(SCENE), device=dev), RES)
    options = RenderOptions(spp=SPP, max_depth=MAX_DEPTH, seed=SEED)
    out = {}

    # 17. sharded: two shards on the card (k = 2), then one (k = 1)
    two = functools.partial(sharding.render_image_sharded, mesh=[dev, dev])
    img2, out["sharded"] = render_counted(torch, _launch, two, scene, options, want, "two-way sharded render")
    rel = float((np.abs(img2 - cbox_img) / np.maximum(np.abs(cbox_img), np.finfo(np.float32).tiny)).max())
    mrel, m2 = mean_rel(img2, cbox_img)
    secs = in_turns(torch, {"render_image": render_image, "sharded": two}, scene, options)
    one = functools.partial(sharding.render_image_sharded, mesh=[dev])
    img1, _ = render_counted(torch, _launch, one, scene, options, want, "one-way sharded render")
    phase("parallel", f"sharded {RES}x{RES} {SPP} spp d{MAX_DEPTH} over [{dev}] * 2 (k 2) through K1/K2 alone "
          f"({out['sharded']}): largest per-pixel difference from the render_image image {rel:.3e} of the pixel "
          f"(limit {SUM_REL}), means {m2.tolist()} vs {cbox_img.mean(axis=(0, 1)).tolist()} (max rel {mrel:.3e}, "
          f"limit {MEAN_REL}); s a render in turns {secs}; over [{dev}] (k 1) equal bit "
          f"for bit: {np.array_equal(img1, cbox_img)}; card: {smi}")
    if rel > SUM_REL or mrel > MEAN_REL:
        raise RuntimeError("the two-way sharded image disagrees with render_image's")
    if not np.array_equal(img1, cbox_img):
        raise RuntimeError("the one-way sharded image differs from render_image's")

    # 18. multihost: one NCCL rank in this process, then two gloo ranks on the card
    work = out_dir / "ranks"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.glob("rank*.npz"):
        f.unlink()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        stats0, stats1 = {}, {}
        distributed.render_image_multihost(scene, options, stats=stats0)  # NCCL sets up its communicator
        multi = functools.partial(distributed.render_image_multihost, stats=stats1)
        img_n, out["multihost_nccl"] = render_counted(torch, _launch, multi, scene, options, want,
                                                      "one-rank NCCL render")
    finally:
        dist.destroy_process_group()
    if not np.array_equal(img_n, cbox_img):
        raise RuntimeError("the one-rank NCCL frame differs from render_image's")
    red = red_material(scene)
    t_img = render_image(scene, RenderOptions(spp=GRAD_TARGET_SPP, max_depth=MAX_DEPTH, seed=3))
    np.save(work / "target.npy", np.ascontiguousarray(t_img[::-1]).reshape(-1, 3))  # rows back to y order
    t0 = time.perf_counter()
    ranks = run_ranks(2, work, DEVICE, RES)
    t_ranks = time.perf_counter() - t0
    for r, z in enumerate(ranks):
        out[f"multihost_gloo_rank{r}"] = kernels_only(z["info"]["launches"], want, f"gloo rank {r}'s render")
    equal = [np.array_equal(z["img"], img2) for z in ranks]
    phase("parallel", f"multihost {RES}x{RES} {SPP} spp d{MAX_DEPTH}: one NCCL rank equal to render_image's image "
          f"bit for bit ({out['multihost_nccl']}; pass_seconds {stats1['pass_seconds']}, assemble_seconds "
          f"{stats1['assemble_seconds']}; the first call's {stats0['assemble_seconds']}); two gloo ranks on one card (two processes, {t_ranks:.1f} s from start "
          f"to exit): frames equal to each other {np.array_equal(ranks[0]['img'], ranks[1]['img'])} and to the "
          f"two-way sharded image {equal}; per rank pass_seconds "
          f"{[z['info']['stats']['pass_seconds'] for z in ranks]}, assemble_seconds "
          f"{[z['info']['stats']['assemble_seconds'] for z in ranks]}, launches "
          f"{[out[f'multihost_gloo_rank{r}'] for r in range(2)]}; card: {smi}")
    if not (np.array_equal(ranks[0]["img"], ranks[1]["img"]) and all(equal)):
        raise RuntimeError("the two gloo ranks' frames differ from each other or from the two-way sharded image")

    # 19. banded gradient on the grad cell's step-0 scene, against render_loss_grad
    s0 = step0_scene(torch, scene, red)
    target = torch.as_tensor(np.load(work / "target.npy"), device=dev)
    pix = torch.arange(RES * RES, dtype=torch.int32, device=dev)
    opts = RenderOptions(spp=GRAD_SPP, max_depth=MAX_DEPTH, seed=GRAD_SEED, grad_mode="auto")
    results, secs, peaks = {}, {"banded": [], "monolithic": []}, {}
    for which in ("banded", "monolithic", "banded", "monolithic", "monolithic", "banded"):  # a first call of each, then in turns
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _launch.reset_launches()
        t0 = time.perf_counter()
        if which == "banded":
            results[which] = overlap.banded_loss_grad(s0, opts, pix, target, BANDS, n_samples=GRAD_SPP)
        else:
            results[which] = grad.render_loss_grad(s0, opts, pix, target, GRAD_SPP)
        torch.cuda.synchronize()
        secs[which].append(time.perf_counter() - t0)
        peaks[which] = max(peaks.get(which, 0), torch.cuda.max_memory_allocated())
        out[which] = kernels_only(dict(_launch.LAUNCHES), want, f"the {which} gradient")
    (loss_b, g_b), (loss_m, g_m) = results["banded"], results["monolithic"]
    loss_rel = abs(float(loss_b) - float(loss_m)) / abs(float(loss_m))
    err1 = grads_allclose("banded at one rank", {k: v.cpu().numpy() for k, v in float_tables(g_b).items()}, g_m)
    errs2, loss2 = [], []
    for r, z in enumerate(ranks):
        out[f"banded_gloo_rank{r}"] = kernels_only(z["info"]["launches_banded"], want, f"gloo rank {r}'s gradient")
        errs2.append(grads_allclose(f"banded at two ranks (rank {r})",
                                    {k[5:]: v for k, v in z.items() if k.startswith("grad/")}, g_m))
        loss2.append(abs(float(z["loss"]) - float(loss_m)) / abs(float(loss_m)))
    mode_b = grad.resolve_mode(opts, RES * RES // BANDS * GRAD_SPP)
    phase("parallel", f"banded gradient ({BANDS} bands, {mode_b} per band) at {RES}x{RES} {GRAD_SPP} spp "
          f"d{MAX_DEPTH} on the grad cell's step-0 scene against render_loss_grad ({grad.resolve_mode(opts, RES * RES * GRAD_SPP)}): loss "
          f"{float(loss_b):.6e} vs {float(loss_m):.6e} (rel {loss_rel:.3e}, limit {BANDED_LOSS_RTOL}), every table "
          f"within rtol {BANDED_RTOL}, atol {BANDED_ATOL} (largest error {err1:.3e} of a table's scale); two gloo "
          f"ranks: loss rel {loss2}, tables {errs2} of scale, s per rank (first, second call) "
          f"{[z['banded_s'].tolist() for z in ranks]}; "
          f"s per gradient, in order banded, monolithic (first calls) {secs['banded'][0]:.4f}, "
          f"{secs['monolithic'][0]:.4f}, then banded, monolithic, monolithic, banded {secs['banded'][1]:.4f}, "
          f"{secs['monolithic'][1]:.4f}, {secs['monolithic'][2]:.4f}, {secs['banded'][2]:.4f}; peak memory banded "
          f"{peaks['banded'] / 2**30:.3f} GiB, monolithic {peaks['monolithic'] / 2**30:.3f} GiB; launches banded "
          f"{out['banded']}, monolithic {out['monolithic']}, gloo ranks "
          f"{[out[f'banded_gloo_rank{r}'] for r in range(2)]}; card: {smi}")
    if max([loss_rel] + loss2) > BANDED_LOSS_RTOL:
        raise RuntimeError("the banded loss disagrees with render_loss_grad's")

    out["resumable"] = checkpoint_phase(torch, scene, options, out_dir, cbox_img, smi)

    # 21. entry: the dry run over two shards on the card, and entry()'s step
    _launch.reset_launches()
    t0 = time.perf_counter()
    losses = entry.dryrun_multichip(2)
    fn, args = entry.entry()
    y = fn(*args)
    torch.cuda.synchronize()
    dt_e = time.perf_counter() - t0
    out["entry"] = kernels_only(dict(_launch.LAUNCHES), want, "the entry point")
    phase("parallel", f"entry: dryrun_multichip(2) over [{dev}] * 2 {losses}; entry() fn -> {tuple(y.shape)}, "
          f"finite {bool(torch.isfinite(y).all())}; {dt_e:.3f} s; launches {out['entry']}; card: {smi}")
    if tuple(y.shape) != (1024, 3) or not bool(torch.isfinite(y).all()):
        raise RuntimeError("entry()'s step is not a finite [1024, 3] radiance")
    return out


KERNEL_KEYS = ("closest", "anyhit", "packet_closest", "packet_anyhit", "cluster_closest", "cluster_anyhit",
               "sweep_closest", "sweep_anyhit")


def bench_cell(torch, dev):
    """22 bench: take_tpu_torch/bench.py's measurements beyond the flagship
    (phase 5): the d50 refill fraction and the 1080p banded replay gradient
    through K1/K2 alone, and the soup check of all six kernel routes.
    Returns each kernel's launches in the phase."""
    from take_tpu_torch import bench
    from take_tpu_torch.geometry import _launch
    from take_tpu_torch.scene.parse_xml import parse_scene_file

    scene = with_res(parse_scene_file(str(SCENE), device=dev), RES)
    runs = []
    torch.cuda.synchronize()
    _launch.reset_launches()
    nom, act, dt = bench.wavefront_counts(scene)
    got = kernels_only(dict(_launch.LAUNCHES), ("closest", "anyhit"), "the d50 refill loop")
    iters = nom // (2 * bench.WAVE)
    phase("bench", f"refill loop at {RES}x{RES}, 1 spp, d{bench.D50}, a wave of {bench.WAVE}: "
          f"active_fraction_d50_wavefront {act / nom:.6f} ({act} of {nom} queries), {iters} iterations in "
          f"{dt:.3f} s ({dt / iters * 1e3:.3f} ms an iteration, one host sync each); launches {got}")
    runs.append(got)
    _launch.reset_launches()
    g = bench.banded_grad(scene)
    torch.cuda.synchronize()
    got = kernels_only(dict(_launch.LAUNCHES), ("closest", "anyhit"), "the 1080p banded gradient")
    phase("bench", f"gradient at {bench.GRAD_SIZE[0]}x{bench.GRAD_SIZE[1]}, 1 spp, d{MAX_DEPTH}, replay, "
          f"{g['bands']} bands of {bench.BAND} pixels after a warm-up band: {g['seconds']:.4f} s = "
          f"{g['mrays']:.3f} Mrays/s (forward + replay), sum of squares {g['sumsq']:.6e}, finite {g['finite']}; "
          f"launches with the warm-up band {got}")
    if not g["finite"]:
        raise RuntimeError("the 1080p gradient is not finite")
    runs.append(got)
    _launch.reset_launches()
    ok, err = bench.kernels_check(dev)
    torch.cuda.synchronize()
    got = {k: _launch.LAUNCHES[k] for k in KERNEL_KEYS[2:]}
    phase("bench", f"soup check ({bench.SOUP_TRI} triangles with a BVH, {bench.SOUP_RAYS} rays, tmax +inf): "
          f"K3, K4, K6 closest and K3, K5, K6 any hit against brute.closest_plain's winner: ok {ok} {err}; "
          f"launches {got}")
    if not ok or any(v != 1 for v in got.values()):
        raise RuntimeError(f"the soup check failed: {err or got}")
    return {k: sum(r.get(k, 0) for r in runs + [got]) for k in KERNEL_KEYS}


def room_grad_cell(torch, room):
    """23 room grad: take_tpu_torch/room_grad_fd.py's full band on the room
    cell's scene (2^16 pixels x 4 samples, d6, seed 17): its gates, and each
    AD gradient against take_tpu's (raising past 1e-2), through K3 alone;
    then K3's launches in one gradient of each mode. Returns
    {"all": the run's launches, "replay": ..., "ad": ...} per kernel."""
    from take_tpu_torch import room_grad_fd
    from take_tpu_torch.geometry import _launch

    rec, misses = room_grad_fd.run(room)
    for which in room_grad_fd.params(room):
        r = rec[which]
        phase("room grad", f"{which}: AD {r['grad_ad']:.7f} (take_tpu's {room_grad_fd.TAKE_TPU_GRAD_AD[which]:.7f}, "
              f"{r['vs_take_tpu_rel']:.3e} off, limit {room_grad_fd.TAKE_TPU_MAX}), replay {r['grad_replay']:.7f}, "
              f"FD {r['fd']:.7f}; ad_vs_fd {r['ad_vs_fd_rel']:.3e} (limit {room_grad_fd.AD_FD_MAX}), replay_vs_ad "
              f"{r['replay_vs_ad_rel']:.3e} (limit {room_grad_fd.REPLAY_AD_MAX}); replay {r['t_replay_s']:.4f} s "
              f"at {r['peak_replay_gib']:.3f} GiB, AD {r['t_ad_s']:.4f} s at {r['peak_ad_gib']:.3f} GiB")
    if misses:
        raise RuntimeError("room gradients missed their gates: " + "; ".join(misses))
    out = {k: {"all": rec["launches"].get(k, 0)} for k in KERNEL_KEYS}
    pix = room_grad_fd.band_pixels(room, room_grad_fd.PIXELS, room.background.device)
    for mode in ("replay", "ad"):
        torch.cuda.synchronize()
        _launch.reset_launches()
        room_grad_fd.gradient(room, "albedo0", mode, pix)
        got = kernels_only(dict(_launch.LAUNCHES), ("packet_closest", "packet_anyhit"), f"a room {mode} gradient")
        for k in KERNEL_KEYS:
            out[k][mode] = got.get(k, 0)
    phase("room grad", f"{rec['band_paths']} paths, d{rec['depth']}, through K3 alone: launches {rec['launches']}; "
          f"in one gradient, replay {out['packet_closest']['replay']} + {out['packet_anyhit']['replay']}, AD "
          f"{out['packet_closest']['ad']} + {out['packet_anyhit']['ad']} (closest + any hit)")
    return out


def inverse_cell(torch, dev):
    """24 inverse: take_tpu_torch/inverse_demo.py cut to INVERSE_STEPS Adam
    steps (64x64, 32 spp a step, d4, its 512-spp target): the loss falls,
    every parameter moves toward the truth, every gradient is finite, K1/K2
    alone. Returns K1/K2's launches a step."""
    from take_tpu_torch import inverse_demo

    rec, params, losses = inverse_demo.run(steps=INVERSE_STEPS, device=dev, log_every=0)
    true = inverse_demo.physical(inverse_demo.raw(inverse_demo.TRUE, "cpu"))
    init = inverse_demo.physical(inverse_demo.raw(inverse_demo.INIT, "cpu"))
    got = inverse_demo.physical(params)
    dist = {k: (float(np.linalg.norm(init[k] - true[k])), float(np.linalg.norm(got[k] - true[k]))) for k in true}
    phase("inverse", f"{rec['steps']} Adam steps at {inverse_demo.RES}x{inverse_demo.RES}, {rec['spp_per_step']} "
          f"spp a step: {rec['seconds']:.3f} s ({rec['seconds_per_step']:.4f} s a step); loss {rec['loss_first']:.6f} "
          f"-> {rec['loss_last']:.6f} (mean of the last 10); distance to the truth "
          + ", ".join(f"{k} {a:.4f} -> {b:.4f}" for k, (a, b) in dist.items())
          + f"; max_rel_err {rec['max_rel_err']}; finite {rec['grads_finite']}; launches a step "
          f"{rec['launches_per_step']}")
    if not rec["loss_last"] < rec["loss_first"] or not all(b < a for a, b in dist.values()):
        raise RuntimeError("the inverse demo did not move toward the truth")
    if not rec["grads_finite"] or set(rec["launches_per_step"]) != {"closest", "anyhit"}:
        raise RuntimeError(f"the inverse demo: gradients finite {rec['grads_finite']}, "
                           f"launches {rec['launches_per_step']}")
    return rec["launches_per_step"]


def graph_pool_bytes(torch):
    """Bytes the caching allocator holds in the private pools of captured
    graphs (their intermediates stay reserved there between replays)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def profile_pass(torch, fn):
    """One call of `fn` under torch.profiler: (busy share of the device
    span, busy ms, device span ms, host ms, host launches: kernels launched
    one by one and graphs launched)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    intervals, kernels, graphs = [], 0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            kernels += 1
        elif e.name == "cudaGraphLaunch":
            graphs += 1
    if not intervals:
        raise RuntimeError("the profiler saw no device time")
    intervals.sort()
    busy, (lo, hi) = 0.0, intervals[0]
    for a, b in intervals[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    span = max(b for _, b in intervals) - intervals[0][0]
    return busy / span, busy / 1e3, span / 1e3, host * 1e3, {"kernels": kernels, "graphs": graphs}


def eager_graph_turns(torch, label, fn, compare=None):
    """`fn` once through graphs (its keys' captures), once op by op
    (render.eager(), warm), then in turns E G E G, each call between
    synchronises with the peak memory and the kernel launches reset. `fn()`
    returns (out, seconds or None: its own time, else the host clock's).
    Raises if a call's launches differ from the first eager call's or a
    graph is captured after the first call; then `compare(outs)`, with
    outs {mode: [out of each turn]}, raises on a miss. Returns {first_s,
    keys: [the first input's shape], captures,
    secs: {mode: [s]}, ratio (eager over graph, medians), launches,
    peaks: {mode: bytes}, pool: the graphs' pool bytes}."""
    from take_tpu_torch import _graph
    from take_tpu_torch.geometry import _launch

    render = importlib.import_module("take_tpu_torch.render")
    render.clear_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # captures each key
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    with render.eager():
        fn()  # a warm eager call: the allocator's blocks for eager calls beside the graphs' pool
    graphs = {id(e) for e in _graph.captured()}
    keys = [tuple(e.inputs[0].shape) for e in _graph.captured()]
    secs, launches, peaks, outs = {"eager": [], "graph": []}, {}, {}, {"eager": [], "graph": []}
    for mode in ("eager", "graph", "eager", "graph"):
        with render.eager() if mode == "eager" else contextlib.nullcontext():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _launch.reset_launches()
            t0 = time.perf_counter()
            out, own_s = fn()
            torch.cuda.synchronize()
            secs[mode].append(own_s if own_s is not None else time.perf_counter() - t0)
            got = {k: v for k, v in _launch.LAUNCHES.items() if v}
        peaks[mode] = max(peaks.get(mode, 0), torch.cuda.max_memory_allocated())
        launches.setdefault(mode, got)
        outs[mode].append(out)
        if got != launches["eager"]:
            raise RuntimeError(f"{label}: the {mode} call launched {got}, eager {launches['eager']}")
    if {id(e) for e in _graph.captured()} != graphs:
        raise RuntimeError(f"{label}: a graph was captured after the first call")
    if compare:
        compare(outs)
    med = {m: float(np.median(v)) for m, v in secs.items()}
    return {"first_s": first_s, "keys": keys, "captures": len(graphs), "secs": secs,
            "ratio": med["eager"] / med["graph"], "launches": launches["graph"], "peaks": peaks,
            "pool": graph_pool_bytes(torch)}


def graph_cell(torch, dev, smi, room):
    """25 graph: each config rendered op by op (render.eager()) and through
    captured pass graphs, a first graph render (the captures) and a warm
    eager render, then in turns E G E G (eager_graph_turns):
    every graph image equal to the eager image bit for bit and every
    render's launches equal (or the script raises); seconds, Mrays/s and
    their ratio; capture and instantiate seconds of each key; peak memory
    allocated in each mode and the bytes the graphs' pools hold; then one
    pass of cbox and of ibl profiled in each mode."""
    from take_tpu_torch.geometry import traverse
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    render = importlib.import_module("take_tpu_torch.render")
    cbox = with_res(parse_scene_file(str(SCENE), device=dev), RES)
    mis = parse_scene_file(str(MIS), device=dev)
    tex = parse_scene_file(str(TEXTURED), device=dev)
    ibl = parse_scene_file(str(IBL), device=dev)
    room_opts = RenderOptions(spp=ROOM_SPP, max_depth=ROOM_DEPTH, seed=SEED)
    ibl_opts = RenderOptions(spp=GRAPH_IBL_SPP, max_depth=IBL_DEPTH, seed=SEED)
    configs = [
        ("cbox", cbox, RenderOptions(spp=SPP, max_depth=MAX_DEPTH, seed=SEED), None),
        ("mis", mis, RenderOptions(spp=MIS_SPP, max_depth=MIS_DEPTH, seed=SEED), None),
        ("room", room, room_opts, None),
        ("room FORCE_SWEEP", room, room_opts, "FORCE_SWEEP"),
        ("room FORCE_CLUSTER", room, room_opts, "FORCE_CLUSTER"),
        ("textured", tex, RenderOptions(spp=TEX_SPP, max_depth=TEX_DEPTH, seed=SEED), None),
        ("ibl", ibl, ibl_opts, None),
    ]
    for label, scene, opts, flag in configs:
        cam = scene.meta.camera

        def same_images(outs):
            want = outs["eager"][0]
            for mode, img in ((m, x) for m, imgs in outs.items() for x in imgs):
                if not np.array_equal(img, want):
                    raise RuntimeError(f"graph {label}: a {mode} image differs from the first eager image "
                                       f"(max abs {np.abs(img - want).max():.3e})")

        with mock.patch.object(traverse, flag, True) if flag else contextlib.nullcontext():
            r = eager_graph_turns(torch, f"graph {label}", lambda: (render.render_image(scene, opts), None),
                                  same_images)
        rays = cam.width * cam.height * opts.spp * (1 + 2 * (opts.max_depth + 1))
        med = {m: float(np.median(v)) for m, v in r["secs"].items()}
        phase("graph", f"{label} {cam.width}x{cam.height} {opts.spp} spp d{opts.max_depth}: graph image equal to the "
              f"eager image bit for bit; launches a render equal in both modes {r['launches']}; in turns E G E G "
              f"eager {r['secs']['eager']} s, graph {r['secs']['graph']} s; Mrays/s eager {rays / med['eager'] / 1e6:.3f}, "
              f"graph {rays / med['graph'] / 1e6:.3f}, graph/eager speed {r['ratio']:.3f}x; first graph render "
              f"(captures) {r['first_s']:.4f} s; keys (pixels a pass) {r['keys']}; peak "
              f"allocated eager {r['peaks']['eager'] / 2**30:.3f} GiB, graph {r['peaks']['graph'] / 2**30:.3f} GiB, "
              f"graph pools {r['pool'] / 2**30:.3f} GiB; card: {smi}")

    rows = []
    for label, scene, opts in (("cbox", cbox, configs[0][2]), ("ibl", ibl, ibl_opts)):
        cam = scene.meta.camera
        k = max(1, min(opts.spp, opts.max_rays_per_pass // (cam.width * cam.height)))
        pix = torch.arange(min(cam.width * cam.height, opts.max_rays_per_pass // k), dtype=torch.int32, device=dev)

        def one_pass():
            with torch.inference_mode():
                render.render_pass(scene, opts, pix, 0, cam.width, k)

        for mode in ("eager", "graph"):
            with render.eager() if mode == "eager" else contextlib.nullcontext():
                one_pass()  # a graph's key captured, the eager pass warm
                share, busy, span, host, calls = profile_pass(torch, one_pass)
            rows.append(f"{label} {mode} ({pix.shape[0]} pixels x {k}): busy {share:.4f} of the device span "
                        f"({busy:.3f} of {span:.3f} ms), host {host:.3f} ms, host launches {calls}")
    phase("graph", "one pass under torch.profiler: " + "; ".join(rows))
    render.clear_cache()
    phase("graph", f"render.PASSES over the script: {render.PASSES}")


def loop_trips(record, D):
    """The trips each replay loop ran, from the conditions
    path_tracer._running returned in order: a loop asks before each trip
    and stops at the first False or after D trips. Raises if the record
    ends inside a loop."""
    trips, n = [], 0
    for r in record:
        n += bool(r)
        if not r or n == D:
            trips.append(n)
            n = 0
    if n:
        raise RuntimeError(f"the record of the replay loops ends inside a loop, after {n} trips")
    return trips


def replay_trips(fn, D):
    """`fn` run op by op (render.eager()) with path_tracer._running watched:
    {loop: [trips run, trips skipped]} over the forward loop, pass 1 and
    pass 2 of every replay pass it ran (the loops run in that order, pass by
    pass)."""
    from take_tpu_torch.integrator import path_tracer

    render = importlib.import_module("take_tpu_torch.render")
    record, running = [], path_tracer._running

    def spy(active):
        record.append(running(active))
        return record[-1]

    with mock.patch.object(path_tracer, "_running", spy), render.eager():
        fn()
    out = {"forward": [0, 0], "pass 1": [0, 0], "pass 2": [0, 0]}
    for j, t in enumerate(loop_trips(record, D)):
        loop = out[("forward", "pass 1", "pass 2")[j % 3]]
        loop[0], loop[1] = loop[0] + t, loop[1] + D - t
    return out


def grad_graph_cell(torch, dev, smi, room):
    """26 grad graph: each gradient cell op by op (render.eager()) and
    through captured gradient graphs (one a pass key, forward and backward)
    by eager_graph_turns: a first graph call (the captures), a warm eager
    call, then in turns E G E G, with the same kernel launches and no
    capture after the first call; each graph loss equal to the first eager
    loss bit for bit, each table of the gradient and each raw parameter's
    (the inverse step: its raw parameters') within max(2 x its difference
    between the two eager calls, 1e-5 x its largest magnitude) of the first
    eager call's (or the script raises); seconds and their ratio, capture
    and instantiate seconds a key, peak memory allocated in each mode, the
    graphs' pool bytes and captures per cell; then op by op the trips the
    replay loops skip (their early exit) in each replay cell, and one
    replay pass of 2^20 paths of the grad cell under torch.profiler in each
    mode."""
    from take_tpu_torch import bench, grad, inverse_demo, room_grad_fd
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene import edit
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions, float_tables

    render = importlib.import_module("take_tpu_torch.render")
    cbox = with_res(parse_scene_file(str(SCENE), device=dev), RES)
    n = RES * RES
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    target_img = render_image(cbox, RenderOptions(spp=GRAD_TARGET_SPP, max_depth=MAX_DEPTH, seed=3))
    target = torch.as_tensor(target_img[::-1].copy(), device=dev).reshape(n, 3)
    red = red_material(cbox)
    opts = RenderOptions(spp=GRAD_SPP, max_depth=MAX_DEPTH, seed=GRAD_SEED, grad_mode="auto")
    k = GRAD_AB_PATHS // GRAD_SPP
    ab = slice((n - k) // 2, (n + k) // 2)
    rpix = room_grad_fd.band_pixels(room, room_grad_fd.PIXELS, dev)
    base = inverse_demo.cornell_box(inverse_demo.RES, inverse_demo.RES).build(device=dev)
    ipix = torch.arange(inverse_demo.RES ** 2, dtype=torch.int32, device=dev)
    itarget = inverse_demo.target_image(base, ipix)

    def grad_step():  # the grad cell's step 0 (replay), carried into its raw parameters
        wall = torch.zeros(3, device=dev, requires_grad=True)
        log_light = torch.tensor(np.log(0.5), dtype=torch.float32, device=dev).requires_grad_(True)
        s = edit.with_light_intensity_scale(edit.with_material_reflectance(cbox, red, torch.sigmoid(wall)),
                                            torch.exp(log_light))
        loss, g = grad.render_loss_grad(s, opts, pix, target, GRAD_SPP)
        grad.backward(s, g)
        return (loss, {**float_tables(g), "d/dwall_logit": wall.grad, "d/dlog_light": log_light.grad}), None

    def bench_grad():  # bench's 1080p banded replay gradient: its bands' losses, the frame's gradient, its seconds
        g = bench.banded_grad(cbox)
        bands = [float_tables(x) for x in g["grads"]]
        return (torch.tensor(g["losses"], dtype=torch.float64), {k: sum(b[k] for b in bands) for k in bands[0]}), \
            g["seconds"]

    def ab_pass(mode):
        def fn():
            loss, g = grad.render_loss_grad(cbox, dataclasses.replace(opts, grad_mode=mode), pix[ab], target[ab],
                                            GRAD_SPP)
            return (loss, float_tables(g)), None
        return fn

    def room_band(mode):  # room_grad_fd's band: its mean radiance and albedo0's gradient
        def fn():
            mean, g, dd = room_grad_fd.band_grad(room, "albedo0", mode, rpix)
            return (mean, {**float_tables(g), "d/dalbedo0": dd}), None
        return fn

    def inverse_step():  # inverse_demo's first step (AD): its loss and raw parameters' gradients
        params = {k: v.requires_grad_(True) for k, v in inverse_demo.raw(inverse_demo.INIT, dev).items()}
        loss = inverse_demo.loss_grad(base, params, ipix, itarget, 0)
        return (loss, {f"d/d{k}": p.grad for k, p in params.items()}), None

    cells = [  # (label, fn, replay loops' D or None for AD)
        (f"grad step {RES}x{RES} {GRAD_SPP} spp d{MAX_DEPTH} replay", grad_step, MAX_DEPTH + 1),
        (f"bench {bench.GRAD_SIZE[0]}x{bench.GRAD_SIZE[1]} 1 spp d{bench.MAX_DEPTH} replay, bands of {bench.BAND}",
         bench_grad, bench.MAX_DEPTH + 1),
        (f"{GRAD_AB_PATHS} paths ad", ab_pass("ad"), None),
        (f"{GRAD_AB_PATHS} paths replay", ab_pass("replay"), MAX_DEPTH + 1),
        (f"room band {room_grad_fd.PIXELS}x{room_grad_fd.SAMPLES} d{room_grad_fd.DEPTH} ad", room_band("ad"), None),
        (f"room band {room_grad_fd.PIXELS}x{room_grad_fd.SAMPLES} d{room_grad_fd.DEPTH} replay", room_band("replay"),
         room_grad_fd.DEPTH + 1),
        (f"inverse step {inverse_demo.RES}x{inverse_demo.RES} {inverse_demo.SPP} spp d{inverse_demo.DEPTH} ad",
         inverse_step, None),
    ]
    for label, fn, D in cells:
        worst = [0.0, None]  # the largest graph-eager difference over its limit, and its table

        def close_to_eager(outs):
            (loss_e, e1), (_, e2) = [(loss.detach(), {k: v.detach() for k, v in t.items()}) for loss, t in outs["eager"]]
            for loss_g, g in outs["graph"]:
                if not torch.equal(loss_g.detach(), loss_e):
                    raise RuntimeError(f"grad graph {label}: the graph loss {loss_g.tolist()} is not the eager loss "
                                       f"{loss_e.tolist()} bit for bit")
                for key, x in e1.items():
                    limit = max(2 * float((e2[key] - x).abs().max()), 1e-5 * float(x.abs().max()))
                    diff = float((g[key].detach() - x).abs().max())
                    if diff > limit:
                        raise RuntimeError(f"grad graph {label}: {key} differs from eager by {diff:.3e} (limit "
                                           f"{limit:.3e})")
                    if limit and diff / limit >= worst[0]:
                        worst[:] = [diff / limit, key]

        r = eager_graph_turns(torch, f"grad graph {label}", fn, close_to_eager)
        trips = replay_trips(fn, D) if D else "none (the scan loop has no early exit)"
        phase("grad graph", f"{label}: graph loss equal to eager's bit for bit, every table within its limit (the "
              f"largest difference {worst[0]:.3f} of its limit, in {worst[1]}), launches a call equal in both modes "
              f"{r['launches']}; in turns E G E G eager {r['secs']['eager']} s, graph {r['secs']['graph']} s, "
              f"graph/eager speed {r['ratio']:.3f}x; first graph call (captures) {r['first_s']:.4f} s; captures "
              f"{r['captures']}, keys (pixels a pass) {r['keys']}; peak allocated eager "
              f"{r['peaks']['eager'] / 2**30:.3f} GiB, graph {r['peaks']['graph'] / 2**30:.3f} GiB, graph pool "
              f"{r['pool'] / 2**30:.3f} GiB; replay loop trips [run, skipped] op by op {trips}; card: {smi}")

    render.clear_cache()
    s0 = step0_scene(torch, cbox, red)
    p1 = pix[:opts.max_rays_per_pass // GRAD_SPP]

    def one_pass():
        grad.partial_loss_grad(s0, opts, p1, target[:p1.shape[0]], GRAD_SPP, "replay", n * 3)

    rows = []
    for mode in ("eager", "graph"):
        with render.eager() if mode == "eager" else contextlib.nullcontext():
            one_pass()  # a graph's key captured, the eager pass warm
            share, busy, span, host, calls = profile_pass(torch, one_pass)
        rows.append(f"{mode}: busy {share:.4f} of the device span ({busy:.3f} of {span:.3f} ms), host {host:.3f} "
                    f"ms, host launches {calls}")
    phase("grad graph", f"one replay pass of {p1.shape[0] * GRAD_SPP} paths (the grad cell's step 0) under "
          f"torch.profiler: " + "; ".join(rows))
    render.clear_cache()
    phase("grad graph", f"grad.PASSES over the script: {grad.PASSES}")


def main():
    import torch

    t_start = time.perf_counter()
    name, smi = device_phase(torch)
    if not (ROOT / "take_tpu_torch" / "__init__.py").is_file() or not all(
            p.is_file() for p in (SCENE, ROOM, MIS, TEXTURED, IBL)):
        raise RuntimeError(f"{ROOT} is not a checkout of the repo (no take_tpu_torch/ or scenes/)")
    sys.path.insert(0, str(ROOT))
    from take_tpu_torch.geometry import _build, _launch
    from take_tpu_torch.render import clear_cache  # and with it every kernel wrapper, each declaring its source
    from take_tpu_torch.scene.types import scene_to

    ptxas = build_phase(_build, _launch)
    dev = torch.device(DEVICE)
    rng_times = rng_cell(torch, dev)
    disney_times = disney_cell(torch, dev)
    light_times = light_cell(torch, dev)
    bsdf_times = bsdf_cell(torch, dev, ptxas["bsdf"])
    out_dir = ROOT / "build" / "take_tpu_torch"
    out_dir.mkdir(parents=True, exist_ok=True)

    kernels, launches, cbox_img, cbox_dt = cbox_cell(torch, dev, out_dir)
    room_kernels, launches_room, room = room_cell(torch, dev, out_dir)
    kernels += room_kernels
    launches_mis, passes_mis, mis_img = mis_cell(torch, dev, out_dir)
    for entry in kernels[:2]:  # K1, K2
        entry.update(launches_mis=launches_mis[entry["name"]], mis_pass_ms=passes_mis[entry["name"]][0],
                     mis_pass_bound_ms=passes_mis[entry["name"]][1])
    launches_tex, tex_img = textured_cell(torch, dev, out_dir)
    reference_phase(torch, dev, mis_img, tex_img, room)
    room = scene_to(room, "cpu")  # off the card until phase 23
    clear_cache()  # and out of the pass graphs that hold it
    launches_ibl, passes_ibl = ibl_cell(torch, dev, out_dir)
    for entry in kernels[:2]:  # K1, K2
        entry.update(launches_ibl=launches_ibl[entry["name"]], ibl_pass_ms=passes_ibl[entry["name"]][0],
                     ibl_pass_bound_ms=passes_ibl[entry["name"]][1])
    launches_grad = grad_cell(torch, dev, out_dir, cbox_img, cbox_dt)
    for entry in kernels[:2]:  # K1, K2
        entry.update(launches_grad_step=launches_grad[entry["name"]])
    launches_par = parallel_cell(torch, dev, out_dir, cbox_img, smi)
    for entry in kernels[:2]:  # K1, K2
        entry.update(launches_parallel={k: v[entry["name"]] for k, v in launches_par.items()})
    launches_bench = bench_cell(torch, dev)
    room = scene_to(room, dev)
    launches_room_grad = room_grad_cell(torch, room)
    launches_inverse = inverse_cell(torch, dev)
    graph_cell(torch, dev, smi, room)
    grad_graph_cell(torch, dev, smi, room)
    del room
    for entry in kernels:
        entry.update(launches_bench=launches_bench[entry["name"]],
                     launches_room_grad=launches_room_grad[entry["name"]])
    for entry in kernels[:2]:  # K1, K2
        entry.update(launches_inverse_step=launches_inverse[entry["name"]])
    phase("times", f"launches per default render: cbox {launches}, room {launches_room}, mis {launches_mis}, "
          f"textured {launches_tex}, ibl {launches_ibl}; per gradient step {launches_grad}; parallel {launches_par}; "
          f"bench {launches_bench}; room grad {launches_room_grad}; inverse step {launches_inverse}")
    phase("times", f"card: {smi}; script {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "rng": rng_times, "disney": disney_times, "light": light_times,
                      "bsdf": bsdf_times}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
