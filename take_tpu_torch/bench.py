"""The port's benchmark record: `python3 -m take_tpu_torch.bench [--device cuda] [--out PATH]`.

Port of bench.py (the repo's benchmark entry point). Prints ONE JSON line
with bench.py's keys:

  * `value`: forward path-tracing throughput on cbox at 1024x1024, 16 spp,
    max_depth 4, in Mrays/s (rays = paths x (1 + 2 (max_depth + 1)), every
    query the scan loop launches, bench.py:58-63); a 1-spp warm-up render,
    then the best of 3 `render_image` calls;
  * `active_fraction`, `active_mrays`: the share of those queries on live
    lanes (`trace_query_counts` over 2 spp), and the rate times it;
  * `active_fraction_d50_wavefront`: the refill loop at max_depth 50 with a
    wave of 2^14 lanes over every pixel at 1 spp (bench.py:99-113);
  * `grad_1080p_seconds`, `grad_1080p_mrays`, `grad_norm_finite`: the L2
    loss gradient of cbox at 1920x1080, 1 spp, d4, grad_mode "replay",
    against a zero target, in bands of 2^18 pixels (one band first as a
    warm-up, then every band timed, one host sync a band for the sum of
    squares of the gradient's float tables); rays count forward and replay
    over the paths traced (the last band is shorter: torch needs no wrap
    padding to keep one compiled shape);
  * `kernels_onchip_ok`: every kernel route against the brute sweep's
    winner on a 3000-triangle soup with a BVH and 1024 seeded rays (K3, K4
    and K6 closest hit: the prim on every ray; K3, K5 and K6 any hit: prim
    >= 0 on every ray), with `kernels_onchip_error` when false. bench.py
    checks K3, K4, K6 and K6's any hit; K3's and K5's any hit are added
    here so that every kernel is covered.

Beside them: `device` (the card's name), `power_limit` (nvidia-smi's) and
`torch` (the version), since every number needs its card beside it.

Left out: `swept_fraction`, the TPU kernels' share of 1024-ray blocks swept
after their dead-block skip, which has no counterpart on the card; and the
`weak_scaling_*` keys (benchmarks/scaling.py): they time N single-core CPU
processes, and on one card the port's ranks would share it, so they would
measure nothing about the card.

Unlike bench.py, which reports errors inside its record, an error here
raises, and a kernel mismatch or a non-finite gradient prints the record
and exits 1: a record with a failed part is not a measurement.
`--out PATH` also writes the record to PATH. The sizes are options so that
the CPU tests can run the whole record small (`--device cpu`).
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from take_tpu_torch import grad
from take_tpu_torch.core import rng
from take_tpu_torch.core.camera import Camera, generate_rays
from take_tpu_torch.geometry import brute, cluster, packet, sweep
from take_tpu_torch.integrator import wavefront
from take_tpu_torch.integrator.path_tracer import trace_query_counts
from take_tpu_torch.render import render_image
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.parse_xml import parse_scene_file
from take_tpu_torch.scene.types import MAT_DIFFUSE, RenderOptions, float_tables

CBOX = Path(__file__).resolve().parent.parent / "scenes" / "cbox" / "cbox.xml"
RES, SPP, MAX_DEPTH = 1024, 16, 4  # the flagship (bench.py:30-32)
COUNT_SPP = 2  # samples of the active-fraction count (bench.py:75)
D50, WAVE = 50, 1 << 14  # the refill loop's depth and wave (bench.py:105-109)
GRAD_SIZE, BAND = (1920, 1080), 1 << 18  # the gradient's frame and band (bench.py:155-172)
SOUP_TRI, SOUP_RAYS = 3000, 1024  # the kernel check (bench.py:244-250)


def card(device):
    """(name, power limit) of the card `device` names, from nvidia-smi, or
    (device, None) on the CPU."""
    if torch.device(device).type != "cuda":
        return str(device), None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(torch.device(device)), smi.split(",")[-1].strip()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def with_camera(scene, width, height):
    """The scene seen through its own camera at width x height."""
    cam = scene.meta.camera
    new = Camera(width, height, cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(scene, meta=dataclasses.replace(scene.meta, camera=new))


def throughput(scene, options):
    """(best seconds of 3 renders, Mrays/s) after a 1-spp warm-up render."""
    device = scene.background.device
    render_image(scene, dataclasses.replace(options, spp=1))
    dts = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        render_image(scene, options)
        sync(device)
        dts.append(time.perf_counter() - t0)
    cam = scene.meta.camera
    rays = cam.width * cam.height * options.spp * (1 + 2 * (options.max_depth + 1))
    return min(dts), rays / min(dts) / 1e6


def query_counts(scene, options, spp):
    """(nominal, active) queries of the scan loop over `spp` samples of
    every pixel (trace_query_counts), in batches of at most
    options.max_rays_per_pass paths."""
    cam = scene.meta.camera
    n_pix, per = cam.width * cam.height, options.max_rays_per_pass
    dev = scene.background.device
    nom = act = 0
    with torch.inference_mode():
        for s in range(spp):
            for p0 in range(0, n_pix, per):
                pix = torch.arange(p0, min(p0 + per, n_pix), dtype=torch.int32, device=dev)
                streams = rng.make_stream(options.seed, pix, torch.full_like(pix, s))
                jx = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
                jy = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
                px = (pix % cam.width).float()
                py = torch.div(pix, cam.width, rounding_mode="floor").float()
                ro, rd = generate_rays(cam, px, py, jx, jy)
                n_, a_ = trace_query_counts(scene, options, ro, rd, streams)
                nom, act = nom + n_, act + a_
    return nom, act


def wavefront_counts(scene, max_depth=D50, wave=WAVE):
    """(nominal, active, seconds) of the refill loop over every pixel at
    1 spp and `max_depth`, with a wave of `wave` lanes (wavefront.WAVE_SIZE,
    restored after). The loop syncs the host once an iteration; it runs
    nominal / (2 min(P, wave)) iterations."""
    cam = scene.meta.camera
    P = cam.width * cam.height
    dev = scene.background.device
    pix = torch.arange(P, dtype=torch.int32, device=dev)
    saved, wavefront.WAVE_SIZE = wavefront.WAVE_SIZE, wave
    try:
        sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            _, nom, act = wavefront.trace_wavefront(scene, RenderOptions(spp=1, max_depth=max_depth, seed=0), pix,
                                                    torch.zeros_like(pix), cam.width, with_counts=True)
        sync(dev)
        return nom, act, time.perf_counter() - t0
    finally:
        wavefront.WAVE_SIZE = saved


def _sumsq(g):
    """Sum of squares of a Scene-shaped gradient's float32 tables, on the device."""
    return sum(torch.sum(x * x) for x in float_tables(g).values() if x.dtype == torch.float32)


def banded_grad(scene, width=GRAD_SIZE[0], height=GRAD_SIZE[1], band=BAND, max_depth=MAX_DEPTH):
    """The replay gradient of the frame at width x height, 1 spp, in bands
    of `band` pixels against a zero target, after one warm-up band. Returns
    {seconds, mrays, finite, sumsq, losses, bands}: the timed bands' seconds,
    forward + replay Mrays/s over the paths traced, and the sum over bands
    of each band's gradient's sum of squares (one host sync a band)."""
    scene = with_camera(scene, width, height)
    dev = scene.background.device
    opts = RenderOptions(spp=1, max_depth=max_depth, seed=0, grad_mode="replay")
    n_pix = width * height
    first = min(band, n_pix)
    _, g = grad.render_loss_grad(scene, opts, torch.arange(first, dtype=torch.int32, device=dev),
                                 torch.zeros((first, 3), device=dev), 1)
    float(_sumsq(g))
    sync(dev)
    t0 = time.perf_counter()
    sumsq, losses = 0.0, []
    for lo in range(0, n_pix, band):
        pix = torch.arange(lo, min(lo + band, n_pix), dtype=torch.int32, device=dev)
        loss, g = grad.render_loss_grad(scene, opts, pix, torch.zeros((pix.shape[0], 3), device=dev), 1)
        s, loss = torch.stack([_sumsq(g), loss]).tolist()
        sumsq += s
        losses.append(loss)
    dt = time.perf_counter() - t0
    rays = n_pix * (1 + 2 * (max_depth + 1)) * 2  # forward + replay
    return {"seconds": dt, "mrays": rays / dt / 1e6, "finite": bool(np.isfinite(sumsq)), "sumsq": sumsq,
            "losses": losses, "bands": len(losses)}


def soup_scene(n_tri, seed=0, spread=10.0, device="cuda"):
    """benchmarks/tpu_smoke.py's random triangle soup (tpu_smoke.py:25-38),
    with a BVH, on `device`."""
    rs = np.random.default_rng(seed)
    b = SceneBuilder()
    b.camera = Camera(8, 8, (0, 0, 30), (0, 0, 0), (0, 1, 0), 45.0)
    m = b.add_material(MAT_DIFFUSE)
    centers = rs.uniform(-spread, spread, (n_tri, 3))
    verts = centers[:, None, :] + rs.uniform(-0.8, 0.8, (n_tri, 3, 3))
    faces = np.arange(3 * n_tri).reshape(n_tri, 3)
    b.add_mesh(verts.reshape(-1, 3), faces, m)
    return b.build(device=device, build_bvh=True)


def soup_rays(n, device):
    """bench.py:250-257's rays: origins in [-14, 14]^3, isotropic
    directions, [1e-4, +inf)."""
    rs = np.random.default_rng(0)
    ro = rs.uniform(-14, 14, (n, 3))
    d = rs.normal(size=(n, 3))
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    ro, rd = (torch.as_tensor(x, dtype=torch.float32, device=device) for x in (ro, rd))
    return ro, rd, torch.full((n,), 1e-4, device=device), torch.full((n,), float("inf"), device=device)


def kernels_check(device, n_tri=SOUP_TRI, n_rays=SOUP_RAYS):
    """Each kernel route on the soup against brute.closest_plain's winner
    (the reference of bench.py:259-261). Returns (ok, error string)."""
    scene = soup_scene(n_tri, device=device)
    bvh, g, n = scene.bvh, scene.geometry, scene.meta.n_tri
    rays = soup_rays(n_rays, device)
    ref = brute.closest_plain(g.tri_rows, g.tri_attr, n, *rays)[5]
    hit = ref >= 0
    got = {
        "packet": packet.closest(bvh, *rays)[3],
        "cluster": cluster.closest(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *rays)[3],
        "sweep": sweep.closest(bvh.cl_aabb, bvh.tris, n, *rays)[3],
    }
    occ = {
        "packet any-hit": packet.occluded(bvh, *rays),
        "cluster any-hit": cluster.occluded(bvh.sup_aabb, bvh.cl_aabb, bvh.tris, *rays),
        "sweep any-hit": sweep.occluded(bvh.cl_aabb, bvh.tris, n, *rays),
    }
    errs = [f"{k} {int((p != ref).sum())} mismatches" for k, p in got.items() if not torch.equal(p, ref)]
    errs += [f"{k} {int((o != hit).sum())}" for k, o in occ.items() if not torch.equal(o, hit)]
    return not errs, "; ".join(errs)


def record(device="cuda", res=RES, spp=SPP, grad_size=GRAD_SIZE, band=BAND, wave=WAVE):
    """bench.py's record (see the module's docstring)."""
    name, power = card(device)
    scene = with_camera(parse_scene_file(str(CBOX), device=device), res, res)
    options = RenderOptions(spp=spp, max_depth=MAX_DEPTH, seed=0)
    _, mrays = throughput(scene, options)
    nom, act = query_counts(scene, options, COUNT_SPP)
    active_fraction = act / max(nom, 1)
    nom50, act50, _ = wavefront_counts(scene, D50, wave)
    g = banded_grad(scene, *grad_size, band)
    ok, err = kernels_check(device)
    rec = {
        "metric": "cbox_1024_fwd_throughput",
        "value": round(mrays, 3),
        "unit": "Mrays/s/chip" if torch.device(device).type == "cuda" else "Mrays/s (cpu)",
        # bench.py divides by BASELINE.json's 100 Mrays/s target for a TPU
        # chip; no TPU number is the port's baseline, so there is none
        "vs_baseline": None,
        "active_fraction": round(active_fraction, 4),
        "active_mrays": round(mrays * active_fraction, 3),
        "grad_1080p_seconds": round(g["seconds"], 3),
        "grad_1080p_mrays": round(g["mrays"], 3),
        "grad_norm_finite": g["finite"],
        "active_fraction_d50_wavefront": round(act50 / max(nom50, 1), 4),
        "kernels_onchip_ok": ok,
        "device": name,
        "power_limit": power,
        "torch": torch.__version__,
    }
    if not ok:
        rec["kernels_onchip_error"] = err[:200]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(prog="take_tpu_torch.bench")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--out", default=None, help="also write the record to this file")
    ap.add_argument("--res", type=int, default=RES, help="the flagship's and the refill loop's resolution")
    ap.add_argument("--spp", type=int, default=SPP, help="the flagship's samples per pixel")
    ap.add_argument("--grad-size", default="x".join(map(str, GRAD_SIZE)), help="the gradient's WxH")
    ap.add_argument("--band", type=int, default=BAND, help="pixels a gradient band")
    ap.add_argument("--wave", type=int, default=WAVE, help="the refill loop's lanes")
    args = ap.parse_args(argv)
    grad_size = tuple(int(x) for x in args.grad_size.split("x"))
    rec = record(args.device, args.res, args.spp, grad_size, args.band, args.wave)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if rec["kernels_onchip_ok"] and rec["grad_norm_finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
