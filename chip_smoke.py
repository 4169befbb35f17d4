#!/usr/bin/env python3
"""Smoke check of take_tpu_torch on one CUDA card: `python3 chip_smoke.py`.

Drives the port's main path (scenes/cbox/cbox.xml, 1024x1024, 16 spp,
max_depth 4, seed 0) on the card, in phases; each phase prints one line and
any failure raises, so the exit code is non-zero:

  1. device: the card's name and nvidia-smi's name and power limit;
  2. build: compiles the CUDA kernels from take_tpu_torch/csrc;
  3. kernel parity: K1 (closest hit) and K2 (any hit) against their plain
     twins on 2^20 rays made from a numpy seed, on the card;
  4. main path: render_image through the kernels (launch counters must
     show kernels only), then at 256x256 through the plain twins;
  5. times: the render's Mrays/s (bench.py's metric), active_fraction,
     and each kernel's per-call time beside its twin's.

It then prints the kernels' JSON line and, last, the device JSON line. It
fails without a CUDA device, and when run outside a checkout of the repo.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "scenes" / "cbox" / "cbox.xml"
RES, SPP, MAX_DEPTH, SEED = 1024, 16, 4, 0
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


def make_rays(torch, scene, rng, n):
    """2^20 rays: camera rays, rays from inside the box, finite-tmax shadow
    rays toward the light, ~10% dead lanes (tmax = -3.4e38), and padded rays
    (tmax = -1) appended the way the JAX package pads its Pallas grid."""
    from take_tpu_torch.core.camera import Camera, generate_rays
    from take_tpu_torch.geometry.intersect import _pad_rays
    from take_tpu_torch.scene.types import LATTR_E1, LATTR_E2, LATTR_V0

    n_pad = 100
    n_cam, n_box = 4 * n // 10, 3 * n // 10
    n_shadow = n - n_pad - n_cam - n_box
    cam = scene.meta.camera
    pix = rng.integers(0, RES * RES, n_cam)
    px = torch.tensor(pix % RES, dtype=torch.float32)
    py = torch.tensor(pix // RES, dtype=torch.float32)
    jx, jy = (torch.tensor(rng.random(n_cam), dtype=torch.float32) for _ in range(2))
    ro_c, rd_c = generate_rays(Camera(RES, RES, cam.lookfrom, cam.lookat, cam.up, cam.vfov), px, py, jx, jy)

    lo, hi = np.array([1.0, 1.0, 1.0]), np.array([555.0, 547.0, 558.0])
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

    t, u, v, _ = tri_uvt(g.tri_affine_o, g.tri_affine_d, n_tri, ro, rd, tmin, tmax)
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
    tpad = g.tri_affine_d.shape[1] // 3
    p = prim.long()
    oh = torch.cat([ro, torch.ones_like(ro[:, :1])], dim=1)
    ao = [g.tri_affine_o[:, k * tpad + p].T for k in range(3)]  # [M, 4]
    ad = [g.tri_affine_d[:, k * tpad + p].T for k in range(3)]  # [M, 3]
    s = [(a * oh).sum(1) for a in ao]
    d = [(a * rd).sum(1) for a in ad]
    S = [(a * oh).abs().sum(1) for a in ao]
    D = [(a * rd).abs().sum(1) for a in ad]
    t = (-s[2] / d[2]).abs()
    et = 8 * eps * (S[2] + t * D[2]) / d[2].abs() + 2 * eps * t
    eu = 8 * eps * (S[0] + t * D[0]) + d[0].abs() * et + 4 * eps * (s[0].abs() + t * d[0].abs())
    ev = 8 * eps * (S[1] + t * D[1]) + d[1].abs() * et + 4 * eps * (s[1].abs() + t * d[1].abs())
    return 2 * et, 2 * eu, 2 * ev


def parity_phase(torch, brute, scene, rays, dead):
    g, n_tri = scene.geometry, scene.meta.n_tri
    ro, rd, tmin, tmax = rays
    a_k, t_k, u_k, v_k, f_k, p_k = brute.closest(g.tri_affine_o, g.tri_affine_d, g.tri_attr, n_tri, *rays)
    a_p, t_p, u_p, v_p, f_p, p_p = brute.closest_plain(g.tri_affine_o, g.tri_affine_d, g.tri_attr, n_tri, *rays)
    torch.cuda.synchronize()
    agree = p_k == p_p
    frac = agree.float().mean().item()
    bad = ~agree
    n_bad = int(bad.sum())
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
    attrs_equal = bool(torch.equal(a_k[both], a_p[both]))
    err_closest = max(dt.max().item(), du.max().item(), dv.max().item())  # t in world units
    dead_miss = bool((p_k[dead] == -1).all() and (p_p[dead] == -1).all()
                     and (t_k[dead] == BIG).all())
    worst = int(t_rel.argmax())
    phase("parity", f"K1 closest: prim agrees on {frac:.6f} of {ro.shape[0]} rays, "
          f"{n_bad} mismatches, {unexplained} not at a near-tie/edge/range end; "
          f"agreeing hits {int(both.sum())}: {flat_frac:.6f} within rel t {REL_T} and abs u/v {ABS_UV} "
          f"(max rel t {t_rel.max().item():.3e} at t={t_p[both][worst].item():.4g}, "
          f"max abs u {du.max().item():.3e} v {dv.max().item():.3e}), "
          f"{over_bound} beyond the float32 rounding bound; "
          f"attrs equal {attrs_equal}; dead+padded lanes miss {dead_miss}")
    if frac < PRIM_AGREE_MIN or unexplained or over_bound or not attrs_equal or not dead_miss:
        raise RuntimeError("K1 disagrees with closest_plain")

    o_k = brute.occluded(g.tri_affine_o, g.tri_affine_d, n_tri, *rays)
    o_p = brute.occluded_plain(g.tri_affine_o, g.tri_affine_d, n_tri, *rays)
    torch.cuda.synchronize()
    obad = o_k != o_p
    ofrac = 1.0 - obad.float().mean().item()
    n_obad = int(obad.sum())
    if n_obad:
        idx = obad.nonzero()[:, 0]
        explained = near_boundary(torch, g, n_tri, ro[idx], rd[idx], tmin[idx], tmax[idx], None)
        o_unexplained = int((~explained).sum())
    else:
        o_unexplained = 0
    odead = bool((~o_k[dead]).all() and (~o_p[dead]).all())
    # max |occ_kernel - occ_plain| over the rays not at a decision boundary
    err_anyhit = float(o_unexplained > 0)
    phase("parity", f"K2 any-hit: occ agrees on {ofrac:.6f} of rays ({int(o_k.sum())} occluded), "
          f"{n_obad} mismatches, {o_unexplained} not near a boundary; dead+padded lanes clear {odead}")
    if ofrac < PRIM_AGREE_MIN or o_unexplained or not odead:
        raise RuntimeError("K2 disagrees with occluded_plain")
    return err_closest, err_anyhit


def with_res(scene, res):
    from take_tpu_torch.core.camera import Camera

    cam = scene.meta.camera
    return dataclasses.replace(scene, meta=dataclasses.replace(
        scene.meta, camera=Camera(res, res, cam.lookfrom, cam.lookat, cam.up, cam.vfov)))


def time_call(torch, fn, warmup=3, iters=20):
    """Milliseconds per call by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch

    name, smi = device_phase(torch)
    if not (ROOT / "take_tpu_torch" / "__init__.py").is_file() or not SCENE.is_file():
        raise RuntimeError(f"{ROOT} is not a checkout of the repo (no take_tpu_torch/ or scenes/)")
    sys.path.insert(0, str(ROOT))
    from take_tpu_torch.core import rng as prng
    from take_tpu_torch.core.camera import generate_rays
    from take_tpu_torch.geometry import _build, brute
    from take_tpu_torch.integrator.path_tracer import trace_query_counts
    from take_tpu_torch.io.exr import write_exr
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    t0 = time.perf_counter()
    lib, nvcc_s, log = _build.build("brute")
    brute._lib()
    ptxas = "; ".join(l.split("ptxas info    : ")[-1] for l in log.splitlines() if "Used" in l)
    phase("build", f"{lib.name}: nvcc {nvcc_s:.2f} s, load {time.perf_counter() - t0:.2f} s; {ptxas}")

    dev = torch.device(DEVICE)
    scene = with_res(parse_scene_file(str(SCENE), device=dev), RES)
    rays, dead = make_rays(torch, scene, np.random.default_rng(SEED), N_RAYS)
    err_closest, err_anyhit = parity_phase(torch, brute, scene, rays, dead)

    options = RenderOptions(spp=SPP, max_depth=MAX_DEPTH, seed=SEED)
    torch.cuda.synchronize()
    brute.reset_launches()
    img = render_image(scene, options)
    torch.cuda.synchronize()
    launches = dict(brute.LAUNCHES)
    finite = bool(np.isfinite(img).all())
    phase("main", f"render {RES}x{RES} {SPP} spp d{MAX_DEPTH}: shape {img.shape}, finite {finite}, "
          f"mean {img.mean(axis=(0, 1)).tolist()}, launches {launches}")
    if img.shape != (RES, RES, 3) or not finite:
        raise RuntimeError("main-path image is not finite or has the wrong shape")
    if launches["closest"] == 0 or launches["anyhit"] == 0 or launches["closest_plain"] or launches["anyhit_plain"]:
        raise RuntimeError(f"main path did not run on the kernels alone: {launches}")
    out = ROOT / "build" / "take_tpu_torch" / "cbox_1024.exr"
    out.parent.mkdir(parents=True, exist_ok=True)
    write_exr(str(out), img)

    small = with_res(scene, 256)
    img_k = render_image(small, options)
    with mock.patch.object(brute, "closest", brute.closest_plain), \
            mock.patch.object(brute, "occluded", brute.occluded_plain):
        img_p = render_image(small, options)
    torch.cuda.synchronize()
    mk, mp = img_k.mean(axis=(0, 1)), img_p.mean(axis=(0, 1))
    mean_rel = float(np.max(np.abs(mk - mp) / np.abs(mp)))
    phase("main", f"256x256 kernels vs plain twins on the card: means {mk.tolist()} vs {mp.tolist()}, "
          f"max rel {mean_rel:.3e} (limit {MEAN_REL}); wrote {out.relative_to(ROOT)}")
    if not np.isfinite(img_p).all() or mean_rel > MEAN_REL:
        raise RuntimeError("kernel render disagrees with the plain-twin render")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_image(scene, options)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rays_total = RES * RES * SPP * (1 + 2 * (MAX_DEPTH + 1))
    mrays = rays_total / dt / 1e6

    nom = act = 0
    pix = torch.arange(RES * RES, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for s in range(2):
            streams = prng.make_stream(SEED, pix, torch.full_like(pix, s))
            jx = prng.uniform(streams, prng.camera_counter(prng.DIM_CAMERA_JITTER_X))
            jy = prng.uniform(streams, prng.camera_counter(prng.DIM_CAMERA_JITTER_Y))
            px = (pix % RES).float()
            py = torch.div(pix, RES, rounding_mode="floor").float()
            ro, rd = generate_rays(scene.meta.camera, px, py, jx, jy)
            n_, a_ = trace_query_counts(scene, options, ro, rd, streams)
            nom, act = nom + n_, act + a_
    active_fraction = act / nom

    g, n_tri = scene.geometry, scene.meta.n_tri
    args_c = (g.tri_affine_o, g.tri_affine_d, g.tri_attr, n_tri, *rays)
    args_o = (g.tri_affine_o, g.tri_affine_d, n_tri, *rays)
    ms = {
        "closest": time_call(torch, lambda: brute.closest(*args_c)),
        "closest_plain": time_call(torch, lambda: brute.closest_plain(*args_c)),
        "anyhit": time_call(torch, lambda: brute.occluded(*args_o)),
        "anyhit_plain": time_call(torch, lambda: brute.occluded_plain(*args_o)),
    }
    phase("times", f"render {dt:.4f} s = {mrays:.3f} Mrays/s; active_fraction {active_fraction:.6f}; "
          f"per call at N={N_RAYS}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; card: {smi}")

    kernels = [
        dict(name="closest", route="cuda", source="take_tpu_torch/csrc/brute.cu",
             replaces="take_tpu/geometry/pallas_brute.py:77", launches=launches["closest"],
             max_abs_err=err_closest, ms=ms["closest"], plain_ms=ms["closest_plain"]),
        dict(name="anyhit", route="cuda", source="take_tpu_torch/csrc/brute.cu",
             replaces="take_tpu/geometry/pallas_brute.py:129", launches=launches["anyhit"],
             max_abs_err=err_anyhit, ms=ms["anyhit"], plain_ms=ms["anyhit_plain"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
