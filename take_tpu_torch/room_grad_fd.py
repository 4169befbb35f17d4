"""Room-scale gradients held against finite differences and take_tpu's own:
`python3 -m take_tpu_torch.room_grad_fd [--device cuda] [--out PATH]`.

Port of benchmarks/room_grad_fd.py. On room (scenes/room/room.xml: 105,998
triangles, its BVH, K3 on every query) at its 1920x1080 camera, the band of
2^16 mid-frame pixels x 4 samples (one 2^18-path gradient band), d6, seed
17, it differentiates mean(render_radiance) with respect to a scalar d at 0
for the three parameters room has, perturbed as the JAX script's
`perturbed` does:
  * albedo0, albedo1: materials.attr[m, MATTR_TEX_VALUE:+3] += d;
  * emission: lights.attr[:, LATTR_INTENSITY:+3] *= 1 + d (the lights'
    table alone, as the JAX script scales it: NEE's radiance).
Per parameter: `grad_replay` and `grad_ad` (grad_mode "replay" and "ad",
through grad.partial_loss_grad: on the card one captured graph per mode,
replayed for every parameter, since only float tables' values change),
`fd` (central, eps 1e-2, common random numbers: both forwards take the same
seed and sample window), the JAX script's two ratios, and `t_replay_s`,
`t_ad_s` (synchronised, after one warm-up gradient in each mode) with the
peak memory of each (`max_memory_allocated`).

Gates (exit 1 when one misses; GATE MISSED lines say which):
  * the JAX script's: ad_vs_fd_rel < 0.05 and replay_vs_ad_rel < 1e-3;
  * K3 alone launched (`_launch.LAUNCHES`: packet_closest, packet_anyhit;
    their plain twins on the CPU).
At the full spec each grad_ad is also held against take_tpu's AD gradient
of the same band (TAKE_TPU_GRAD_AD): past 1e-2 relative the script raises.
A wrong gradient scope (a missing NEE or emission term) moves a gradient by
tens of percent; paths diverging at the ulp level move it by about 1e-4.

The JSON record is printed (and written to --out); the JAX script's
appending to benchmarks/results_r5.json is not ported.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

from take_tpu_torch import grad
from take_tpu_torch.bench import card, sync
from take_tpu_torch.geometry import _launch
from take_tpu_torch.scene import types as T
from take_tpu_torch.scene.parse_xml import parse_scene_file

ROOM = Path(__file__).resolve().parent.parent / "scenes" / "room" / "room.xml"
PIXELS, SAMPLES, DEPTH, SEED, EPS = 1 << 16, 4, 6, 17, 1e-2  # room_grad_fd.py:54-57, :78, :102
AD_FD_MAX, REPLAY_AD_MAX = 0.05, 1e-3  # room_grad_fd.py:125-128
# take_tpu's AD gradients of this band on the TPU, at the full spec above:
# benchmarks/results_r5.json["room_grad_fd"][param]["grad_ad"], written by
# benchmarks/room_grad_fd.py (its replay within 8e-7, its FD within 2.3e-4)
TAKE_TPU_GRAD_AD = {"albedo0": 1.0458290576934814, "albedo1": 0.021381128579378128, "emission": 0.29579633474349976}
TAKE_TPU_MAX = 1e-2


def band_pixels(scene, pixels, device):
    """`pixels` consecutive pixel ids around the frame's middle row
    (room_grad_fd.py:56): the rows there see the whole room."""
    cam = scene.meta.camera
    y0 = (cam.height // 2 - pixels // cam.width // 2) * cam.width
    return torch.arange(y0, y0 + pixels, dtype=torch.int32, device=device)


def params(scene):
    """room_grad_fd.py:95: the first two materials' albedo and the emission."""
    return [f"albedo{m}" for m in range(min(2, scene.materials.attr.shape[0]))] + ["emission"]


def perturbed(scene, which, d):
    """The scene with parameter `which` moved by d (room_grad_fd.py:63-75)."""
    if which.startswith("albedo"):
        mask = torch.zeros_like(scene.materials.attr)
        mask[int(which[-1]), T.MATTR_TEX_VALUE : T.MATTR_TEX_VALUE + 3] = 1.0
        return dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, attr=scene.materials.attr + d * mask))
    la = scene.lights.attr.clone()
    la[:, T.LATTR_INTENSITY : T.LATTR_INTENSITY + 3] = (
        scene.lights.attr[:, T.LATTR_INTENSITY : T.LATTR_INTENSITY + 3] * (1.0 + d))
    return dataclasses.replace(scene, lights=dataclasses.replace(scene.lights, attr=la))


def mean_radiance(scene, which, d, mode, pix, samples=SAMPLES, depth=DEPTH, seed=SEED):
    """mean(render_radiance) of the band with `which` moved by d."""
    options = T.RenderOptions(spp=1, max_depth=depth, seed=seed, grad_mode=mode)
    return grad.render_radiance(perturbed(scene, which, d), options, pix, 0, samples).mean()


def band_grad(scene, which, mode, pix, samples=SAMPLES, depth=DEPTH, seed=SEED):
    """(the band's mean radiance, its Scene-shaped gradient, d mean / d d at
    0) with `which` moved by d, under `mode`: grad.partial_loss_grad's
    linear loss with unit weights (take_tpu jits jax.grad of the mean),
    whose passes on the card replay captured graphs, carried into d by
    grad.backward."""
    dev = pix.device
    d = torch.zeros((), device=dev, requires_grad=True)
    s = perturbed(scene, which, d)
    options = T.RenderOptions(spp=1, max_depth=depth, seed=seed, grad_mode=mode)
    ones = torch.ones((pix.shape[0], 3), dtype=torch.float32, device=dev)
    mean, g = grad.partial_loss_grad(s, options, pix, ones, samples, mode, ones.numel(), loss="linear")
    grad.backward(s, g)
    return mean, g, d.grad


def gradient(scene, which, mode, pix, **kw):
    """(d mean / d d at 0, seconds, peak bytes on the card) under `mode`
    (band_grad)."""
    dev = pix.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    g = float(band_grad(scene, which, mode, pix, **kw)[2])
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return g, dt, peak


def run(scene, pixels=PIXELS, samples=SAMPLES, depth=DEPTH, seed=SEED):
    """Every parameter's gradients, FD, ratios, times and memory. Returns
    (record, the gates missed). Raises where a grad_ad at the full spec is
    past TAKE_TPU_MAX of take_tpu's."""
    dev = scene.background.device
    pix = band_pixels(scene, pixels, dev)
    kw = dict(samples=samples, depth=depth, seed=seed)
    names = params(scene)
    for mode in ("replay", "ad"):  # warm-up: the kernels' build, the first launches
        gradient(scene, names[0], mode, pix, **kw)
    full = (pixels, samples, depth, seed) == (PIXELS, SAMPLES, DEPTH, SEED)
    sync(dev)
    _launch.reset_launches()
    rec, misses = {"band_paths": pixels * samples, "depth": depth}, []
    for which in names:
        g_replay, t_replay, m_replay = gradient(scene, which, "replay", pix, **kw)
        g_ad, t_ad, m_ad = gradient(scene, which, "ad", pix, **kw)
        with torch.no_grad():
            fp = float(mean_radiance(scene, which, EPS, "ad", pix, **kw))
            fm = float(mean_radiance(scene, which, -EPS, "ad", pix, **kw))
        fd = (fp - fm) / (2 * EPS)
        r = {
            "grad_ad": g_ad,
            "grad_replay": g_replay,
            "fd": fd,
            "ad_vs_fd_rel": abs(g_ad - fd) / max(abs(fd), 1e-12),
            "replay_vs_ad_rel": abs(g_replay - g_ad) / max(abs(g_ad), 1e-12),
            "t_replay_s": t_replay,
            "t_ad_s": t_ad,
            "peak_replay_gib": None if m_replay is None else m_replay / 2**30,
            "peak_ad_gib": None if m_ad is None else m_ad / 2**30,
        }
        if full:
            ref = TAKE_TPU_GRAD_AD[which]
            r["vs_take_tpu_rel"] = abs(g_ad - ref) / abs(ref)
        rec[which] = r
        print(which, json.dumps(r), flush=True)
        if full and r["vs_take_tpu_rel"] > TAKE_TPU_MAX:
            raise RuntimeError(f"{which}: grad_ad {g_ad} is {r['vs_take_tpu_rel']:.3e} from take_tpu's {ref} "
                               f"(limit {TAKE_TPU_MAX})")
        if not r["ad_vs_fd_rel"] < AD_FD_MAX:
            misses.append(f"{which}: ad_vs_fd_rel {r['ad_vs_fd_rel']:.3e} (limit {AD_FD_MAX})")
        if not r["replay_vs_ad_rel"] < REPLAY_AD_MAX:
            misses.append(f"{which}: replay_vs_ad_rel {r['replay_vs_ad_rel']:.3e} (limit {REPLAY_AD_MAX})")
    sync(dev)
    suffix = "" if dev.type == "cuda" else "_plain"
    want = {f"packet_closest{suffix}", f"packet_anyhit{suffix}"}
    rec["launches"] = {k: v for k, v in _launch.LAUNCHES.items() if v}
    if set(rec["launches"]) != want:
        misses.append(f"launches {rec['launches']}: not {sorted(want)} alone")
    rec["gradient_allclose"] = not misses
    return rec, misses


def main(argv=None):
    ap = argparse.ArgumentParser(prog="take_tpu_torch.room_grad_fd")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--out", default=None, help="also write the record to this file")
    ap.add_argument("--pixels", type=int, default=PIXELS, help="pixels in the band")
    ap.add_argument("--samples", type=int, default=SAMPLES, help="samples a pixel")
    ap.add_argument("--depth", type=int, default=DEPTH, help="max_depth")
    args = ap.parse_args(argv)
    name, power = card(args.device)
    t0 = time.perf_counter()
    scene = parse_scene_file(str(ROOM), device=args.device)
    t_parse = time.perf_counter() - t0
    rec, misses = run(scene, args.pixels, args.samples, args.depth)
    rec.update(parse_s=t_parse, device=name, power_limit=power, torch=torch.__version__)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    for m in misses:
        print(f"GATE MISSED: {m}", flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
