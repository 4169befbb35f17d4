"""The five published configs at full spec, each image held against take_tpu's own.

    python3 -m take_tpu_torch.run_configs [--only cbox,mis] [--json OUT] [--device cuda]
        [--out DIR] [--pixels N] [--tpu-envmap-bf16]

The port's counterpart of benchmarks/run_benchmarks.py: the same CONFIGS,
a warm-up of one pass of the production shape, then the render through
render.render_image, the best of 3 when one takes under 5 s, and one JSON
line per config with run_benchmarks' keys (rays = paths x (1 + 2 (max_depth
+ 1)), bench.py's metric). EXRs go to build/take_tpu_torch/configs/ (--out).

Each image is held against the TPU render of the same spec that take_tpu
committed (`vs_take_tpu`, benchmarks/out/<name>.exr; room's is
room_1080p_1024spp.exr), and room also against the C++ reference binary's
128-spp golden (`parity_vs_reference_128spp`, parity_stats, the record's own
comparison). The RNG is counter-based per (pixel, sample), so at one spec the
port computes take_tpu's paths: a pixel differs only where a path diverges at
the ulp level (the card's and the TPU's transcendentals differ in the last
bit). The EXRs hold half floats, so the image is rounded to half floats, as
its own EXR holds it, before it is held against one.

The gates (a miss makes the exit code 1):
  * each channel's mean within MEAN_REL of the reference's;
  * at most SHARE_BEYOND[scene] of the pixels beyond the per-pixel bound
    (the pixel's largest channel difference above
    PIXEL_REL * max(the reference pixel's largest channel, PIXEL_FLOOR));
  * room's three parity_stats figures against the golden, over the
    record's 16 blocks a side (GOLDEN_BLOCKS; run_benchmarks' parity_stats
    takes 8 at 1080 rows and is reported beside them), at most GOLDEN_SLACK
    times the record's (GOLDEN_RECORD).

ibl is held against take_tpu in float32 instead: its TPU image rotates the
environment's directions with a matmul at the TPU's default precision
(take_tpu/lights/envmap.py:100 and :113 round both operands to bfloat16),
which shifts every path that meets the sky. take_tpu at HEAD on the CPU
computes those in float32, as the port does: TAKE_TPU_IBL holds its image at
a seeded set of pixels (written by tests/take_tpu_pixels.py), the gate for
ibl (`vs_take_tpu_f32`); its `vs_take_tpu` figures are reported ungated.
--tpu-envmap-bf16 renders ibl with the port's two transforms at bfloat16
operands, as the TPU ran them, and gates it against the EXR like the rest.

--pixels N renders only N seeded pixels of each config (at its full spp,
camera and resolution) through render.render_pass and holds them against
the same pixels of the references: a cheap check, on the CPU too. Room's
golden needs the whole frame, so --pixels refuses room.

A missing reference, or one of another shape, is an error.
"""

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SCENES = ROOT / "scenes"
TAKE_TPU_OUT = ROOT / "benchmarks" / "out"
GOLDEN = ROOT / "benchmarks" / "goldens" / "room_d6_128spp_reference.exr"
TAKE_TPU_IBL = Path(__file__).resolve().parent / "data" / "ibl_1024_256spp_take_tpu_f32.npz"
OUT = ROOT / "build" / "take_tpu_torch" / "configs"

CONFIGS = [
    # (name, scene, res_override, spp, max_depth) — the five BASELINE.json
    # configs at their full spec (room at its 1024 spp)
    ("cbox_256_16spp", "cbox/cbox.xml", 256, 16, 4),
    ("textured_512_64spp", "textured/textured.xml", 512, 64, 6),
    ("mis_512_128spp", "mis/mis.xml", 512, 128, 6),
    ("ibl_1024_256spp", "ibl/ibl.xml", 1024, 256, 6),
    ("room_1080p_1024spp", "room/room.xml", None, 1024, 6),
]

MEAN_REL = 1e-4
PIXEL_REL, PIXEL_FLOOR = 1e-3, 1e-2
# mis's paths diverge between any two platforms more than the others': its
# exponent lobes and sphere lights carry last-bit differences of pow and
# sqrt into other directions. Measured: the H100's image 0.704% beyond the
# TPU's; take_tpu itself on the CPU 0.757% of 16,384 seeded pixels beyond
# its TPU image (python -m tests.take_tpu_pixels mis_512_128spp 16384; PERF.md).
SHARE_BEYOND = {"cbox": 0.005, "textured": 0.005, "mis": 0.01, "ibl": 0.005, "room": 0.005}
# the record's room parity (benchmarks/results_r5_configs.json), taken by
# benchmarks/room_parity_r5.py:36-52: parity_stats' figures over 16 blocks a side
GOLDEN_RECORD = {"mean_rel_err": 0.00014, "block_rel_median": 0.00058, "block_rel_p99": 0.00365}
GOLDEN_BLOCKS = 16
GOLDEN_SLACK = 1.2
SUBSET_SEED = 0


def parity_stats(ours, ref, nb=None):
    """Statistical parity metrics between two renders of one scene.

    Resolutions may differ by an integer factor (box-filter block means
    estimate the same continuous image under jittered sampling). `nb` blocks
    a side over the top-left square (by default run_benchmarks' choice: 16
    where they divide the height, else 8).
    """
    H, W = ours.shape[:2]
    fy, fx = ref.shape[0] // H, ref.shape[1] // W
    if fy > 1 or fx > 1:
        ref = ref.reshape(H, fy, W, fx, 3).mean(axis=(1, 3))
    m_ref = ref.mean(axis=(0, 1))
    m_ours = ours.mean(axis=(0, 1))
    mean_rel = float(np.abs(m_ours - m_ref).sum() / (m_ref.sum() + 1e-12))
    nb = nb or (16 if H % 16 == 0 else 8)
    b = H // nb
    r = ref[: nb * b, : nb * b].reshape(nb, b, nb, b, 3).mean(axis=(1, 3)).sum(-1)
    o = ours[: nb * b, : nb * b].reshape(nb, b, nb, b, 3).mean(axis=(1, 3)).sum(-1)
    rel = np.abs(o - r) / (r + 0.05)
    return {
        "mean_rel_err": round(mean_rel, 5),
        "block_rel_median": round(float(np.median(rel)), 5),
        "block_rel_p99": round(float(np.quantile(rel, 0.99)), 5),
    }


def pixel_agreement(ours, ref):
    """Per-pixel agreement of two renders of one spec: [H, W, 3] images or
    [N, 3] sets of pixels. Returns each channel's mean relative difference,
    the share (and count) of pixels whose largest channel difference exceeds
    PIXEL_REL * max(the reference pixel's largest channel, PIXEL_FLOOR), and
    the largest absolute difference with its pixel ([row, col], or [index])."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    if ours.shape != ref.shape:
        raise ValueError(f"shapes differ: {ours.shape} vs {ref.shape}")
    axes = tuple(range(ours.ndim - 1))
    m_ours, m_ref = ours.mean(axis=axes), ref.mean(axis=axes)
    diff = np.abs(ours - ref).max(axis=-1)
    scale = np.maximum(np.abs(ref).max(axis=-1), PIXEL_FLOOR)
    beyond = int((diff > PIXEL_REL * scale).sum())
    worst = np.unravel_index(int(np.argmax(diff)), diff.shape)
    return {
        "mean_rel": (np.abs(m_ours - m_ref) / np.abs(m_ref)).tolist(),
        "share_beyond": beyond / diff.size,
        "n_beyond": beyond,
        "n_pixels": int(diff.size),
        "max_abs": float(diff[worst]),
        "max_abs_pixel": [int(i) for i in worst],
    }


def agreement_misses(name, agreement):
    """The gates a pixel_agreement result misses, as strings."""
    out = []
    if max(agreement["mean_rel"]) > MEAN_REL:
        out.append(f"{name}: channel means differ by {agreement['mean_rel']} (limit {MEAN_REL})")
    if agreement["share_beyond"] > share_limit(name):
        out.append(f"{name}: {agreement['n_beyond']} of {agreement['n_pixels']} pixels beyond the per-pixel "
                   f"bound ({agreement['share_beyond']:.3%}; limit {share_limit(name):.3%})")
    return out


def share_limit(name):
    """The share of pixels a config's image may have beyond the per-pixel
    bound, by its scene (the first word of its name)."""
    return SHARE_BEYOND[name.split("_")[0]]


def golden_misses(stats):
    return [f"room vs the 128-spp golden: {k} {stats[k]} above {GOLDEN_SLACK} x the record's {v}"
            for k, v in GOLDEN_RECORD.items() if stats[k] > GOLDEN_SLACK * v]


def read_reference(path, shape):
    """An EXR the runner holds a render against; missing or misshapen is an error."""
    from take_tpu_torch.io.exr import read_exr

    if not Path(path).is_file():
        raise FileNotFoundError(f"reference image {path} is missing")
    ref = read_exr(str(path))
    if ref.shape != tuple(shape):
        raise ValueError(f"reference image {path} has shape {ref.shape}, the render {tuple(shape)}")
    return ref


def subset_ids(n_pixels, n, seed=SUBSET_SEED):
    """n seeded pixel ids (y * W + x, before the image's y-flip); the first
    n of one seed's permutation, so a smaller set is a prefix of a larger."""
    return np.random.default_rng(seed).permutation(n_pixels)[:n].astype(np.int32)


def image_pixels(img, ids):
    """The pixels `ids` of a y-flipped [H, W, 3] image, as [N, 3]."""
    H, W = img.shape[:2]
    return img[H - 1 - ids // W, ids % W]


def render_pixels(scene, options, ids):
    """The pixels `ids` of the image render_image makes, through render_pass
    (all of a pixel's samples in one pass, so its sum is taken in another
    order than render_image's, which can differ in the last bits), in
    batches of at most options.max_rays_per_pass paths. Returns [N, 3]."""
    import torch

    from take_tpu_torch.render import render_pass

    W = scene.meta.camera.width
    per = max(1, options.max_rays_per_pass // options.spp)
    pix = torch.as_tensor(ids, dtype=torch.int32, device=scene.background.device)
    with torch.inference_mode():
        out = [render_pass(scene, options, pix[i:i + per], 0, W, options.spp) for i in range(0, len(ids), per)]
    return (torch.cat(out) / options.spp).cpu().numpy()


@contextlib.contextmanager
def tpu_envmap_bf16():
    """The port's envmap direction transforms with both operands rounded to
    bfloat16 and float32 products and sums, as take_tpu's default-precision
    matmuls (take_tpu/lights/envmap.py:100, :113) run on the TPU. Each
    calls the port's own transform, with a rounded operand or, for the
    product it makes inside, the identity (exact in float32)."""
    import torch

    from take_tpu_torch.lights import envmap

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)

    dir_to_uv, uv_to_dir = envmap._dir_to_uv, envmap._uv_to_dir

    def dir_to_uv_bf16(env, d):
        return dir_to_uv(dataclasses.replace(env, to_local=bf16(env.to_local)), bf16(d))

    def uv_to_dir_bf16(env, u, v):
        eye = torch.eye(3, dtype=env.to_world.dtype, device=env.to_world.device)
        return bf16(uv_to_dir(dataclasses.replace(env, to_world=eye), u, v)) @ bf16(env.to_world.T)

    with mock.patch.object(envmap, "_dir_to_uv", dir_to_uv_bf16), \
            mock.patch.object(envmap, "_uv_to_dir", uv_to_dir_bf16):
        yield


def config_scene(rel, res, device):
    from take_tpu_torch.core.camera import Camera
    from take_tpu_torch.scene.parse_xml import parse_scene_file

    scene = parse_scene_file(str(SCENES / rel), device=device)
    if res is None:
        return scene
    cam = scene.meta.camera
    camera = Camera(res, res, cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(scene, meta=dataclasses.replace(scene.meta, camera=camera))


def timed(fn, sync):
    """(seconds, result): the warm-up is the caller's; one call, then the
    best of 3 when it took under 5 s (run_benchmarks.py:164-185)."""
    t0 = time.perf_counter()
    out = fn()
    sync()
    dt = time.perf_counter() - t0
    if dt < 5.0:
        for _ in range(2):
            t0 = time.perf_counter()
            out = fn()
            sync()
            dt = min(dt, time.perf_counter() - t0)
    return dt, out


def run_config(name, rel, res, spp, depth, device, out_dir, pixels=None, envmap_bf16=False):
    """Render one config and hold it against its references. Returns (the
    result's JSON dict, the gates it misses)."""
    import torch

    from take_tpu_torch.io.exr import write_exr
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.types import RenderOptions

    scene = config_scene(rel, res, device)
    cam = scene.meta.camera
    W, H = cam.width, cam.height
    options = RenderOptions(spp=spp, max_depth=depth, seed=0)
    bf16 = envmap_bf16 and name.startswith("ibl")
    ibl_f32 = name.startswith("ibl") and not envmap_bf16
    ref = read_reference(TAKE_TPU_OUT / f"{name}.exr", (H, W, 3))
    f32 = np.load(TAKE_TPU_IBL) if ibl_f32 else None
    if f32 is not None and f32["spec"].tolist() != [W, H, spp, depth, options.seed]:
        raise ValueError(f"{TAKE_TPU_IBL} holds spec {f32['spec'].tolist()}, not {[W, H, spp, depth, options.seed]}")

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    with tpu_envmap_bf16() if bf16 else contextlib.nullcontext():
        k = max(1, min(spp, options.max_rays_per_pass // (W * H)))
        if pixels is None:
            render_image(scene, dataclasses.replace(options, spp=k))  # warm-up: one pass of the production shape
            dt, img = timed(lambda: render_image(scene, options), sync)
            n_paths = W * H * spp
        else:
            ids = subset_ids(W * H, pixels)
            render_pixels(scene, dataclasses.replace(options, spp=k), ids)
            dt, img = timed(lambda: render_pixels(scene, options, ids), sync)
            n_paths = len(ids) * spp
    result = {
        "resolution": [W, H],
        "spp": spp,
        "max_depth": depth,
        "seconds": round(dt, 3),
        "Mpaths_per_sec": round(n_paths / dt / 1e6, 3),
        "Mrays_per_sec": round(n_paths * (1 + 2 * (depth + 1)) / dt / 1e6, 3),
        "mean_radiance": [round(float(c), 5) for c in img.reshape(-1, 3).mean(axis=0)],
    }
    if pixels is not None:
        result["pixels"] = len(ids)
        np.savez(out_dir / f"{name}_pixels{len(ids)}.npz", ids=ids, radiance=img)
        ref = image_pixels(ref, ids)
    else:
        write_exr(str(out_dir / f"{name}.exr"), img)
    if bf16:
        result["envmap_bf16"] = True
    result["vs_take_tpu"] = pixel_agreement(img.astype(np.float16), ref)  # as our EXR holds it
    if ibl_f32:  # the EXR's figures ungated; take_tpu in float32 on its pixels gated
        n = len(f32["ids"]) if pixels is None else min(pixels, len(f32["ids"]))
        if pixels is not None and not np.array_equal(ids[:n], f32["ids"][:n]):
            raise ValueError(f"{TAKE_TPU_IBL} holds other pixels than subset_ids")
        ours = image_pixels(img, f32["ids"]) if pixels is None else img[:n]
        result["vs_take_tpu_f32"] = pixel_agreement(ours, f32["radiance"][:n])
        misses = agreement_misses(name, result["vs_take_tpu_f32"])
    else:
        misses = agreement_misses(name, result["vs_take_tpu"])
    if name.startswith("room"):
        golden = read_reference(GOLDEN, (H, W, 3))
        result["parity_vs_reference_128spp"] = parity_stats(img, golden, nb=GOLDEN_BLOCKS)
        result["parity_vs_reference_128spp_run_benchmarks_blocks"] = parity_stats(img, golden)
        misses += golden_misses(result["parity_vs_reference_128spp"])
    return result, misses


def main(argv=None):
    ap = argparse.ArgumentParser(prog="take_tpu_torch.run_configs")
    ap.add_argument("--only", default=None, help="comma-separated name fragments (cbox,mis,...)")
    ap.add_argument("--json", default=None, help="write every config's result to this file")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--out", default=str(OUT), help="directory for the EXRs")
    ap.add_argument("--pixels", type=int, default=None, help="render only this many seeded pixels a config")
    ap.add_argument("--tpu-envmap-bf16", action="store_true",
                    help="ibl's envmap transforms at bfloat16 operands, as the TPU ran them; gated against the EXR")
    args = ap.parse_args(argv)

    import torch

    configs = [c for c in CONFIGS if not args.only or any(tok in c[0] for tok in args.only.split(","))]
    if args.pixels is not None and any(c[0].startswith("room") for c in configs):
        raise SystemExit("--pixels: room's golden comparison needs the whole frame; leave room out with --only")
    if torch.device(args.device).type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}", flush=True)
    else:
        print(f"device: {args.device}; torch {torch.__version__}", flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    results, misses = {}, []
    for name, rel, res, spp, depth in configs:
        results[name], miss = run_config(name, rel, res, spp, depth, args.device, out_dir, args.pixels,
                                         args.tpu_envmap_bf16)
        misses += miss
        print(name, json.dumps(results[name]), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(results, fh, indent=2)
    for m in misses:
        print(f"GATE MISSED: {m}", flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
