"""End-to-end inverse rendering: recover scene parameters from a target
image by gradient descent. `python3 -m take_tpu_torch.inverse_demo [--steps
800] [--spp 32] [--res 64] [--target-spp 512] [--device cuda] [--out PATH]`.

Port of benchmarks/inverse_demo.py. A Cornell box (cornell_box, a copy of
tests/scenes.py's) whose red wall's and white material's (floor, ceiling,
back wall, boxes) reflectance and the light's intensity scale are unknown.
The target is rendered at the true parameters (512 spp, seed 3);
optimisation starts from gray walls and half the light and runs Adam (lr
2e-2, torch.optim.Adam in place of optax's adam: both eps 1e-8 with bias
correction) on an L2 image loss through grad.render_radiance (32 spp a
step, seed 11, d4). Albedos live on a sigmoid and the light scale on an
exp; each step maps the raw parameters into the pristine base scene through
scene/edit.py, and draws a fresh sample window (step i starts at sample
i * spp), so the loss is a fresh Monte Carlo estimate each step.

Prints one JSON record (the JAX script's keys: the loss curve every 10
steps, the first loss and the mean of the last 10, true and recovered
parameters, each parameter's largest relative error in physical space,
`converged_5pct`; plus seconds a step, K1/K2's launches a step, whether
every gradient was finite, and the card's name and power limit), written to
--out too; the JAX script's appending to benchmarks/results_r5.json is not
ported. Exit 1 unless every parameter converged within 5%.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from take_tpu_torch.bench import card, sync
from take_tpu_torch.core.camera import Camera
from take_tpu_torch.geometry import _launch
from take_tpu_torch.grad import render_radiance
from take_tpu_torch.scene import edit
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.types import MAT_DIFFUSE, RenderOptions

STEPS, SPP, RES, TARGET_SPP = 800, 32, 64, 512  # inverse_demo.py:46-49
LR, DEPTH, SEED, TARGET_SEED = 2e-2, 4, 11, 3  # inverse_demo.py:108-121
# cornell_box's material ids, in add_material order (white is shared by the
# floor, ceiling, back wall and boxes)
CBOX_MAT_WHITE, CBOX_MAT_RED = 0, 1
TRUE = {"wall_rgb": [0.75, 0.15, 0.12], "floor_rgb": [0.5, 0.62, 0.4], "log_light": 1.7}  # inverse_demo.py:72-81
INIT = {"wall_rgb": [0.5, 0.5, 0.5], "floor_rgb": [0.5, 0.5, 0.5], "log_light": 0.5}


def quad(p0, p1, p2, p3):
    """Two triangles for quad p0..p3 (counter-clockwise)."""
    return np.array([p0, p1, p2, p3], np.float64), np.array([[0, 1, 2], [0, 2, 3]], np.int64)


def cornell_box(width=64, height=64):
    """tests/scenes.py's self-contained Cornell box (5 diffuse walls, an area
    light, 2 blocks; the classic 1x1x1 box, the camera looking down -z), as
    a SceneBuilder."""
    b = SceneBuilder()
    b.camera = Camera(width=width, height=height, lookfrom=(0.5, 0.5, 1.4), lookat=(0.5, 0.5, 0.0),
                      up=(0.0, 1.0, 0.0), vfov=33.0)
    b.background = np.zeros(3)
    white = b.add_material(MAT_DIFFUSE, tex_value=(0.73, 0.73, 0.73))
    red = b.add_material(MAT_DIFFUSE, tex_value=(0.65, 0.05, 0.05))
    green = b.add_material(MAT_DIFFUSE, tex_value=(0.12, 0.45, 0.15))
    light_mat = b.add_material(MAT_DIFFUSE, tex_value=(0.0, 0.0, 0.0))
    # floor, ceiling, back, left (red), right (green); normals point inward
    b.add_mesh(*quad([0, 0, 0], [1, 0, 0], [1, 0, -1], [0, 0, -1]), white)
    b.add_mesh(*quad([0, 1, 0], [0, 1, -1], [1, 1, -1], [1, 1, 0]), white)
    b.add_mesh(*quad([0, 0, -1], [1, 0, -1], [1, 1, -1], [0, 1, -1]), white)
    b.add_mesh(*quad([0, 0, 0], [0, 0, -1], [0, 1, -1], [0, 1, 0]), red)
    b.add_mesh(*quad([1, 0, 0], [1, 1, 0], [1, 1, -1], [1, 0, -1]), green)
    # the ceiling light, just below the ceiling, wound so that its normal points down
    l, c = 0.35, 0.5
    b.add_mesh(*quad([c - l / 2, 0.999, -c - l / 2], [c + l / 2, 0.999, -c - l / 2],
                     [c + l / 2, 0.999, -c + l / 2], [c - l / 2, 0.999, -c + l / 2]),
               light_mat, emission=(15.0, 15.0, 15.0))

    def block(x0, x1, y0, y1, z0, z1, mat):
        for p, i in (
            quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # front
            quad([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),  # back
            quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # left
            quad([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),  # right
            quad([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]),  # top
        ):
            b.add_mesh(p, i, mat)

    block(0.1, 0.45, 0.0, 0.6, -0.75, -0.4, white)
    block(0.55, 0.9, 0.0, 0.3, -0.55, -0.2, white)
    b.spp = 16
    return b


def raw(values, device):
    """Physical parameters -> raw ones: logit of the albedos (clipped to
    [1e-4, 1 - 1e-4]), log of the light scale; float32 tensors."""
    out = {}
    for k, v in values.items():
        x = np.asarray(v, np.float64)
        if k == "log_light":
            x = np.log(x)
        else:
            x = np.clip(x, 1e-4, 1 - 1e-4)
            x = np.log(x / (1 - x))
        out[k] = torch.tensor(x, dtype=torch.float32, device=device)
    return out


def physical(params):
    """Raw parameters -> physical ones (float64 numpy): sigmoid, exp."""
    out = {}
    for k, v in params.items():
        x = v.detach().cpu().numpy().astype(np.float64)
        out[k] = np.exp(x) if k == "log_light" else 1.0 / (1.0 + np.exp(-x))
    return out


def apply(base, params):
    """The base scene at the raw parameters (inverse_demo.py:88-98)."""
    s = edit.with_material_reflectance(base, CBOX_MAT_RED, torch.sigmoid(params["wall_rgb"]))
    s = edit.with_material_reflectance(s, CBOX_MAT_WHITE, torch.sigmoid(params["floor_rgb"]))
    return edit.with_light_intensity_scale(s, torch.exp(params["log_light"]))


def run(steps=STEPS, spp=SPP, res=RES, target_spp=TARGET_SPP, device="cuda", log_every=50):
    """The demo. Returns (the record, the raw parameters after the last
    step, the loss of each step)."""
    base = cornell_box(res, res).build(device=device)
    pix = torch.arange(res * res, dtype=torch.int32, device=device)

    def render(params, sample0, n, seed):
        return render_radiance(apply(base, params), RenderOptions(spp=1, max_depth=DEPTH, seed=seed), pix,
                               sample0, n)

    with torch.no_grad():
        target = render(raw(TRUE, device), 0, target_spp, TARGET_SEED)
    params = {k: v.requires_grad_(True) for k, v in raw(INIT, device).items()}
    opt = torch.optim.Adam(list(params.values()), lr=LR)
    losses, finite = [], True
    sync(device)
    _launch.reset_launches()
    t0 = time.perf_counter()
    for i in range(steps):
        opt.zero_grad()
        loss = torch.mean((render(params, i * spp, spp, SEED) - target) ** 2)
        loss.backward()
        finite &= all(bool(torch.isfinite(p.grad).all()) for p in params.values())
        opt.step()
        losses.append(float(loss.detach()))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i}: loss {losses[-1]:.6f}", flush=True)
    sync(device)
    dt = time.perf_counter() - t0
    launches = {k: v / steps for k, v in _launch.LAUNCHES.items() if v}
    true, got = physical(raw(TRUE, "cpu")), physical(params)
    err = {k: float(np.max(np.abs(got[k] - true[k]) / np.maximum(np.abs(true[k]), 1e-6))) for k in true}
    rec = {
        "steps": steps,
        "spp_per_step": spp,
        "seconds": dt,
        "seconds_per_step": dt / steps,
        "loss_first": losses[0],
        "loss_last": float(np.mean(losses[-10:])),
        "loss_curve_every10": losses[::10],
        "true": {k: np.round(v, 4).tolist() for k, v in true.items()},
        "recovered": {k: np.round(v, 4).tolist() for k, v in got.items()},
        "max_rel_err": err,
        "converged_5pct": all(v < 0.05 for v in err.values()),
        "grads_finite": finite,
        "launches_per_step": launches,
    }
    return rec, {k: v.detach() for k, v in params.items()}, losses


def main(argv=None):
    ap = argparse.ArgumentParser(prog="take_tpu_torch.inverse_demo")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--spp", type=int, default=SPP)
    ap.add_argument("--res", type=int, default=RES)
    ap.add_argument("--target-spp", type=int, default=TARGET_SPP)
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--out", default=None, help="also write the record to this file")
    args = ap.parse_args(argv)
    name, power = card(args.device)
    rec, _, _ = run(args.steps, args.spp, args.res, args.target_spp, args.device)
    rec.update(device=name, power_limit=power, torch=torch.__version__)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if rec["converged_5pct"] else 1


if __name__ == "__main__":
    sys.exit(main())
