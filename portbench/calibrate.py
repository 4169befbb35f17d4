"""Readings that the comparison's limits are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... [--control-seeds ...]
        [--fault-seeds ...] [--seconds 3] [--out FILE]

Prints one JSON line per reading: the program's numbers on each of
`--seeds` (a short window each, the run's own path and sizes); the
control's on each of `--control-seeds`: the reference in bfloat16 put in
the program's place, at the cell's own sizes, against the reference in
its own precision; and each planted fault (portbench/faults.py) of the
cell's kind on each of `--fault-seeds`. Not run by the benchmark's runs.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import checks, faults, loops, run, spec
from portbench.reference import tracer

CONTROL = torch.bfloat16


def control_numbers(cell, seed, device):
    """The cell's numbers with the reference in bfloat16 as the program."""
    cfg, lim = cell["config_data"], cell["limits"]
    if cell["traffic_data"]["kind"] == "render":
        W, H = cfg["resolution"]
        n = min(lim["pixels"], W * H)
        pix = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(W * H, size=n, replace=False)), device=device)

        def image(dt, gdt):
            s = loops.reference_scene(cfg, device, dt, gdt)
            return tracer.render_pixels(s, seed, pix, cfg["spp"], cfg["max_depth"]).float().cpu().numpy()

        return checks.image_numbers(image(CONTROL, CONTROL)[None], image(torch.float32, torch.float64))
    loop = loops.GradLoop(cell, seed, device)  # the program's parameters at the window's kept step
    while loop.step <= loop.check_at:
        loop.unit()
    step, theta, _ = loop.window_step()
    loop.free()
    want = loops.ReferenceLoop(cell, seed, device)
    got = loops.ReferenceLoop(cell, seed, device, CONTROL, CONTROL)
    steps = cell["traffic_data"]["setup_steps"]
    (l0, g0, d0), (l1, g1, d1) = want.follow(steps), got.follow(steps)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(l1, l0)), "grad_gap": checks.leaf_gap(g1, g0),
            "change_gap": checks.leaf_gap(d1, d0, checks.moved_leaves(g0)),
            "step_grad_gap": checks.leaf_gap(got.loss_grad(theta, step)[1], want.loss_grad(theta, step)[1])}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec.update(workload=args.workload, card=torch.cuda.get_device_name(0))
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    def reading(kind, seed, fn):
        t0 = time.perf_counter()
        try:
            rec = fn(t0)
        except Exception as e:  # a reading that crashes is recorded as such, and the others go on
            rec = {"error": f"{type(e).__name__}: {e}"}
        emit({"kind": kind, "seed": seed, **rec, "seconds": time.perf_counter() - t0})

    def program(seed, t0):
        res, _ = run.run(args.workload, seed, args.seconds, 0, t_start=t0)
        return {"numbers": {k: v["value"] for k, v in res["checks"].items()}, "correct": res["correct"],
                "metrics": res["metrics"], "attempted": res["attempted"]}

    for seed in seeds(args.seeds):
        reading("program", seed, lambda t0: program(seed, t0))
    for seed in seeds(args.control_seeds):
        reading("control", seed, lambda t0: {"numbers": control_numbers(cell, seed, "cuda")})
    for name in faults.KINDS[cell["traffic_data"]["kind"]]:
        for seed in seeds(args.fault_seeds):
            with faults.plant(name):
                reading(name, seed, lambda t0: program(seed, t0))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
