"""The program's own spans and device phase marks, for the per-layer
metrics that read them (take_tpu_torch/tracing.py).

The traced run's window and its profiled units run with the program's
tracing off, as the runs that time the end-to-end metrics do. The readers
of these metrics call `segment(ctx)`, which, once a process, after the
run's own readings: turns the program's tracing on, sets the cell's loop
up anew at the run's seed (the scene's load and every graph key captured,
now with its phase marks) and keeps the set-up's span totals (`spans`),
runs units for loops.TRACED_SECONDS under torch.profiler, as the run's own
traced units run, and reduces that trace (`reduce`). Then it frees the
loop and turns tracing off. A program without tracing.py (one older than
it) gives None, and so does each reader.
"""

import argparse
import bisect
import collections
import gc
import importlib
import json
import re
import sys
import time

import torch

from portbench import loops, traceread

SPAN = "portbench.phases"
MARK = re.compile(r"^take_mark_(forward|backward)_([a-z]+)$")
UNMARKED = "unmarked"
NO_SPAN = "(no program span)"
_SEGMENTS = {}  # cell name -> segment


def kineto_rows(results):
    """(name, start, end, on the device, a record_function range) of each
    of the profiler's raw results (times in microseconds), without building
    its event tree (which takes seconds for a second of graph replays)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3, e.device_type() == cuda, e.is_user_annotation())
            for e in results.events()]


def reduce(rows):
    """The segment's figures from its trace's rows (see kineto_rows()):
    `window_s`, `busy_s` and `device_s` as traceread.reduce counts them;
    `phases`, device seconds by "<stage>.<phase>", each device operation,
    in the order they start, charged to the latest mark (a mark kernel to
    its own phase; after an `end` mark, and before any mark, to
    "unmarked"); `program_gaps`, the idle gaps' seconds by the innermost
    program span (`take.*`, a record_function range on the host) open at
    each gap's middle, or "(no program span)", and `gap_counts`, their
    numbers; `marks`, the mark kernels seen, and `ops`, all device
    operations."""
    span = [r for r in rows if r[0] == SPAN and not r[3]]
    if not span:
        raise RuntimeError(f"the trace has no {SPAN} span")
    lo, hi = span[0][1], span[0][2]
    dev, host = [], []
    for name, start, end, on_device, annotation in rows:
        a, b = max(start, lo), min(end, hi)
        if b <= a or name == SPAN:
            continue
        if on_device:
            if not annotation:  # a range's copy on the device's timeline is no operation
                dev.append((a, b, name))
        elif name.startswith("take."):
            host.append((start, end, name))
    dev.sort()
    phases, current, n_marks = collections.defaultdict(float), UNMARKED, 0
    for a, b, name in dev:
        m = MARK.match(name)
        if m:
            n_marks += 1
            current = UNMARKED if m.group(2) == "end" else f"{m.group(1)}.{m.group(2)}"
        phases[current] += (b - a) / 1e6
    busy = traceread._union(sorted((a, b) for a, b, _ in dev))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps, counts = collections.defaultdict(float), collections.Counter()
    host.sort()
    starts = [h[0] for h in host]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and host[i][1] <= mid:
            i -= 1
        owner = host[i][2] if i >= 0 else NO_SPAN
        gaps[owner] += (b - a) / 1e6
        counts[owner] += 1
    return {"window_s": (hi - lo) / 1e6, "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_s": sum(phases.values()), "phases": dict(phases), "program_gaps": dict(gaps),
            "gap_counts": dict(counts), "marks": n_marks, "ops": len(dev)}


def program_tracing():
    """take_tpu_torch.tracing, or None where the program has none."""
    try:
        return importlib.import_module("take_tpu_torch.tracing")
    except ModuleNotFoundError as e:
        if e.name != "take_tpu_torch.tracing":
            raise
        return None


def run_seed():
    """The run's --seed (0 where the command line has none)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def traced(fn, cuda):
    """(fn's result, the reduced trace of its run) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg = reduce(kineto_rows(prof.profiler.kineto_results))
    seg["reduce_s"] = time.perf_counter() - t0
    return out, seg


def measure(cell, seed, device):
    """The segment of `cell` (spec.cell's entries) at `seed` on `device`:
    reduce's figures with `spans`, the set-up's span totals, and `units`;
    None where the program has no tracing."""
    tracing = program_tracing()
    if tracing is None:
        return None
    cuda = torch.device(device).type == "cuda"
    tracing.reset()
    tracing.enable()
    try:
        loop = loops.LOOPS[cell["traffic_data"]["kind"]](cell, seed, device)
        loops.sync(device)
        spans = tracing.totals()

        def units():
            n, t0 = 0, time.perf_counter()
            while n == 0 or time.perf_counter() - t0 < loops.TRACED_SECONDS:
                loop.unit()
                n += 1
            return n

        n, seg = traced(units, cuda)
        loop.free()
    finally:
        tracing.disable()
        tracing.reset()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    seg.update(spans=spans, units=n)
    return seg


def segment(ctx):
    """The cell's segment, measured at its first call in the process; None
    where the program has no tracing or its trace holds no mark."""
    name = ctx.cell["name"]
    if name not in _SEGMENTS:
        device = "cuda" if torch.cuda.is_available() else "cpu"
        seg = measure(ctx.cell, run_seed(), device)
        if seg is not None:
            top = {k: seg[k] for k in ("window_s", "busy_s", "device_s", "phases", "program_gaps", "gap_counts",
                                        "marks", "ops", "units", "reduce_s")}
            top["setup_spans"] = {k: v["total_s"] for k, v in seg["spans"].items()}
            print(f"portbench.phases {name}: {json.dumps(top)}", file=sys.stderr)
        _SEGMENTS[name] = seg if seg is not None and (seg["marks"] or not seg["device_s"]) else None
    return _SEGMENTS[name]


def share(seg, keys):
    """100 x the device seconds of phases `keys` over all device seconds."""
    return 100.0 * sum(seg["phases"].get(k, 0.0) for k in keys) / seg["device_s"] if seg["device_s"] else None


def stage_seconds(seg, stage):
    return sum(v for k, v in seg["phases"].items() if k.startswith(stage + "."))
