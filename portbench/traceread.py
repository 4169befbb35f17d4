"""The traced window: device activity from torch.profiler's trace.

`traced(fn)` runs `fn` under the profiler (host and device activity, the
kernels inside CUDA graph replays included) inside a span of its own, and
reduces the trace to what the per-layer readers and the result's `device`
and `breakdown` read: the window's length, the seconds in which some
operation ran on the device (the union of their intervals), device time by
operation name, and each idle gap of the device charged to the innermost
host span open at its middle.
"""

import bisect
import collections
import time

import torch

SPAN = "portbench.traced"
NAME_CHARS = 100  # operation names are cut to this many characters in `breakdown`


def _union(intervals):
    """Merged [start, end) intervals of a sorted list."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events):
    """The trace's figures from the profiler's events (times in microseconds)."""
    span = [e for e in events if e.name == SPAN]
    if not span:
        raise RuntimeError(f"the trace has no {SPAN} span")
    lo, hi = span[0].time_range.start, span[0].time_range.end
    dev, host = [], []
    for e in events:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b <= a:
            continue
        if e.name == SPAN or getattr(e, "is_user_annotation", False):
            continue  # a span's copy on the device's timeline is no operation
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((a, b, e.name))
        else:
            host.append((e.time_range.start, e.time_range.end, e.name))
    by_name = collections.defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) / 1e6
    busy = _union(sorted((a, b) for a, b, _ in dev))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = collections.defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        # the innermost host span open at the gap's middle: the latest to start
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and host[i][1] <= mid:
            i -= 1
        gaps[host[i][2] if i >= 0 else "(no host span)"] += (b - a) / 1e6
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_s": sum(by_name.values()),
        "by_name": dict(by_name),
        "gaps": dict(gaps),
        "n_device_ops": len(dev),
    }


def traced(fn):
    """(fn's result, the reduced trace of its run, ended by a synchronise)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            out = fn()
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = reduce(prof.events())
    trace["reduce_s"] = time.perf_counter() - t0
    return out, trace


def breakdown(trace):
    """The result's `breakdown`: the ten device operations that took most
    time, and the ten largest sums of idle time by host span."""
    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(trace["by_name"]), "idle_gaps": top(trace["gaps"])}
