"""A kernel's share of its roofline: the least time of the traced units'
calls of it (portbench/yardstick.py: bytes over the peak bandwidth; every
call of a pass gets the pass's paths as rays) over the kernel's summed
device time by name in the trace. Calls come from the program's launch
counter; the kernel's file is portbench/kernels/<kernel>.json."""

import re

from portbench import spec, yardstick


def read(ctx, metric):
    k = spec.kernels()[metric[: -len("_roofline")]]
    pat = re.compile(k["trace_name"])
    seconds = sum(s for name, s in ctx.trace["by_name"].items() if pat.search(name))
    calls = ctx.segment["launches"].get(k["launch_key"], 0)
    if seconds <= 0 or calls <= 0 or ctx.segment["passes"] <= 0:
        return None
    rays = calls * ctx.segment["paths"] / ctx.segment["passes"]
    return 100.0 * yardstick.least_seconds(yardstick.query_bytes(rays, calls, k["answer_bytes"], ctx.n_tri)) / seconds
