"""The device time of the scene-query kernels (every file of
portbench/kernels) over all device time of the traced units."""

import re

from portbench import spec


def read(ctx, metric):
    t = ctx.trace
    pats = [re.compile(k["trace_name"]) for k in spec.kernels().values()]
    kern = sum(s for name, s in t["by_name"].items() if any(p.search(name) for p in pats))
    return 100.0 * kern / t["device_s"] if kern > 0 else None
