"""The counter RNG's share of the device time: the program's RNG kernels
(`take_rng_*`, take_tpu_torch/csrc/rng.cu) over all device time of the
traced units. None where no such kernel ran (a program that draws with
plain torch ops)."""

import re

RNG = re.compile(r"\btake_rng_")


def read(ctx, metric):
    t = ctx.trace
    rng = sum(s for name, s in t["by_name"].items() if RNG.search(name))
    return 100.0 * rng / t["device_s"] if rng > 0 else None
