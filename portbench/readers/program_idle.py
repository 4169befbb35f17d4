"""The device's idle time inside the program: the idle gaps whose middle
falls in a program span (`take.*`, take_tpu_torch/tracing.py) over the
segment's traced window (portbench/phases.py); gaps outside every program
span (the harness's own work) are left out."""

from portbench import phases


def read(ctx, metric):
    seg = phases.segment(ctx)
    if not seg:
        return None
    named = sum(v for k, v in seg["program_gaps"].items() if k != phases.NO_SPAN)
    return 100.0 * named / seg["window_s"]
