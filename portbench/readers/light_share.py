"""The lights' share of the device time: the forward's `light` phase (light
selection and sampling, the light and environment pdfs, the MIS weights of
NEE and of the sampled ray's arrival) over all device time of the
segment's units, from the program's phase marks (portbench/phases.py)."""

from portbench import phases


def read(ctx, metric):
    seg = phases.segment(ctx)
    return phases.share(seg, ["forward.light"]) if seg else None
