"""The environment map's share of the device time: the forward's `envmap`
phase (lights/envmap.py's envmap_sample, envmap_eval and envmap_pdf at
their call sites in the integrator) over all device time of the segment's
units, from the program's phase marks (portbench/phases.py). None where the
segment has no such phase (a program without the mark)."""

from portbench import phases

PHASE = "forward.envmap"


def read(ctx, metric):
    seg = phases.segment(ctx)
    return phases.share(seg, [PHASE]) if seg and PHASE in seg["phases"] else None
