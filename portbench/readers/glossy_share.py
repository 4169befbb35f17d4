"""The glossy lobes' share of the device time: the forward's `glossy`
phase (the Phong, Blinn-Phong and Blinn-Phong microfacet lobes inside each
bsdf_sample, bsdf_eval and bsdf_pdf dispatch) over all device time of the
segment's units, from the program's phase marks (portbench/phases.py).
None where the segment has no such phase (a program without the mark)."""

from portbench import phases

PHASE = "forward.glossy"


def read(ctx, metric):
    seg = phases.segment(ctx)
    return phases.share(seg, [PHASE]) if seg and PHASE in seg["phases"] else None
