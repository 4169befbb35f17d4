"""The materials' share of the device time: the forward's `shade` (the
shade point, materials/bsdf.make_shade_point and is_specular) and `bsdf`
(bsdf_eval, bsdf_pdf, bsdf_sample) phases over all device time of the
segment's units, from the program's phase marks (portbench/phases.py)."""

from portbench import phases


def read(ctx, metric):
    seg = phases.segment(ctx)
    return phases.share(seg, ["forward.shade", "forward.bsdf"]) if seg else None
