"""Hit assembly's share of the device time: the forward's `hit` phase (the
winners' attribute rows gathered and merged into the Hit after K1 or K3,
geometry/intersect.py) over all device time of the segment's units, from
the program's phase marks (portbench/phases.py)."""

from portbench import phases


def read(ctx, metric):
    seg = phases.segment(ctx)
    return phases.share(seg, ["forward.hit"]) if seg else None
