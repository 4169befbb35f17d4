"""The backward's share of a gradient pass's device time: every phase of
stage `backward` (the vector-Jacobian products, and path replay's two
passes of recomputed bounces) over the phases of both stages, from the
program's phase marks (portbench/phases.py); device time outside a pass
is left out."""

from portbench import phases


def read(ctx, metric):
    seg = phases.segment(ctx)
    if not seg:
        return None
    back, fwd = phases.stage_seconds(seg, "backward"), phases.stage_seconds(seg, "forward")
    return 100.0 * back / (back + fwd) if back + fwd > 0 else None
