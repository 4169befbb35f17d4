"""Host seconds spent building the environment map's tables in set-up (the
importance weights and the alias table's Python loop over its texels): the
program's take.scene.envmap span over the set-up of the segment's loop
(portbench/phases.py). None where the set-up has no such span (a program
without it)."""

from portbench import phases

SPAN = "take.scene.envmap"


def read(ctx, metric):
    seg = phases.segment(ctx)
    return seg["spans"][SPAN]["total_s"] if seg and SPAN in seg["spans"] else None
