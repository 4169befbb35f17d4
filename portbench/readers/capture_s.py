"""Host seconds spent capturing the cell's CUDA graphs in set-up: the
program's take.graph.capture (recording the body) and
take.graph.instantiate spans over the set-up of the segment's loop
(portbench/phases.py), a process whose card is already in use."""

from portbench import phases

SPANS = ("take.graph.capture", "take.graph.instantiate")


def read(ctx, metric):
    seg = phases.segment(ctx)
    return sum(seg["spans"].get(k, {}).get("total_s", 0.0) for k in SPANS) if seg else None
