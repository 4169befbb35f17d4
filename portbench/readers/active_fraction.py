"""The share of the scene queries the fixed-trip loop launches that serve
live lanes (integrator/path_tracer.trace_query_counts), over the first
pass of each row band."""


def read(ctx, metric):
    c = ctx.counts
    return 100.0 * c["live"] / c["nominal"] if c and c["nominal"] else None
