"""Passes of the window not replayed from a captured graph: passes run op
by op (render.PASSES and grad.PASSES, "eager") and graphs captured in it."""


def read(ctx, metric):
    return ctx.window["passes_eager"] + ctx.window["graphs_new"]
