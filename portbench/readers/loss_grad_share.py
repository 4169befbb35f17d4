"""The share of the window's step time spent in grad.render_loss_grad, by
the benchmark's own span around it (a synchronise at each end); the rest
is the edit, grad.backward, the Adam step and the loss read."""


def read(ctx, metric):
    spans = ctx.window["loss_grad_s"]
    return 100.0 * sum(spans) / sum(ctx.window["unit_s"]) if spans else None
