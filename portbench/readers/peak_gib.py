"""The peak of what the process holds on the card over the window
(torch.cuda.max_memory_reserved after a reset at its start): live tensors,
the graphs' pools and the allocator's cache."""


def read(ctx, metric):
    return ctx.window["peak_bytes"] / 2**30 if ctx.window["peak_bytes"] else None
