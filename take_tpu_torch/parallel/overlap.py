"""Banded gradient reduction, overlapped with the next band's backward.
Port of take_tpu/parallel/overlap.py.

A data-parallel gradient step that reduces once, after the whole backward,
puts the reduction's latency on the critical path. Here the pixel batch is
split into bands; each rank takes its contiguous slice of band k, takes
that band's gradient on fresh leaf tables (grad.partial_loss_grad), flattens
the band's gradients and loss into one buffer and starts an asynchronous
all-reduce of it, then goes on to band k+1: band k's reduction depends only
on band k's backward, so it can run under band k+1's. The handles are
waited on at the end, and the bands summed in order.

The estimator is the monolithic one: the L2 loss decomposes over bands and
pixels, so loss and gradients equal grad.render_loss_grad's up to float
re-association (tests/test_torch_parallel.py, at 1 and 2 ranks). The mode
("ad" or "replay") is resolved on the rank's band slice, as take_tpu
resolves it inside shard_map on the per-device shard.
"""

import torch

from take_tpu_torch import grad
from take_tpu_torch.parallel.distributed import collective_device, world
from take_tpu_torch.scene.types import float_tables, replace_tables


def banded_loss_grad(scene, options, pixel_idx, target, n_bands: int, group=None, n_samples: int = 1):
    """L2 loss and scene gradient with a per-band, overlapped all-reduce
    over the process group `group` (the default group; one process, and no
    collective, when none is initialised or the group has one rank).

    Args:
        pixel_idx: [N] pixel ids, the same on every rank (N divisible by
            n_bands x ranks).
        target: [N, 3].
    Returns:
        (loss, grads) on the scene's device, the same on every rank: the
        monolithic mean, and a Scene-shaped gradient, both scaled by
        1 / (N x 3).
    """
    rank, n_ranks = world(group)
    N = pixel_idx.shape[0]
    if N % (n_bands * n_ranks):
        raise ValueError(f"{N} pixels do not split into {n_bands} bands over {n_ranks} ranks")
    band, per = N // n_bands, N // (n_bands * n_ranks)
    device = scene.background.device
    mode = grad.resolve_mode(options, per * n_samples)
    bufs, handles = [], []
    for b in range(n_bands):
        sl = slice(b * band + rank * per, b * band + (rank + 1) * per)
        loss, g = grad.partial_loss_grad(scene, options, pixel_idx[sl].to(device), target[sl].to(device),
                                         n_samples, mode, N * 3)
        tables = float_tables(g)
        buf = torch.cat([t.reshape(-1).to(device) for t in tables.values()] + [loss.reshape(1)])
        if n_ranks > 1:
            buf = buf.to(collective_device(device, group))
            handles.append(torch.distributed.all_reduce(buf, group=group, async_op=True))
        bufs.append(buf)
    for h in handles:
        h.wait()
    total = bufs[0]
    for buf in bufs[1:]:
        total = total + buf
    total = total.to(device)
    parts = total[:-1].split([t.numel() for t in tables.values()])
    grads = {key: p.reshape(t.shape).to(t.device) for (key, t), p in zip(tables.items(), parts)}
    return total[-1], replace_tables(g, grads, drop_rest=True)
