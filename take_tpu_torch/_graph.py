"""Captured CUDA graphs, one per compile key: the port's counterpart of the
executable cache of a jitted function (take_tpu/render.py::_render_pass_jit
and take_tpu/grad.py::render_loss_grad, each a `jax.jit` with static
arguments).

`run(key, hold, body, inputs, params)` returns `body(*inputs, *params)`
computed by the graph captured for `key`. At a key's first call, `body` runs
once on a side stream (a warm-up: it builds the kernels, `_lib()`, and
cuBLAS's workspace), then runs again under capture, reading static copies
of `inputs` and `params`; the graph's output is the tensor, or the tuple of
tensors (and Nones), that call returned. On every call the inputs and
params are copied into the static buffers, the graph replays on the current
stream, and a clone of each output is returned, since the next replay
writes over it.

Without `params` the body runs under inference mode (a render pass). With
them it runs with autograd on: each param's static buffer is a leaf that
requires grad, so a body that calls `torch.autograd.grad` on them (a
gradient pass, forward and backward) records its backward's kernels into the
same graph, on the capturing stream, as torch.cuda.make_graphed_callables
does. New param values are copied into the leaves (under no_grad) before
each replay, so the graph gives the gradient at the values of this call, as
a jitted function takes new parameter values without a new compile.

Every graph of a device draws on one memory pool. That is safe because
graphs replay one at a time on one stream and each output is cloned at once:
a replay may write over memory that another graph's output or intermediates
used, never over memory that anything still reads. The static inputs are
allocated outside the pool.

The kernel wrappers count launches in Python (geometry/_launch.py). A
capture calls them, but nothing runs then; a replay runs their kernels
without calling them. So what a capture counts is taken back out of
`_launch.LAUNCHES` and added in again at every replay: LAUNCHES counts
what ran (the warm-up ran, and counts).

A capture or a replay that fails raises; nothing retries eagerly. A
capture refuses calls that are unsafe under capture from its own thread
only ("thread_local"), so that other threads' CUDA calls (NCCL's watchdog)
go on while it records.
"""

import collections
import dataclasses
import time

import torch

from take_tpu_torch.geometry import _launch

MAX_GRAPHS = 48  # graphs kept, the least recently used dropped first


@dataclasses.dataclass
class Captured:
    """One key's graph, its static buffers and what it counts."""

    graph: object  # torch.cuda.CUDAGraph
    inputs: list  # the static input and param buffers the graph reads
    output: object  # the tensor, or tuple of tensors (and Nones), the graph writes
    launches: dict  # kernel launches of one replay, by _launch.LAUNCHES key
    hold: object  # what the graph reads and must outlive it (the scene)
    capture_s: float  # host seconds to record the body
    instantiate_s: float  # host seconds of cudaGraphInstantiate


_CACHE = collections.OrderedDict()
_POOLS = {}  # device -> graph_pool_handle()


def add_launches(delta, times=1):
    """Add `times` x `delta` ({LAUNCHES key: count}) to _launch.LAUNCHES."""
    for key, n in delta.items():
        _launch.LAUNCHES[key] += times * n


def uncounted(fn):
    """(fn(), the launches it counted), with those counts taken back out of
    _launch.LAUNCHES, also when fn raises."""
    before = dict(_launch.LAUNCHES)
    try:
        out = fn()
    finally:
        delta = {k: n - before.get(k, 0) for k, n in _launch.LAUNCHES.items() if n != before.get(k, 0)}
        add_launches(delta, -1)
    return out, delta


def _capture(body, inputs, params, hold):
    device = inputs[0].device
    static = [x.clone() for x in inputs]  # outside the pool
    static += [p.detach().clone().requires_grad_(True) for p in params]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body(*static)
    torch.cuda.current_stream(device).wait_stream(side)
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph(keep_graph=True)

    def record():
        with torch.cuda.graph(graph, pool=_POOLS[device], capture_error_mode="thread_local"):
            return body(*static)

    t0 = time.perf_counter()
    output, launches = uncounted(record)
    t1 = time.perf_counter()
    graph.instantiate()
    return Captured(graph, static, output, launches, hold, t1 - t0, time.perf_counter() - t1)


def run(key, hold, body, inputs, params=()):
    """body(*inputs, *params) by the graph captured for `key` (captured now
    if the key is new). `inputs` and `params` are tensors on one CUDA
    device whose shapes and dtypes the key fixes; with `params` the body
    runs with autograd on, each param a leaf that requires grad. `hold` is
    kept with the graph."""
    device = inputs[0].device
    mode = torch.enable_grad() if params else torch.inference_mode()
    with torch.cuda.device(device), mode:
        entry = _CACHE.get(key)
        if entry is None:
            entry = _CACHE[key] = _capture(body, inputs, params, hold)
            while len(_CACHE) > MAX_GRAPHS:
                _CACHE.popitem(last=False)
        else:
            _CACHE.move_to_end(key)
            with torch.no_grad():
                for buf, x in zip(entry.inputs, [*inputs, *params]):
                    buf.copy_(x)
        entry.graph.replay()
    add_launches(entry.launches)
    # clones in the caller's mode: not inference tensors outside inference_mode
    if isinstance(entry.output, tuple):
        return tuple(None if x is None else x.clone() for x in entry.output)
    return entry.output.clone()


def captured():
    """The cached graphs, least recently used first."""
    return list(_CACHE.values())


def clear():
    """Drop every graph, its buffers and the pools."""
    _CACHE.clear()
    _POOLS.clear()
