"""Differentiable rendering: gradients of pixel radiance with respect to the
scene's tables (materials, textures, light and emitter radiance, the
environment map). Port of take_tpu/grad.py.

The counter-based RNG makes the estimator a deterministic function of
(scene, seed), so the backward follows the forward's paths. Two modes
(RenderOptions.grad_mode): "ad", autograd through the scan loop
(`trace_mis`, residuals per bounce), and "replay", the path-replay backward
of `trace_mis_replay` (memory O(wavefront)); "auto" picks replay beyond
2^24 path-bounces. Scope, as in take_tpu: continuous parameters only.
Geometry and visibility are constant (no boundary terms); sampled
directions are detached.

Gradients come back Scene-shaped: a Scene whose float tables are their
gradients (zeros where a table received none) and whose integer tables and
derived fields (`tri_rows`, the BVH's kernel layouts) are None. Nothing
here moves the scene off its device.

take_tpu jits its gradient (`render_loss_grad`, a `jax.jit` of
`value_and_grad` with `options` and `n_samples` static). Here each pass of
`partial_loss_grad` (which every gradient entry point calls) on the card
replays one captured CUDA graph per key (`grad_key`) that holds the pass's
forward and backward (take_tpu_torch/_graph.py): the float tables on the
pass's device are the graph's parameters, copied into its own leaf buffers
at every call, so new parameter values (an Adam step, a scene/edit.py edit)
replay the same graph, as a jitted function takes new values without a new
compile. Inside `render.eager()` and on the CPU every pass runs op by op;
`PASSES` counts both kinds. `param_grads` is the same body with a linear
loss, so its passes replay graphs too.
"""

import torch

from take_tpu_torch import _graph
from take_tpu_torch.core import rng
from take_tpu_torch.core.camera import generate_rays
from take_tpu_torch.integrator.path_tracer import trace_mis, trace_mis_replay
from take_tpu_torch.render import in_eager, key_options, route, table_facts
from take_tpu_torch.scene.types import RenderOptions, Scene, float_tables, replace_tables

REPLAY_PATH_BOUNCES = 1 << 24  # "auto" picks replay above this many path-bounces
PASSES = {"graph": 0, "eager": 0}  # gradient passes run, by kind


def resolve_mode(options: RenderOptions, n_paths: int) -> str:
    """The mode grad_mode selects for `n_paths` paths: autograd through the
    scan loop stores residuals per bounce, so its memory grows with
    paths x depth; beyond 2^24 path-bounces "auto" takes replay, whose
    backward memory is O(paths) at about twice the work."""
    mode = options.grad_mode
    if mode == "auto":
        return "replay" if n_paths * (options.max_depth + 1) > REPLAY_PATH_BOUNCES else "ad"
    if mode not in ("ad", "replay"):
        raise ValueError(f"unknown grad_mode {mode!r}")
    return mode


def _radiance(scene: Scene, options: RenderOptions, pixel_idx, sample0, n_samples: int, mode: str):
    """[P, 3] mean radiance; `sample0` an int or a 0-d int32 tensor on the
    pixels' device."""
    cam = scene.meta.camera
    P = pixel_idx.shape[0]
    pix = pixel_idx[:, None].expand(P, n_samples).reshape(P * n_samples)
    samp = sample0 + torch.arange(n_samples, dtype=torch.int32, device=pix.device)
    samp = samp[None, :].expand(P, n_samples).reshape(P * n_samples)
    px = (pix % cam.width).to(torch.float32)
    py = torch.div(pix, cam.width, rounding_mode="floor").to(torch.float32)
    streams = rng.make_stream(options.seed, pix, samp)
    jx = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
    jy = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
    ro, rd = generate_rays(cam, px, py, jx, jy)
    trace = trace_mis_replay if mode == "replay" else trace_mis
    return trace(scene, options, ro, rd, streams).reshape(P, n_samples, 3).mean(dim=1)


def render_radiance(scene: Scene, options: RenderOptions, pixel_idx, sample0, n_samples: int):
    """Differentiable radiance estimate for a pixel batch.

    Args:
        pixel_idx: [P] int32 linearised pixel indices (y * width + x).
        sample0: first sample index (int).
    Returns:
        [P, 3] mean radiance over `n_samples` consecutive samples,
        differentiable with respect to every float table of `scene`.
    """
    mode = resolve_mode(options, pixel_idx.shape[0] * n_samples)
    return _radiance(scene, options, pixel_idx, int(sample0), n_samples, mode)


def _passes(options: RenderOptions, P: int, n_samples: int):
    """Pixel slices of at most options.max_rays_per_pass paths each."""
    per = max(1, options.max_rays_per_pass // n_samples)
    return [slice(p0, min(p0 + per, P)) for p0 in range(0, P, per)]


def _loss_part(loss: str, img, target, denom):
    if loss == "l2":
        return torch.sum((img - target) ** 2) / denom
    if loss == "linear":
        return torch.sum(img * target) / denom
    raise ValueError(f"unknown loss {loss!r}")


def _pass_grad(scene: Scene, options: RenderOptions, keys, n_samples: int, mode: str, loss: str, pixel_idx, target,
               sample0, denom, *tables):
    """One pass's loss part and its gradient with respect to `tables` (leaves
    for the float tables at `keys`): the body take_tpu jits, forward and
    backward, run op by op or captured. `sample0` (int32) and `denom`
    (float32) are 0-d tensors on the pixels' device, so a graph reads them
    as it reads the pixels. torch.autograd.grad, not .backward(), so that no
    `.grad` accumulates on a graph's leaves. Returns (part, *gradients),
    None where a table gets none."""
    s = replace_tables(scene, dict(zip(keys, tables)))
    img = _radiance(s, options, pixel_idx, sample0, n_samples, mode)
    part = _loss_part(loss, img, target, denom)
    return (part.detach(), *torch.autograd.grad(part, tables, allow_unused=True))


def _add_into(acc, g):
    """acc + g, written into acc; None is zero."""
    if g is None:
        return acc
    return g.contiguous() if acc is None else acc.add_(g)


def grad_key(scene: Scene, options: RenderOptions, mode: str, n_samples: int, loss: str, pixel_idx, target):
    """The compile key of a gradient pass: take_tpu's static arguments (the
    options, with spp and max_rays_per_pass normalized as render.pass_key
    does, since no pass reads them; the resolved mode; n_samples) and the
    loss; the pass's pixel and target shapes, dtypes and device; the route
    (render.route); and the scene's integer tables and derived fields by
    address, shape, strides, dtype and version, which the graph reads in
    place. The float tables on the pixels' device are in it by shape, dtype
    and device alone: they are the graph's parameters, so new values replay
    the same graph."""
    return (key_options(options), mode, n_samples, loss, tuple(pixel_idx.shape), pixel_idx.dtype, pixel_idx.device,
            tuple(target.shape), target.dtype, target.device, route(), table_facts(scene, pixel_idx.device))


def graphed(pixel_idx) -> bool:
    """Whether a gradient pass replays a captured graph: on the card,
    outside render.eager()."""
    return pixel_idx.is_cuda and not in_eager()


def partial_loss_grad(scene: Scene, options: RenderOptions, pixel_idx, target, n_samples: int, mode: str,
                      denom: int, sample0: int = 0, loss: str = "l2"):
    """sum((img - target)^2) / denom over a pixel batch (with loss="linear",
    sum(img * target) / denom: a target of weights), and its gradient with
    respect to every float table of the scene, in passes of at most
    options.max_rays_per_pass paths, under the given mode ("ad" or
    "replay"); the host sums the passes' parts and gradients. The part of
    a loss over more pixels (denom = 3 x their number) that a shard or a
    band computes (parallel/sharding.py, parallel/overlap.py).

    On the card, outside render.eager(), each pass replays the graph
    captured for its key (grad_key); a capture that fails raises.

    Returns:
        (loss, grads): a 0-d tensor and a Scene-shaped gradient.
    """
    device = pixel_idx.device
    tables = float_tables(scene)
    keys = tuple(k for k, t in tables.items() if t.device == device)  # a graph's parameters
    s0 = torch.full((), int(sample0), dtype=torch.int32, device=device)
    dn = torch.full((), denom, dtype=torch.float32, device=device)
    graph = graphed(pixel_idx)
    if graph:  # what a graph holds: the scene without its parameters
        held = replace_tables(scene, dict.fromkeys(keys))
    else:
        params = [tables[k].detach().requires_grad_(True) for k in keys]
    total = torch.zeros((), dtype=torch.float32, device=scene.background.device)
    acc = [None] * len(keys)  # the first pass's gradients, each later pass's added in place
    for sl in _passes(options, pixel_idx.shape[0], n_samples):
        pix, tgt = pixel_idx[sl], target[sl]
        if graph:
            PASSES["graph"] += 1
            key = grad_key(scene, options, mode, n_samples, loss, pix, tgt)
            out = _graph.run(key, held, lambda *a: _pass_grad(held, key[0], keys, n_samples, mode, loss, *a),
                             [pix, tgt, s0, dn], [tables[k] for k in keys])
        else:
            PASSES["eager"] += 1
            with torch.enable_grad():
                out = _pass_grad(scene, options, keys, n_samples, mode, loss, pix, tgt, s0, dn, *params)
        total = total + out[0]
        acc = [_add_into(a, g) for a, g in zip(acc, out[1:])]
    got = dict(zip(keys, acc))  # zeros, once, where a table got no gradient
    grads = {k: torch.zeros_like(t) if got.get(k) is None else got[k] for k, t in tables.items()}
    return total, replace_tables(scene, grads, drop_rest=True)


def render_loss_grad(scene: Scene, options: RenderOptions, pixel_idx, target, n_samples: int, sample0: int = 0):
    """L2 image loss mean((img - target)^2) and its gradient with respect to
    every float table of the scene: the inverse-rendering primitive.

    The mode is resolved once for the whole batch (grad_mode, over
    P * n_samples paths); the batch then runs in passes of at most
    options.max_rays_per_pass paths (partial_loss_grad), their gradients
    summed, so memory is bounded by a pass. `sample0` starts the
    sample window (a fresh window per optimisation step gives fresh noise).

    Returns:
        (loss, grads): a 0-d tensor and a Scene-shaped gradient.
    """
    mode = resolve_mode(options, pixel_idx.shape[0] * n_samples)
    return partial_loss_grad(scene, options, pixel_idx, target, n_samples, mode, target.numel(), sample0)


def param_grads(scene: Scene, options: RenderOptions, pixel_idx, cotangent, n_samples: int = 1):
    """Vector-Jacobian product of the radiance with respect to the scene's
    float tables for an image cotangent [P, 3]: a Scene-shaped gradient.
    The gradient of the linear loss sum(img * cotangent), by
    partial_loss_grad (so its passes replay graphs on the card)."""
    mode = resolve_mode(options, pixel_idx.shape[0] * n_samples)
    return partial_loss_grad(scene, options, pixel_idx, cotangent, n_samples, mode, 1, loss="linear")[1]


def backward(scene: Scene, grads: Scene):
    """Carry a Scene-shaped gradient on into what the scene's tables were
    computed from (the raw parameters of scene/edit.py's edits, say): the
    chain rule's last step, after render_loss_grad or param_grads."""
    tables, g = float_tables(scene), float_tables(grads)
    pairs = [(t, g[k]) for k, t in tables.items() if t.requires_grad]
    if pairs:
        torch.autograd.backward([t for t, _ in pairs], [x for _, x in pairs])
