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
"""

import torch

from take_tpu_torch.core import rng
from take_tpu_torch.core.camera import generate_rays
from take_tpu_torch.integrator.path_tracer import trace_mis, trace_mis_replay
from take_tpu_torch.scene.types import RenderOptions, Scene, float_tables, replace_tables

REPLAY_PATH_BOUNCES = 1 << 24  # "auto" picks replay above this many path-bounces


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


def _leaves(scene: Scene):
    """(scene on fresh leaf tables, {path: leaf}): every float table detached
    and requiring grad."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in float_tables(scene).items()}
    return replace_tables(scene, leaves), leaves


def _grad_scene(scene: Scene, leaves: dict) -> Scene:
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)) for k, v in leaves.items()}
    return replace_tables(scene, grads, drop_rest=True)


def _passes(options: RenderOptions, P: int, n_samples: int):
    """Pixel slices of at most options.max_rays_per_pass paths each."""
    per = max(1, options.max_rays_per_pass // n_samples)
    return [slice(p0, min(p0 + per, P)) for p0 in range(0, P, per)]


def partial_loss_grad(scene: Scene, options: RenderOptions, pixel_idx, target, n_samples: int, mode: str,
                      denom: int, sample0: int = 0):
    """sum((img - target)^2) / denom over a pixel batch, and its gradient
    with respect to every float table of the scene, in passes of at most
    options.max_rays_per_pass paths, each pass's backward adding into the
    same fresh leaf tables, under the given mode ("ad" or "replay"). The
    part of a loss over more pixels (denom = 3 x their number) that a
    shard or a band computes (parallel/sharding.py, parallel/overlap.py).

    Returns:
        (loss, grads): a 0-d tensor and a Scene-shaped gradient.
    """
    s, leaves = _leaves(scene)
    loss = torch.zeros((), dtype=torch.float32, device=scene.background.device)
    for sl in _passes(options, pixel_idx.shape[0], n_samples):
        img = _radiance(s, options, pixel_idx[sl], int(sample0), n_samples, mode)
        part = torch.sum((img - target[sl]) ** 2) / denom
        part.backward()
        loss = loss + part.detach()
    return loss, _grad_scene(scene, leaves)


def render_loss_grad(scene: Scene, options: RenderOptions, pixel_idx, target, n_samples: int, sample0: int = 0):
    """L2 image loss mean((img - target)^2) and its gradient with respect to
    every float table of the scene: the inverse-rendering primitive.

    The mode is resolved once for the whole batch (grad_mode, over
    P * n_samples paths); the batch then runs in passes of at most
    options.max_rays_per_pass paths, each pass's backward adding into the
    same gradients, so memory is bounded by a pass. `sample0` starts the
    sample window (a fresh window per optimisation step gives fresh noise).

    Returns:
        (loss, grads): a 0-d tensor and a Scene-shaped gradient.
    """
    mode = resolve_mode(options, pixel_idx.shape[0] * n_samples)
    return partial_loss_grad(scene, options, pixel_idx, target, n_samples, mode, target.numel(), sample0)


def param_grads(scene: Scene, options: RenderOptions, pixel_idx, cotangent, n_samples: int = 1):
    """Vector-Jacobian product of the radiance with respect to the scene's
    float tables for an image cotangent [P, 3]: a Scene-shaped gradient."""
    s, leaves = _leaves(scene)
    img = render_radiance(s, options, pixel_idx, 0, n_samples)
    img.backward(cotangent)
    return _grad_scene(scene, leaves)


def backward(scene: Scene, grads: Scene):
    """Carry a Scene-shaped gradient on into what the scene's tables were
    computed from (the raw parameters of scene/edit.py's edits, say): the
    chain rule's last step, after render_loss_grad or param_grads."""
    tables, g = float_tables(scene), float_tables(grads)
    pairs = [(t, g[k]) for k, t in tables.items() if t.requires_grad]
    if pairs:
        torch.autograd.backward([t for t, _ in pairs], [x for _, x in pairs])
