"""Render loop: camera rays -> integrator -> accumulated image.

Port of take_tpu/render.py (render.cpp:9-86). The image is flattened to a
path axis [n_pixels * spp_chunk] and rendered in passes of at most
RenderOptions.max_rays_per_pass paths; passes accumulate on the scene's
device. The reference's y-flip (img(x, H-1-y), render.cpp:78) happens at
assembly.

A pass on the card runs as one captured CUDA graph per compile key, the
counterpart of take_tpu's jitted pass (`_render_pass_jit`, one executable
per static key): `render_pass` captures the pass at a key's first call and
replays the graph on every later one (take_tpu_torch/_graph.py). The key is
take_tpu's: the options with `spp` and `max_rays_per_pass` normalized, the
width, the samples a pass and the pixel batch's shape, dtype and device;
and, since a graph reads fixed addresses, the scene's tables (address,
shape, strides, dtype, version: a table written in place or replaced is a
new key; the graph holds the scene) and the route a query takes at call
time (`traverse.FORCE_CLUSTER`/`FORCE_SWEEP` and the kernel functions, so
a patched route never replays another's graph). The scan integrators and
`mis_replay` (`GRAPH_INTEGRATORS`; the replay loop runs every trip under a
capture) are captured under inference mode or no_grad; a pass that autograd
records, the refill loop (`mis_wavefront`, which syncs the host), every pass
inside `eager()` and every pass on the CPU run op by op. `PASSES` counts
both kinds; `clear_cache()` drops every graph, the gradient passes' too
(grad.py).
"""

import contextlib
import dataclasses
import os
import time

import torch

from take_tpu_torch import _graph
from take_tpu_torch.core import rng
from take_tpu_torch.core.camera import generate_rays
from take_tpu_torch.geometry import brute, cluster, packet, sweep, traverse
from take_tpu_torch.integrator.path_tracer import trace_mis, trace_mis_replay
from take_tpu_torch.integrator.variants import trace_one_sample_mis, trace_one_sample_mis_power, trace_raw
from take_tpu_torch.integrator.wavefront import trace_wavefront
from take_tpu_torch.lights import envmap
from take_tpu_torch.scene.types import RenderOptions, Scene

# The integrators whose pass makes no host sync under a capture, so that it can be captured.
GRAPH_INTEGRATORS = ("mis", "mis_scan", "mis_replay", "one_sample_mis", "one_sample_mis_power", "raw")
# Module functions a pass looks up at call time; each is part of the key.
ROUTE = tuple((m, name) for m in (brute, packet, cluster, sweep) for name in ("closest", "occluded")) + (
    (envmap, "_dir_to_uv"), (envmap, "_uv_to_dir"))
PASSES = {"graph": 0, "eager": 0}  # passes run, by kind
_EAGER = [0]  # depth of eager() contexts


def use_wavefront_policy(scene: Scene, options: RenderOptions) -> bool:
    """Whether a pass runs the lane-refill wavefront loop: only when
    integrator="mis_wavefront" forces it; "mis" runs the scan loop.

    The JAX package picks the refill loop for envmap scenes at depth >= 2,
    open BVH scenes at depth >= 3 and BVH scenes at depth >= 8. On the H100
    the scan loop won each of those arms in an interleaved A/B (PERF.md,
    prof_room.py --policy): at the default pass size (max_rays_per_pass =
    WAVE_SIZE) no lane is ever refilled, and each refill iteration costs a
    host sync and a full set of launches whatever its live width."""
    return options.integrator == "mis_wavefront"


def _trace_fn(scene: Scene, options: RenderOptions):
    """The bounce loop of a pass: trace_wavefront, which makes its own camera
    rays, where the policy picks it; else the integrator's own loop."""
    if use_wavefront_policy(scene, options):
        return trace_wavefront
    if options.integrator in ("mis", "mis_scan"):
        return trace_mis
    if options.integrator == "mis_replay":
        return trace_mis_replay
    if options.integrator == "one_sample_mis":
        return trace_one_sample_mis
    if options.integrator == "one_sample_mis_power":
        return trace_one_sample_mis_power
    if options.integrator == "raw":
        return trace_raw
    raise ValueError(f"unknown integrator {options.integrator!r}")


def checks_enabled() -> bool:
    """TAKE_TPU_CHECKS=1 makes render_image check every accumulated pass for
    NaN/Inf on the host and raise with the band (the JAX package's opt-in
    guard, take_tpu/config.py::checks_enabled). Off by default: the check
    waits for the card after every pass."""
    return os.environ.get("TAKE_TPU_CHECKS", "") == "1"


@contextlib.contextmanager
def eager():
    """Run every pass op by op inside this context, render passes and
    gradient passes (grad.py) alike: the counterpart of jax.disable_jit().
    Needed where a pass cannot be captured (a route patched to plain twins
    that sync the host, e.g. `packet_plain`) or must run its Python each
    time (a patch that records its arguments). Nests."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def in_eager() -> bool:
    """Whether an eager() context is open."""
    return _EAGER[0] > 0


def clear_cache():
    """Drop every captured pass graph, render and gradient: the counterpart
    of jax.clear_caches()."""
    _graph.clear()


def _pass(scene: Scene, options: RenderOptions, pixel_idx, sample0, width: int, n_samples: int):
    """The pass's computation (take_tpu's `_render_pass_jit` body): `sample0`
    is a 0-d int32 tensor on the pixels' device, so a captured graph reads
    it as it reads the pixels."""
    trace = _trace_fn(scene, options)
    P = pixel_idx.shape[0]
    # pixel-major path flattening: lane i*k + j = (pixel i, sample j)
    pix = pixel_idx[:, None].expand(P, n_samples).reshape(P * n_samples)
    samp = sample0 + torch.arange(n_samples, dtype=torch.int32, device=pix.device)
    samp = samp[None, :].expand(P, n_samples).reshape(P * n_samples)
    if trace is trace_wavefront:  # the refill loop makes its own camera rays
        return trace(scene, options, pix, samp, width).reshape(P, n_samples, 3).sum(dim=1)
    px = (pix % width).to(torch.float32)
    py = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
    streams = rng.make_stream(options.seed, pix, samp)
    jx = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
    jy = rng.uniform(streams, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
    ro, rd = generate_rays(scene.meta.camera, px, py, jx, jy)
    radiance = trace(scene, options, ro, rd, streams)
    return radiance.reshape(P, n_samples, 3).sum(dim=1)


def table_facts(obj, param_device=None):
    """The tables of a scene (or of one of its groups) as hashable facts:
    each tensor's address, shape, strides, dtype, device and version (-1 for
    an inference tensor, which keeps none), groups nested, the rest as is.
    With `param_device`, each float scene table on that device (a gradient
    pass's input, which its graph copies into leaves of its own at every
    call: grad.py) is its shape, dtype and device alone."""
    out = []
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if isinstance(x, torch.Tensor):
            if f.compare and x.is_floating_point() and x.device == param_device:
                out.append((tuple(x.shape), x.dtype, x.device))
            else:
                out.append((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype, x.device,
                            -1 if x.is_inference() else x._version))
        elif dataclasses.is_dataclass(x) and not type(x).__dataclass_params__.frozen:
            out.append(table_facts(x, param_device))
        else:
            out.append(x)
    return tuple(out)


def route():
    """The route a query takes now: the traversal flags and the kernel
    functions of ROUTE, looked up at call time."""
    return (traverse.FORCE_CLUSTER, traverse.FORCE_SWEEP, *(getattr(m, name) for m, name in ROUTE))


def key_options(options: RenderOptions) -> RenderOptions:
    """The options as a compile key holds them: spp and max_rays_per_pass,
    which only the host's pass loop reads, normalized."""
    return dataclasses.replace(options, spp=1, max_rays_per_pass=RenderOptions.max_rays_per_pass)


def pass_key(scene: Scene, options: RenderOptions, pixel_idx, width: int, n_samples: int):
    """The compile key of a pass, as take_tpu/render.py::render_pass forms
    it (spp and max_rays_per_pass are read by the host's pass loop only, so
    a 1-spp warm-up and a 4096-spp render share a key), with the scene's
    tables and the route the pass takes now."""
    return (key_options(options), width, n_samples, tuple(pixel_idx.shape), pixel_idx.dtype, pixel_idx.device,
            table_facts(scene), route())


def graphed(options: RenderOptions, pixel_idx) -> bool:
    """Whether render_pass replays a captured graph for this pass."""
    return (pixel_idx.is_cuda and not in_eager() and options.integrator in GRAPH_INTEGRATORS
            and not torch.is_grad_enabled())


def render_pass(scene: Scene, options: RenderOptions, pixel_idx, sample0, width: int, n_samples: int):
    """Render `n_samples` consecutive samples for a batch of pixels.

    Args:
        pixel_idx: [P] int32 linearized pixel index (y * width + x).
        sample0: first sample index of this pass.
    Returns:
        [P, 3] radiance *sum* over the pass's samples: a tensor of its own,
        also when a graph computed it.
    """
    s0 = torch.full((), sample0, dtype=torch.int32, device=pixel_idx.device)
    if not graphed(options, pixel_idx):
        PASSES["eager"] += 1
        return _pass(scene, options, pixel_idx, s0, width, n_samples)
    PASSES["graph"] += 1
    key = pass_key(scene, options, pixel_idx, width, n_samples)
    return _graph.run(key, scene, lambda pix, s: _pass(scene, key[0], pix, s, width, n_samples),
                      [pixel_idx, s0])


def render_image(scene: Scene, options: RenderOptions = RenderOptions(), progress=None):
    """Full-frame render -> [H, W, 3] float32 numpy image (y-flipped like the
    reference). Splits work into passes to bound live memory."""
    cam = scene.meta.camera
    W, H = cam.width, cam.height
    n_pixels = W * H
    device = scene.background.device
    _trace_fn(scene, options)  # refuse what the port cannot render, up front

    # pass shape: row band of pixels x k samples, k * band <= max_rays_per_pass
    max_pass = options.max_rays_per_pass
    k = max(1, min(options.spp, max_pass // max(n_pixels, 1)))
    rows_per_band = max(1, max_pass // (W * k))
    acc = torch.zeros((n_pixels, 3), dtype=torch.float32, device=device)

    checks = checks_enabled()
    n_passes = 0
    with torch.inference_mode():
        for y0 in range(0, H, rows_per_band):
            y1 = min(y0 + rows_per_band, H)
            pix = torch.arange(y0 * W, y1 * W, dtype=torch.int32, device=device)
            band_acc = torch.zeros((pix.shape[0], 3), dtype=torch.float32, device=device)
            s = 0
            while s < options.spp:
                ns = min(k, options.spp - s)
                band_acc = band_acc + render_pass(scene, options, pix, s, W, ns)
                s += ns
                n_passes += 1
                if checks and not bool(torch.isfinite(band_acc).all()):
                    raise FloatingPointError(
                        f"non-finite radiance in rows [{y0}, {y1}) after sample {s} (TAKE_TPU_CHECKS=1)")
                if progress is not None:
                    progress(n_passes)
            acc[y0 * W : y1 * W] = band_acc
    img = acc.cpu().numpy().reshape(H, W, 3) / options.spp
    return img[::-1]  # y-flip (render.cpp:78)


def render(scene: Scene, **opts):
    """render_image with keyword options, printing the time and Mpaths/s."""
    options = RenderOptions(**opts)
    t0 = time.time()
    img = render_image(scene, options)
    dt = time.time() - t0
    cam = scene.meta.camera
    n_paths = cam.width * cam.height * options.spp
    print(
        f"Rendered {cam.width}x{cam.height} @ {options.spp}spp in {dt:.2f}s "
        f"({n_paths / max(dt, 1e-9) / 1e6:.2f} Mpaths/s)"
    )
    return img
