"""Render loop: camera rays -> integrator -> accumulated image.

Port of take_tpu/render.py (render.cpp:9-86). The image is flattened to a
path axis [n_pixels * spp_chunk] and rendered in passes of at most
RenderOptions.max_rays_per_pass paths; passes accumulate on the scene's
device. The reference's y-flip (img(x, H-1-y), render.cpp:78) happens at
assembly.
"""

import os
import time

import torch

from take_tpu_torch.core import rng
from take_tpu_torch.core.camera import generate_rays
from take_tpu_torch.integrator.path_tracer import trace_mis, trace_mis_replay
from take_tpu_torch.integrator.variants import trace_one_sample_mis, trace_one_sample_mis_power, trace_raw
from take_tpu_torch.integrator.wavefront import trace_wavefront
from take_tpu_torch.scene.types import RenderOptions, Scene


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


def render_pass(scene: Scene, options: RenderOptions, pixel_idx, sample0: int, width: int, n_samples: int):
    """Render `n_samples` consecutive samples for a batch of pixels.

    Args:
        pixel_idx: [P] int32 linearized pixel index (y * width + x).
        sample0: first sample index of this pass.
    Returns:
        [P, 3] radiance *sum* over the pass's samples.
    """
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
