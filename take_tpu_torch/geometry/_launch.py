"""What the kernel wrappers (brute.py, packet.py, cluster.py, sweep.py) share at run time.

`LAUNCHES` counts what ran: each wrapper adds one to its kernel's key where
it launches the kernel, and each plain twin to its `_plain` key where it
runs. Beside it, the wrappers' argument checks and the launch-error check.
"""

import torch

LAUNCHES = {
    **{
        key: 0
        for kernel in ("", "packet_", "cluster_", "sweep_")
        for key in (f"{kernel}closest", f"{kernel}anyhit", f"{kernel}closest_plain", f"{kernel}anyhit_plain")
    },
    "reference": 0,  # brute.reference, the K1/K2 reference kernel (no render path)
}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def check(name, x, dtype, shape, device):
    """Raise unless `x` is a contiguous `dtype` tensor of `shape` on `device`."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})"
        )


def check_rays(ro, rd, tmin, tmax) -> int:
    """Check a batch of rays ([N, 3] origins and directions, [N] ranges,
    float32, on one device); returns N."""
    n = ro.shape[0]
    for name, x, shape in (("ro", ro, (n, 3)), ("rd", rd, (n, 3)), ("tmin", tmin, (n,)), ("tmax", tmax, (n,))):
        check(name, x, torch.float32, shape, ro.device)
    return n


def raise_on(lib, code, what):
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {lib.tt_error_string(code).decode()} ({code})")
