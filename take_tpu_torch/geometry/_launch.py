"""The port's kernel runtime: each CUDA source (csrc/<name>.cu) is declared
here once, by the module that wraps it (`declare`), and no other module
names it.

Counters. Each wrapper adds one to its kernel's key where it launches the
kernel, and each plain twin to its `_plain` key where it runs. `LAUNCHES`
counts the scene queries (brute.py, packet.py, cluster.py, sweep.py); the
other wrappers count in dicts of their own. Every counter is registered by
key in `COUNTED`, no key in two: `reset_launches()` zeroes them all, and the
graph cache (_graph.py) takes a capture's counts out of them and adds them
back at each replay. Beside them, the wrappers' argument checks and the
launch-error check, and the fields (`Field`, `field`) through which the
kernels of csrc/disney.cu, light.cu and bsdf.cu read their inputs in place.
"""

import collections
import ctypes
import functools

import torch

LAUNCHES = {
    **{
        key: 0
        for kernel in ("", "packet_", "cluster_", "sweep_")
        for key in (f"{kernel}closest", f"{kernel}anyhit", f"{kernel}closest_plain", f"{kernel}anyhit_plain")
    },
    "reference": 0,  # brute.reference, the K1/K2 reference kernel (no render path)
}
COUNTED = dict.fromkeys(LAUNCHES, LAUNCHES)  # launch key -> the counter that holds it
Source = collections.namedtuple("Source", "lib flags warm")  # a declared source
SOURCES = {}  # name -> Source, in the order declared


def declare(name, functions, launches=None, flags: tuple = (), warm=None):
    """Declare csrc/<name>.cu: `functions` maps each C function (each returns
    an int) to its ctypes argument types, `launches` is the dict that counts
    its launches (refused if another counter holds one of its keys), `flags`
    its nvcc flags beyond _build.NVCC_FLAGS, and `warm()` launches each of
    its kernels once on the current stream, counting nothing. Returns the
    source's loader (build if needed, load, declare `functions` and
    `tt_error_string`), cached; the wrapper binds it to its `_lib`, where a
    test may put a stand-in library."""
    if name in SOURCES:
        raise ValueError(f"csrc/{name}.cu is declared twice")
    if launches is not None:
        taken = [key for key in launches if COUNTED.get(key, launches) is not launches]
        if taken:
            raise ValueError(f"csrc/{name}.cu: launch keys {taken} are counted elsewhere already")
        COUNTED.update(dict.fromkeys(launches, launches))

    @functools.cache
    def lib():
        from take_tpu_torch.geometry import _build

        loaded = _build.load(name, flags)
        for fn, argtypes in functions.items():
            c_fn = getattr(loaded, fn)
            c_fn.argtypes, c_fn.restype = argtypes, ctypes.c_int
        loaded.tt_error_string.argtypes, loaded.tt_error_string.restype = [ctypes.c_int], ctypes.c_char_p
        return loaded

    SOURCES[name] = Source(lib, flags, warm)
    return lib


def reset_launches():
    """Zero every registered counter."""
    for key, counter in COUNTED.items():
        counter[key] = 0


def warm():
    """Run every declared source's warm function on the current device and
    stream, so that no kernel is loaded while a graph is being captured
    (no-op without a card)."""
    if torch.cuda.is_available():
        for source in SOURCES.values():
            if source.warm is not None:
                source.warm()


def check(name, x, dtype, shape, device):
    """Raise unless `x` is a contiguous `dtype` tensor of `shape` on `device`."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})"
        )


class Field(ctypes.Structure):
    """A field of a kernel's Inputs struct (csrc/disney.cu, light.cu,
    bsdf.cu): lane i at p[i * s], a vector's component k at p[i * s + k]."""

    _fields_ = [("p", ctypes.c_void_p), ("s", ctypes.c_int64)]


def field(name, x, n, dtype, width, device) -> Field:
    """x as a Field, read in place: a `dtype` tensor on `device` of shape
    [n] or [n, width], the last axis of unit stride; raise otherwise."""
    shape = (n,) if width == 1 else (n, width)
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape or (width > 1 and x.stride(1) != 1):
        raise ValueError(f"{name}: expected a {dtype} tensor of shape {shape} on {device} with a unit stride on "
                         f"its last axis, got {x.dtype} {tuple(x.shape)} strides {x.stride()} on {x.device}")
    return Field(x.data_ptr(), x.stride(0))


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
