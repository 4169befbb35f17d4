"""The counter RNG that the path tracer under test keys its paths by, frozen.

Keyed by (seed, pixel, sample, draw) through a murmur3-finalizer hash, so
that the reference draws the same numbers for the same path and its paths
are the tracer's paths. Words are held in int64 tensors with values in
[0, 2^32): products wrap modulo 2^64 and are masked back to 32 bits, which
is uint32 arithmetic. A copy, so that a change to the tracer's RNG shows
as a wrong image instead of moving the yardstick with it.
"""

import torch

MASK = 0xFFFFFFFF
_M1, _M2, _M3, _M4 = 0x85EBCA6B, 0xC2B2AE35, 0x7FEB352D, 0x846CA68B
_GOLDEN = 0x9E3779B9

DIMS_PER_BOUNCE = 10
# draws of a bounce, by dimension
LIGHT_SELECT, LIGHT_U1, LIGHT_U2, LOBE_SELECT, BSDF_U1, BSDF_U2 = 0, 1, 2, 3, 4, 5
# draws of the camera vertex
JITTER_X, JITTER_Y = 0, 1


def _mix(x):
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK
    x = x ^ (x >> 13)
    x = (x * _M2) & MASK
    return x ^ (x >> 16)


def _mix2(a, b):
    return _mix((a * _GOLDEN + b) & MASK)


def make_stream(seed: int, pixel, sample):
    """(hi, lo) stream key of each path from its pixel and sample indices."""
    p = pixel.to(torch.int64) & MASK
    s = sample.to(torch.int64) & MASK
    seed_t = torch.full_like(p, seed & MASK)
    return _mix2(_mix2(seed_t, p), s), _mix2(_mix2(seed_t ^ 0xDEADBEEF, s), p)


def uniform(stream, counter: int, dtype=torch.float32):
    """U[0, 1) from 24 bits of the hash of (stream, counter)."""
    hi, lo = stream
    c = counter & MASK
    x = _mix(hi ^ ((c * _M3) & MASK))
    y = _mix((lo + ((c * _M4) & MASK) + _GOLDEN) & MASK)
    bits = _mix(x ^ (((y << 1) & MASK) | (y >> 31)))
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def bounce_counter(bounce: int, dim: int) -> int:
    """The draw index of dimension `dim` at bounce `bounce` (the camera's draws are 0 and 1)."""
    return ((bounce + 1) * DIMS_PER_BOUNCE + dim) & MASK
