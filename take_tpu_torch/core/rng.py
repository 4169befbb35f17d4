"""Counter-based (stateless) RNG, bit-identical to take_tpu/core/rng.py.

Keyed by (seed, pixel, sample, bounce, dim) through a murmur3-finalizer
hash, so the same seed gives the same bits on any device and in any lane
order. torch has no complete uint32 arithmetic (no logical right shift on
uint32 on the CPU, and `>>` on int32 is arithmetic), so every word is held
in an int64 tensor with values in [0, 2^32): products wrap modulo 2^64 and
are masked back to their low 32 bits, which is exactly uint32 arithmetic.
"""

import torch

_MASK = 0xFFFFFFFF

# murmur3 / splitmix constants
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_M3 = 0x7FEB352D
_M4 = 0x846CA68B
_GOLDEN = 0x9E3779B9


def _mix(x):
    """32-bit avalanche (murmur3 finalizer variant) on int64-held words."""
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 13)
    x = (x * _M2) & _MASK
    return x ^ (x >> 16)


def _mix2(a, b):
    """Combine-and-avalanche two words."""
    return _mix((a * _GOLDEN + b) & _MASK)


def _word(x, device):
    """An int tensor or Python int as an int64 tensor of uint32 words."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def make_stream(seed, pixel_idx, sample_idx):
    """Per-path stream key (hi, lo) from (seed, pixel, sample).

    Args:
        seed: Python int.
        pixel_idx: [...] int tensor (linearized pixel index).
        sample_idx: [...] int tensor (spp index), broadcastable with pixel_idx.
    Returns:
        (hi, lo): two int64 tensors of uint32 words.
    """
    device = pixel_idx.device
    s32 = seed & _MASK
    p = _word(pixel_idx, device)
    s = _word(sample_idx, device)
    seed_t = torch.full_like(p, s32)
    hi = _mix2(_mix2(seed_t, p), s)
    lo = _mix2(_mix2(seed_t ^ 0xDEADBEEF, s), p)
    return hi, lo


def random_bits(stream, counter):
    """uint32 random bits (in int64) for a (stream, counter) coordinate.

    counter is the logical draw index, a Python int or an int tensor, e.g.
    bounce_counter(bounce, dim).
    """
    hi, lo = stream
    if isinstance(counter, int):
        c = counter & _MASK
    else:
        c = _word(counter, hi.device)
    x = _mix(hi ^ ((c * _M3) & _MASK))
    y = _mix((lo + ((c * _M4) & _MASK) + _GOLDEN) & _MASK)
    return _mix(x ^ (((y << 1) & _MASK) | (y >> 31)))


def uniform(stream, counter, dtype=torch.float32):
    """U[0, 1) float from (stream, counter); 24 mantissa-safe bits."""
    bits = random_bits(stream, counter)
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


# Logical dimension allocation per bounce (same layout as take_tpu).
DIMS_PER_BOUNCE = 10

DIM_LIGHT_SELECT = 0
DIM_LIGHT_U1 = 1
DIM_LIGHT_U2 = 2
DIM_LOBE_SELECT = 3
DIM_BSDF_U1 = 4
DIM_BSDF_U2 = 5
DIM_MIS_TECH = 6
DIM_AUX = 7
DIM_ENV_U3 = 8
DIM_RR = 9

DIM_CAMERA_JITTER_X = 0
DIM_CAMERA_JITTER_Y = 1


def bounce_counter(bounce: int, dim: int) -> int:
    """Map (bounce, dim) -> flat counter. Camera jitter = bounce '-1' (slot 0)."""
    return ((bounce + 1) * DIMS_PER_BOUNCE + dim) & _MASK


def camera_counter(dim: int) -> int:
    return dim
