"""Counter-based (stateless) RNG, bit-identical to take_tpu/core/rng.py.

Keyed by (seed, pixel, sample, bounce, dim) through a murmur3-finalizer
hash, so the same seed gives the same bits on any device and in any lane
order. torch has no complete uint32 arithmetic (no logical right shift on
uint32 on the CPU, and `>>` on int32 is arithmetic), so every word is held
in an int64 tensor with values in [0, 2^32): products wrap modulo 2^64 and
are masked back to their low 32 bits, which is exactly uint32 arithmetic.

On CUDA tensors `make_stream`, `random_bits` and `uniform` launch the
hand-written kernels of csrc/rng.cu, one launch a call, or raise; the
stream words keep their int64 form. On CPU tensors they run the plain
versions below (`_make_stream_plain`, `_random_bits_plain`,
`_uniform_plain`), whose arithmetic the kernels repeat. `LAUNCHES` counts
what ran: each kernel launch, and each call of a plain version.
"""

import ctypes

import torch

from take_tpu_torch.geometry import _launch

_MASK = 0xFFFFFFFF

# murmur3 / splitmix constants
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_M3 = 0x7FEB352D
_M4 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_SALT = 0xDEADBEEF  # the seed's word of a stream's lo half

LAUNCHES = {"stream": 0, "uniform": 0, "bits": 0, "stream_plain": 0, "uniform_plain": 0, "bits_plain": 0}


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


def _make_stream_plain(seed, pixel_idx, sample_idx):
    device = pixel_idx.device
    s32 = seed & _MASK
    p = _word(pixel_idx, device)
    s = _word(sample_idx, device)
    seed_t = torch.full_like(p, s32)
    hi = _mix2(_mix2(seed_t, p), s)
    lo = _mix2(_mix2(seed_t ^ _SALT, s), p)
    return hi, lo


def _random_bits_plain(stream, counter):
    hi, lo = stream
    if isinstance(counter, int):
        c = counter & _MASK
    else:
        c = _word(counter, hi.device)
    x = _mix(hi ^ ((c * _M3) & _MASK))
    y = _mix((lo + ((c * _M4) & _MASK) + _GOLDEN) & _MASK)
    return _mix(x ^ (((y << 1) & _MASK) | (y >> 31)))


def _uniform_plain(stream, counter, dtype=torch.float32):
    bits = _random_bits_plain(stream, counter)
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def _lanes(name, x):
    """An int32 or int64 tensor, contiguous."""
    if x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: expected an int32 or int64 tensor, got {x.dtype}")
    return x.contiguous()


def _make_stream_kernel(seed, pixel_idx, sample_idx):
    dev = pixel_idx.device
    # torch.broadcast_tensors, not torch.broadcast_shapes: the latter's first call imports sympy (~3.5 s)
    p, s = torch.broadcast_tensors(pixel_idx, torch.as_tensor(sample_idx, device=dev))
    p, s = _lanes("pixel_idx", p), _lanes("sample_idx", s)
    hi, lo = (torch.empty(p.shape, dtype=torch.int64, device=dev) for _ in range(2))
    if p.numel():
        p64, s64 = int(p.dtype == torch.int64), int(s.dtype == torch.int64)
        code = _lib().tt_rng_stream(seed & _MASK, p.data_ptr(), p64, s.data_ptr(), s64, p.numel(), hi.data_ptr(),
                                    lo.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _launch.raise_on(_lib(), code, "take_rng_stream")
    return hi, lo


def _draw_kernel(stream, counter, out_dtype):
    """A draw of every lane by take_rng_uniform (float32 out) or take_rng_bits (int64)."""
    hi, lo = stream
    dev = hi.device
    if hi.dtype != torch.int64 or lo.dtype != torch.int64 or lo.device != dev:
        raise ValueError(f"stream: expected two int64 tensors on one device, got {hi.dtype} on {hi.device} "
                         f"and {lo.dtype} on {lo.device}")
    if isinstance(counter, int):
        (hi, lo), ctr, c = torch.broadcast_tensors(hi, lo), None, counter & _MASK
    else:
        hi, lo, ctr = torch.broadcast_tensors(hi, lo, torch.as_tensor(counter, device=dev))
        ctr, c = _lanes("counter", ctr).to(torch.int64), 0
    hi, lo = hi.contiguous(), lo.contiguous()
    out = torch.empty(hi.shape, dtype=out_dtype, device=dev)
    if out.numel():
        fn = _lib().tt_rng_uniform if out_dtype == torch.float32 else _lib().tt_rng_bits
        code = fn(hi.data_ptr(), lo.data_ptr(), None if ctr is None else ctr.data_ptr(), c, out.numel(),
                  out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _launch.raise_on(_lib(), code, "take_rng draw")
    return out


def make_stream(seed, pixel_idx, sample_idx):
    """Per-path stream key (hi, lo) from (seed, pixel, sample).

    Args:
        seed: Python int.
        pixel_idx: [...] int tensor (linearized pixel index).
        sample_idx: [...] int tensor (spp index), broadcastable with pixel_idx.
    Returns:
        (hi, lo): two int64 tensors of uint32 words.
    """
    if not pixel_idx.is_cuda:
        LAUNCHES["stream_plain"] += 1
        return _make_stream_plain(seed, pixel_idx, sample_idx)
    out = _make_stream_kernel(seed, pixel_idx, sample_idx)
    LAUNCHES["stream"] += 1
    return out


def random_bits(stream, counter):
    """uint32 random bits (in int64) for a (stream, counter) coordinate.

    counter is the logical draw index, a Python int or an int tensor, e.g.
    bounce_counter(bounce, dim).
    """
    if not stream[0].is_cuda:
        LAUNCHES["bits_plain"] += 1
        return _random_bits_plain(stream, counter)
    out = _draw_kernel(stream, counter, torch.int64)
    LAUNCHES["bits"] += 1
    return out


def uniform(stream, counter, dtype=torch.float32):
    """U[0, 1) float from (stream, counter); 24 mantissa-safe bits."""
    if not stream[0].is_cuda:
        LAUNCHES["uniform_plain"] += 1
        return _uniform_plain(stream, counter, dtype)
    if dtype != torch.float32:
        raise ValueError(f"uniform: the kernel draws float32, not {dtype}")
    out = _draw_kernel(stream, counter, torch.float32)
    LAUNCHES["uniform"] += 1
    return out


def _warm():
    """Each kernel once, on one lane, uncounted."""
    one = torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", torch.cuda.current_device()))
    stream = _make_stream_kernel(0, one, one)
    _draw_kernel(stream, 0, torch.float32)
    _draw_kernel(stream, 0, torch.int64)


_P, _I, _I64, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
_lib = _launch.declare("rng", {
    "tt_rng_stream": [_U32, _P, _I, _P, _I, _I64, _P, _P, _P],
    "tt_rng_uniform": [_P, _P, _P, _U32, _I64, _P, _P],
    "tt_rng_bits": [_P, _P, _P, _U32, _I64, _P, _P],
}, launches=LAUNCHES, warm=_warm)


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
