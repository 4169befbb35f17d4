"""The counter RNG's kernels (take_tpu_torch/csrc/rng.cu) from the CPU: the
route a CPU tensor takes, the source's constants, a uint32 walk of the
kernels' arithmetic against the plain version, the wrapper's argument
handling, and the per-lane counter form
against take_tpu's. The kernels themselves run in tests/test_torch_cuda.py."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.core import rng as jrng
from take_tpu_torch.core import rng
from take_tpu_torch.geometry import _launch

SOURCE = os.path.join(os.path.dirname(__file__), "..", "take_tpu_torch", "csrc", "rng.cu")
CBOX = os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox", "cbox.xml")
NAMES = {"kM1": "_M1", "kM2": "_M2", "kM3": "_M3", "kM4": "_M4", "kGolden": "_GOLDEN", "kSalt": "_SALT"}


def source_constants():
    text = open(SOURCE).read()
    return {k: int(v, 16) for k, v in re.findall(r"constexpr uint32_t (k\w+) = 0x([0-9A-Fa-f]+)u;", text)}


def test_cpu_draws_take_the_plain_route():
    _launch.reset_launches()
    pix = torch.arange(64, dtype=torch.int32)
    st = rng.make_stream(5, pix, torch.zeros_like(pix))
    rng.uniform(st, rng.bounce_counter(2, rng.DIM_BSDF_U1))
    rng.uniform(st, torch.full((64,), 7))
    rng.random_bits(st, 3)
    assert rng.LAUNCHES == {"stream": 0, "uniform": 0, "bits": 0,
                            "stream_plain": 1, "uniform_plain": 2, "bits_plain": 1}
    assert torch.equal(st[0], rng._make_stream_plain(5, pix, torch.zeros_like(pix))[0])


def test_kernel_constants_equal_rng_py():
    found = source_constants()
    assert set(NAMES) <= set(found)
    for k, name in NAMES.items():
        assert found[k] == getattr(rng, name), k


def _walk(seed, pix, samp, counter):
    """rng.cu's take_rng_stream, take_rng_bits and take_rng_uniform in numpy
    uint32 arithmetic, with the constants read from the source."""
    k = {n: np.uint32(v) for n, v in source_constants().items()}

    def mix(x):
        x = x ^ (x >> np.uint32(16))
        x = x * k["kM1"]
        x = x ^ (x >> np.uint32(13))
        x = x * k["kM2"]
        return x ^ (x >> np.uint32(16))

    def mix2(a, b):
        return mix(a * k["kGolden"] + b)

    with np.errstate(over="ignore"):
        s, p, q = np.uint32(seed & 0xFFFFFFFF), pix.astype(np.uint32), samp.astype(np.uint32)
        hi, lo = mix2(mix2(s, p), q), mix2(mix2(s ^ k["kSalt"], q), p)
        c = counter.astype(np.uint32)
        x = mix(hi ^ (c * k["kM3"]))
        y = mix(lo + c * k["kM4"] + k["kGolden"])
        bits = mix(x ^ ((y << np.uint32(1)) | (y >> np.uint32(31))))
    return hi, lo, bits, (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0**-24)


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_kernel_walk_equals_plain(rng_np, seed):
    n = 1 << 14
    pix = rng_np.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    pix[:4] = (0, 1, (1 << 31) - 1, -1)
    samp = rng_np.integers(0, 1 << 16, n).astype(np.int32)
    counter = rng_np.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.int64)
    counter[:3] = ((1 << 32) - 1, (1 << 32) - 2, 0)
    hi, lo, bits, u = _walk(seed, pix, samp, counter)
    st = rng._make_stream_plain(seed, torch.from_numpy(pix), torch.from_numpy(samp))
    np.testing.assert_array_equal(st[0].numpy(), hi.astype(np.int64))
    np.testing.assert_array_equal(st[1].numpy(), lo.astype(np.int64))
    c = torch.from_numpy(counter)
    np.testing.assert_array_equal(rng._random_bits_plain(st, c).numpy(), bits.astype(np.int64))
    np.testing.assert_array_equal(rng._uniform_plain(st, c).numpy(), u)


def test_wrapper_lanes_contiguous_and_refuse():
    _, got = torch.broadcast_tensors(torch.zeros(2, 1), torch.arange(3, dtype=torch.int32))
    got = rng._lanes("counter", got)
    assert got.shape == (2, 3) and got.is_contiguous() and got.dtype == torch.int32
    same = torch.arange(6)
    assert rng._lanes("pixel_idx", same).data_ptr() == same.data_ptr()  # no copy
    for bad in (torch.zeros(3), torch.zeros(3, dtype=torch.uint8), torch.zeros(3, dtype=torch.bool)):
        with pytest.raises(ValueError, match="counter"):
            rng._lanes("counter", bad)


WRAPPER_PROBE = """
import sys, types, torch
from take_tpu_torch.core import rng
calls = []
class Lib:
    def __getattr__(self, name):
        return lambda *args: calls.append((name, args)) or 0
rng._lib = Lib
torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(cuda_stream=0)
hi, lo = rng._make_stream_kernel(3, torch.arange(4, dtype=torch.int32)[:, None], torch.arange(3))
u = rng._draw_kernel((hi, lo[:1]), torch.arange(3, dtype=torch.int32), torch.float32)
b = rng._draw_kernel((hi, lo), 5, torch.int64)
print([tuple(hi.shape), tuple(u.shape), u.dtype == torch.float32, b.dtype == torch.int64])
print([(name, args[2], args[4], args[5]) if name == "tt_rng_stream" else (name, args[2] is None, args[3], args[4])
       for name, args in calls])
print("sympy" in sys.modules)
"""


def test_kernel_wrappers_broadcast_and_launch():
    """The CUDA wrappers' plumbing, on CPU tensors with a stand-in library:
    broadcast shapes, the index widths, the per-lane or scalar counter and
    the lane count handed to the launchers; and no import of sympy, which
    torch.broadcast_shapes makes at its first call (seconds of a fresh
    process's set-up)."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", WRAPPER_PROBE], capture_output=True, text=True, check=True,
                         cwd=os.path.join(os.path.dirname(__file__), "..")).stdout.splitlines()
    assert out[0] == "[(4, 3), (4, 3), True, True]"
    assert out[1] == ("[('tt_rng_stream', 0, 1, 12), ('tt_rng_uniform', False, 0, 12), "
                      "('tt_rng_bits', True, 5, 12)]")
    assert out[2] == "False"


def test_cbox_pass_draws_two_plus_seven_a_bounce():
    """A cbox pass at d4 makes one stream and 2 + 7 x 5 draws: the camera's
    jitter, then 3 light and 4 BSDF uniforms on each of 5 trips."""
    from take_tpu_torch.render import _pass
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    from chip_smoke import with_res

    scene = with_res(parse_scene_file(CBOX, device="cpu"), 8)
    pix = torch.arange(64, dtype=torch.int32)
    _launch.reset_launches()
    with torch.inference_mode():
        _pass(scene, RenderOptions(spp=1, max_depth=4), pix, torch.zeros((), dtype=torch.int32), 8, 1)
    assert {k: v for k, v in rng.LAUNCHES.items() if v} == {"stream_plain": 1, "uniform_plain": 2 + 7 * 5}


def test_per_lane_counter_bit_identical(rng_np):
    """The per-lane counter form (the refill loop's `bounce_counter(nextv -
    1, dim)`, from bounce -1 on) against take_tpu's draws at the same
    counters."""
    n = 1 << 14
    pixel = rng_np.integers(0, 1 << 31, n, dtype=np.int64).astype(np.int32)
    sample = rng_np.integers(0, 1 << 16, n).astype(np.int32)
    bounce = rng_np.integers(-1, 51, n)
    js = jrng.make_stream(11, jnp.asarray(pixel), jnp.asarray(sample))
    ts = rng.make_stream(11, torch.from_numpy(pixel), torch.from_numpy(sample))
    for dim in range(rng.DIMS_PER_BOUNCE):
        c = rng.bounce_counter(torch.from_numpy(bounce), dim)
        want = ((bounce + 1) * rng.DIMS_PER_BOUNCE + dim).astype(np.uint32)
        np.testing.assert_array_equal(c.numpy(), want.astype(np.int64))
        np.testing.assert_array_equal(rng.uniform(ts, c).numpy(), np.asarray(jrng.uniform(js, jnp.asarray(want))))
        np.testing.assert_array_equal(rng.random_bits(ts, c).numpy(),
                                      np.asarray(jrng.random_bits(js, jnp.asarray(want))).astype(np.int64))
