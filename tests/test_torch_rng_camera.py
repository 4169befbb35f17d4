"""take_tpu_torch RNG and camera rays against take_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.core import rng as jrng
from take_tpu.core.camera import Camera as JCamera
from take_tpu.core.camera import generate_rays as j_generate_rays
from take_tpu_torch.core import rng as trng
from take_tpu_torch.core.camera import Camera as TCamera
from take_tpu_torch.core.camera import generate_rays as t_generate_rays

N_TRIPLES = 1 << 16


def _triples(rng_np):
    pixel = rng_np.integers(0, 1 << 31, N_TRIPLES, dtype=np.int64).astype(np.int32)
    sample = rng_np.integers(0, 1 << 16, N_TRIPLES).astype(np.int32)
    counter = rng_np.integers(0, 1 << 32, N_TRIPLES, dtype=np.uint64).astype(np.uint32)
    return pixel, sample, counter


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_random_bits_bit_identical(rng_np, seed):
    pixel, sample, counter = _triples(rng_np)
    js = jrng.make_stream(seed, jnp.asarray(pixel), jnp.asarray(sample))
    ts = trng.make_stream(seed, torch.from_numpy(pixel), torch.from_numpy(sample))
    for j, t in zip(js, ts):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))
    jb = np.asarray(jrng.random_bits(js, jnp.asarray(counter)))
    tb = trng.random_bits(ts, torch.from_numpy(counter.astype(np.int64)))
    np.testing.assert_array_equal(tb.numpy(), jb.astype(np.int64))


def test_uniform_and_counters_bit_identical(rng_np):
    pixel, sample, _ = _triples(rng_np)
    js = jrng.make_stream(3, jnp.asarray(pixel), jnp.asarray(sample))
    ts = trng.make_stream(3, torch.from_numpy(pixel), torch.from_numpy(sample))
    for bounce in range(6):
        for dim in range(trng.DIMS_PER_BOUNCE):
            c = trng.bounce_counter(bounce, dim)
            assert c == int(jrng.bounce_counter(bounce, dim))
            tu = trng.uniform(ts, c).numpy()
            ju = np.asarray(jrng.uniform(js, jrng.bounce_counter(bounce, dim)))
            assert tu.dtype == ju.dtype
            np.testing.assert_array_equal(tu, ju)
    cam = trng.uniform(ts, trng.camera_counter(trng.DIM_CAMERA_JITTER_Y)).numpy()
    np.testing.assert_array_equal(
        cam, np.asarray(jrng.uniform(js, jrng.camera_counter(jrng.DIM_CAMERA_JITTER_Y))))


@pytest.mark.parametrize(
    "cam",
    [
        (64, 48, (278.0, 273.0, -800.0), (278.0, 273.0, 0.0), (0.0, 1.0, 0.0), 39.3077),
        (32, 32, (0.5, 0.5, 1.4), (0.5, 0.5, 0.0), (0.0, 1.0, 0.0), 33.0),
        (40, 20, (1.0, 2.0, 3.0), (-1.0, 0.5, 0.0), (0.0, 0.0, 1.0), 70.0),
    ],
)
def test_camera_rays_agree(rng_np, cam):
    w, h = cam[0], cam[1]
    pix = rng_np.integers(0, w * h, 4096)
    px = (pix % w).astype(np.float32)
    py = (pix // w).astype(np.float32)
    jx, jy = rng_np.random((2, 4096)).astype(np.float32)
    jo, jd = j_generate_rays(JCamera(*cam), *map(jnp.asarray, (px, py, jx, jy)))
    to, td = t_generate_rays(TCamera(*cam), *map(torch.from_numpy, (px, py, jx, jy)))
    # measured: origins bit-equal; directions ~99% bit-equal, the rest
    # within 2.1e-7 relative (one ulp, from XLA's and torch's sum orders)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=0)
