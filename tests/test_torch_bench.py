"""take_tpu_torch/bench.py, the port of bench.py, against take_tpu on the CPU.

Each measurement of the record at a small size: the soup of the kernel
check (benchmarks/tpu_smoke.py's) built to take_tpu's tables, the check
itself through the plain twins, the active fraction of the scan loop and
the refill loop's counts at max_depth 50, and the banded replay gradient,
each against take_tpu's own computation as bench.py makes it; then the
whole record at a tiny size.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest

from benchmarks.tpu_smoke import soup_scene as jax_soup_scene
from take_tpu import config as jconfig
from take_tpu.core import rng as jrng
from take_tpu.core.camera import Camera as JCamera
from take_tpu.core.camera import generate_rays as jgenerate_rays
from take_tpu.grad import render_loss_grad as jrender_loss_grad
from take_tpu.integrator.path_tracer import trace_query_counts as jtrace_query_counts
from take_tpu.integrator.wavefront import trace_wavefront as jtrace_wavefront
from take_tpu.scene.parse_xml import parse_scene_file as jparse
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch import bench
from take_tpu_torch.geometry import _launch
from take_tpu_torch.scene.parse_xml import parse_scene_file
from take_tpu_torch.scene.types import RenderOptions
from tests.torch_parity import CBOX, one_torch_thread, tables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_cbox(width, height):
    s = jparse(CBOX)
    cam = s.meta.camera
    camera = JCamera(width, height, cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(s, meta=dataclasses.replace(s.meta, camera=camera))


def _port_cbox(width, height):
    return bench.with_camera(parse_scene_file(CBOX, device="cpu"), width, height)


def test_soup_tables_equal_take_tpus():
    """The port's soup_scene(3000) (tpu_smoke.py:25-38 on the port's
    SceneBuilder, BVH included) has take_tpu's tables exactly."""
    want, got = tables(jax_soup_scene(3000)), tables(bench.soup_scene(3000, device="cpu"))
    assert got.keys() == want.keys() and "bvh.cl_aabb" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_active_fraction_matches_take_tpu():
    """cbox at 32x32, 2 spp, d4: the scan loop's nominal and active query
    counts (bench.py:70-89) within 0.1% of take_tpu's."""
    res, opts = 32, dict(spp=2, max_depth=4, seed=0)
    nom, act = bench.query_counts(_port_cbox(res, res), RenderOptions(**opts), 2)
    scene = _jax_cbox(res, res)
    pix = jnp.arange(res * res, dtype=jnp.int32)
    jnom = jact = 0
    for s in range(2):
        streams = jrng.make_stream(0, pix, jnp.full_like(pix, s))
        jx = jrng.uniform(streams, jrng.camera_counter(jrng.DIM_CAMERA_JITTER_X))
        jy = jrng.uniform(streams, jrng.camera_counter(jrng.DIM_CAMERA_JITTER_Y))
        ro, rd = jgenerate_rays(scene.meta.camera, (pix % res).astype(jnp.float32),
                                (pix // res).astype(jnp.float32), jx, jy)
        n_, a_, _ = jax.jit(jtrace_query_counts, static_argnames=("options",))(scene, JOptions(**opts), ro, rd,
                                                                               streams)
        jnom, jact = jnom + int(n_), jact + int(a_)
    assert nom == jnom
    assert abs(act / jact - 1) < 1e-3 and 0 < act < nom


def test_d50_refill_counts_match_take_tpu(monkeypatch):
    """cbox at 16x16, 1 spp, max_depth 50, a wave of 2^6 lanes in both
    packages: the refill loop's nominal and active counts (bench.py:99-113)
    within 0.1% of take_tpu's; WAVE_SIZE is restored after."""
    saved = bench.wavefront.WAVE_SIZE
    nom, act, _ = bench.wavefront_counts(_port_cbox(16, 16), 50, 1 << 6)
    assert bench.wavefront.WAVE_SIZE == saved
    monkeypatch.setattr(jconfig, "WAVE_SIZE", 1 << 6)
    pix = jnp.arange(256, dtype=jnp.int32)
    _, jnom, jact = jtrace_wavefront(_jax_cbox(16, 16), JOptions(spp=1, max_depth=50, seed=0), pix,
                                     jnp.zeros(256, jnp.int32), 16, with_counts=True)
    assert abs(nom / float(jnom) - 1) < 1e-3 and abs(act / float(jact) - 1) < 1e-3
    assert nom > 2 * 64 * 10  # the loop refilled its lanes many times


def test_banded_replay_gradient_matches_take_tpu():
    """cbox at 48x27, 1 spp, d4, replay, bands of 2^8 pixels (the last one
    shorter) against a zero target: each band's loss within 1e-5 relative
    and the sum over bands of the gradient's sum of squares within 1e-4
    relative of take_tpu's render_loss_grad on the same bands."""
    W, H, band = 48, 27, 1 << 8
    got = bench.banded_grad(_port_cbox(W, H), W, H, band)
    scene = _jax_cbox(W, H)
    opts = JOptions(spp=1, max_depth=4, seed=0, grad_mode="replay")
    losses, sumsq = [], 0.0
    for lo in range(0, W * H, band):
        pix = jnp.arange(lo, min(lo + band, W * H), dtype=jnp.int32)
        loss, g = jrender_loss_grad(scene, opts, pix, jnp.zeros((pix.shape[0], 3)), 1)
        losses.append(float(loss))
        sumsq += sum(float(jnp.sum(x * x)) for x in jtu.tree_leaves(g)
                     if hasattr(x, "dtype") and x.dtype == jnp.float32)
    assert got["bands"] == len(losses) == 6 and got["finite"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert abs(got["sumsq"] / sumsq - 1) < 1e-4


def test_record_at_a_tiny_size(capsys):
    """main(["--device", "cpu", ...]) prints one JSON line with bench.py's
    keys (less swept_fraction and weak_scaling_*), vs_baseline null, the
    device named, and the kernel check ok through the plain twins (each of
    the six routes' twins run; no kernel launched); exit code 0."""
    _launch.reset_launches()
    rc = bench.main(["--device", "cpu", "--res", "8", "--spp", "1", "--grad-size", "16x9", "--band", "64",
                     "--wave", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rc == 0 and len(lines) == 1
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "active_fraction", "active_mrays",
                        "grad_1080p_seconds", "grad_1080p_mrays", "grad_norm_finite",
                        "active_fraction_d50_wavefront", "kernels_onchip_ok", "device", "power_limit", "torch"}
    assert rec["metric"] == "cbox_1024_fwd_throughput" and rec["vs_baseline"] is None
    assert rec["kernels_onchip_ok"] and rec["grad_norm_finite"] and rec["device"] == "cpu"
    assert 0 < rec["active_fraction"] < 1 and 0 < rec["active_fraction_d50_wavefront"] < 1
    ran = {k for k, v in _launch.LAUNCHES.items() if v}
    assert ran == {f"{p}{q}_plain" for p in ("", "packet_", "cluster_", "sweep_") for q in ("closest", "anyhit")}
