"""take_tpu_torch/utils and entry.py on the CPU, mirroring
test_checkpoint_metrics.py: resume bit for bit, the seed check,
scene_summary against take_tpu's, checkpoints that cross between
the two packages, profiler_trace, and dryrun_multichip on two CPU devices."""

import os

import numpy as np
import pytest

from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu.utils import checkpoint as jckpt
from take_tpu.utils.metrics import scene_summary as j_summary
from take_tpu_torch import entry
from take_tpu_torch.render import render_image
from take_tpu_torch.scene.types import RenderOptions
from take_tpu_torch.utils import checkpoint as ckpt
from take_tpu_torch.utils.metrics import profiler_trace, scene_summary
from tests.scenes import cornell_box
from tests.test_torch_render import _compare
from tests.torch_parity import one_torch_thread, port_scene  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# test_checkpoint_metrics.py's render: 4 passes of 2 samples
OPTS = dict(spp=8, max_depth=2, seed=13, max_rays_per_pass=16 * 16 * 2)


class Stop(Exception):
    pass


def stop_after(n_passes):
    """A progress callback that interrupts the render after `n_passes`."""
    def progress(s, spp):
        if s >= 2 * n_passes:
            raise Stop
    return progress


@pytest.fixture(scope="module")
def jscene():
    return cornell_box(width=16, height=16).build()


@pytest.fixture(scope="module")
def straight(jscene):
    scene = port_scene(jscene)
    return scene, render_image(scene, RenderOptions(**OPTS))


def test_resume_is_bit_exact(straight, tmp_path):
    """Uninterrupted, and stopped after the first checkpoint (2 passes of
    checkpoint_every=2) then resumed: render_image's image bit for bit; the
    last checkpoint is marked complete."""
    scene, img = straight
    path = str(tmp_path / "render.ckpt")
    np.testing.assert_array_equal(ckpt.render_image_resumable(scene, RenderOptions(**OPTS), path, 1), img)
    assert ckpt.load_accumulator(path)[1:] == (8, 13, {"complete": True})

    path = str(tmp_path / "stopped.ckpt")
    with pytest.raises(Stop):
        ckpt.render_image_resumable(scene, RenderOptions(**OPTS), path, 2, progress=stop_after(3))
    assert ckpt.load_accumulator(path)[1:] == (4, 13, {})
    np.testing.assert_array_equal(ckpt.render_image_resumable(scene, RenderOptions(**OPTS), path, 2), img)


def test_checkpoint_rejects_mismatched_seed(straight, tmp_path):
    scene, _ = straight
    path = str(tmp_path / "c.ckpt")
    ckpt.save_accumulator(path, np.zeros((256, 3)), 2, seed=999)
    with pytest.raises(ValueError, match="seed"):
        ckpt.render_image_resumable(scene, RenderOptions(spp=4, max_depth=1, seed=1), path)
    ckpt.save_accumulator(path, np.zeros((64, 3)), 2, seed=1)
    with pytest.raises(ValueError, match="pixels 64"):
        ckpt.render_image_resumable(scene, RenderOptions(spp=4, max_depth=1, seed=1), path)


def test_checkpoints_cross_between_packages(jscene, straight, tmp_path):
    """The port's half-done checkpoint is read by take_tpu (the same arrays)
    and written back by take_tpu's save_accumulator, from which the port
    resumes bit for bit; take_tpu resumes the port's checkpoint, and the
    port take_tpu's, each within test_torch_render.py's image tolerance of
    the port's straight render."""
    scene, img = straight
    ours = str(tmp_path / "port.ckpt")
    with pytest.raises(Stop):
        ckpt.render_image_resumable(scene, RenderOptions(**OPTS), ours, 2, progress=stop_after(3))
    acc, spp_done, seed, meta = jckpt.load_accumulator(ours)
    np.testing.assert_array_equal(acc, ckpt.load_accumulator(ours)[0])
    assert (spp_done, seed, meta) == (4, 13, {})

    theirs = str(tmp_path / "rewritten.ckpt")
    jckpt.save_accumulator(theirs, acc, spp_done, seed)
    np.testing.assert_array_equal(ckpt.render_image_resumable(scene, RenderOptions(**OPTS), theirs), img)

    assert _compare(np.asarray(jckpt.render_image_resumable(jscene, JOptions(**OPTS), ours)), img) < 1e-4

    jax_half = str(tmp_path / "jax.ckpt")
    with pytest.raises(Stop):
        jckpt.render_image_resumable(jscene, JOptions(**OPTS), jax_half, 2, progress=stop_after(3))
    assert ckpt.load_accumulator(jax_half)[1] == 4
    assert _compare(ckpt.render_image_resumable(scene, RenderOptions(**OPTS), jax_half), img) < 1e-4


def test_scene_summary_matches_jax():
    js = cornell_box(width=8, height=8).build()
    info = scene_summary(port_scene(js))
    assert info == j_summary(js)
    assert info["triangles"] == 32 and info["lights"] == 2
    assert info["camera"]["resolution"] == [8, 8]


def test_profiler_trace_writes_a_trace(straight, tmp_path):
    scene, _ = straight
    with profiler_trace(str(tmp_path), device="cpu") as prof:
        render_image(scene, RenderOptions(spp=1, max_depth=1))
    assert prof is not None
    (trace,) = os.listdir(tmp_path)
    assert trace.endswith(".json") and os.path.getsize(tmp_path / trace) > 0
    with profiler_trace(None) as prof:
        assert prof is None


def test_dryrun_multichip_on_two_cpu_devices():
    losses = entry.dryrun_multichip(2, device="cpu")
    assert abs(losses["banded_loss"] - losses["loss"]) < 1e-4 * (1 + abs(losses["loss"]))
    fn, args = entry.entry(device="cpu")
    assert tuple(fn(*args).shape) == (1024, 3)
