"""take_tpu_torch/room_grad_fd.py, the port of benchmarks/room_grad_fd.py,
against take_tpu on the CPU.

Room (105,998 triangles, its BVH; K3's plain twin here, take_tpu's XLA
traversal there), parsed once per package for the file: the band and the
perturbations are the JAX script's, and each parameter's gradient on a
64-pixel mid-frame band, 1 sample, d3, under "replay" and "ad", is within
1e-4 relative of jax.grad of take_tpu's render_radiance; then the whole
record at a tiny size.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.grad import render_radiance as jrender_radiance
from take_tpu.scene import types as JT
from take_tpu.scene.parse_xml import parse_scene_file as jparse
from take_tpu_torch import room_grad_fd
from take_tpu_torch.geometry import _launch
from take_tpu_torch.scene.parse_xml import parse_scene_file
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOM = os.path.join(os.path.dirname(__file__), "..", "scenes", "room", "room.xml")
PIXELS, DEPTH = 64, 3


@pytest.fixture(scope="module")
def rooms():
    return jparse(ROOM), parse_scene_file(ROOM, device="cpu")


def _jax_perturbed(scene, mat_mask, lflag, d):
    """benchmarks/room_grad_fd.py:63-75."""
    attr = scene.materials.attr + d * mat_mask
    la = scene.lights.attr.at[:, JT.LATTR_INTENSITY : JT.LATTR_INTENSITY + 3].multiply(1.0 + d * lflag)
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, attr=attr),
                               lights=dataclasses.replace(scene.lights, attr=la))


def _jax_masks(scene, which):
    """benchmarks/room_grad_fd.py:83-92."""
    mask = np.zeros(scene.materials.attr.shape, np.float32)
    lflag = np.float32(0.0)
    if which.startswith("albedo"):
        mask[int(which[-1]), JT.MATTR_TEX_VALUE : JT.MATTR_TEX_VALUE + 3] = 1.0
    else:
        lflag = np.float32(1.0)
    return jnp.asarray(mask), jnp.asarray(lflag)


@functools.cache
def _jax_grad_fn(mode):
    def f(scene, mat_mask, lflag, d, pix):
        options = JT.RenderOptions(spp=1, max_depth=DEPTH, seed=room_grad_fd.SEED, grad_mode=mode)
        return jnp.mean(jrender_radiance(_jax_perturbed(scene, mat_mask, lflag, d), options, pix, jnp.int32(0), 1))

    return jax.jit(jax.grad(f, argnums=3))


def _jax_band(scene, pixels):
    """benchmarks/room_grad_fd.py:54-57."""
    W = scene.meta.camera.width
    y0 = (scene.meta.camera.height // 2 - pixels // W // 2) * W
    return jnp.arange(y0, y0 + pixels, dtype=jnp.int32)


def test_band_and_perturbations_are_the_jax_scripts(rooms):
    """The band's pixels and each perturbed table equal the JAX script's (d
    = 0.25), and the parameters are room's two albedos and its emission."""
    jscene, scene = rooms
    pix = room_grad_fd.band_pixels(scene, room_grad_fd.PIXELS, "cpu")
    np.testing.assert_array_equal(pix.numpy(), np.asarray(_jax_band(jscene, room_grad_fd.PIXELS)))
    assert room_grad_fd.params(scene) == ["albedo0", "albedo1", "emission"]
    for which in room_grad_fd.params(scene):
        s = room_grad_fd.perturbed(scene, which, torch.tensor(0.25))
        js = _jax_perturbed(jscene, *_jax_masks(jscene, which), jnp.float32(0.25))
        np.testing.assert_array_equal(s.materials.attr.numpy(), np.asarray(js.materials.attr))
        np.testing.assert_array_equal(s.lights.attr.numpy(), np.asarray(js.lights.attr))


@pytest.mark.parametrize("which", ["albedo0", "albedo1", "emission"])
def test_gradient_matches_take_tpu(rooms, which):
    """d mean(render_radiance) / d d at 0 on a 64-pixel mid-frame band, 1
    sample, d3: the port's replay and AD gradients within 1e-4 relative of
    jax.grad of take_tpu's render_radiance under the same mode, through K3's
    twin alone."""
    jscene, scene = rooms
    pix = room_grad_fd.band_pixels(scene, PIXELS, "cpu")
    jpix = _jax_band(jscene, PIXELS)
    for mode in ("replay", "ad"):
        _launch.reset_launches()
        got, _, _ = room_grad_fd.gradient(scene, which, mode, pix, samples=1, depth=DEPTH)
        assert {k for k, v in _launch.LAUNCHES.items() if v} == {"packet_closest_plain", "packet_anyhit_plain"}
        want = float(_jax_grad_fn(mode)(jscene, *_jax_masks(jscene, which), jnp.float32(0.0), jpix))
        assert abs(want) > 1e-4, (which, mode, want)
        assert abs(got - want) <= 1e-4 * abs(want), (which, mode, got, want)


def test_record_at_a_tiny_size(rooms, monkeypatch, capsys):
    """main(["--device", "cpu", ...]) on 16 pixels, 1 sample, d2: every
    parameter's gradients, FD and ratios, the gates met (K3's twins alone),
    no take_tpu value held at this size, exit code 0."""
    monkeypatch.setattr(room_grad_fd, "parse_scene_file", lambda *a, **k: rooms[1])
    rc = room_grad_fd.main(["--device", "cpu", "--pixels", "16", "--samples", "1", "--depth", "2"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["gradient_allclose"] and rec["band_paths"] == 16 and rec["device"] == "cpu"
    for which in ("albedo0", "albedo1", "emission"):
        r = rec[which]
        assert r["ad_vs_fd_rel"] < room_grad_fd.AD_FD_MAX and r["replay_vs_ad_rel"] < room_grad_fd.REPLAY_AD_MAX
        assert "vs_take_tpu_rel" not in r and r["t_ad_s"] > 0
    assert set(rec["launches"]) == {"packet_closest_plain", "packet_anyhit_plain"}
