"""take_tpu_torch/inverse_demo.py, the port of benchmarks/inverse_demo.py,
against take_tpu and optax on the CPU.

The port's cornell_box builds tests/scenes.py's tables exactly, and 3 Adam
steps of the demo at 16x16, 4 spp (a 16-spp target) move the raw parameters
where benchmarks/inverse_demo.py's loop (take_tpu's render_radiance, optax's
adam) moves them, within 1e-4; then the whole record at a tiny size.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import tests.scenes as jscenes
from take_tpu.grad import render_radiance as jrender_radiance
from take_tpu.scene import edit as jedit
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch import inverse_demo
from tests.torch_parity import one_torch_thread, tables  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_cornell_box_tables_equal_take_tpus():
    """cornell_box(64, 64) on the port's SceneBuilder: tests/scenes.py's
    tables and camera exactly, and the same material ids."""
    got = inverse_demo.cornell_box(64, 64).build(device="cpu")
    want = jscenes.cornell_box(64, 64).build()
    a, b = tables(got), tables(want)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert vars(got.meta.camera) == vars(want.meta.camera)
    assert (inverse_demo.CBOX_MAT_RED, inverse_demo.CBOX_MAT_WHITE) == (jscenes.CBOX_MAT_RED, jscenes.CBOX_MAT_WHITE)


def _jax_demo(res, spp, target_spp, steps):
    """benchmarks/inverse_demo.py:56-142 at a small size: the raw parameters
    after `steps` steps and each step's loss."""
    base = jscenes.cornell_box(res, res).build()
    pix = jnp.arange(res * res, dtype=jnp.int32)

    def logit(x):
        x = np.clip(np.asarray(x, np.float64), 1e-4, 1 - 1e-4)
        return jnp.asarray(np.log(x / (1 - x)), jnp.float32)

    true = {"wall_rgb": logit(inverse_demo.TRUE["wall_rgb"]), "floor_rgb": logit(inverse_demo.TRUE["floor_rgb"]),
            "log_light": jnp.float32(np.log(inverse_demo.TRUE["log_light"]))}
    params = {"wall_rgb": logit(inverse_demo.INIT["wall_rgb"]), "floor_rgb": logit(inverse_demo.INIT["floor_rgb"]),
              "log_light": jnp.float32(np.log(inverse_demo.INIT["log_light"]))}

    def render(params, sample0, spp, seed):
        s = jedit.with_material_reflectance(base, jscenes.CBOX_MAT_RED, jax.nn.sigmoid(params["wall_rgb"]))
        s = jedit.with_material_reflectance(s, jscenes.CBOX_MAT_WHITE, jax.nn.sigmoid(params["floor_rgb"]))
        s = jedit.with_light_intensity_scale(s, jnp.exp(params["log_light"]))
        return jrender_radiance(s, JOptions(spp=1, max_depth=4, seed=seed), pix, sample0, spp)

    target = jax.jit(render, static_argnames=("spp", "seed"))(true, jnp.int32(0), target_spp, 3)
    opt = optax.adam(2e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state, sample0):
        loss, g = jax.value_and_grad(lambda p: jnp.mean((render(p, sample0, spp, 11) - target) ** 2))(params)
        updates, state = opt.update(g, state)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for i in range(steps):
        params, state, loss = step(params, state, jnp.int32(i * spp))
        losses.append(float(loss))
    return params, losses


def test_three_adam_steps_match_optax():
    """3 steps at 16x16, 4 spp a step, a 16-spp target: every raw parameter
    within 1e-4 of the JAX loop's, each step's loss within 1e-4 relative."""
    _, params, losses = inverse_demo.run(steps=3, spp=4, res=16, target_spp=16, device="cpu", log_every=0)
    jparams, jlosses = _jax_demo(16, 4, 16, 3)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for k in jparams:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), atol=1e-4, rtol=0, err_msg=k)
        init = inverse_demo.raw(inverse_demo.INIT, "cpu")[k].numpy()
        assert np.all(np.abs(params[k].numpy() - init) > 1e-3), k  # every parameter moved


def test_record_at_a_tiny_size(capsys):
    """main(["--device", "cpu", ...]) for 2 steps at 8x8: the JAX script's
    keys and the port's, finite gradients through K1/K2's twins, not
    converged, so exit code 1."""
    rc = inverse_demo.main(["--device", "cpu", "--steps", "2", "--spp", "2", "--res", "8", "--target-spp", "4"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"steps", "spp_per_step", "seconds", "loss_first", "loss_last", "loss_curve_every10", "true", "recovered",
            "max_rel_err", "converged_5pct"} <= set(rec)
    assert rec["steps"] == 2 and rec["grads_finite"] and rec["device"] == "cpu" and rec["power_limit"] is None
    assert set(rec["launches_per_step"]) == {"closest_plain", "anyhit_plain"}
    assert rc == 1 and not rec["converged_5pct"]
