"""take_tpu_torch's grad-safe numeric helpers against take_tpu's
(test_grad_safety.py's cases): each gives the JAX helper's primal and a
finite gradient (zero where it should be) at the degenerate point where the
naive form gives NaN or inf."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from take_tpu.core.math import normalize as j_normalize
from take_tpu.core.math import safe_norm as j_safe_norm
from take_tpu.materials.disney import _ggx_D as j_ggx_D
from take_tpu.materials.disney import _sqrt0 as j_sqrt0
from take_tpu_torch.core.math import normalize, safe_norm
from take_tpu_torch.materials.disney import _ggx_D, _sqrt0


def _grad(f, x):
    x = torch.as_tensor(x, dtype=torch.float32).clone().requires_grad_(True)
    f(x).sum().backward()
    return x.grad


def test_safe_norm_matches_and_zero_grad_at_origin():
    x = np.array([[3.0, 4.0, 0.0], [0.0, 0.0, 0.0], [1e-20, 0.0, 0.0]], np.float32)
    ours = safe_norm(torch.as_tensor(x))
    # the primal is the plain form's bit for bit; XLA on the CPU flushes the
    # third row's subnormal square (1e-40) to 0, torch keeps it
    assert torch.equal(ours, torch.sqrt(torch.sum(torch.as_tensor(x) ** 2, dim=-1)))
    assert np.array_equal(ours.numpy()[:2], np.asarray(j_safe_norm(jnp.asarray(x)))[:2])
    g = _grad(safe_norm, x)
    assert torch.isfinite(g).all() and not g[1].any()
    np.testing.assert_allclose(g[0].numpy(), [0.6, 0.8, 0.0], rtol=1e-6)
    j_g = np.asarray(jax.grad(lambda v: j_safe_norm(v).sum())(jnp.asarray(x)))
    np.testing.assert_array_equal(g.numpy()[:2], j_g[:2])
    # the naive form NaNs at the origin row
    assert torch.isnan(_grad(lambda v: torch.sqrt(torch.sum(v * v, dim=-1)), x)[1]).any()


def test_sqrt0_matches_and_zero_grad_at_zero():
    x = np.array([4.0, 1e-12, 0.0], np.float32)
    assert np.array_equal(_sqrt0(torch.as_tensor(x)).numpy(), np.asarray(j_sqrt0(jnp.asarray(x))))
    g = _grad(_sqrt0, x)
    assert torch.isfinite(g).all() and float(g[2]) == 0.0
    assert torch.isinf(_grad(torch.sqrt, x)[2])


def test_normalize_eps_grad_finite_at_zero_vector():
    x = np.array([[1.0, 2.0, 2.0], [0.0, 0.0, 0.0]], np.float32)
    out = normalize(torch.as_tensor(x), eps=1e-20)
    assert np.array_equal(out.numpy(), np.asarray(j_normalize(jnp.asarray(x), eps=1e-20)))
    np.testing.assert_array_equal(out[1].numpy(), [0.0, 0.0, 0.0])
    assert torch.isfinite(_grad(lambda v: normalize(v, eps=1e-20), x)).all()


def test_ggx_d_grad_finite_small_alpha_small_k():
    """Near-grazing half vector and tiny roughness, where the naive
    1 / (pi ax ay k^2) underflows: finite value and gradient at each alpha,
    the same primal as take_tpu's (rtol 1e-6), a backfacing row exactly 0."""
    hl = np.array([[1e-3, 0.0, 0.9999], [0.0, 0.0, 1.0], [0.5, 0.5, -0.1]], np.float32)
    th = torch.as_tensor(hl)
    for a0 in (1e-4, 1e-2, 0.5):
        a = torch.tensor(a0, requires_grad=True)
        d = _ggx_D(th, a, a)
        d.sum().backward()
        assert torch.isfinite(d).all() and torch.isfinite(a.grad), a0
        np.testing.assert_allclose(d.detach().numpy(), np.asarray(j_ggx_D(jnp.asarray(hl), a0, a0)), rtol=1e-6)
    assert float(_ggx_D(th, 0.1, 0.1)[2]) == 0.0
