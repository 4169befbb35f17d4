"""rng_share.* on traces made by hand: the RNG's kernels over all device time."""

import types

import pytest

from portbench import run


def ctx(by_name):
    return types.SimpleNamespace(trace={"by_name": by_name, "device_s": sum(by_name.values())})


@pytest.mark.parametrize("metric", ["rng_share.render", "rng_share.grad"])
def test_rng_share(metric):
    others = {"void closest_kernel(float4 const*)": 2e-3, "take_mark_forward_light": 1e-3,
              "void at::native::vectorized_elementwise_kernel<2, ...>": 5e-3}
    assert run.read_metric(metric, ctx(others)) is None  # a program that draws with torch ops
    t = ctx({**others, "take_rng_uniform": 1.5e-3, "take_rng_stream": 0.5e-3})
    assert run.read_metric(metric, t) == pytest.approx(20.0)
    assert run.read_metric(metric, ctx({"take_rng_bits": 1e-3, "xtake_rng_uniform": 1e-3})) == pytest.approx(50.0)
