"""The yardstick's counts, the trace reduction and the readers that use them."""

import types

import pytest
import torch

from portbench import run, spec, traceread, yardstick


def test_ray_count():
    assert yardstick.rays_per_path(4) == 11
    assert yardstick.rays_per_image(1024, 1024, 16, 4) == 1024 * 1024 * 16 * 11


def test_query_bytes_by_hand():
    # 2 calls of 1000 rays each over 32 triangles, 144-byte answers
    assert yardstick.query_bytes(2000, 2, 144, 32) == 2000 * (32 + 144) + 2 * 32 * 96
    assert yardstick.least_seconds(3.35e12) == 1.0


class Ev:
    def __init__(self, name, a, b, cuda, annotation=False):
        self.name, self.is_user_annotation = name, annotation
        self.time_range = types.SimpleNamespace(start=a, end=b)
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU


def test_reduce():
    events = [Ev(traceread.SPAN, 0, 100, False), Ev(traceread.SPAN, 0, 100, True, True),
              Ev("cudaGraphLaunch", 0, 10, False), Ev("cudaDeviceSynchronize", 10, 100, False),
              Ev("k1", 5, 30, True), Ev("k2", 20, 40, True), Ev("k1", 60, 70, True)]
    t = traceread.reduce(events)
    assert t["window_s"] == pytest.approx(100e-6) and t["busy_s"] == pytest.approx(45e-6)
    assert t["by_name"] == pytest.approx({"k1": 35e-6, "k2": 20e-6})
    assert t["gaps"] == pytest.approx({"cudaGraphLaunch": 5e-6, "cudaDeviceSynchronize": 50e-6})
    b = traceread.breakdown(t)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2


def test_roofline_and_shares():
    k1 = spec.kernels()["k1"]
    ctx = types.SimpleNamespace(
        trace={"by_name": {"void closest_kernel(float4 const*)": 2e-3, "other": 6e-3}, "device_s": 8e-3,
               "busy_s": 6e-3, "window_s": 1e-2},
        segment={"paths": 4 << 20, "passes": 4, "launches": {k1["launch_key"]: 24}}, n_tri=32,
        window={"peak_bytes": 2**31, "passes_eager": 1, "graphs_new": 2, "loss_grad_s": [], "unit_s": [1.0]},
        counts={"nominal": 10, "live": 4})
    rays = 24 * (1 << 20)
    want = 100 * yardstick.least_seconds(yardstick.query_bytes(rays, 24, 144, 32)) / 2e-3
    assert run.read_metric("k1_roofline", ctx) == pytest.approx(want)
    assert run.read_metric("k2_roofline", ctx) is None  # nothing of it in the trace
    assert run.read_metric("intersect_share.render", ctx) == pytest.approx(25.0)
    assert run.read_metric("idle_share.render", ctx) == pytest.approx(40.0)
    assert run.read_metric("active_fraction.render", ctx) == pytest.approx(40.0)
    assert run.read_metric("graph_miss.render", ctx) == 3
    assert run.read_metric("peak_gib.render", ctx) == pytest.approx(2.0)
    assert run.read_metric("loss_grad_share.grad", ctx) is None
