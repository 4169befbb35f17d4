"""The program's spans and phase marks as the new per-layer metrics read
them: the reduction of a trace made by hand, each reader on a segment made
by hand, a program without tracing, and a tiny segment on the CPU."""

import types

import pytest
import torch

from portbench import phases, run, traceread
from portbench.tests.conftest import tiny_cell

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
SEED = 2**32 + 777


def ev(name, a, b, device=CPU):
    """A FunctionEvent's fields; a program span is a record_function range (a user annotation)."""
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b), device_type=device,
                                 is_user_annotation=name.startswith("take."))


def rows(events):
    """phases.kineto_rows()'s form of FunctionEvents."""
    return [(e.name, e.time_range.start, e.time_range.end, e.device_type == CUDA, e.is_user_annotation)
            for e in events]


def events(span):
    """One traced stretch of 100 us: a pass (camera, hit, end marks) with
    work before, between and after them, and host spans around the gaps."""
    return [
        ev(span, 0, 100),
        ev("take.render.image", 0, 100), ev("take.graph.key", 1, 12), ev("cudaGraphLaunch", 12, 14),
        ev("take.render.to_host", 80, 100), ev("cudaMemcpyAsync", 85, 95),
        ev("memset", 15, 16, CUDA),  # before any mark: unmarked
        ev("take_mark_forward_camera", 16, 17, CUDA), ev("gen", 17, 20, CUDA),
        ev("take_mark_forward_hit", 20, 21, CUDA), ev("gather", 21, 40, CUDA), ev("cat", 30, 45, CUDA),
        ev("take_mark_backward_vjp", 50, 51, CUDA), ev("add", 51, 60, CUDA),
        ev("take_mark_forward_end", 60, 61, CUDA), ev("clone", 61, 70, CUDA),
    ]


def test_reduce_keeps_traceread_and_adds_phases_and_gaps():
    old = traceread.reduce(events(traceread.SPAN))
    assert old["by_name"]["gather"] == pytest.approx(19e-6) and old["n_device_ops"] == 10
    assert old["busy_s"] == pytest.approx(50e-6) and old["window_s"] == pytest.approx(100e-6)
    got = phases.reduce(rows(events(phases.SPAN)))
    assert got["window_s"] == old["window_s"] and got["busy_s"] == old["busy_s"]
    assert got["device_s"] == pytest.approx(old["device_s"]) and got["marks"] == 4
    assert got["phases"] == pytest.approx({"unmarked": 11e-6, "forward.camera": 4e-6, "forward.hit": 35e-6,
                                           "backward.vjp": 10e-6})
    # gaps [0,15) mid 7.5 in take.graph.key; [45,50) and [70,100) in take.render.image, to_host
    assert got["program_gaps"] == pytest.approx({"take.graph.key": 15e-6, "take.render.image": 5e-6,
                                                 "take.render.to_host": 30e-6})
    assert got["gap_counts"] == {"take.graph.key": 1, "take.render.image": 1, "take.render.to_host": 1}
    assert got["ops"] == old["n_device_ops"]


def test_reduce_without_a_program_span():
    got = phases.reduce(rows([ev(phases.SPAN, 0, 10), ev("k", 2, 4, CUDA), ev("aten::add", 0, 10)]))
    assert got["program_gaps"] == pytest.approx({phases.NO_SPAN: 8e-6}) and got["phases"] == {"unmarked": 2e-6}


SEG = {"window_s": 2.0, "busy_s": 1.8, "device_s": 1.0, "marks": 40, "units": 3,
       "phases": {"forward.hit": 0.2, "forward.shade": 0.05, "forward.bsdf": 0.1, "forward.light": 0.15,
                  "backward.vjp": 0.3, "backward.hit": 0.1, "unmarked": 0.1},
       "program_gaps": {"take.graph.key": 0.1, "take.render.to_host": 0.06, phases.NO_SPAN: 0.04},
       "spans": {"take.graph.capture": {"total_s": 0.5}, "take.graph.instantiate": {"total_s": 0.25},
                 "take.scene.load": {"total_s": 3.0}}}

EXPECTED = {"hit_share.render": 20.0, "shade_share.render": 15.0, "light_share.render": 15.0,
            "backward_share.grad": 100 * 0.4 / 0.9, "program_idle.render": 8.0, "program_idle.grad": 8.0,
            "capture_s.render": 0.75, "capture_s.grad": 0.75}


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_each_reader_reads_its_value(metric, monkeypatch):
    monkeypatch.setitem(phases._SEGMENTS, "x", SEG)
    ctx = types.SimpleNamespace(cell={"name": "x"})
    assert run.read_metric(metric, ctx) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_readers_give_none_without_program_tracing(metric, monkeypatch):
    monkeypatch.setattr(phases, "program_tracing", lambda: None)
    monkeypatch.setattr(phases, "_SEGMENTS", {})
    assert run.read_metric(metric, types.SimpleNamespace(cell={"name": "cbox.render"})) is None


def test_tiny_segment_on_the_cpu(monkeypatch):
    """A tiny cbox render: the set-up's spans and the units' program gaps
    are read, the program's tracing is off again afterwards, and nothing
    runs on a device (so no mark is seen)."""
    from take_tpu_torch import tracing

    seg = phases.measure(tiny_cell("cbox.render"), SEED, "cpu")
    assert not tracing.enabled() and tracing.totals() == {}
    assert {"take.scene.load", "take.render.image", "take.render.pass", "take.render.to_host"} <= set(seg["spans"])
    assert seg["units"] >= 1 and seg["marks"] == 0 and seg["device_s"] == 0
    assert set(seg["program_gaps"]) <= {phases.NO_SPAN} | {k for k in seg["spans"] if k.startswith("take.")}
    monkeypatch.setattr(phases, "_SEGMENTS", {"cbox.render": seg})
    ctx = types.SimpleNamespace(cell={"name": "cbox.render"})
    assert run.read_metric("capture_s.render", ctx) == 0.0  # no graph on the CPU
    assert run.read_metric("hit_share.render", ctx) is None  # no device time
