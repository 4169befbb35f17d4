"""The port's kernel runtime (take_tpu_torch/geometry/_launch.py), on the CPU.

Each CUDA source is declared once, by its wrapper, and the graph cache
(take_tpu_torch/_graph.py) keeps every declared counter through captures
and replays. Here: the bookkeeping of every registered counter, and of a
stand-in source declared in this file alone, through `_graph.uncounted`,
`_graph.add_launches` and `_graph.run` on test_torch_pass_graph.py's
fake_cuda; `_launch.warm()` loading no library without a card, for every
declared source; and a launch key or a source declared twice, refused.
"""

import ctypes
from unittest import mock

import pytest
import torch

from take_tpu_torch import _graph, tracing
from take_tpu_torch.core import rng
from take_tpu_torch.geometry import _build, _launch
from take_tpu_torch.materials import bsdf, disney
from tests.test_torch_pass_graph import fake_cuda  # noqa: F401 (a fixture)

# a source that only this file declares: its launch keys are counted across
# captures and replays with no edit to _graph.py, _build.py or chip_smoke.py
STANDIN = {"standin_scan": 0, "standin_fold": 0, "standin_scan_plain": 0}
_launch.declare("standin", {"tt_standin_scan": [ctypes.c_void_p, ctypes.c_int64]}, launches=STANDIN)

COUNTERS = {  # counter, and three of its keys
    "scene queries": (_launch.LAUNCHES, ("closest", "anyhit", "packet_closest")),
    "rng": (rng.LAUNCHES, ("uniform", "stream", "bits")),
    "disney": (disney.LAUNCHES, ("eval", "sample", "pdf")),
    "bsdf": (bsdf.LAUNCHES, ("bsdf_eval", "bsdf_sample", "bsdf_pdf")),
    "stand-in": (STANDIN, ("standin_scan", "standin_fold", "standin_scan_plain")),
}


@pytest.mark.parametrize("which", COUNTERS)
def test_launch_bookkeeping(which, fake_cuda):  # noqa: F811 (the fixture)
    """What a capture counts is taken back out of the counter (also when the
    capture raises), each replay adds it back, and the other counters keep
    their counts."""
    counter, (a, b, c) = COUNTERS[which]
    assert all(_launch.COUNTED[k] is counter for k in counter)
    _launch.reset_launches()
    others = {k: i + 1 for i, (k, held) in enumerate(_launch.COUNTED.items()) if held is not counter}
    for k, n in others.items():
        _launch.COUNTED[k][k] = n
    counter[a] = 5

    def capture():
        counter[a] += 3
        counter[b] += 2
        return "graph"

    assert _graph.uncounted(capture) == ("graph", {a: 3, b: 2})
    assert counter[a] == 5 and counter[b] == 0

    def failing():
        counter[c] += 1
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        _graph.uncounted(failing)
    assert counter[c] == 0
    for _ in range(4):
        _graph.add_launches({a: 3, b: 2})
    assert {k: v for k, v in counter.items() if v} == {a: 17, b: 8}

    def body(x):  # a pass that launches `a` twice
        counter[a] += 2
        return x + 1

    for _ in range(3):  # the warm-up and a replay, then two replays
        out = _graph.run(("bookkeeping", which), None, body, [torch.zeros(4)])
    assert torch.equal(out, torch.ones(4)) and [g.replays for g in fake_cuda] == [3]
    assert {k: v for k, v in counter.items() if v} == {a: 17 + 4 * 2, b: 8}
    assert {k: _launch.COUNTED[k][k] for k in others} == others


@pytest.mark.parametrize("name", list(_launch.SOURCES))
def test_warm_loads_no_library_without_a_card(name):
    source = _launch.SOURCES[name]
    before = source.lib.cache_info()
    with mock.patch.object(torch.cuda, "is_available", lambda: False), \
            mock.patch.object(_build, "load", side_effect=AssertionError("loaded")), \
            mock.patch.object(tracing, "_ON", [True]):
        _launch.warm()
    assert source.lib.cache_info() == before


def test_a_key_or_source_declared_twice_is_refused():
    sources, counted = dict(_launch.SOURCES), dict(_launch.COUNTED)
    with pytest.raises(ValueError, match=r"\['uniform'\] are counted elsewhere"):
        _launch.declare("rng_again", {}, launches={"uniform": 0, "uniform_again": 0})
    with pytest.raises(ValueError, match="declared twice"):
        _launch.declare("standin", {}, launches={"standin_again": 0})
    assert _launch.SOURCES == sources and _launch.COUNTED == counted
