"""K6's loop (csrc/sweep.cu) on the CPU: room's mix with a list of 16
pairs, swept where it fills.

A test of tests/test_torch_sweep_layout.py, whose walk of the kernel's loop
it uses, in a file of its own so that the test suite's workers can run it
beside that file. The walk reads the kernel's list size from that module
(`layout.PAIRS`), so the test sets it there.
"""

import pytest

import tests.test_torch_sweep_layout as layout
from take_tpu_torch.geometry import sweep
from tests.test_torch_cluster_layout import _mix, room  # noqa: F401 (fixture)
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_walk_matches_twin_when_lists_fill(room, monkeypatch):  # noqa: F811
    """A list of 16 pairs on 2,048 rays of the room mix: blocks sweep where
    their lists fill, many times a chunk; the answers stay sweep_plain's bit
    for bit and the counters sweep_work's, and rays enter fewer clusters
    than with the kernel's list (their ranges shrink sooner)."""
    bvh = room.bvh
    rays = _mix(room, 2048, seed=3)
    args = (bvh.cl_aabb, bvh.tris, room.meta.n_tri)
    full = sweep.sweep_work(*args, *rays)
    monkeypatch.setattr(layout, "PAIRS", 16)
    monkeypatch.setattr(sweep, "PAIRS", 16)
    closest, _, _ = layout._assert_walk(*args, rays)
    assert closest[:, 1].sum() < full[:, 1].sum()
