"""K6's loop (csrc/sweep.cu) on the CPU: room's edge rays with a list of
4 pairs.

A test of tests/test_torch_sweep_layout.py, whose walk of the kernel's loop
it uses, in a file of its own so that the test suite's workers can run it
beside that file. The walk reads the kernel's list size from that module
(`layout.PAIRS`), so the test sets it there.
"""

import pytest

import tests.test_torch_sweep_layout as layout
from take_tpu_torch.geometry import sweep
from take_tpu_torch.geometry.packet import BIG
from tests.test_torch_cluster_layout import _edge_rays, room  # noqa: F401 (fixture)
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_walk_matches_twin_on_edge_rays(room, monkeypatch):  # noqa: F811
    """Room's edge rays (on cluster box faces, from box centres, aimed at
    shared vertices and edges, grazing the room's walls, dead and padded
    lanes, a ragged count), with a list of 4 pairs so that ranges shrink
    between boxes: the walk answers as sweep_plain bit for bit; dead and
    padded lanes miss."""
    bvh = room.bvh
    rays = _edge_rays(room)
    assert rays[0].shape[0] % layout.THREADS
    args = (bvh.cl_aabb, bvh.tris, room.meta.n_tri)
    monkeypatch.setattr(layout, "PAIRS", 4)
    monkeypatch.setattr(sweep, "PAIRS", 4)
    t, _, _, prim = layout._assert_walk(*args, rays)[2]
    off = rays[3] < rays[2]
    assert (prim[off] == -1).all() and (t[off] == BIG).all() and (prim[~off] >= 0).float().mean() > 0.8
