"""take_tpu_torch's BVH build against take_tpu's: the node, cluster and
supercluster tables, the triangle order, the granules and the permuted
attribute rows, bit for bit; and the per-ray stack bound."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from take_tpu.geometry.bvh import build_bvh as jax_build_bvh
from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu_torch.geometry import bvh as tbvh
from take_tpu_torch.geometry import packet
from take_tpu_torch.scene.parse_xml import parse_scene_file as port_parse
from take_tpu_torch.scene.types import BVH_TABLES
from tests.test_bvh import random_soup_scene
from tests.torch_parity import port_meta, port_soup, tables

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")
TEXTURED = os.path.join(SCENES, "textured", "textured.xml")
ROOM = os.path.join(SCENES, "room", "room.xml")


def _assert_bvh_tables_equal(port, jax_scene):
    """Every table equal in dtype, shape and bits, the BVH's included."""
    got, want = tables(port), tables(jax_scene)
    assert set(got) == set(want)
    assert {f"bvh.{n}" for n in BVH_TABLES} <= set(got)
    for key, value in got.items():
        assert value.dtype == want[key].dtype, key
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    assert port.meta == port_meta(jax_scene.meta)


def _jax_depth(node_child):
    """Wide depth by walking the tree from the root (independent of the
    breadth-first numbering that tbvh.wide_depth relies on)."""
    def walk(m):
        return 1 + max((walk(c) for c in node_child[m] if c >= 0), default=0)

    return walk(0)


@pytest.mark.parametrize("n_tri", [40, 300, 1500])
def test_soup_bvh_tables_match(n_tri):
    jax_scene = random_soup_scene(n_tri, build_bvh=True)
    port = port_soup(n_tri, build_bvh=True)
    _assert_bvh_tables_equal(port, jax_scene)
    assert port.bvh.depth == _jax_depth(np.asarray(jax_scene.bvh.node_child))


def test_textured_bvh_tables_match():
    jax_scene = jax_parse(TEXTURED)
    port = port_parse(TEXTURED, device="cpu")
    assert port.bvh is not None and port.meta.n_tri > 256
    _assert_bvh_tables_equal(port, jax_scene)


def test_room_bvh_tables_match():
    """room.xml (105,998 triangles): the configuration the card renders."""
    jax_scene = jax_parse(ROOM)
    port = port_parse(ROOM, device="cpu")
    assert port.meta.n_tri == 105998
    _assert_bvh_tables_equal(port, jax_scene)
    assert port.bvh.depth == 8 and packet.stack_bound(port.bvh.depth) == 57


def test_build_bvh_matches_on_boxes():
    """The numpy build itself, on random boxes (no scene around it)."""
    rng = np.random.default_rng(7)
    lo = rng.uniform(-5, 5, (900, 3))
    hi = lo + rng.uniform(0.01, 2.0, (900, 3))
    for a, b in zip(tbvh.build_bvh(lo, hi), jax_build_bvh(lo, hi)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    cl_t, sup_t = tbvh.cluster_aabbs(lo, hi, 900)
    assert np.isnan(cl_t[-1]).all() and np.isnan(sup_t[-1]).all()


def test_kernel_layout_matches_jax_prep_tables():
    from take_tpu.geometry.pallas_traverse import prep_tables as jax_prep

    jax_scene = random_soup_scene(300, build_bvh=True)
    port = port_soup(300, build_bvh=True)
    nodes, tris = jax_prep(jax_scene)
    np.testing.assert_array_equal(port.bvh.nodes.numpy(), np.asarray(nodes))
    np.testing.assert_array_equal(port.bvh.tris.numpy(), np.asarray(tris))


def test_stack_overflow_raises_not_drops():
    """The twin sizes its stack from the tree's depth; a stack made too
    small for the tree raises instead of dropping nodes."""
    port = port_soup(1500, build_bvh=True)
    assert port.bvh.depth >= 3
    rng = np.random.default_rng(5)
    ro = torch.tensor(rng.uniform(-2, 2, (256, 3)), dtype=torch.float32)  # inside the soup
    d = rng.normal(size=(256, 3))
    rd = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), dtype=torch.float32)
    tmin, tmax = torch.full((256,), 1e-4), torch.full((256,), float("inf"))
    packet.packet_plain(port.bvh, ro, rd, tmin, tmax)
    shallow = dataclasses.replace(port.bvh, depth=0)  # room for the root alone
    with pytest.raises(RuntimeError, match="stack overflow"):
        packet.packet_plain(shallow, ro, rd, tmin, tmax)
