"""take_tpu_torch scene tables against take_tpu's: parsing, building, and the
numpy hand-over (scene_from_numpy)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.parse_xml import parse_scene_file as port_parse
from take_tpu_torch.scene.types import scene_from_numpy
from tests.scenes import cornell_box, sphere_furnace
from tests.torch_parity import CBOX, port_builder, port_meta, port_scene, tables


def _assert_tables_equal(port, jax_scene):
    """Every port table equals take_tpu's exactly, in dtype, shape and bits,
    and neither package has a table the other lacks."""
    got = tables(port)
    want = tables(jax_scene)
    assert set(want) == set(got)
    for key, value in got.items():
        assert value.dtype == want[key].dtype, key
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def _assert_meta_equal(port, jax_scene):
    assert port.meta == port_meta(jax_scene.meta)


@pytest.mark.parametrize("scene_fn", [cornell_box, sphere_furnace])
def test_builder_tables_match(scene_fn):
    jax_scene = scene_fn().build()
    port = port_builder(scene_fn).build(device="cpu")
    _assert_tables_equal(port, jax_scene)
    _assert_meta_equal(port, jax_scene)


def test_cbox_xml_tables_match():
    jax_scene = jax_parse(CBOX)
    port = port_parse(CBOX, device="cpu")
    assert port.meta.n_tri == 32 and port.meta.n_sph == 0 and port.meta.n_lights == 2
    _assert_tables_equal(port, jax_scene)
    _assert_meta_equal(port, jax_scene)


def test_scene_from_numpy_round_trips():
    jax_scene = jax_parse(CBOX)
    port = port_scene(jax_scene)
    got = tables(port)
    for key, value in tables(jax_scene).items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    again = scene_from_numpy(got, port.meta, "cpu")
    for key, value in tables(again).items():
        np.testing.assert_array_equal(value, got[key], err_msg=key)


def test_scene_from_numpy_refuses_unknown_and_unported_tables():
    """Unknown tables raise KeyError, and so does an incomplete envmap (its
    seven tables come together); a complete one, from a constant
    environment built by each package, uploads to take_tpu's tables."""
    from take_tpu.lights.envmap import build_envmap as jax_build_envmap
    from take_tpu_torch.lights.envmap import build_envmap

    packed, meta = SceneBuilder().build_tables()
    with pytest.raises(KeyError):
        scene_from_numpy({**packed, "geometry.bogus": np.zeros(1)}, meta, "cpu")
    with pytest.raises(KeyError):
        scene_from_numpy({**packed, "envmap.data": np.zeros(1)}, meta, "cpu")
    const = np.full((1, 2, 3), 0.25)
    env = {f"envmap.{k}": v for k, v in build_envmap(const).items()}
    scene = scene_from_numpy({**packed, **env}, meta, "cpu")
    want = jax_build_envmap(const)
    for f in dataclasses.fields(want):
        got = getattr(scene.envmap, f.name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(want, f.name)), err_msg=f.name)
        assert str(got.dtype) == ("torch.int32" if f.name == "alias_idx" else "torch.float32"), f.name


def test_bvh_sized_scene_raises():
    """A grid mesh above the 256-primitive "auto" threshold builds a BVH
    scene (it once raised), with every table equal to take_tpu's."""
    from take_tpu.scene.build import SceneBuilder as JaxBuilder

    grid = np.array([[x, y, 0.0] for x in range(12) for y in range(12)])
    idx = np.array([[r * 12 + c, r * 12 + c + 1, (r + 1) * 12 + c]
                    for r in range(11) for c in range(11)] * 3)
    scenes = []
    for b in (SceneBuilder(), JaxBuilder()):
        b.add_mesh(grid, idx, b.add_material(0))
        scenes.append(b.build(device="cpu") if isinstance(b, SceneBuilder) else b.build())
    port, jax_scene = scenes
    assert port.bvh is not None and port.meta.n_tri == idx.shape[0]
    _assert_tables_equal(port, jax_scene)
    assert port.bvh.depth >= 1 and port.bvh.nodes.shape == (port.bvh.node_child.shape[0] * 8, 8)


def test_envmap_scene_raises(tmp_path):
    """A constant environment (the envmap emitter's `radiance` form) parses
    to take_tpu's tables, its envmap included; an envmap with neither a
    file nor a radiance raises ValueError in both packages."""
    xml = tmp_path / "env.xml"
    xml.write_text('<scene version="0.6.0"><emitter type="constant">'
                   '<rgb name="radiance" value="1, 0.5, 2"/><float name="scale" value="1.5"/></emitter>'
                   '<shape type="sphere"><float name="radius" value="1"/><bsdf type="diffuse"/></shape></scene>')
    port, jax_scene = port_parse(str(xml), device="cpu"), jax_parse(str(xml))
    assert port.meta.has_envmap and port.envmap.data.shape == (1, 2, 3)
    _assert_tables_equal(port, jax_scene)
    _assert_meta_equal(port, jax_scene)
    xml.write_text('<scene version="0.6.0"><emitter type="envmap"/></scene>')
    for parse in (jax_parse, port_parse):
        with pytest.raises(ValueError, match="envmap"):
            parse(str(xml))


def test_import_leaves_jax_out():
    """Every module of take_tpu_torch imports neither JAX nor take_tpu."""
    code = ("import importlib, pkgutil, sys, take_tpu_torch; "
            "names = [m.name for m in pkgutil.walk_packages(take_tpu_torch.__path__, 'take_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert {'take_tpu_torch.cli', 'take_tpu_torch.entry', 'take_tpu_torch.parallel.sharding', "
            "'take_tpu_torch.parallel.distributed', 'take_tpu_torch.parallel.overlap', "
            "'take_tpu_torch.utils.checkpoint', 'take_tpu_torch.utils.metrics', 'take_tpu_torch.run_configs', "
            "'take_tpu_torch.bench', 'take_tpu_torch.room_grad_fd', 'take_tpu_torch.inverse_demo'} "
            "<= set(names), names; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'take_tpu')); "
            "assert not bad, bad")
    root = os.path.join(os.path.dirname(__file__), "..")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


def test_scene_device_and_dtypes():
    port = port_parse(CBOX, device="cpu")
    for group in (port.geometry, port.materials, port.lights, port.textures):
        for f in dataclasses.fields(group):
            value = getattr(group, f.name)
            assert value.device.type == "cpu"
            assert str(value.dtype) in ("torch.float32", "torch.int32"), f.name
