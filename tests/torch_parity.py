"""Helpers for the take_tpu_torch parity tests: hand one scene to both
packages as numpy, and build the port's twin of a take_tpu test scene."""

import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch

import take_tpu_torch.core.camera as tcam
import take_tpu_torch.scene.build as tbuild
import take_tpu_torch.scene.types as tt
import tests.scenes as jscenes

CBOX = os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox", "cbox.xml")


def tables(scene) -> dict:
    """A Scene's tables (take_tpu's, or the port's on the CPU) as numpy,
    keyed by field path, the form scene_from_numpy takes (derived fields
    left out)."""
    out = {}
    for group in ("geometry", "materials", "lights", "textures"):
        g = getattr(scene, group)
        for f in dataclasses.fields(g):
            if not f.compare:  # derived at upload (the port's geometry.tri_rows)
                continue
            out[f"{group}.{f.name}"] = np.asarray(getattr(g, f.name))
    if scene.bvh is not None:
        for name in tt.BVH_TABLES:
            out[f"bvh.{name}"] = np.asarray(getattr(scene.bvh, name))
    if scene.envmap is not None:
        for f in dataclasses.fields(tt.EnvMap):
            out[f"envmap.{f.name}"] = np.asarray(getattr(scene.envmap, f.name))
    out["background"] = np.asarray(scene.background)
    return out


def port_camera(cam):
    return tcam.Camera(cam.width, cam.height, cam.lookfrom, cam.lookat, cam.up, cam.vfov)


def port_meta(meta):
    """take_tpu's SceneMeta as the port's (same fields, the port's Camera)."""
    fields = {f.name: getattr(meta, f.name) for f in dataclasses.fields(tt.SceneMeta)}
    fields["camera"] = port_camera(meta.camera) if meta.camera is not None else None
    return tt.SceneMeta(**fields)


def port_scene(jax_scene, device="cpu"):
    """The port's Scene computing on take_tpu's tables, bit for bit."""
    return tt.scene_from_numpy(tables(jax_scene), port_meta(jax_scene.meta), device)


def port_builder(scene_fn, *args, **kwargs):
    """Run a tests/scenes.py constructor with the port's SceneBuilder and
    Camera in place of take_tpu's (the material tags are the same ints)."""
    with mock.patch.object(jscenes, "SceneBuilder", tbuild.SceneBuilder), \
            mock.patch.object(jscenes, "Camera", tcam.Camera):
        return scene_fn(*args, **kwargs)


class _CPUBuilder(tbuild.SceneBuilder):
    """The port's SceneBuilder, building on the CPU unless told otherwise."""

    def build(self, device="cpu", build_bvh="auto"):
        return super().build(device, build_bvh)


def port_soup(n_tri, **kwargs):
    """tests/test_bvh.py's random triangle soup, built by the port on the CPU."""
    import tests.test_bvh as jbvh

    with mock.patch.object(jbvh, "SceneBuilder", _CPUBuilder), \
            mock.patch.object(jbvh, "Camera", tcam.Camera):
        return jbvh.random_soup_scene(n_tri, **kwargs)


def with_res(scene, res, camera_cls):
    cam = scene.meta.camera
    new = camera_cls(res, res, cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(scene, meta=dataclasses.replace(scene.meta, camera=new))



@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread, then restore the count. The
    gradient tests take thousands of small ops a bounce; with several pytest
    workers each spinning torch's full thread pool on them, the pools
    contend and a test runs tens of times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
