"""The reference's own loader of Mitsuba-XML scenes, for the subset that the
benchmark's scenes use: a perspective sensor with an hdrfilm, bsdfs,
shapes, emitters and a flat background.

Shapes, bsdfs and emitters are found by type name as modules of
`portbench.reference.shapes`, `.materials` and `.lights`; a scene that
names a type without a module is refused. A shape module gives either a
triangle mesh or analytic primitives, which the tracer intersects through
the module. Triangles, primitives, materials and lights are numbered in
the order the file defines them, the order in which the tracer under test
numbers them, so that the counter RNG's light choice picks the same light
on both sides; an emitter module with `LAST = True` (a light at infinity)
takes the last slots.
"""

import dataclasses
import importlib
import os
import re
import xml.etree.ElementTree as ET

import numpy as np
import torch

from portbench.reference import geometry


def module(kind: str, name: str):
    """portbench.reference.<kind>.<name>, or a ValueError naming what is missing."""
    try:
        return importlib.import_module(f"portbench.reference.{kind}.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"the reference has no {kind} module {name!r}") from e


@dataclasses.dataclass
class Scene:
    """A scene as host numpy (float64 geometry) and the camera."""

    width: int
    height: int
    lookfrom: tuple
    lookat: tuple
    up: tuple
    vfov: float
    background: np.ndarray  # [3]
    materials: list  # [(type name, {param: value})], by material id
    material_ids: dict  # XML id -> material id
    v0: np.ndarray  # [T, 3]
    v1: np.ndarray
    v2: np.ndarray
    normals: np.ndarray  # [T, 3, 3] vertex normals (zeros without)
    has_normals: np.ndarray  # [T] bool
    mat: np.ndarray  # [T] material id
    light: np.ndarray  # [T] light id, -1 if not emissive
    emit: np.ndarray  # [T, 3]
    analytic: dict  # shape type -> {"params": {name: [P, ...]}, "mat": [P], "light": [P], "emit": [P, 3]}
    lights: list  # light slots: (type name, shape type, index); MESH for triangle `index`, None for a
    # light of the scene (its `index`-th payload in light_data)
    light_data: dict  # light type -> [payload] of the scene's own lights

    @property
    def n_tri(self):
        return self.v0.shape[0]

    def with_resolution(self, width, height):
        return dataclasses.replace(self, width=int(width), height=int(height))


MESH = "mesh"  # the shape type of a light slot on a triangle


class _Parser:
    def __init__(self, scene_dir):
        self.dir, self.defaults = scene_dir, {}
        self.cam = dict(width=768, height=576, lookfrom=(0, 0, 0), lookat=(0, 0, -1), up=(0, 1, 0), vfov=30.0)
        self.background = np.zeros(3)
        self.materials, self.material_ids = [], {}
        self.tris, self.lights = [], []  # per triangle: (v0, v1, v2, normals, has_n, mat, light, emit)
        self.analytic, self.light_data, self.last = {}, {}, []

    def sub(self, v):
        return self.defaults[v[1:]] if v and v[0] == "$" else v

    def f(self, v):
        return float(self.sub(v))

    def v3(self, v):
        parts = [float(p) for p in re.split(r"[, ]+", self.sub(v).strip()) if p]
        return np.array(parts * 3 if len(parts) == 1 else parts, np.float64)

    def rgb(self, node):
        if node.tag != "rgb":
            raise ValueError(f"the reference reads colours as <rgb> only, not <{node.tag}>")
        return self.v3(node.get("value"))

    def transform(self, node):
        m = np.eye(4)
        for c in node:
            tag = c.tag.lower()
            if tag in ("scale", "translate"):
                x = np.array([1.0 if tag == "scale" else 0.0] * 3)
                for i, k in enumerate("xyz"):
                    if c.get(k) is not None:
                        x[i] = self.f(c.get(k))
                if c.get("value") is not None:
                    x = self.v3(c.get("value"))
                m = (geometry.scale(x) if tag == "scale" else geometry.translate(x)) @ m
            elif tag == "rotate":
                axis = [self.f(c.get(k, "0")) for k in "xyz"]
                m = geometry.rotate(self.f(c.get("angle", "0")), axis) @ m
            elif tag == "lookat":
                m = geometry.look_at(self.v3(c.get("origin")), self.v3(c.get("target")), self.v3(c.get("up"))) @ m
            elif tag == "matrix":
                m = np.array([float(p) for p in re.split(r"[, ]+", self.sub(c.get("value")).strip()) if p]
                             ).reshape(4, 4) @ m
            else:
                raise ValueError(f"unknown transform <{c.tag}>")
        return m

    def sensor(self, node):
        if node.get("type") != "perspective":
            raise ValueError(f"the reference has no sensor {node.get('type')!r}")
        fov, axis = 90.0, "x"
        for c in node:
            name = c.get("name")
            if name == "fov":
                fov = self.f(c.get("value"))
            elif name in ("fovAxis", "fov_axis"):
                axis = c.get("value")
            elif name in ("toWorld", "to_world"):
                (la,) = list(c)
                self.cam.update(lookfrom=tuple(self.v3(la.get("origin"))), lookat=tuple(self.v3(la.get("target"))),
                                up=tuple(self.v3(la.get("up"))))
            if c.tag == "film":
                for g in c:
                    if g.get("name") in ("width", "height"):
                        self.cam[g.get("name")] = int(self.sub(g.get("value")))
        w, h = self.cam["width"], self.cam["height"]
        if axis == "x" or (axis == "smaller" and w < h) or (axis == "larger" and h < w):
            fov = np.degrees(2 * np.arctan(np.tan(np.radians(fov) / 2) * h / w))
        elif axis == "diagonal":
            aspect = h / w
            fov = np.degrees(2 * np.arctan(2 * np.tan(np.radians(fov) / 2) / np.sqrt(1 + 1 / (aspect * aspect)) / 2))
        self.cam["vfov"] = float(fov)

    def bsdf(self, node, parent_id=""):
        kind, bid = node.get("type"), node.get("id") or parent_id
        if kind == "twosided":
            return self.bsdf(next(c for c in node if c.tag == "bsdf"), bid)
        params = module("materials", kind).parse(node, self)
        self.materials.append((kind, params))
        if bid:
            self.material_ids[bid] = len(self.materials) - 1
        return len(self.materials) - 1

    def shape_args(self, node):
        """(file path or None, shape index, to_world [4, 4], boolean options) of a <shape>."""
        to_world, path, index, options = np.eye(4), None, 0, {}
        for c in node:
            name = c.get("name")
            if name == "filename":
                path = os.path.join(self.dir, self.sub(c.get("value")))
            elif name in ("toWorld", "to_world") and c.tag == "transform":
                to_world = self.transform(c)
            elif name in ("shapeIndex", "shape_index"):
                index = int(self.sub(c.get("value")))
            elif c.tag == "boolean" and name:
                options[re.sub(r"_(\w)", lambda m: m.group(1).upper(), name)] = self.sub(c.get("value")) == "true"
        return path, index, to_world, options

    def shape(self, node):
        mat, emitter = -1, None
        for c in node:
            if c.tag == "ref":
                mat = self.material_ids[c.get("id")]
            elif c.tag == "bsdf":
                mat = self.bsdf(c)
            elif c.tag == "emitter":
                emitter = c
        if mat < 0:  # no material: the tracer's default, a mid-grey diffuse
            self.materials.append(("diffuse", {"reflectance": np.full(3, 0.5)}))
            mat = len(self.materials) - 1
        kind = node.get("type")
        geom = module("shapes", kind).load(node, self)
        emit = np.zeros(3) if emitter is None else module("lights", emitter.get("type")).parse(emitter, self)

        def light_slot(shape, index):
            if emitter is None:
                return -1
            self.lights.append((emitter.get("type"), shape, index))
            return len(self.lights) - 1

        if "analytic" in geom:
            group = self.analytic.setdefault(kind, {"params": [], "mat": [], "light": [], "emit": []})
            for prim in geom["analytic"]:
                group["light"].append(light_slot(kind, len(group["mat"])))
                group["params"].append(prim)
                group["mat"].append(mat)
                group["emit"].append(emit)
            return
        options = self.shape_args(node)[3]
        normals = None if options.get("faceNormals") else geom["normals"]
        if normals is None and not options.get("faceNormals"):
            normals = geometry.vertex_normals(geom["positions"], geom["indices"])
        p = geom["positions"]
        for f in geom["indices"]:
            light = light_slot(MESH, len(self.tris))
            n = np.zeros((3, 3)) if normals is None else normals[f]
            self.tris.append((p[f[0]], p[f[1]], p[f[2]], n, normals is not None, mat, light, emit))

    def emitter(self, node):
        """A light of the scene itself, held by no shape."""
        kind = node.get("type")
        mod = module("lights", kind)
        if not hasattr(mod, "attach"):
            raise ValueError(f"the reference's {kind!r} emitter is held by a shape only")
        payloads = self.light_data.setdefault(kind, [])
        payloads.append(mod.attach(node, self))
        slot = (kind, None, len(payloads) - 1)
        (self.last if getattr(mod, "LAST", False) else self.lights).append(slot)

    def parse(self, root):
        for c in root:
            if c.tag == "default":
                self.defaults[c.get("name")] = c.get("value")
            elif c.tag == "sensor":
                self.sensor(c)
            elif c.tag == "bsdf":
                self.bsdf(c)
            elif c.tag == "shape":
                self.shape(c)
            elif c.tag == "background":
                for g in c:
                    if g.get("name") == "radiance":
                        self.background = self.rgb(g)
            elif c.tag == "emitter":
                self.emitter(c)
        empty = [np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3, 3)), np.zeros(0, bool),
                 np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros((0, 3))]
        cols = [np.stack(c) if len(c) else e for c, e in zip(zip(*self.tris), empty)] if self.tris else empty
        analytic = {k: {"params": {n: np.stack([np.asarray(p[n], np.float64) for p in g["params"]])
                                   for n in g["params"][0]},
                        "mat": np.array(g["mat"]), "light": np.array(g["light"]), "emit": np.stack(g["emit"])}
                    for k, g in self.analytic.items()}
        return Scene(**self.cam, background=self.background, materials=self.materials,
                     material_ids=self.material_ids, v0=cols[0], v1=cols[1], v2=cols[2], normals=cols[3],
                     has_normals=np.asarray(cols[4], bool), mat=np.asarray(cols[5], np.int64),
                     light=np.asarray(cols[6], np.int64), emit=cols[7], analytic=analytic,
                     lights=self.lights + self.last, light_data=self.light_data)


def load(path) -> Scene:
    """Parse a scene file into the reference's host-side Scene."""
    root = ET.parse(path).getroot()
    return _Parser(os.path.dirname(os.path.abspath(path))).parse(root)


@dataclasses.dataclass
class Group:
    """The analytic primitives of one shape type, intersected by its module."""

    kind: str
    module: object
    data: dict  # the module's tables ({name: [P, ...]} unless its to_device says otherwise)
    mat: torch.Tensor  # [P] int64
    light: torch.Tensor  # [P] int64 light slot, -1 if not emissive
    emit: torch.Tensor  # [P, 3]


@dataclasses.dataclass
class DeviceScene:
    """The tables the reference tracer reads, on one device. Geometry for
    the intersection tests in `geom_dtype`; the shading tables in `dtype`,
    rounded from float64 as the tracer under test rounds its own."""

    host: Scene
    dtype: torch.dtype
    v0: torch.Tensor  # [T, 3] geom_dtype
    e1: torch.Tensor
    e2: torch.Tensor
    geo_n: torch.Tensor  # [T, 3] unit, dtype
    normals: torch.Tensor  # [T, 3, 3]
    has_normals: torch.Tensor  # [T] bool
    mat: torch.Tensor  # [T] int64
    light: torch.Tensor  # [T] int64
    emit: torch.Tensor  # [T, 3]
    inv_area: torch.Tensor  # [T]
    groups: list  # [Group] of analytic shapes; a lane's shape is 0 for triangles, g + 1 for groups[g]
    mat_kind: torch.Tensor  # [M] index into kinds
    kinds: tuple  # material type names
    mat_params: dict  # param name -> [M, ...] tensor
    light_kind: torch.Tensor  # [L] index into light_kinds, by slot
    light_kinds: tuple  # light type names
    light_shape: torch.Tensor  # [L] the slot's shape (0 triangles, g + 1 groups[g], -1 none)
    light_prim: torch.Tensor  # [L] its triangle or primitive, or its payload's index
    light_emit: torch.Tensor  # [L, 3] the radiance of a light on a shape
    light_data: dict  # light type -> its module's to_device of the scene's payloads
    background: torch.Tensor  # [3]


def to_device(s: Scene, device, dtype=torch.float32, geom_dtype=torch.float64) -> DeviceScene:
    if s.n_tri == 0:  # one triangle of no area, which no ray hits, so that the tables have a row
        z = np.zeros((1, 3))
        s = dataclasses.replace(s, v0=z, v1=z, v2=z, normals=np.zeros((1, 3, 3)), has_normals=np.zeros(1, bool),
                                mat=np.zeros(1, np.int64), light=np.full(1, -1), emit=z)
    e1, e2 = s.v1 - s.v0, s.v2 - s.v0
    nrm = np.cross(e1, e2)
    length = np.linalg.norm(nrm, axis=-1, keepdims=True)
    area = 0.5 * length[:, 0]
    kinds = tuple(sorted({k for k, _ in s.materials}))
    names = sorted({n for _, p in s.materials for n in p})
    params = {n: np.stack([np.asarray(p.get(n, 0.0), np.float64) for _, p in s.materials]) for n in names}

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    groups = []
    for kind, g in s.analytic.items():
        mod = module("shapes", kind)
        data = (mod.to_device(g["params"], device, dtype, geom_dtype) if hasattr(mod, "to_device")
                else {n: t(v, geom_dtype) for n, v in g["params"].items()})
        groups.append(Group(kind, mod, data, t(g["mat"], torch.int64), t(g["light"], torch.int64), t(g["emit"])))
    shape_ids = {MESH: 0, None: -1, **{g.kind: i + 1 for i, g in enumerate(groups)}}
    light_kinds = tuple(sorted({k for k, _, _ in s.lights}))

    def slot_emit(shape, index):
        if shape is None:
            return np.zeros(3)
        return s.emit[index] if shape == MESH else s.analytic[shape]["emit"][index]

    return DeviceScene(
        host=s, dtype=dtype,
        v0=t(s.v0, geom_dtype), e1=t(e1, geom_dtype), e2=t(e2, geom_dtype),
        geo_n=t(nrm / np.where(length > 0, length, 1.0)), normals=t(s.normals),
        has_normals=t(s.has_normals, torch.bool), mat=t(s.mat, torch.int64), light=t(s.light, torch.int64),
        emit=t(s.emit), inv_area=t(np.where(area > 0, 1.0 / np.maximum(area, 1e-30), 0.0)), groups=groups,
        mat_kind=t([kinds.index(k) for k, _ in s.materials], torch.int64), kinds=kinds,
        mat_params={n: t(v) for n, v in params.items()},
        light_kind=t([light_kinds.index(k) for k, _, _ in s.lights], torch.int64), light_kinds=light_kinds,
        light_shape=t([shape_ids[sh] for _, sh, _ in s.lights], torch.int64),
        light_prim=t([i for _, _, i in s.lights], torch.int64),
        light_emit=t(np.stack([slot_emit(sh, i) for _, sh, i in s.lights]) if s.lights else np.zeros((0, 3))),
        light_data={k: module("lights", k).to_device(v, device, dtype) for k, v in s.light_data.items()
                    if hasattr(module("lights", k), "to_device")},
        background=t(s.background))
