"""Mitsuba-XML scene frontend -> SceneBuilder -> device Scene.

Feature-parity port of parse/parse_scene.cpp (cited per function): <default>
variable substitution, transform stacks, perspective sensor with fovAxis
conversion, film/sampler, all 12 bsdf types (+twosided unwrap), point
emitters, sphere/obj/ply/serialized/rectangle shapes with per-face area
lights, named texture/material refs, <background>, and the JAX package's
envmap/constant emitter extension (IBL).

Copied from take_tpu/scene/parse_xml.py with imports pointed at this
package.
"""

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from take_tpu_torch.core.camera import Camera
from take_tpu_torch.io.images import imread3
from take_tpu_torch.lights.envmap import build_envmap
from take_tpu_torch.scene import transforms
from take_tpu_torch.scene import types as T
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.parse_obj import parse_obj
from take_tpu_torch.scene.parse_ply import parse_ply
from take_tpu_torch.scene.parse_serialized import parse_serialized

_DEFAULT_FOV = 45.0
_DEFAULT_RES = 256

_BSDF_TAGS = {
    "diffuse": T.MAT_DIFFUSE,
    "mirror": T.MAT_MIRROR,
    "plastic": T.MAT_PLASTIC,
    "phong": T.MAT_PHONG,
    "blinn": T.MAT_BLINN_PHONG,
    "blinnphong": T.MAT_BLINN_PHONG,
    "blinn_microfacet": T.MAT_BLINN_PHONG_MICROFACET,
    "blinnphong_microfacet": T.MAT_BLINN_PHONG_MICROFACET,
    "disneydiffuse": T.MAT_DISNEY_DIFFUSE,
    "disneymetal": T.MAT_DISNEY_METAL,
    "disneyglass": T.MAT_DISNEY_GLASS,
    "disneyclearcoat": T.MAT_DISNEY_CLEARCOAT,
    "disneysheen": T.MAT_DISNEY_SHEEN,
    "disneybsdf": T.MAT_DISNEY_BSDF,
    "principled": T.MAT_DISNEY_BSDF,
}


def _srgb_to_linear(c):
    c = np.asarray(c, np.float64)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


class _Parser:
    def __init__(self, scene_dir):
        self.scene_dir = scene_dir
        self.defaults = {}
        self.builder = SceneBuilder()
        self.texture_map = {}  # name -> texture spec dict
        self.material_map = {}  # name -> material id
        self.max_depth_hint = None

    # -- value parsing with $default substitution (parse_scene.cpp:65-88) --

    def sub(self, value: str) -> str:
        if value and value[0] == "$":
            key = value[1:]
            if key not in self.defaults:
                raise ValueError(f"Reference default variable ${key} not found")
            return self.defaults[key]
        return value

    def f(self, value):
        return float(self.sub(value))

    def i(self, value):
        return int(self.sub(value))

    def b(self, value):
        v = self.sub(value)
        if v == "true":
            return True
        if v == "false":
            return False
        raise ValueError(f"parse_boolean failed: {value!r}")

    def v3(self, value):
        parts = [p for p in re.split(r"[, ]+", self.sub(value).strip()) if p]
        if len(parts) == 1:
            x = float(parts[0])
            return np.array([x, x, x])
        if len(parts) == 3:
            return np.array([float(p) for p in parts])
        raise ValueError(f"parse_vector3 failed: {value!r}")

    def srgb(self, value):
        v = self.sub(value)
        if len(v) == 7 and v[0] == "#":
            enc = int(v[1:], 16)
            return np.array(
                [(enc >> 16) & 0xFF, (enc >> 8) & 0xFF, enc & 0xFF], np.float64
            ) / 255.0
        raise ValueError(f"Unknown SRGB format: {value!r}")

    def matrix(self, value):
        parts = [p for p in re.split(r"[, ]+", self.sub(value).strip()) if p]
        if len(parts) != 16:
            raise ValueError("parse_matrix4x4 failed")
        return np.array([float(p) for p in parts]).reshape(4, 4)

    def path(self, filename):
        p = self.sub(filename)
        return p if os.path.isabs(p) else os.path.join(self.scene_dir, p)

    # -- transforms (parse_scene.cpp:191-267) --

    def transform(self, node):
        m = np.eye(4)
        for child in node:
            name = child.tag.lower()
            if name == "scale":
                x = y = z = 1.0
                if child.get("x") is not None:
                    x = self.f(child.get("x"))
                if child.get("y") is not None:
                    y = self.f(child.get("y"))
                if child.get("z") is not None:
                    z = self.f(child.get("z"))
                if child.get("value") is not None:
                    x, y, z = self.v3(child.get("value"))
                m = transforms.scale((x, y, z)) @ m
            elif name == "translate":
                x = y = z = 0.0
                if child.get("x") is not None:
                    x = self.f(child.get("x"))
                if child.get("y") is not None:
                    y = self.f(child.get("y"))
                if child.get("z") is not None:
                    z = self.f(child.get("z"))
                if child.get("value") is not None:
                    x, y, z = self.v3(child.get("value"))
                m = transforms.translate((x, y, z)) @ m
            elif name == "rotate":
                x = y = z = angle = 0.0
                if child.get("x") is not None:
                    x = self.f(child.get("x"))
                if child.get("y") is not None:
                    y = self.f(child.get("y"))
                if child.get("z") is not None:
                    z = self.f(child.get("z"))
                if child.get("angle") is not None:
                    angle = self.f(child.get("angle"))
                m = transforms.rotate(angle, (x, y, z)) @ m
            elif name == "lookat":
                m = (
                    transforms.look_at(
                        self.v3(child.get("origin")),
                        self.v3(child.get("target")),
                        self.v3(child.get("up")),
                    )
                    @ m
                )
            elif name == "matrix":
                m = self.matrix(child.get("value")) @ m
        return m

    # -- sensor (parse_scene.cpp:307-386) --

    def sensor(self, node):
        if node.get("type") != "perspective":
            raise ValueError(f"Unsupported sensor: {node.get('type')}")
        fov = _DEFAULT_FOV
        fov_axis = "x"
        lookfrom, lookat, up = (0, 0, 0), (0, 0, -1), (0, 1, 0)
        width = height = _DEFAULT_RES
        filename = "image.exr"
        spp = 16
        for child in node:
            name = child.get("name")
            if name == "fov":
                fov = self.f(child.get("value"))
            elif name in ("toWorld", "to_world"):
                for gc in child:
                    if gc.tag.lower() != "lookat":
                        raise ValueError(
                            "Only support LookAt transform in a sensor."
                        )
                    lookfrom = tuple(self.v3(gc.get("origin")))
                    lookat = tuple(self.v3(gc.get("target")))
                    up = tuple(self.v3(gc.get("up")))
            elif name in ("fovAxis", "fov_axis"):
                fov_axis = child.get("value")
                if fov_axis not in ("x", "y", "diagonal", "smaller", "larger"):
                    raise ValueError(f"Unknown fovAxis value: {fov_axis}")
            if child.tag == "film":
                for gc in child:
                    n = gc.get("name")
                    if n == "width":
                        width = self.i(gc.get("value"))
                    elif n == "height":
                        height = self.i(gc.get("value"))
                    elif n == "filename":
                        filename = self.sub(gc.get("value"))
            elif child.tag == "sampler":
                for gc in child:
                    if gc.get("name") in ("sampleCount", "sample_count"):
                        spp = self.i(gc.get("value"))

        # convert to vertical fov (parse_scene.cpp:367-377); default axis = X
        if (
            fov_axis == "x"
            or (fov_axis == "smaller" and width < height)
            or (fov_axis == "larger" and height < width)
        ):
            fov = np.degrees(
                2 * np.arctan(np.tan(np.radians(fov) / 2) * height / width)
            )
        elif fov_axis == "diagonal":
            aspect = height / width
            diagonal = 2 * np.tan(np.radians(fov) / 2)
            h = diagonal / np.sqrt(1 + 1 / (aspect * aspect))
            fov = np.degrees(2 * np.arctan(h / 2))

        self.builder.camera = Camera(
            width=width, height=height, lookfrom=lookfrom, lookat=lookat,
            up=up, vfov=float(fov),
        )
        self.builder.spp = spp
        self.builder.output_filename = filename

    # -- textures (parse_scene.cpp:390-425) --

    def texture(self, node):
        if node.get("type") != "bitmap":
            raise ValueError(f"Unknown texture type: {node.get('type')}")
        filename = ""
        uscale = vscale = 1.0
        uoffset = voffset = 0.0
        for child in node:
            name = child.get("name")
            if name == "filename":
                filename = child.get("value")
            elif name == "uvscale":
                uscale = vscale = self.f(child.get("value"))
            elif name == "uscale":
                uscale = self.f(child.get("value"))
            elif name == "vscale":
                vscale = self.f(child.get("value"))
            elif name == "uoffset":
                uoffset = self.f(child.get("value"))
            elif name == "voffset":
                voffset = self.f(child.get("value"))
        path = self.path(filename)
        tex_id = self.builder.add_texture_image(imread3(path), name=path)
        return dict(
            tex_kind=T.TEX_IMAGE,
            tex_image=tex_id,
            tex_uvscale=(uscale, vscale),
            tex_uvoffset=(uoffset, voffset),
        )

    def color(self, node):
        """<rgb>/<srgb>/<ref>/<texture> -> texture spec (parse_scene.cpp:427-452)."""
        t = node.tag
        if t == "rgb":
            return dict(tex_kind=T.TEX_CONST, tex_value=tuple(self.v3(node.get("value"))))
        if t == "srgb":
            return dict(
                tex_kind=T.TEX_CONST,
                tex_value=tuple(_srgb_to_linear(self.srgb(node.get("value")))),
            )
        if t == "ref":
            rid = node.get("id")
            if rid not in self.texture_map:
                raise ValueError(f"Texture not found. ID = {rid}")
            return self.texture_map[rid]
        if t == "texture":
            return self.texture(node)
        raise ValueError(f"Unknown spectrum texture type: {t}")

    def intensity(self, node):
        if node.tag == "rgb":
            return self.v3(node.get("value"))
        if node.tag == "srgb":
            return _srgb_to_linear(self.srgb(node.get("value")))
        return np.ones(3)

    # -- bsdfs (parse_scene.cpp:472-699) --

    def bsdf(self, node, parent_id=""):
        """Returns (name_id, material_index)."""
        btype = node.get("type")
        bid = node.get("id") or parent_id
        if btype == "twosided":
            for child in node:
                if child.tag == "bsdf":
                    return self.bsdf(child, bid)
            raise ValueError("twosided bsdf without inner bsdf")
        if btype not in _BSDF_TAGS:
            raise ValueError(f"Unknown BSDF: {btype}")
        tag = _BSDF_TAGS[btype]

        params = dict(tex_kind=T.TEX_CONST, tex_value=(0.5, 0.5, 0.5))
        if btype == "mirror":
            params["tex_value"] = (1.0, 1.0, 1.0)
        defaults = {
            "plastic": dict(eta=1.5),
            "phong": dict(exponent=5.0),
            "blinn": dict(exponent=5.0),
            "blinnphong": dict(exponent=5.0),
            "blinn_microfacet": dict(exponent=5.0),
            "blinnphong_microfacet": dict(exponent=5.0),
            "disneydiffuse": dict(roughness=0.5, subsurface=0.0),
            "disneymetal": dict(roughness=0.5, anisotropic=0.0),
            "disneyglass": dict(roughness=0.5, anisotropic=0.0, eta=1.5),
            "disneyclearcoat": dict(clearcoat_gloss=1.0),
            "disneysheen": dict(sheen_tint=0.5),
            "disneybsdf": dict(
                spec_trans=0.0, metallic=0.0, subsurface=0.0, specular=0.5,
                roughness=0.5, specular_tint=0.0, anisotropic=0.0, sheen=0.0,
                sheen_tint=0.5, clearcoat=0.0, clearcoat_gloss=1.0, eta=1.5,
            ),
            "principled": dict(
                spec_trans=0.0, metallic=0.0, subsurface=0.0, specular=0.5,
                roughness=0.5, specular_tint=0.0, anisotropic=0.0, sheen=0.0,
                sheen_tint=0.5, clearcoat=0.0, clearcoat_gloss=1.0, eta=1.5,
            ),
        }
        params.update(defaults.get(btype, {}))

        scalar_names = {
            "ior": "eta", "eta": "eta",
            "exponent": "exponent", "alpha": "exponent",
            "roughness": "roughness", "subsurface": "subsurface",
            "anisotropic": "anisotropic", "metallic": "metallic",
            "specular": "specular",
            "specularTransmission": "spec_trans",
            "specular_transmission": "spec_trans",
            "specTrans": "spec_trans", "spec_trans": "spec_trans",
            "specularTint": "specular_tint", "specular_tint": "specular_tint",
            "specTint": "specular_tint", "spec_tint": "specular_tint",
            "sheen": "sheen",
            "sheenTint": "sheen_tint", "sheen_tint": "sheen_tint",
            "clearcoat": "clearcoat",
            "clearcoatGloss": "clearcoat_gloss",
            "clearcoat_gloss": "clearcoat_gloss",
        }
        for child in node:
            name = child.get("name")
            if name in ("reflectance", "baseColor", "base_color"):
                params.update(self.color(child))
            elif name in scalar_names:
                params[scalar_names[name]] = self.f(child.get("value"))

        mat_id = self.builder.add_material(tag, **params)
        if bid:
            self.material_map[bid] = mat_id
        return bid, mat_id

    # -- emitters (parse_scene.cpp:701-727 + envmap extension) --

    def emitter(self, node):
        etype = node.get("type")
        if etype == "point":
            position = np.zeros(3)
            intensity = np.ones(3)
            for child in node:
                name = child.get("name")
                if name == "position":
                    position = np.array(
                        [
                            self.f(child.get("x", "0")),
                            self.f(child.get("y", "0")),
                            self.f(child.get("z", "0")),
                        ]
                    )
                elif name == "intensity":
                    intensity = self.intensity(child)
            self.builder.add_point_light(position, intensity)
        elif etype in ("envmap", "constant"):
            scale = 1.0
            data = None
            to_world = np.eye(4)
            for child in node:
                name = child.get("name")
                if name == "filename":
                    data = imread3(self.path(child.get("value")))
                elif name == "scale":
                    scale = self.f(child.get("value"))
                elif name in ("toWorld", "to_world"):
                    to_world = self.transform(child)
                elif name == "radiance":
                    data = self.intensity(child)[None, None, :] * np.ones((1, 2, 3))
            if data is None:
                raise ValueError("envmap emitter requires a filename")
            self.builder.envmap = build_envmap(data, to_world, scale)
        else:
            raise ValueError(f"Unknown emitter: {etype}")

    # -- shapes (parse_scene.cpp:729-948) --

    def shape(self, node):
        material_id = -1
        for child in node:
            if child.tag == "ref":
                rid = child.get("id")
                if rid is None:
                    raise ValueError("Material reference id not specified.")
                if rid not in self.material_map:
                    raise ValueError(f"Material reference {rid} not found.")
                material_id = self.material_map[rid]
            elif child.tag == "bsdf":
                _, material_id = self.bsdf(child)

        emission = None
        for child in node:
            if child.tag == "emitter":
                emission = np.ones(3)
                for gc in child:
                    if gc.get("name") == "radiance":
                        emission = self.intensity(gc)

        if material_id < 0:
            # reference leaves material_id == -1 (a crash downstream ⚠);
            # we default to a mid-grey diffuse
            material_id = self.builder.add_material(
                T.MAT_DIFFUSE, tex_value=(0.5, 0.5, 0.5)
            )

        stype = node.get("type")
        if stype == "sphere":
            center = np.zeros(3)
            radius = 1.0
            for child in node:
                name = child.get("name")
                if name == "center":
                    center = np.array(
                        [
                            self.f(child.get("x", "0")),
                            self.f(child.get("y", "0")),
                            self.f(child.get("z", "0")),
                        ]
                    )
                elif name == "radius":
                    radius = self.f(child.get("value"))
            self.builder.add_sphere(center, radius, material_id, emission)
            return

        to_world = np.eye(4)
        face_normals = False
        filename = None
        shape_index = 0
        flip_normals = False
        for child in node:
            name = child.get("name")
            if name == "filename":
                filename = self.path(child.get("value"))
            elif name in ("toWorld", "to_world") and child.tag == "transform":
                to_world = self.transform(child)
            elif name in ("faceNormals", "face_normals"):
                face_normals = self.b(child.get("value"))
            elif name in ("shapeIndex", "shape_index"):
                shape_index = self.i(child.get("value"))
            elif name in ("flipNormals", "flip_normals"):
                flip_normals = self.b(child.get("value"))

        if stype == "obj":
            mesh = parse_obj(filename, to_world)
        elif stype == "ply":
            mesh = parse_ply(filename, to_world)
        elif stype == "serialized":
            mesh = parse_serialized(filename, shape_index, to_world)
        elif stype == "rectangle":
            from take_tpu_torch.scene.parse_obj import MeshData

            mesh = MeshData()
            mesh.positions = transforms.xform_points(
                to_world,
                np.array(
                    [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64
                ),
            )
            mesh.indices = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
            mesh.uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
            n = np.array([[0, 0, 1.0]] * 4)
            if flip_normals:
                n = -n
            mesh.normals = transforms.xform_normals(to_world, n)
        else:
            raise ValueError(f"Unknown shape: {stype}")

        normals = None if face_normals else mesh.normals
        self.builder.add_mesh(
            mesh.positions,
            mesh.indices,
            material_id,
            normals=normals,
            uvs=mesh.uvs,
            emission=emission,
            face_normals=face_normals,
        )

    # -- scene root (parse_scene.cpp:950-1025) --

    def parse(self, root):
        for child in root:
            tag = child.tag
            if tag == "default":
                if child.get("name") is not None and child.get("value") is not None:
                    self.defaults[child.get("name")] = child.get("value")
            elif tag == "sensor":
                self.sensor(child)
            elif tag == "bsdf":
                self.bsdf(child)
            elif tag == "emitter":
                self.emitter(child)
            elif tag == "shape":
                self.shape(child)
            elif tag == "texture":
                tid = child.get("id")
                if tid in self.texture_map:
                    raise ValueError(f"Duplicated texture ID: {tid}")
                self.texture_map[tid] = self.texture(child)
            elif tag == "background":
                for gc in child:
                    if gc.get("name") == "radiance":
                        self.builder.background = self.intensity(gc)
            elif tag == "integrator":
                for gc in child:
                    if gc.get("name") in ("maxDepth", "max_depth"):
                        self.max_depth_hint = self.i(gc.get("value"))
        return self.builder


def parse_scene_file(path, build=True, **build_kwargs):
    """parse_scene equivalent (parse_scene.cpp:1027-1042). Returns a built
    Scene (or the SceneBuilder when build=False)."""
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "scene":
        root = root.find("scene")
    parser = _Parser(os.path.dirname(os.path.abspath(path)))
    builder = parser.parse(root)
    if not build:
        return builder
    return builder.build(**build_kwargs)
