"""Scene representation: tagged SoA tensors + static metadata.

Port of take_tpu/scene/types.py: the same dataclasses, field for field, with
torch tensors in place of JAX arrays, and the same packed column layouts
(ATTR_*, SATTR_*, MATTR_*, LATTR_*). Every tensor of a Scene lies on one
device, chosen when the scene is built (scene/build.py) or converted
(`scene_from_numpy`).
"""

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from take_tpu_torch.core.camera import Camera

# Material tags (order mirrors the reference variant, material.h:82-93)
MAT_DIFFUSE = 0
MAT_MIRROR = 1
MAT_PLASTIC = 2
MAT_PHONG = 3
MAT_BLINN_PHONG = 4
MAT_BLINN_PHONG_MICROFACET = 5
MAT_DISNEY_DIFFUSE = 6
MAT_DISNEY_METAL = 7
MAT_DISNEY_GLASS = 8
MAT_DISNEY_CLEARCOAT = 9
MAT_DISNEY_SHEEN = 10
MAT_DISNEY_BSDF = 11

MATERIAL_NAMES = {
    MAT_DIFFUSE: "diffuse",
    MAT_MIRROR: "mirror",
    MAT_PLASTIC: "plastic",
    MAT_PHONG: "phong",
    MAT_BLINN_PHONG: "blinnphong",
    MAT_BLINN_PHONG_MICROFACET: "blinnphongmicrofacet",
    MAT_DISNEY_DIFFUSE: "disneydiffuse",
    MAT_DISNEY_METAL: "disneymetal",
    MAT_DISNEY_GLASS: "disneyglass",
    MAT_DISNEY_CLEARCOAT: "disneyclearcoat",
    MAT_DISNEY_SHEEN: "disneysheen",
    MAT_DISNEY_BSDF: "disneybsdf",
}

# Light tags (light.h:19)
LIGHT_POINT = 0
LIGHT_AREA = 1

# Shape kinds for light -> shape references
SHAPE_TRI = 0
SHAPE_SPHERE = 1

# Texture slot kinds (texture.h:27)
TEX_CONST = 0
TEX_IMAGE = 1


@dataclass
class GeometryArrays:
    """Triangle soup + sphere table (see take_tpu's GeometryArrays).

    `tri_affine_o` / `tri_affine_d` hold each triangle's affine map into its
    (u, v, w) frame, axis-major: column k * Tpad + t is row k of triangle t.
    `tri_sweep` holds the same operands as the TPU cluster kernel's
    transposed supercluster granules (rows sup * 24 + j hold operand j of
    the supercluster's 512 triangles). No kernel of the port reads it, so it
    stays on the host (HOST_TABLES), built only to be checked against the
    JAX package's.

    `tri_rows` is derived from the affine tables once, when the scene is
    uploaded (`scene_from_numpy`), and is no scene table: the same maps as
    one row a triangle (`affine_rows`), which the brute-force kernels read.
    A BVH scene shares the tensor with `bvh.tris`.
    """

    tri_v0: Any  # [T, 3]
    tri_e1: Any  # [T, 3]
    tri_e2: Any  # [T, 3]
    tri_n0: Any  # [T, 3]
    tri_n1: Any  # [T, 3]
    tri_n2: Any  # [T, 3]
    tri_uv0: Any  # [T, 2]
    tri_uv1: Any  # [T, 2]
    tri_uv2: Any  # [T, 2]
    tri_mat: Any  # [T] int32
    tri_light: Any  # [T] int32, -1 if not emissive
    tri_flags: Any  # [T] int32
    tri_affine_o: Any  # [4, 3T]  homogeneous origin map
    tri_affine_d: Any  # [3, 3T]  direction map
    tri_sweep: Any  # [SupP * 24, 512], SupP a multiple of bvh.GROUP
    tri_attr: Any  # [T, ATTR_DIM] packed shading attributes
    sph_center: Any  # [S, 3]
    sph_radius: Any  # [S]
    sph_mat: Any  # [S] int32
    sph_light: Any  # [S] int32
    sph_attr: Any  # [Spad, SATTR_DIM] packed shading attributes
    tri_rows: Any = dataclasses.field(default=None, compare=False, repr=False)  # [Tpad, 24]


@dataclass
class MaterialArrays:
    """Material tag + packed parameter table (slots MATTR_*)."""

    tag: Any  # [M] int32
    attr: Any  # [Mpad, MATTR_DIM]


@dataclass
class LightArrays:
    """Point + diffuse-area lights as one tagged table (slots LATTR_*)."""

    tag: Any  # [L] int32
    power_pmf: Any  # [L]
    power_cdf: Any  # [L] inclusive cdf
    attr: Any  # [Lpad, LATTR_DIM]


@dataclass
class TextureAtlas:
    """Image textures, padded to a common [n, Hmax, Wmax, 3] block."""

    data: Any  # [n, Hmax, Wmax, 3]
    width: Any  # [n] int32
    height: Any  # [n] int32


@dataclass
class EnvMap:
    """Environment light (IBL): lat-long radiance map and its sampling tables
    (lights/envmap.py). Present when SceneMeta.has_envmap."""

    data: Any  # [H, W, 3] radiance
    alias_prob: Any  # [H*W] acceptance probability
    alias_idx: Any  # [H*W] int32 alias index
    pdf: Any  # [H, W] pdf numerator pmf*W*H/(2 pi^2); pdf(d) = pdf[texel(d)] / sin(theta(d))
    to_world: Any  # [3, 3] rotation
    to_local: Any  # [3, 3] inverse rotation
    scale: Any  # [] radiance multiplier


# Tables scene_from_numpy keeps on the host (CPU tensors) whatever the device.
HOST_TABLES = ("geometry.tri_sweep",)

# The BVH's scene tables, in the JAX package's BVHArrays order.
BVH_TABLES = ("node_min", "node_max", "node_child", "node_count", "cl_aabb", "sup_aabb")


@dataclass
class BVHArrays:
    """Flattened wide BVH (geometry/bvh.py), built on the host.

    The first six fields are scene tables, as in take_tpu's BVHArrays. The
    others are derived from them once, when the scene is uploaded
    (`scene_from_numpy`), and kept with the scene so that no query rebuilds
    them: the tree's wide depth, which sizes the traversal stacks, and the
    packet layouts of the node and triangle tables: the exact node rows,
    the triangle rows and the kernel's quantised nodes
    (geometry/packet.py::prep_tables).
    """

    node_min: Any  # [M, W, 3] child box minima (empty slots +3e38)
    node_max: Any  # [M, W, 3] child box maxima (empty slots -3e38)
    node_child: Any  # [M, W] int32: >= 0 internal node, < 0 leaf -(start + 1)
    node_count: Any  # [M, W] int32: leaf triangle count (0 otherwise)
    cl_aabb: Any  # [Cpad, 8] cluster boxes, all-NaN padding rows
    sup_aabb: Any  # [SupP, 8] supercluster boxes, all-NaN padding rows
    depth: int = dataclasses.field(default=0, compare=False)
    nodes: Any = dataclasses.field(default=None, compare=False, repr=False)  # [M * W, 8]
    tris: Any = dataclasses.field(default=None, compare=False, repr=False)  # [Tpad, 24]
    qnodes: Any = dataclasses.field(default=None, compare=False, repr=False)  # [M', 24] int32


@dataclass(frozen=True)
class SceneMeta:
    """Static scene facts."""

    n_tri: int
    n_sph: int
    n_mat: int
    n_lights: int
    n_tex: int
    used_material_tags: Tuple[int, ...]
    has_image_textures: bool
    has_envmap: bool
    has_area_lights: bool
    has_point_lights: bool
    any_uv: bool
    any_normals: bool
    camera: Optional[Camera] = None
    has_background: bool = False


@dataclass(frozen=True)
class RenderOptions:
    """Runtime rendering options (reference RenderOptions, scene.h:5-10 +
    CLI -max_depth, render.cpp:14) and the gradient mode (`grad_mode`,
    read by grad.py)."""

    spp: int = 4
    max_depth: int = 50
    # "mis" (the default, the scan loop; "mis_scan" too, "mis_wavefront" the
    # refill loop) | "mis_replay" (the early-exit loop with the path-replay
    # backward) | "one_sample_mis" | "one_sample_mis_power" | "raw"
    integrator: str = "mis"
    seed: int = 0
    # Russian roulette from this bounce index; -1 = off (reference default)
    rr_depth: int = -1
    # Rays are processed in chunks of at most this many paths to bound memory.
    max_rays_per_pass: int = 1 << 20
    # Gradient mode (grad.py): "ad" = autograd through the scan loop
    # (residuals per bounce); "replay" = path-replay backward (memory
    # O(wavefront)); "auto" = replay when paths * (max_depth + 1) > 2^24.
    grad_mode: str = "ad"


@dataclass
class Scene:
    """The full device scene. `bvh` is None for brute-force scenes, `envmap`
    for scenes without an environment light."""

    geometry: GeometryArrays
    materials: MaterialArrays
    lights: LightArrays
    textures: TextureAtlas
    background: Any  # [3] radiance returned on miss (scene.h:27)
    envmap: Optional[EnvMap]
    bvh: Optional[BVHArrays]
    meta: SceneMeta


# Flags bits for tri_flags
TRI_HAS_NORMALS = 1
TRI_HAS_UV = 2

# tri_attr packed layout (f32 columns; ids are exact below 2^24)
ATTR_GEO_N = 0  # 0:3   unit geometric normal (unflipped)
ATTR_N0 = 3  # 3:6
ATTR_N1 = 6  # 6:9
ATTR_N2 = 9  # 9:12
ATTR_UV0 = 12  # 12:14
ATTR_UV1 = 14  # 14:16
ATTR_UV2 = 16  # 16:18
ATTR_MAT = 18
ATTR_LIGHT = 19
ATTR_FLAGS = 20
ATTR_EMIT = 21  # 21:24 area-light radiance (0 when not emissive)
ATTR_INV_AREA = 24  # 1/triangle area (area-light pdf base)
ATTR_DIM = 32

# sph_attr packed layout
SATTR_CENTER = 0  # 0:3
SATTR_RADIUS = 3
SATTR_MAT = 4
SATTR_LIGHT = 5
SATTR_EMIT = 6  # 6:9
SATTR_DIM = 16

# mat_attr packed layout (scalar parameters; reflectance texture slot)
MATTR_TAG = 0
MATTR_TEX_KIND = 1
MATTR_TEX_IMAGE = 2
MATTR_UVSCALE = 3  # 3:5
MATTR_UVOFFSET = 5  # 5:7
MATTR_TEX_VALUE = 7  # 7:10
MATTR_ETA = 10
MATTR_EXPONENT = 11
MATTR_ROUGHNESS = 12
MATTR_SUBSURFACE = 13
MATTR_ANISOTROPIC = 14
MATTR_METALLIC = 15
MATTR_SPEC_TRANS = 16
MATTR_SPECULAR = 17
MATTR_SPECULAR_TINT = 18
MATTR_SHEEN = 19
MATTR_SHEEN_TINT = 20
MATTR_CLEARCOAT = 21
MATTR_CLEARCOAT_GLOSS = 22
MATTR_DIM = 24

# light_attr packed layout
LATTR_TAG = 0
LATTR_KIND = 1  # SHAPE_TRI | SHAPE_SPHERE
LATTR_INV_AREA = 2
LATTR_INTENSITY = 3  # 3:6
LATTR_POS = 6  # 6:9 point-light position | sphere center
LATTR_RADIUS = 9  # sphere radius
LATTR_V0 = 10  # 10:13 triangle vertex
LATTR_E1 = 13  # 13:16
LATTR_E2 = 16  # 16:19
LATTR_N0 = 19  # 19:22 corner shading normals (flip reference)
LATTR_N1 = 22  # 22:25
LATTR_N2 = 25  # 25:28
LATTR_DIM = 32


class Hit(NamedTuple):
    """Batched intersection record (intersection.h) as SoA."""

    valid: Any  # [N] bool
    t: Any  # [N]
    pos: Any  # [N, 3]
    geo_n: Any  # [N, 3] always faces the incoming ray (shape.cpp:35,84)
    sh_n: Any  # [N, 3] interpolated shading normal (NOT ray-flipped)
    uv: Any  # [N, 2]
    mat_id: Any  # [N] int32
    light_id: Any  # [N] int32 (-1 = not an emitter)
    front: Any = None  # [N] bool: ray hit the outward-facing side
    emit: Any = None  # [N, 3] area-light radiance at the hit (0 if none)
    light_geom: Any = None  # [N] 1/area for tri lights; -radius for spheres


_GROUPS = ("geometry", "materials", "lights", "textures", "envmap", "bvh")


def float_tables(scene: Scene) -> dict:
    """The scene's floating-point tables keyed by field path
    ("geometry.tri_attr", "bvh.node_min", "envmap.data", "background"):
    the tensors gradients are taken with respect to. Integer tables and
    the derived fields (`compare=False`) are left out."""
    out = {}
    for prefix in _GROUPS:
        group = getattr(scene, prefix)
        if group is None:
            continue
        for f in dataclasses.fields(group):
            x = getattr(group, f.name)
            if f.compare and torch.is_tensor(x) and x.is_floating_point():
                out[f"{prefix}.{f.name}"] = x
    out["background"] = scene.background
    return out


def replace_tables(scene: Scene, tables: dict, drop_rest=False) -> Scene:
    """The scene with the tables at these field paths replaced
    (dataclasses.replace, so the derived fields are kept). With
    `drop_rest`, every other table and derived field becomes None: the
    form of a gradient Scene, whose float tables are gradients."""
    groups = {}
    for prefix in _GROUPS:
        group = getattr(scene, prefix)
        if group is None:
            continue
        new = {}
        for f in dataclasses.fields(group):
            key = f"{prefix}.{f.name}"
            if key in tables:
                new[f.name] = tables[key]
            elif drop_rest and torch.is_tensor(getattr(group, f.name)):
                new[f.name] = None
        groups[prefix] = dataclasses.replace(group, **new)
    background = tables.get("background", None if drop_rest else scene.background)
    return dataclasses.replace(scene, background=background, **groups)


def affine_rows(tri_affine_o, tri_affine_d):
    """The affine maps of `tri_affine_o` [4, 3 Tpad] and `tri_affine_d`
    [3, 3 Tpad] (axis-major) as one row a triangle, [Tpad, 24]: o_u[4],
    o_v[4], o_w[4], d_u[3], d_v[3], d_w[3], 0, 0, 0, contiguous, on the
    tables' device."""
    tpad = tri_affine_o.numel() // 12
    o = tri_affine_o.reshape(4, 3, tpad)  # [row, uvw, tri]
    d = tri_affine_d.reshape(3, 3, tpad)
    return torch.cat(
        [o.permute(2, 1, 0).reshape(tpad, 12), d.permute(2, 1, 0).reshape(tpad, 9), o.new_zeros((tpad, 3))],
        dim=1,
    ).contiguous()


_TABLE_GROUPS = (
    ("geometry", GeometryArrays),
    ("materials", MaterialArrays),
    ("lights", LightArrays),
    ("textures", TextureAtlas),
)


def scene_from_numpy(tables: dict, meta: SceneMeta, device) -> Scene:
    """Build a Scene from numpy tables keyed by field path.

    Keys are "geometry.tri_attr", "bvh.node_min", "envmap.data",
    "lights.attr", ..., and "background", as the JAX package's Scene names
    its fields; the six "bvh." tables, and the seven "envmap." ones, come
    all together or not at all. Floating tables become float32 and integer
    tables int32 on `device` (HOST_TABLES on the CPU). Unknown keys raise
    KeyError. The derived fields (`compare=False`: `geometry.tri_rows` and
    the BVH's kernel layouts) are built here, not read.
    """
    tables = dict(tables)

    def upload(a, key=None):
        a = np.asarray(a)
        dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        return torch.from_numpy(np.array(a, dtype=dtype)).to("cpu" if key in HOST_TABLES else device)

    groups = {}
    for prefix, cls in _TABLE_GROUPS:
        keys = [f"{prefix}.{f.name}" for f in dataclasses.fields(cls) if f.compare]
        groups[prefix] = cls(**{k.split(".")[1]: upload(tables.pop(k), k) for k in keys})
    bvh = None
    if any(key.startswith("bvh.") for key in tables):
        from take_tpu_torch.geometry.bvh import wide_depth
        from take_tpu_torch.geometry.packet import prep_tables

        host = {n: tables.pop(f"bvh.{n}") for n in BVH_TABLES}
        bvh = BVHArrays(**{n: upload(a) for n, a in host.items()})
        bvh.depth = wide_depth(np.asarray(host["node_child"]))
        bvh.nodes, bvh.tris, bvh.qnodes = prep_tables(bvh, groups["geometry"])
    envmap = None
    if any(key.startswith("envmap.") for key in tables):
        envmap = EnvMap(**{f.name: upload(tables.pop(f"envmap.{f.name}")) for f in dataclasses.fields(EnvMap)})
    g = groups["geometry"]
    g.tri_rows = bvh.tris if bvh is not None else affine_rows(g.tri_affine_o, g.tri_affine_d)
    background = upload(tables.pop("background"))
    if tables:
        raise KeyError(f"unknown scene tables: {sorted(tables)}")
    return Scene(background=background, envmap=envmap, bvh=bvh, meta=meta, **groups)


def scene_to(scene: Scene, device) -> Scene:
    """The scene with every table on `device`, the derived layouts
    (`geometry.tri_rows`, `bvh.nodes/tris/qnodes`) too; HOST_TABLES stay on
    the CPU, and where `tri_rows` is `bvh.tris` (BVH scenes) the copy keeps
    them one tensor. `bvh.depth` and `meta` carry over. A table already on
    `device` is not copied. The torch form of take_tpu's shard_scene, which
    replicates the scene onto every device of a mesh."""
    device = torch.device(device)

    def move(prefix, group):
        new = {}
        for f in dataclasses.fields(group):
            x = getattr(group, f.name)
            if torch.is_tensor(x) and f"{prefix}.{f.name}" not in HOST_TABLES:
                new[f.name] = x.to(device)
        return dataclasses.replace(group, **new)

    groups = {p: move(p, getattr(scene, p)) for p in _GROUPS if getattr(scene, p) is not None}
    if scene.bvh is not None and scene.geometry.tri_rows is scene.bvh.tris:
        groups["geometry"].tri_rows = groups["bvh"].tris
    return dataclasses.replace(scene, background=scene.background.to(device), **groups)
