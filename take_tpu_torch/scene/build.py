"""Host-side scene construction: accumulate shapes/materials/lights in numpy,
then freeze into a device `Scene` (port of take_tpu/scene/build.py).

The numpy packing is take_tpu's SceneBuilder's, step for step, so both packages
build identical tables from the same calls; `build` then uploads every table
once, as float32 or int32, to the requested device. Responsibilities
mirrored from the reference:

  * one `DiffuseAreaLight` per emissive mesh face (parse_scene.cpp:937-945),
  * angle-weighted vertex normals when a mesh has none (compute_normals.cpp),
  * light power PMF/CDF, power = luminance * area * pi (light.cpp:25-30).
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from take_tpu_torch import tracing
from take_tpu_torch.core.camera import Camera
from take_tpu_torch.geometry import bvh as B
from take_tpu_torch.scene import types as T
from take_tpu_torch.scene.compute_normals import compute_vertex_normals

# Above this many primitives take_tpu's "auto" rule builds a BVH.
BVH_AUTO_MIN = 256


@dataclass
class _Mat:
    tag: int
    tex_kind: int = T.TEX_CONST
    tex_value: tuple = (0.5, 0.5, 0.5)
    tex_image: int = 0
    tex_uvscale: tuple = (1.0, 1.0)
    tex_uvoffset: tuple = (0.0, 0.0)
    eta: float = 1.0
    exponent: float = 1.0
    roughness: float = 0.0
    subsurface: float = 0.0
    anisotropic: float = 0.0
    metallic: float = 0.0
    spec_trans: float = 0.0
    specular: float = 0.5
    specular_tint: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.5
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0


def _pack_triangles(np_tri, Tpad):
    """Host numpy triangle tables + the per-triangle affine intersection maps
    (geometry/brute.py), their supercluster granules (geometry/cluster.py)
    and the packed attribute rows."""
    tables = dict(np_tri)
    v0 = np_tri["tri_v0"]
    e1 = np_tri["tri_e1"]
    e2 = np_tri["tri_e2"]
    nrm = np.cross(e1, e2)
    basis = np.stack([e1, e2, nrm], axis=-1)  # [T, 3, 3] columns
    det = np.linalg.det(basis)
    ok = np.abs(det) > 1e-18
    safe = np.where(ok[:, None, None], basis, np.eye(3)[None])
    Minv = np.linalg.inv(safe) * ok[:, None, None]  # [T, 3, 3]
    # axis-major packing: column j = k * Tpad + t holds row k of tri t
    aff_o = np.zeros((4, 3 * Tpad))
    aff_d = np.zeros((3, 3 * Tpad))
    for k in range(3):
        cols = slice(k * Tpad, (k + 1) * Tpad)
        aff_d[:, cols] = Minv[:, k, :].T  # [3, T]
        aff_o[:3, cols] = Minv[:, k, :].T
        aff_o[3, cols] = -np.einsum("tj,tj->t", Minv[:, k, :], v0)
    # transposed per-supercluster granules of the same operands: rows
    # sup * 24 + j hold operand j of the supercluster's 512 triangles, padded
    # with all-zero columns (rejected as parallel) to the GROUP multiple of
    # the sup_aabb table, so every supercluster id of that table has one
    supt = B.SUP * B.CLUSTER_K
    n_sup_valid = B.cluster_pad(Tpad) // B.SUP
    n_sup = max(B.GROUP, -(-n_sup_valid // B.GROUP) * B.GROUP)
    ops = np.zeros((24, n_sup * supt))
    for k in range(3):
        cols = slice(k * Tpad, (k + 1) * Tpad)
        ops[4 * k : 4 * k + 4, :Tpad] = aff_o[:, cols]
        ops[12 + 3 * k : 15 + 3 * k, :Tpad] = aff_d[:, cols]
    sweep = ops.reshape(24, n_sup, supt).transpose(1, 0, 2).reshape(n_sup * 24, supt)
    nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
    geo_n = nrm / np.where(nlen > 0, nlen, 1.0)
    attr = np.zeros((Tpad, T.ATTR_DIM))
    attr[:, T.ATTR_GEO_N : T.ATTR_GEO_N + 3] = geo_n
    attr[:, T.ATTR_N0 : T.ATTR_N0 + 3] = np_tri["tri_n0"]
    attr[:, T.ATTR_N1 : T.ATTR_N1 + 3] = np_tri["tri_n1"]
    attr[:, T.ATTR_N2 : T.ATTR_N2 + 3] = np_tri["tri_n2"]
    attr[:, T.ATTR_UV0 : T.ATTR_UV0 + 2] = np_tri["tri_uv0"]
    attr[:, T.ATTR_UV1 : T.ATTR_UV1 + 2] = np_tri["tri_uv1"]
    attr[:, T.ATTR_UV2 : T.ATTR_UV2 + 2] = np_tri["tri_uv2"]
    attr[:, T.ATTR_MAT] = np_tri["tri_mat"]
    attr[:, T.ATTR_LIGHT] = np_tri["tri_light"]
    attr[:, T.ATTR_FLAGS] = np_tri["tri_flags"]
    attr[:, T.ATTR_EMIT : T.ATTR_EMIT + 3] = np_tri["tri_emit"]
    area = 0.5 * np.linalg.norm(nrm, axis=-1)
    attr[:, T.ATTR_INV_AREA] = np.where(area > 0, 1.0 / np.maximum(area, 1e-30), 0.0)
    tables["tri_affine_o"] = aff_o
    tables["tri_affine_d"] = aff_d
    tables["tri_sweep"] = sweep
    tables["tri_attr"] = attr
    tables.pop("tri_emit")
    return tables


class SceneBuilder:
    """Accumulates scene content host-side; `.build()` freezes to a Scene."""

    def __init__(self):
        self._tris: List[tuple] = []  # (v0, e1, e2, n0..2, uv0..2, mat, light, flags)
        self._spheres: List[tuple] = []  # (center, radius, mat, light)
        self._materials: List[_Mat] = []
        self._lights: List[dict] = []
        self._textures: List[np.ndarray] = []
        self._texture_names = {}
        self.camera: Optional[Camera] = None
        self.background = np.array([0.5, 0.5, 0.5], np.float64)
        self.envmap = None  # numpy tables from lights/envmap.py::build_envmap
        self.spp = 4
        self.output_filename = "image.exr"

    # -- materials ---------------------------------------------------------

    def add_material(self, tag, **params) -> int:
        self._materials.append(_Mat(tag=tag, **params))
        return len(self._materials) - 1

    def add_texture_image(self, img: np.ndarray, name=None) -> int:
        """Register an image (H, W, 3 float, linear) and return its atlas id."""
        if name is not None and name in self._texture_names:
            return self._texture_names[name]
        tex_id = len(self._textures)
        self._textures.append(np.asarray(img, np.float32))
        if name is not None:
            self._texture_names[name] = tex_id
        return tex_id

    # -- shapes ------------------------------------------------------------

    def add_sphere(self, center, radius, material_id, emission=None) -> None:
        light_id = -1
        if emission is not None:
            light_id = len(self._lights)
            self._lights.append(
                dict(
                    tag=T.LIGHT_AREA,
                    intensity=np.asarray(emission, np.float64),
                    shape_kind=T.SHAPE_SPHERE,
                    shape_idx=len(self._spheres),
                    area=4.0 * np.pi * radius * radius,
                )
            )
        self._spheres.append(
            (np.asarray(center, np.float64), float(radius), material_id, light_id)
        )

    def add_mesh(
        self,
        positions,
        indices,
        material_id,
        normals=None,
        uvs=None,
        emission=None,
        face_normals=False,
    ) -> None:
        """Add a triangle mesh; one area light per face if emissive.

        positions [V,3], indices [F,3] int, normals [V,3] or None,
        uvs [V,2] or None. When normals is None and face_normals is False,
        angle-weighted vertex normals are computed (parse_scene.cpp:828-834).
        """
        positions = np.asarray(positions, np.float64)
        indices = np.asarray(indices, np.int64)
        if normals is None and not face_normals:
            normals = compute_vertex_normals(positions, indices)
        has_normals = normals is not None
        has_uv = uvs is not None
        flags = (T.TRI_HAS_NORMALS if has_normals else 0) | (
            T.TRI_HAS_UV if has_uv else 0
        )
        zero2 = np.zeros(2)
        zero3 = np.zeros(3)
        for f in range(indices.shape[0]):
            i0, i1, i2 = indices[f]
            v0, v1, v2 = positions[i0], positions[i1], positions[i2]
            light_id = -1
            if emission is not None:
                light_id = len(self._lights)
                area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0))
                self._lights.append(
                    dict(
                        tag=T.LIGHT_AREA,
                        intensity=np.asarray(emission, np.float64),
                        shape_kind=T.SHAPE_TRI,
                        shape_idx=len(self._tris),
                        area=area,
                    )
                )
            n = (
                (normals[i0], normals[i1], normals[i2])
                if has_normals
                else (zero3, zero3, zero3)
            )
            uv = (uvs[i0], uvs[i1], uvs[i2]) if has_uv else (zero2, zero2, zero2)
            self._tris.append(
                (v0, v1 - v0, v2 - v0, *n, *uv, material_id, light_id, flags)
            )

    def add_point_light(self, position, intensity) -> None:
        """Point light, sampled by NEE (the reference parses but ignores
        them, parse_scene.cpp:723)."""
        self._lights.append(
            dict(
                tag=T.LIGHT_POINT,
                intensity=np.asarray(intensity, np.float64),
                position=np.asarray(position, np.float64),
            )
        )

    # -- freeze ------------------------------------------------------------

    def build_tables(self, build_bvh="auto"):
        """Pack every table in host numpy, as take_tpu's SceneBuilder does.

        Returns (tables, meta): numpy tables (floating or integer; the
        upload casts them to float32/int32) keyed by field path
        ("geometry.tri_attr", "bvh.node_min", "envmap.data", ...) and the static
        SceneMeta. With build_bvh (or "auto" above BVH_AUTO_MIN
        primitives) the wide BVH is built and the triangle rows are
        reordered into its leaf order before anything is packed.
        """
        n_tri = len(self._tris)
        n_sph = len(self._spheres)
        n_lights = len(self._lights)
        n_tex = len(self._textures)
        if build_bvh == "auto":
            build_bvh = n_tri + n_sph > BVH_AUTO_MIN

        def pad_rows(a, n_target):
            a = np.asarray(a, np.float64)
            if a.ndim == 1:
                a = a[:, None]
            out = np.zeros((n_target,) + a.shape[1:], a.dtype)
            out[: a.shape[0]] = a
            return out

        def pad_int(a, n_target, fill=0):
            out = np.full(n_target, fill, np.int64)
            out[: len(a)] = a
            return out

        # --- geometry --- (tables pad to a multiple of 128 rows like the
        # take_tpu's; inert rows are masked by meta.n_tri / n_sph)
        Tpad = max(128, -(-n_tri // 128) * 128)
        if n_tri:
            cols = list(zip(*self._tris))
        else:
            cols = [[np.zeros(3)]] * 6 + [[np.zeros(2)]] * 3 + [[0], [-1], [0]]
        np_tri = dict(
            tri_v0=pad_rows(np.stack(cols[0]), Tpad),
            tri_e1=pad_rows(np.stack(cols[1]), Tpad),
            tri_e2=pad_rows(np.stack(cols[2]), Tpad),
            tri_n0=pad_rows(np.stack(cols[3]), Tpad),
            tri_n1=pad_rows(np.stack(cols[4]), Tpad),
            tri_n2=pad_rows(np.stack(cols[5]), Tpad),
            tri_uv0=pad_rows(np.stack(cols[6]), Tpad),
            tri_uv1=pad_rows(np.stack(cols[7]), Tpad),
            tri_uv2=pad_rows(np.stack(cols[8]), Tpad),
            tri_mat=pad_int(cols[9], Tpad),
            tri_light=pad_int(cols[10], Tpad, fill=-1),
            tri_flags=pad_int(cols[11], Tpad),
        )
        emit = np.zeros((Tpad, 3))
        for t_idx, tri in enumerate(self._tris):
            lid = tri[10]
            if lid >= 0:
                emit[t_idx] = self._lights[lid]["intensity"]
        np_tri["tri_emit"] = emit

        # --- BVH: built on the host, then the triangle rows are permuted
        # into leaf order (padding rows keep their places) ---
        bvh_tables = {}
        if build_bvh and n_tri > 0:
            p0 = np_tri["tri_v0"][:n_tri]
            p1 = p0 + np_tri["tri_e1"][:n_tri]
            p2 = p0 + np_tri["tri_e2"][:n_tri]
            bmin = np.minimum(np.minimum(p0, p1), p2)
            bmax = np.maximum(np.maximum(p0, p1), p2)
            with tracing.span("take.scene.bvh"):
                node_min, node_max, node_child, node_count, order = B.build_bvh(bmin, bmax)
                perm = np.arange(Tpad)
                perm[:n_tri] = order
                np_tri = {k: v[perm] for k, v in np_tri.items()}
                cl_aabb, sup_aabb = B.cluster_aabbs(bmin[order], bmax[order], n_tri)
            bvh_tables = dict(zip(
                (f"bvh.{n}" for n in T.BVH_TABLES),
                (node_min, node_max, node_child, node_count, cl_aabb, sup_aabb),
            ))
        tables = {f"geometry.{k}": v for k, v in _pack_triangles(np_tri, Tpad).items()}
        tables.update(bvh_tables)

        Spad = max(8, -(-max(n_sph, 1) // 8) * 8)
        if n_sph:
            sc = np.stack([s[0] for s in self._spheres])
            sr = np.array([s[1] for s in self._spheres])
            sm = np.array([s[2] for s in self._spheres])
            sl = np.array([s[3] for s in self._spheres])
        else:
            sc, sr = np.zeros((1, 3)), np.array([-1.0])
            sm, sl = np.array([0]), np.array([-1])
        sph_attr = np.zeros((Spad, T.SATTR_DIM))
        sph_attr[:, T.SATTR_CENTER : T.SATTR_CENTER + 3] = pad_rows(sc, Spad)
        sph_attr[:, T.SATTR_RADIUS] = pad_rows(sr, Spad)[:, 0]
        sph_attr[:, T.SATTR_MAT] = pad_int(sm, Spad)
        sph_attr[:, T.SATTR_LIGHT] = pad_int(sl, Spad, fill=-1)
        for s_idx, s in enumerate(self._spheres):
            if s[3] >= 0:
                sph_attr[s_idx, T.SATTR_EMIT : T.SATTR_EMIT + 3] = self._lights[
                    s[3]
                ]["intensity"]
        tables["geometry.sph_center"] = pad_rows(sc, Spad)
        tables["geometry.sph_radius"] = pad_rows(sr, Spad)[:, 0]
        tables["geometry.sph_mat"] = pad_int(sm, Spad)
        tables["geometry.sph_light"] = pad_int(sl, Spad, fill=-1)
        tables["geometry.sph_attr"] = sph_attr

        # --- materials ---
        mats = self._materials or [_Mat(tag=T.MAT_DIFFUSE)]
        Mpad = max(8, -(-len(mats) // 8) * 8)
        mat_attr = np.zeros((Mpad, T.MATTR_DIM))
        for k, m in enumerate(mats):
            mat_attr[k, T.MATTR_TAG] = m.tag
            mat_attr[k, T.MATTR_TEX_KIND] = m.tex_kind
            mat_attr[k, T.MATTR_TEX_IMAGE] = m.tex_image
            mat_attr[k, T.MATTR_UVSCALE : T.MATTR_UVSCALE + 2] = m.tex_uvscale
            mat_attr[k, T.MATTR_UVOFFSET : T.MATTR_UVOFFSET + 2] = m.tex_uvoffset
            mat_attr[k, T.MATTR_TEX_VALUE : T.MATTR_TEX_VALUE + 3] = m.tex_value
            for col, name in (
                (T.MATTR_ETA, "eta"), (T.MATTR_EXPONENT, "exponent"),
                (T.MATTR_ROUGHNESS, "roughness"),
                (T.MATTR_SUBSURFACE, "subsurface"),
                (T.MATTR_ANISOTROPIC, "anisotropic"),
                (T.MATTR_METALLIC, "metallic"),
                (T.MATTR_SPEC_TRANS, "spec_trans"),
                (T.MATTR_SPECULAR, "specular"),
                (T.MATTR_SPECULAR_TINT, "specular_tint"),
                (T.MATTR_SHEEN, "sheen"), (T.MATTR_SHEEN_TINT, "sheen_tint"),
                (T.MATTR_CLEARCOAT, "clearcoat"),
                (T.MATTR_CLEARCOAT_GLOSS, "clearcoat_gloss"),
            ):
                mat_attr[k, col] = getattr(m, name)
        tables["materials.tag"] = np.array([m.tag for m in mats], np.int64)
        tables["materials.attr"] = mat_attr

        # --- lights: power pmf/cdf (light.cpp:25-30: lum * area * pi) ---
        if n_lights:
            tag = np.array([l["tag"] for l in self._lights])
            intensity = np.stack([l["intensity"] for l in self._lights])
            area = np.array([l.get("area", 0.0) for l in self._lights])
            lum = (
                intensity[:, 0] * 0.212671
                + intensity[:, 1] * 0.715160
                + intensity[:, 2] * 0.072169
            )
            power = np.where(tag == T.LIGHT_AREA, lum * area * np.pi, lum * 4 * np.pi)
            total = power.sum()
            pmf = power / total if total > 0 else np.full(n_lights, 1.0 / n_lights)
            cdf = np.cumsum(pmf)
        else:
            tag = np.array([T.LIGHT_POINT])
            pmf = np.ones(1)
            cdf = np.ones(1)
        # packed per-light sampling operands, shape geometry resolved now
        Lpad = max(8, -(-max(n_lights, 1) // 8) * 8)
        lattr = np.zeros((Lpad, T.LATTR_DIM))
        for li, l in enumerate(self._lights):
            lattr[li, T.LATTR_TAG] = l["tag"]
            lattr[li, T.LATTR_INTENSITY : T.LATTR_INTENSITY + 3] = l["intensity"]
            if l["tag"] == T.LIGHT_POINT:
                lattr[li, T.LATTR_POS : T.LATTR_POS + 3] = l["position"]
                continue
            lattr[li, T.LATTR_KIND] = l["shape_kind"]
            lattr[li, T.LATTR_INV_AREA] = 1.0 / max(l["area"], 1e-30)
            si = l["shape_idx"]
            if l["shape_kind"] == T.SHAPE_TRI:
                tri = self._tris[si]
                lattr[li, T.LATTR_V0 : T.LATTR_V0 + 3] = tri[0]
                lattr[li, T.LATTR_E1 : T.LATTR_E1 + 3] = tri[1]
                lattr[li, T.LATTR_E2 : T.LATTR_E2 + 3] = tri[2]
                lattr[li, T.LATTR_N0 : T.LATTR_N0 + 3] = tri[3]
                lattr[li, T.LATTR_N1 : T.LATTR_N1 + 3] = tri[4]
                lattr[li, T.LATTR_N2 : T.LATTR_N2 + 3] = tri[5]
            else:
                sph = self._spheres[si]
                lattr[li, T.LATTR_POS : T.LATTR_POS + 3] = sph[0]
                lattr[li, T.LATTR_RADIUS] = sph[1]
        tables["lights.tag"] = np.asarray(tag, np.int64)
        tables["lights.power_pmf"] = pmf
        tables["lights.power_cdf"] = cdf
        tables["lights.attr"] = lattr

        # --- texture atlas (pad to common extent) ---
        if n_tex:
            hmax = max(t.shape[0] for t in self._textures)
            wmax = max(t.shape[1] for t in self._textures)
            data = np.zeros((n_tex, hmax, wmax, 3), np.float32)
            w_arr, h_arr = [], []
            for k, t in enumerate(self._textures):
                data[k, : t.shape[0], : t.shape[1]] = t[..., :3]
                h_arr.append(t.shape[0])
                w_arr.append(t.shape[1])
        else:
            data, w_arr, h_arr = np.zeros((1, 1, 1, 3)), [1], [1]
        tables["textures.data"] = data
        tables["textures.width"] = np.asarray(w_arr, np.int64)
        tables["textures.height"] = np.asarray(h_arr, np.int64)
        tables["background"] = np.asarray(self.background, np.float64)
        if self.envmap is not None:  # lights/envmap.py::build_envmap's tables
            tables.update({f"envmap.{k}": v for k, v in self.envmap.items()})

        meta = T.SceneMeta(
            n_tri=n_tri,
            n_sph=n_sph,
            n_mat=len(mats),
            n_lights=n_lights,
            n_tex=n_tex,
            used_material_tags=tuple(sorted({m.tag for m in mats})),
            has_image_textures=any(m.tex_kind == T.TEX_IMAGE for m in mats),
            has_envmap=self.envmap is not None,
            has_area_lights=any(l["tag"] == T.LIGHT_AREA for l in self._lights),
            has_point_lights=any(l["tag"] == T.LIGHT_POINT for l in self._lights),
            any_uv=any(t[11] & T.TRI_HAS_UV for t in self._tris),
            any_normals=any(t[11] & T.TRI_HAS_NORMALS for t in self._tris),
            camera=self.camera,
            has_background=bool(np.any(np.asarray(self.background) != 0.0)),
        )
        return tables, meta

    def build(self, device="cuda", build_bvh="auto") -> T.Scene:
        """Pack the tables (`build_tables`) and upload them once to `device`:
        the card unless the caller asks for "cpu" (no fallback without one)."""
        tables, meta = self.build_tables(build_bvh)
        return T.scene_from_numpy(tables, meta, device)
