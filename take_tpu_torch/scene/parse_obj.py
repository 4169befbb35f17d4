"""Wavefront OBJ loader, behavior-matched to parse_obj.cpp.

Supports v/vt/vn/f with negative indices, triangles + quads (quad split as
[v0,v1,v2] + [v0,v2,v3]); n-gons error. vt is flipped to 1-t at load
(parse_obj.cpp:138); positions/normals transformed by to_world at load.
Vertices are deduplicated on the (v, vt, vn) triple.
"""

import numpy as np

from take_tpu_torch.scene import transforms


class MeshData:
    def __init__(self):
        self.positions = None  # [V, 3]
        self.indices = None  # [F, 3]
        self.normals = None  # [V, 3] or None
        self.uvs = None  # [V, 2] or None


def _face_indices(tok, n_pos, n_uv, n_nor):
    """Parse 'v', 'v/vt', 'v//vn', 'v/vt/vn' with 1-based/negative indices."""
    parts = tok.split("/")
    v = int(parts[0])
    v = v - 1 if v > 0 else n_pos + v
    vt = vn = -1
    if len(parts) > 1 and parts[1]:
        vt = int(parts[1])
        vt = vt - 1 if vt > 0 else n_uv + vt
    if len(parts) > 2 and parts[2]:
        vn = int(parts[2])
        vn = vn - 1 if vn > 0 else n_nor + vn
    return (v, vt, vn)


def parse_obj(path, to_world=None) -> MeshData:
    if to_world is None:
        to_world = transforms.identity()
    pos_pool, uv_pool, nor_pool = [], [], []
    vertex_map = {}
    out_pos, out_uv, out_nor, out_idx = [], [], [], []

    def vertex_id(key):
        if key in vertex_map:
            return vertex_map[key]
        vid = len(out_pos)
        v, vt, vn = key
        out_pos.append(pos_pool[v])
        if vt >= 0:
            out_uv.append(uv_pool[vt])
        if vn >= 0:
            out_nor.append(nor_pool[vn])
        vertex_map[key] = vid
        return vid

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if tok[0] == "v":
                x, y, z = float(tok[1]), float(tok[2]), float(tok[3])
                w = float(tok[4]) if len(tok) > 4 else 1.0
                pos_pool.append((x / w, y / w, z / w))
            elif tok[0] == "vt":
                s, t = float(tok[1]), float(tok[2])
                uv_pool.append((s, 1.0 - t))  # flip (parse_obj.cpp:138)
            elif tok[0] == "vn":
                n = np.array([float(tok[1]), float(tok[2]), float(tok[3])])
                nor_pool.append(n / np.linalg.norm(n))
            elif tok[0] == "f":
                if len(tok) > 5:
                    raise ValueError(
                        f"{path}: n-gon (n>4) faces are not supported"
                    )
                keys = [
                    _face_indices(t, len(pos_pool), len(uv_pool), len(nor_pool))
                    for t in tok[1:]
                ]
                ids = [vertex_id(k) for k in keys[:3]]
                out_idx.append(ids)
                if len(keys) == 4:
                    out_idx.append([ids[0], ids[2], vertex_id(keys[3])])

    mesh = MeshData()
    mesh.positions = transforms.xform_points(
        to_world, np.asarray(out_pos, np.float64)
    )
    mesh.indices = np.asarray(out_idx, np.int64)
    if out_uv and len(out_uv) == len(out_pos):
        mesh.uvs = np.asarray(out_uv, np.float64)
    if out_nor and len(out_nor) == len(out_pos):
        mesh.normals = transforms.xform_normals(
            to_world, np.asarray(out_nor, np.float64)
        )
    return mesh
