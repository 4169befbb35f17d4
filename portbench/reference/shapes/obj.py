"""Wavefront OBJ: v/vt/vn/f with negative indices, triangles and quads
(split as [v0, v1, v2] + [v0, v2, v3]); vertices deduplicated on the
(v, vt, vn) triple, as Mitsuba's loader and the tracer's do."""

import numpy as np

from portbench.reference import geometry


def _corner(tok, n_pos, n_nor):
    parts = tok.split("/")
    v = int(parts[0])
    vn = -1
    if len(parts) > 2 and parts[2]:
        vn = int(parts[2])
        vn = vn - 1 if vn > 0 else n_nor + vn
    vt = parts[1] if len(parts) > 1 else ""
    return (v - 1 if v > 0 else n_pos + v, vt, vn)


def load(node, parser):
    path, shape_index, to_world, options = parser.shape_args(node)
    pos_pool, nor_pool, vertex_map = [], [], {}
    out_pos, out_nor, out_idx = [], [], []

    def vertex_id(key):
        if key not in vertex_map:
            vertex_map[key] = len(out_pos)
            out_pos.append(pos_pool[key[0]])
            if key[2] >= 0:
                out_nor.append(nor_pool[key[2]])
        return vertex_map[key]

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                w = float(tok[4]) if len(tok) > 4 else 1.0
                pos_pool.append((float(tok[1]) / w, float(tok[2]) / w, float(tok[3]) / w))
            elif tok[0] == "vn":
                n = np.array([float(x) for x in tok[1:4]])
                nor_pool.append(n / np.linalg.norm(n))
            elif tok[0] == "f":
                if len(tok) > 5:
                    raise ValueError(f"{path}: faces of more than 4 vertices")
                keys = [_corner(t, len(pos_pool), len(nor_pool)) for t in tok[1:]]
                ids = [vertex_id(k) for k in keys[:3]]
                out_idx.append(ids)
                if len(keys) == 4:
                    out_idx.append([ids[0], ids[2], vertex_id(keys[3])])
    normals = None
    if out_nor and len(out_nor) == len(out_pos):
        normals = geometry.xform_normals(to_world, np.asarray(out_nor, np.float64))
    return {"positions": geometry.xform_points(to_world, np.asarray(out_pos, np.float64)),
            "indices": np.asarray(out_idx, np.int64), "normals": normals}
