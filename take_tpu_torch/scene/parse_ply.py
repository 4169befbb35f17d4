"""PLY mesh loader (ascii + binary little/big endian), matching the
capabilities the reference gets from tinyply (parse_ply.cpp:84-120):
positions float/double, optional per-vertex nx/ny/nz and u/v (or s/t),
face indices of any integer width. Transforms applied at load.
"""

import numpy as np

from take_tpu_torch.scene import transforms
from take_tpu_torch.scene.parse_obj import MeshData

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def parse_ply(path, to_world=None) -> MeshData:
    if to_world is None:
        to_world = transforms.identity()
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ('list', ct, dt, name)])
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append(
                        ("list", _DTYPES[tok[2]], _DTYPES[tok[3]], tok[4])
                    )
                else:
                    elements[-1][2].append((tok[2], _DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        data = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [fh.readline().split() for _ in range(count)]
                if any(p[0] == "list" for p in props):
                    lists = []
                    for r in rows:
                        n = int(r[0])
                        lists.append([int(x) for x in r[1 : 1 + n]])
                    data[name] = {"__list__": lists}
                else:
                    arr = np.array(rows, np.float64)
                    data[name] = {
                        p[0]: arr[:, i] for i, p in enumerate(props)
                    }
            else:
                if any(p[0] == "list" for p in props):
                    # general case: parse row by row (counts may vary)
                    lists = []
                    scalars = {p[0]: [] for p in props if p[0] != "list"}
                    for _ in range(count):
                        for p in props:
                            if p[0] == "list":
                                cdt = np.dtype(endian + p[1])
                                n = int(
                                    np.frombuffer(fh.read(cdt.itemsize), cdt)[0]
                                )
                                idt = np.dtype(endian + p[2])
                                vals = np.frombuffer(
                                    fh.read(idt.itemsize * n), idt
                                )
                                lists.append(vals.astype(np.int64))
                            else:
                                dt = np.dtype(endian + p[1])
                                scalars[p[0]].append(
                                    np.frombuffer(fh.read(dt.itemsize), dt)[0]
                                )
                    d = {"__list__": lists}
                    d.update(
                        {k: np.asarray(v, np.float64) for k, v in scalars.items()}
                    )
                    data[name] = d
                else:
                    dt = np.dtype(
                        [(p[0], endian + p[1]) for p in props]
                    )
                    arr = np.frombuffer(fh.read(dt.itemsize * count), dt)
                    data[name] = {
                        p[0]: arr[p[0]].astype(np.float64) for p in props
                    }

    v = data["vertex"]
    mesh = MeshData()
    mesh.positions = transforms.xform_points(
        to_world, np.stack([v["x"], v["y"], v["z"]], axis=-1)
    )
    if all(k in v for k in ("nx", "ny", "nz")):
        mesh.normals = transforms.xform_normals(
            to_world, np.stack([v["nx"], v["ny"], v["nz"]], axis=-1)
        )
    for ukey, vkey in (("u", "v"), ("s", "t")):
        if ukey in v and vkey in v:
            mesh.uvs = np.stack([v[ukey], v[vkey]], axis=-1)
            break

    faces = data["face"]["__list__"]
    idx = []
    for f in faces:
        for k in range(1, len(f) - 1):  # fan-triangulate
            idx.append([f[0], f[k], f[k + 1]])
    mesh.indices = np.asarray(idx, np.int64)
    return mesh
