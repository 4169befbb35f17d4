"""Mitsuba `.serialized` meshes (versions 3 and 4): per-shape zlib streams
and an offset table at the end of the file to seek to `shape_index`."""

import struct
import zlib

import numpy as np

from portbench.reference import geometry

_HAS_NORMALS, _HAS_TEXCOORDS, _HAS_COLORS, _DOUBLE = 0x0001, 0x0002, 0x0008, 0x2000


def load(node, parser):
    path, shape_index, to_world, options = parser.shape_args(node)
    with open(path, "rb") as fh:
        raw = fh.read()
    _, version = struct.unpack_from("<HH", raw, 0)
    offset = 4
    if shape_index > 0:
        (count,) = struct.unpack_from("<I", raw, len(raw) - 4)
        if version == 4:
            (offset,) = struct.unpack_from("<Q", raw, len(raw) - 8 * (count - shape_index) - 4)
        else:
            (offset,) = struct.unpack_from("<I", raw, len(raw) - 4 * (count - shape_index + 1))
        offset += 4
    body = zlib.decompressobj().decompress(raw[offset:])
    (flags,) = struct.unpack_from("<I", body, 0)
    at = 4
    if version == 4:
        at = body.index(b"\0", at) + 1  # the shape's name
    n_vert, n_tri = struct.unpack_from("<QQ", body, at)
    at += 16
    prec = np.dtype("<f8" if flags & _DOUBLE else "<f4")

    def take(dtype, count):
        nonlocal at
        out = np.frombuffer(body, dtype, count, at)
        at += dtype.itemsize * count
        return out

    pos = take(prec, 3 * n_vert).reshape(-1, 3).astype(np.float64)
    normals = None
    if flags & _HAS_NORMALS:
        normals = geometry.xform_normals(to_world, take(prec, 3 * n_vert).reshape(-1, 3).astype(np.float64))
    if flags & _HAS_TEXCOORDS:
        take(prec, 2 * n_vert)
    if flags & _HAS_COLORS:
        take(prec, 3 * n_vert)
    indices = take(np.dtype("<i4"), 3 * n_tri).reshape(-1, 3).astype(np.int64)
    return {"positions": geometry.xform_points(to_world, pos), "indices": indices, "normals": normals}
