"""Mitsuba `.serialized` mesh loader (v3/v4), matching parse_serialized.cpp.

Layout: uint16 magic, uint16 version; per-shape zlib streams; EOF offset
table (v3: uint32 entries, v4: uint64 entries; trailing uint32 count) used
to seek to shape_index (parse_serialized.cpp:103-121). Flags word selects
normals/uvs/colors and single/double precision.
"""

import struct
import zlib

import numpy as np

from take_tpu_torch.scene import transforms
from take_tpu_torch.scene.parse_obj import MeshData

_V3 = 0x0003
_V4 = 0x0004

_HAS_NORMALS = 0x0001
_HAS_TEXCOORDS = 0x0002
_HAS_COLORS = 0x0008
_DOUBLE_PRECISION = 0x2000


class _ZReader:
    """Incremental zlib stream over raw bytes (ZStream equivalent)."""

    def __init__(self, data: bytes):
        self._d = zlib.decompressobj()
        self._data = data
        self._pos = 0
        self._buf = b""

    def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            if self._pos >= len(self._data):
                chunk = self._d.flush()
                if not chunk:
                    raise EOFError("serialized: read past end of stream")
                self._buf += chunk
                continue
            take = min(32768, len(self._data) - self._pos)
            self._buf += self._d.decompress(
                self._data[self._pos : self._pos + take]
            )
            self._pos += take
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def read_array(self, dtype, count):
        dt = np.dtype(dtype)
        return np.frombuffer(self.read(dt.itemsize * count), dt)


def parse_serialized(path, shape_index=0, to_world=None) -> MeshData:
    if to_world is None:
        to_world = transforms.identity()
    with open(path, "rb") as fh:
        raw = fh.read()

    magic, version = struct.unpack_from("<HH", raw, 0)
    offset = 4
    if shape_index > 0:
        (count,) = struct.unpack_from("<I", raw, len(raw) - 4)
        if version == _V4:
            table_at = len(raw) - 8 * (count - shape_index) - 4
            (offset,) = struct.unpack_from("<Q", raw, table_at)
        else:
            table_at = len(raw) - 4 * (count - shape_index + 1)
            (offset,) = struct.unpack_from("<I", raw, table_at)
        offset += 4  # skip the per-shape header (2x uint16)

    zs = _ZReader(raw[offset:])
    (flags,) = struct.unpack("<I", zs.read(4))
    if version == _V4:
        # null-terminated shape name
        while zs.read(1) != b"\0":
            pass
    (vertex_count,) = struct.unpack("<Q", zs.read(8))
    (triangle_count,) = struct.unpack("<Q", zs.read(8))

    prec = "<f8" if flags & _DOUBLE_PRECISION else "<f4"
    mesh = MeshData()
    pos = zs.read_array(prec, vertex_count * 3).reshape(-1, 3).astype(np.float64)
    mesh.positions = transforms.xform_points(to_world, pos)
    if flags & _HAS_NORMALS:
        nrm = zs.read_array(prec, vertex_count * 3).reshape(-1, 3)
        mesh.normals = transforms.xform_normals(to_world, nrm.astype(np.float64))
    if flags & _HAS_TEXCOORDS:
        mesh.uvs = (
            zs.read_array(prec, vertex_count * 2).reshape(-1, 2).astype(np.float64)
        )
    if flags & _HAS_COLORS:
        zs.read_array(prec, vertex_count * 3)  # parsed and discarded
    mesh.indices = (
        zs.read_array("<i4", triangle_count * 3).reshape(-1, 3).astype(np.int64)
    )
    return mesh


def write_serialized(path, positions, indices, normals=None, uvs=None,
                     version=_V4, name=b"mesh"):
    """Writer (used by tests to round-trip the reader; single shape)."""
    flags = 0
    if normals is not None:
        flags |= _HAS_NORMALS
    if uvs is not None:
        flags |= _HAS_TEXCOORDS
    body = struct.pack("<I", flags)
    if version == _V4:
        body += name + b"\0"
    body += struct.pack("<QQ", len(positions), len(indices))
    body += np.asarray(positions, "<f4").tobytes()
    if normals is not None:
        body += np.asarray(normals, "<f4").tobytes()
    if uvs is not None:
        body += np.asarray(uvs, "<f4").tobytes()
    body += np.asarray(indices, "<i4").tobytes()
    comp = zlib.compress(body)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<HH", 0x041C, version))
        fh.write(comp)
        if version == _V4:
            fh.write(struct.pack("<Q", 0))
        else:
            fh.write(struct.pack("<I", 0))
        fh.write(struct.pack("<I", 1))
