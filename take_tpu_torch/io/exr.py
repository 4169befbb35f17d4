"""Minimal OpenEXR scanline codec (numpy + zlib).

Covers what the reference tool-chain produces/consumes via tinyexr
(image.cpp:135-177: fp16 RGB, ZIP compression — NONE for tiny images) so
golden images can round-trip without external EXR bindings:
  * read: NONE / ZIP / ZIPS compression, HALF / FLOAT channels,
  * write: HALF RGB with ZIP (16-scanline blocks).
"""

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76

_PT_UINT = 0
_PT_HALF = 1
_PT_FLOAT = 2

_COMP_NONE = 0
_COMP_RLE = 1
_COMP_ZIPS = 2
_COMP_ZIP = 3


def _attr(name, typ, payload):
    return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(payload)) + payload


def _channel_entry(name, pixel_type):
    return (
        name.encode()
        + b"\0"
        + struct.pack("<i", pixel_type)
        + b"\0\0\0\0"  # pLinear + reserved
        + struct.pack("<ii", 1, 1)  # x/y sampling
    )


def _zip_compress(raw: bytes) -> bytes:
    """EXR ZIP pre-processing: split-interleave then delta encode, deflate."""
    arr = np.frombuffer(raw, np.uint8)
    n = arr.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = arr[0::2]
    out[half:] = arr[1::2]
    d = out.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + 128
    return zlib.compress(d.astype(np.uint8).tobytes())


def _zip_decompress(data: bytes, expected: int) -> bytes:
    raw = zlib.decompress(data)
    arr = np.frombuffer(raw, np.uint8).astype(np.int16)
    arr[1:] -= 128
    recon = np.cumsum(arr, dtype=np.int64).astype(np.uint8)
    n = recon.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = recon[:half]
    out[1::2] = recon[half:]
    return out.tobytes()[:expected]


def write_exr(path, image: np.ndarray) -> None:
    """Write [H, W, 3] float image as fp16 RGB, ZIP scanline EXR."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    half = img.astype(np.float16)

    channels = b"".join(_channel_entry(c, _PT_HALF) for c in ("B", "G", "R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            struct.pack("<I", _MAGIC),
            struct.pack("<I", 2),  # version 2, scanline
            _attr("channels", "chlist", channels),
            _attr("compression", "compression", bytes([_COMP_ZIP])),
            _attr("dataWindow", "box2i", box),
            _attr("displayWindow", "box2i", box),
            _attr("lineOrder", "lineOrder", bytes([0])),
            _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
            _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ]
    )

    lines_per_block = 16
    nblocks = (h + lines_per_block - 1) // lines_per_block
    chunks = []
    for b in range(nblocks):
        y0 = b * lines_per_block
        y1 = min(y0 + lines_per_block, h)
        rows = []
        for y in range(y0, y1):
            # channel order B, G, R within each scanline
            rows.append(half[y, :, 2].tobytes())
            rows.append(half[y, :, 1].tobytes())
            rows.append(half[y, :, 0].tobytes())
        raw = b"".join(rows)
        comp = _zip_compress(raw)
        if len(comp) >= len(raw):
            comp = raw
        chunks.append(struct.pack("<ii", y0, len(comp)) + comp)

    offset_table_size = 8 * nblocks
    base = len(header) + offset_table_size
    offsets = []
    pos = base
    for c in chunks:
        offsets.append(pos)
        pos += len(c)

    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(struct.pack("<%dQ" % nblocks, *offsets))
        for c in chunks:
            fh.write(c)


def read_exr(path):
    """Read a scanline EXR into [H, W, C] float32 (C follows R,G,B[,A] order
    when those channels exist, else file order)."""
    with open(path, "rb") as fh:
        data = fh.read()
    magic, version = struct.unpack_from("<Ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    pos = 8

    attrs = {}
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        end = data.index(b"\0", pos)
        typ = data[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (typ, data[pos : pos + size])
        pos += size
    pos += 1  # header terminator

    # channels
    chl = attrs["channels"][1]
    channels = []
    cp = 0
    while chl[cp] != 0:
        end = chl.index(b"\0", cp)
        cname = chl[cp:end].decode()
        cp = end + 1
        (ptype,) = struct.unpack_from("<i", chl, cp)
        cp += 16  # ptype + pLinear/reserved + samplings
        channels.append((cname, ptype))
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w = x1 - x0 + 1
    h = y1 - y0 + 1

    if comp == _COMP_NONE:
        lines_per_block = 1
    elif comp == _COMP_ZIPS:
        lines_per_block = 1
    elif comp == _COMP_ZIP:
        lines_per_block = 16
    else:
        raise ValueError(f"{path}: unsupported compression {comp}")

    nblocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from("<%dQ" % nblocks, data, pos)

    dtypes = {_PT_HALF: np.float16, _PT_FLOAT: np.float32, _PT_UINT: np.uint32}
    out = {name: np.zeros((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        payload = data[off + 8 : off + 8 + size]
        rows = min(lines_per_block, y1 - y + 1)
        expected = rows * sum(
            w * np.dtype(dtypes[pt]).itemsize for _, pt in channels
        )
        if comp != _COMP_NONE and size != expected:
            payload = _zip_decompress(payload, expected)
        cp = 0
        for r in range(rows):
            for cname, ptype in channels:
                dt = dtypes[ptype]
                nbytes = w * np.dtype(dt).itemsize
                row = np.frombuffer(payload[cp : cp + nbytes], dt)
                out[cname][y - y0 + r] = row.astype(np.float32)
                cp += nbytes

    names = [c for c, _ in channels]
    if set("RGB").issubset(names):
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        order = names
    return np.stack([out[c] for c in order], axis=-1)
