"""The reference's own reader of OpenEXR scanline images, for environment
maps: numpy and zlib, from the file layout of OpenEXR's "Technical
Introduction" (a header of attributes, an offset table, chunks of scanlines
holding each channel's row in turn, channels in the order the header lists
them). It reads HALF and FLOAT channels, uncompressed or compressed by ZIPS
(one line a chunk) or ZIP (16 lines a chunk): zlib's deflate after a delta
predictor over the bytes and a split of even and odd bytes.
"""

import struct
import zlib

import numpy as np

MAGIC = 20000630
LINES = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP: scanlines a chunk
TYPES = {1: np.float16, 2: np.float32}  # HALF, FLOAT


def _header(buf):
    """{name: (type, bytes)} and the offset where the header ends."""
    attrs, pos = {}, 8
    while buf[pos] != 0:
        name_end = buf.index(b"\0", pos)
        type_end = buf.index(b"\0", name_end + 1)
        (size,) = struct.unpack_from("<i", buf, type_end + 1)
        start = type_end + 5
        attrs[buf[pos:name_end].decode()] = (buf[name_end + 1:type_end].decode(), buf[start:start + size])
        pos = start + size
    return attrs, pos + 1


def _channels(raw):
    """[(name, numpy dtype)] of a chlist attribute."""
    out, pos = [], 0
    while raw[pos] != 0:
        end = raw.index(b"\0", pos)
        (kind,) = struct.unpack_from("<i", raw, end + 1)
        if kind not in TYPES:
            raise ValueError(f"EXR channel type {kind} is not read")
        out.append((raw[pos:end].decode(), TYPES[kind]))
        pos = end + 1 + 16  # pixel type, pLinear and 3 reserved bytes, x and y sampling
    return out


def _inflate(data, size):
    """ZIP's decoding: inflate, undo the byte predictor, interleave the two halves."""
    d = np.frombuffer(zlib.decompress(data), np.uint8)
    d = np.cumsum(np.concatenate([d[:1], d[1:].astype(np.int64) - 128])).astype(np.uint8)  # t[i] = t[i-1] + d[i] - 128
    out = np.empty_like(d)
    half = (d.size + 1) // 2
    out[0::2], out[1::2] = d[:half], d[half:]
    if out.size != size:
        raise ValueError("an EXR chunk inflates to the wrong size")
    return out


def read(path):
    """[H, W, C] float32 with C the channels R, G, B (else the file's order)."""
    buf = open(path, "rb").read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC or version & 0x1A00:  # tiled, deep or multi-part
        raise ValueError(f"{path}: not a single-part scanline EXR")
    attrs, pos = _header(buf)
    chans = _channels(attrs["channels"][1])
    compression = attrs["compression"][1][0]
    if compression not in LINES:
        raise ValueError(f"{path}: EXR compression {compression} is not read")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h, lines = x1 - x0 + 1, y1 - y0 + 1, LINES[compression]
    n_chunks = -(-h // lines)
    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, pos)
    planes = {name: np.empty((h, w), np.float32) for name, _ in chans}
    row_bytes = sum(w * np.dtype(dt).itemsize for _, dt in chans)
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        rows = min(lines, y1 - y + 1)
        data = buf[off + 8:off + 8 + size]
        raw = np.frombuffer(data, np.uint8) if size == rows * row_bytes else _inflate(data, rows * row_bytes)
        at = 0
        for r in range(rows):
            for name, dt in chans:
                n = w * np.dtype(dt).itemsize
                planes[name][y - y0 + r] = np.frombuffer(raw[at:at + n].tobytes(), dt)
                at += n
    names = [c for c, _ in chans]
    order = ["R", "G", "B"] if {"R", "G", "B"} <= set(names) else names
    return np.stack([planes[c] for c in order], -1)
