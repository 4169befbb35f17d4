"""Texture image loading (imread3 equivalent, image.cpp:80-133).

LDR formats decode via PIL and apply stb_image's ldr->hdr transfer
(pow(x/255, 2.2) — stbi_loadf's default gamma), HDR radiance files get a
native decoder, EXR uses our codec.
"""

import os

import numpy as np


def _read_radiance_hdr(path):
    """Minimal Radiance .hdr (RGBE) reader, new-style RLE + flat scanlines."""
    with open(path, "rb") as fh:
        if not fh.readline().startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance HDR file")
        while True:
            line = fh.readline()
            if line in (b"\n", b"\r\n"):
                break
        dims = fh.readline().split()
        # "-Y H +X W" standard orientation
        h, w = int(dims[1]), int(dims[3])
        data = fh.read()

    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (
            pos + 4 <= len(data)
            and data[pos] == 2
            and data[pos + 1] == 2
            and ((data[pos + 2] << 8) | data[pos + 3]) == w
        ):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:  # run
                        rgbe[y, x : x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:  # literal
                        rgbe[y, x : x + cnt, c] = np.frombuffer(
                            data[pos : pos + cnt], np.uint8
                        )
                        pos += cnt
                        x += cnt
        else:  # flat scanline
            row = np.frombuffer(data[pos : pos + 4 * w], np.uint8).reshape(w, 4)
            rgbe[y] = row
            pos += 4 * w

    f = rgbe.astype(np.float32)
    e = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136)  # 2^(e-128-8)
    rgb = f[..., :3] * e[..., None]
    rgb[rgbe[..., 3] == 0] = 0.0
    return rgb


def imread3(path):
    """Read an image as [H, W, 3] linear float32."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".exr":
        from take_tpu_torch.io.exr import read_exr

        return read_exr(path)[..., :3].astype(np.float32)
    if ext == ".hdr":
        return _read_radiance_hdr(path)
    if ext == ".pfm":
        from take_tpu_torch.io.pfm import read_pfm

        return read_pfm(path)
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return img**2.2  # stbi_loadf ldr->hdr gamma (image.cpp via stb defaults)


def imread1(path):
    """Read as [H, W] float32 (channel mean for EXR, image.cpp:55-72)."""
    img = imread3(path)
    return img.mean(axis=-1)
