"""PFM writer, byte-compatible with the reference (image.cpp:141-153)."""

import numpy as np


def write_pfm(path, image: np.ndarray) -> None:
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as fh:
        fh.write(b"PF\n")
        fh.write(f"{w} {h}\n".encode())
        fh.write(b"-1\n")
        fh.write(img.astype("<f4").tobytes())


def read_pfm(path):
    with open(path, "rb") as fh:
        assert fh.readline().strip() == b"PF"
        w, h = map(int, fh.readline().split())
        scale = float(fh.readline())
        dt = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(fh.read(w * h * 3 * 4), dt)
    return data.reshape(h, w, 3).astype(np.float32)
