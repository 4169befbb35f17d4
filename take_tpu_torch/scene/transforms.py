"""Host-side 4x4 transforms (numpy), matching transform.cpp (pbrt-style).

Row-major, points as column vectors: composition in the XML applies children
top-to-bottom as `tform = child * tform` (parse_scene.cpp:214,234,251,258,264).
"""

import numpy as np


def identity():
    return np.eye(4)


def translate(delta):
    m = np.eye(4)
    m[:3, 3] = delta
    return m


def scale(s):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate(angle_deg, axis):
    """Rotation about `axis` by degrees (transform.cpp:19-44)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.radians(angle_deg))
    c = np.cos(np.radians(angle_deg))
    x, y, z = a
    m = np.eye(4)
    m[0, 0] = x * x + (1 - x * x) * c
    m[0, 1] = x * y * (1 - c) - z * s
    m[0, 2] = x * z * (1 - c) + y * s
    m[1, 0] = x * y * (1 - c) + z * s
    m[1, 1] = y * y + (1 - y * y) * c
    m[1, 2] = y * z * (1 - c) - x * s
    m[2, 0] = x * z * (1 - c) - y * s
    m[2, 1] = y * z * (1 - c) + x * s
    m[2, 2] = z * z + (1 - z * z) * c
    return m


def look_at(pos, look, up):
    """Camera-to-world (transform.cpp:46-70): +z = view dir, +x = left."""
    pos = np.asarray(pos, np.float64)
    dir = np.asarray(look, np.float64) - pos
    dir = dir / np.linalg.norm(dir)
    up = np.asarray(up, np.float64)
    left = np.cross(up / np.linalg.norm(up), dir)
    left = left / np.linalg.norm(left)
    new_up = np.cross(dir, left)
    m = np.eye(4)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = dir
    m[:3, 3] = pos
    return m


def xform_points(m, pts):
    """Apply to [N, 3] points with homogeneous divide (transform.cpp:80-89)."""
    pts = np.asarray(pts, np.float64)
    h = pts @ m[:3, :3].T + m[:3, 3]
    w = pts @ m[3, :3].T + m[3, 3]
    return h / w[..., None]


def xform_vectors(m, v):
    return np.asarray(v, np.float64) @ m[:3, :3].T


def xform_normals(m, n):
    """Normals transform by the inverse-transpose; input `m` is the forward
    matrix (callers pass to_world; we invert here, cf. parse_obj.cpp:100-104)."""
    inv = np.linalg.inv(m)
    out = np.asarray(n, np.float64) @ inv[:3, :3]
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.where(norm > 0, norm, 1.0)
