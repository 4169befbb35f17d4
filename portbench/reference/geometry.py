"""Host-side geometry of the scene files: 4x4 transforms and vertex normals.

Frozen copies of the port's numpy frontends (transform.cpp's pbrt-style
matrices; compute_normals.cpp's angle-weighted vertex normals, after
Nelson Max 1999), so that the reference builds the same triangles and
shading normals from the same files without importing the port.
"""

import numpy as np


def translate(delta):
    m = np.eye(4)
    m[:3, 3] = delta
    return m


def scale(s):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate(angle_deg, axis):
    """Rotation about `axis` by degrees."""
    a = np.asarray(axis, np.float64)
    x, y, z = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(angle_deg)), np.cos(np.radians(angle_deg))
    m = np.eye(4)
    m[0, :3] = (x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s)
    m[1, :3] = (x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s)
    m[2, :3] = (x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c)
    return m


def look_at(pos, look, up):
    """Camera-to-world: +z the view direction, +x to the left."""
    pos = np.asarray(pos, np.float64)
    d = np.asarray(look, np.float64) - pos
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float64)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, np.cross(d, left), d, pos
    return m


def xform_points(m, pts):
    pts = np.asarray(pts, np.float64)
    return (pts @ m[:3, :3].T + m[:3, 3]) / (pts @ m[3, :3].T + m[3, 3])[..., None]


def xform_normals(m, n):
    """Normals by the inverse transpose of the forward matrix `m`, renormalized."""
    out = np.asarray(n, np.float64) @ np.linalg.inv(m)[:3, :3]
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.where(norm > 0, norm, 1.0)


def _unit_angle(u, v):
    d = np.einsum("ij,ij->i", u, v)
    ang_opp = (np.pi - 2.0) * np.arcsin(np.clip(0.5 * np.linalg.norm(v + u, axis=-1), -1.0, 1.0))
    ang_acu = 2.0 * np.arcsin(np.clip(0.5 * np.linalg.norm(v - u, axis=-1), -1.0, 1.0))
    return np.where(d < 0.0, ang_opp, ang_acu)


def vertex_normals(positions, indices):
    """Angle-weighted vertex normals; zero-area faces add nothing, and a
    vertex whose sum is zero keeps a zero normal."""
    p = np.asarray(positions, np.float64)
    idx = np.asarray(indices, np.int64)
    normals = np.zeros_like(p)
    p0, p1, p2 = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    ln = np.linalg.norm(fn, axis=-1)
    ok = ln > 0.0
    fn = np.where(ok[:, None], fn / np.where(ok, ln, 1.0)[:, None], 0.0)

    def unit(e):
        n = np.linalg.norm(e, axis=-1, keepdims=True)
        return e / np.where(n > 0, n, 1.0)

    for i, (a, b, c) in enumerate(((p0, p1, p2), (p1, p2, p0), (p2, p0, p1))):
        np.add.at(normals, idx[:, i], fn * (_unit_angle(unit(b - a), unit(c - a)) * ok)[:, None])
    n = np.linalg.norm(normals, axis=-1, keepdims=True)
    return np.where(n > 0, normals / np.where(n > 0, n, 1.0), 0.0)
