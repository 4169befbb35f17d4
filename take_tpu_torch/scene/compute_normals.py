"""Angle-weighted vertex normals (Nelson Max 1999), vectorized in numpy.

Behavioral counterpart of the reference's compute_normals.cpp:12-47 —
per-corner weight is the robust unit-vector angle between the two adjacent
edges; degenerate faces (zero-area) contribute nothing; zero-sum vertex
normals stay zero.
"""

import numpy as np


def _unit_angle(u, v):
    """Numerically robust angle between unit vectors (compute_normals.cpp:4-10)."""
    d = np.einsum("ij,ij->i", u, v)
    ang_opp = (np.pi - 2.0) * np.arcsin(
        np.clip(0.5 * np.linalg.norm(v + u, axis=-1), -1.0, 1.0)
    )
    ang_acu = 2.0 * np.arcsin(
        np.clip(0.5 * np.linalg.norm(v - u, axis=-1), -1.0, 1.0)
    )
    return np.where(d < 0.0, ang_opp, ang_acu)


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """positions [V,3] float, indices [F,3] int -> normals [V,3] float."""
    positions = np.asarray(positions, np.float64)
    indices = np.asarray(indices, np.int64)
    V = positions.shape[0]
    normals = np.zeros((V, 3), np.float64)

    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    ln = np.linalg.norm(fn, axis=-1)
    ok = ln > 0.0
    fn = np.where(ok[:, None], fn / np.where(ok, ln, 1.0)[:, None], 0.0)

    def norm(e):
        l = np.linalg.norm(e, axis=-1, keepdims=True)
        return e / np.where(l > 0, l, 1.0)

    corners = [(p0, p1, p2), (p1, p2, p0), (p2, p0, p1)]
    for i, (a, b, c) in enumerate(corners):
        w = _unit_angle(norm(b - a), norm(c - a)) * ok
        np.add.at(normals, indices[:, i], fn * w[:, None])

    l = np.linalg.norm(normals, axis=-1, keepdims=True)
    return np.where(l > 0, normals / np.where(l > 0, l, 1.0), 0.0)
