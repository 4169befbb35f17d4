"""Mitsuba's rectangle: the square [-1, 1]^2 at z = 0 with normal +z
(flipped by `flipNormals`), as two triangles, under its to_world."""

import numpy as np

from portbench.reference import geometry


def load(node, parser):
    path, shape_index, to_world, options = parser.shape_args(node)
    corners = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64)
    n = np.array([[0, 0, -1.0 if options.get("flipNormals") else 1.0]] * 4)
    return {"positions": geometry.xform_points(to_world, corners),
            "indices": np.array([[0, 1, 2], [0, 2, 3]], np.int64),
            "normals": geometry.xform_normals(to_world, n)}
