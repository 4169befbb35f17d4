"""Shape loaders of the reference, one module per Mitsuba shape type.

Each module defines `load(node, parser) -> dict` for its <shape> element
(`parser.shape_args(node)` gives the file, shape index, to_world and
boolean options). A mesh gives `positions` [V, 3], `indices` [F, 3] and
`normals` [V, 3] or None (float64 numpy, in world space), which become
triangles. An analytic shape gives `analytic`, a list of primitives, each
a dict of float64 parameters; its module then also defines, on its
device tables `data` ({name: [P, ...]}, or what an optional
`to_device(params, device, dtype, geom_dtype)` makes) and batches of rays:

  closest(data, ro, rd, tmin, tmax) -> (found, t, prim)   nearest in [tmin, tmax]
  occluded(data, ro, rd, tmin, tmax) -> [N] bool           rays with tmax <= 0 untraced
  surface(data, prim, pos) -> (geo_n, sh_n)                outward normals at a hit
  sample(data, prim, ref_pos, u1, u2) -> (point, normal, pdf_area)   for emitters on it
  pdf_area(data, prim, point, ref_pos) -> pdf_area

The scene loader finds the module by the shape's type name; a scene with
another type is refused.
"""
