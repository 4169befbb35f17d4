"""Points on the surfaces that carry emitters: sampled for next-event
estimation, and their pdf per area for multiple importance sampling. A
lane's `shape` is 0 for triangles, sampled uniformly by the square-root
warp with the geometric normal turned toward the interpolated vertex
normal, and g + 1 for the scene's analytic groups[g], sampled by their
shape's module."""

import torch

from portbench.reference import frame


def _own(shape, prim, g):
    """`prim` on lanes of shape `g`, 0 on the others, so that every gather stays in range."""
    return torch.where(shape == g, prim, 0)


def _merge(shape, parts):
    """The tuple of tensors of each lane's own shape: parts is [(g, tuple)]."""
    out = None
    for g, val in parts:
        if out is None:
            out = val
            continue
        mask = shape == g
        out = tuple(torch.where(mask.view(-1, *[1] * (a.dim() - 1)), a, b) for a, b in zip(val, out))
    return out


def _triangle(s, tri, u1, u2):
    dt = s.dtype
    v0, e1, e2 = s.v0[tri].to(dt), s.e1[tri].to(dt), s.e2[tri].to(dt)
    su1 = torch.sqrt(u1)
    b1, b2 = 1.0 - su1, su1 * u2
    point = v0 + b1[..., None] * e1 + b2[..., None] * e2
    n = frame.normalize(torch.linalg.cross(e1, e2, dim=-1), eps=1e-30)
    vn = s.normals[tri]
    sh = (1.0 - b1 - b2)[..., None] * vn[:, 0] + b1[..., None] * vn[:, 1] + b2[..., None] * vn[:, 2]
    toward = torch.where(torch.sum(sh * sh, dim=-1) > 1e-12, frame.dot(sh, n) > 0.0, True)
    return point, torch.where(toward[..., None], n, -n), s.inv_area[tri]


def sample(s, shape, prim, ref_pos, u1, u2):
    """(point, normal, pdf per area) of a point on each lane's primitive, seen from `ref_pos`."""
    parts = [(0, _triangle(s, _own(shape, prim, 0) if s.groups else prim, u1, u2))]
    parts += [(g, grp.module.sample(grp.data, _own(shape, prim, g), ref_pos, u1, u2))
              for g, grp in enumerate(s.groups, 1)]
    return _merge(shape, parts)


def pdf_area(s, shape, prim, point, ref_pos):
    """The pdf per area with which `sample` picks `point` on each lane's primitive."""
    parts = [(0, (s.inv_area[_own(shape, prim, 0) if s.groups else prim],))]
    parts += [(g, (grp.module.pdf_area(grp.data, _own(shape, prim, g), point, ref_pos),))
              for g, grp in enumerate(s.groups, 1)]
    return _merge(shape, parts)[0]
