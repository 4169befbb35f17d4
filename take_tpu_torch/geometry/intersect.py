"""Batched ray/scene intersection (port of take_tpu/geometry/intersect.py).

Scenes with a BVH go to geometry/traverse.py. Otherwise triangles go through
the sweeps of geometry/brute.py: the CUDA kernels K1/K2 for rays on the
card, their plain twins for rays on the CPU. Spheres stay in plain torch,
as they stay in XLA in the JAX package, and are merged here.

Primitive semantics mirror the reference:
  * parallel-ray epsilon reject on the affine form (shape.cpp:44-110),
  * sphere quadratic with near/far root selection (shape.cpp:13-42),
  * geometric normal always flipped to face the incoming ray
    (shape.cpp:35, :84),
  * barycentric UV / interpolated UV, interpolated (unflipped) shading
    normal (shape.cpp:88-107),
  * sphere spherical UV via get_sphere_uv (shape.cpp:3-11).

With tracing on, a closest-hit query marks its phases (tracing.mark):
intersect for the kernel's call, hit for the Hit's assembly after it.
"""

import torch

from take_tpu_torch import tracing
from take_tpu_torch.core.math import C_PI, C_TWOPI, add_rows, gather_rows, normalize
from take_tpu_torch.geometry import brute
from take_tpu_torch.scene.types import (
    ATTR_DIM,
    ATTR_EMIT,
    ATTR_FLAGS,
    ATTR_GEO_N,
    ATTR_INV_AREA,
    ATTR_LIGHT,
    ATTR_MAT,
    ATTR_N0,
    ATTR_N1,
    ATTR_N2,
    ATTR_UV0,
    ATTR_UV1,
    ATTR_UV2,
    SATTR_CENTER,
    SATTR_EMIT,
    SATTR_LIGHT,
    SATTR_MAT,
    SATTR_RADIUS,
    TRI_HAS_NORMALS,
    TRI_HAS_UV,
    Hit,
    Scene,
)

_BIG = brute.BIG


def _sph_t(g, ro, rd, tmin, tmax, n_sph):
    """Sphere quadratic (shape.cpp:13-29), component form: (t, valid) [N, S].

    The sphere table is detached: geometry is constant under AD, as the
    triangles' is. (take_tpu leaves it attached, and its gradient there is
    NaN: sqrt's derivative at a clamped discriminant of 0, on every ray
    that misses a sphere.)"""
    c = g.sph_center[:n_sph].detach()
    r2 = g.sph_radius[:n_sph].detach() ** 2
    ocx = ro[:, 0:1] - c[:, 0]
    ocy = ro[:, 1:2] - c[:, 1]
    ocz = ro[:, 2:3] - c[:, 2]
    rdx, rdy, rdz = rd[:, 0:1], rd[:, 1:2], rd[:, 2:3]
    a = rdx * rdx + rdy * rdy + rdz * rdz  # [N, 1]
    half_b = ocx * rdx + ocy * rdy + ocz * rdz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = half_b * half_b - a * cc
    hit = disc >= 0.0
    sqrtd = torch.sqrt(torch.clamp(disc, min=0.0))
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    in0 = (root0 >= tmin[:, None]) & (root0 <= tmax[:, None])
    in1 = (root1 >= tmin[:, None]) & (root1 <= tmax[:, None])
    t = torch.where(in0, root0, root1)
    return t, hit & (in0 | in1)


def _sphere_uv(p):
    """Spherical UV of a unit vector (shape.cpp:3-11), incl. the negative v."""
    theta = torch.arccos(torch.clamp(-p[..., 1], -1.0, 1.0))
    phi = torch.atan2(-p[..., 2], p[..., 0]) + C_PI
    return torch.stack([phi / C_TWOPI, -theta / C_PI], dim=-1)


def _pad_rays(ro, rd, tmin, tmax, block):
    """Pad the ray axis to a multiple of `block` with guaranteed-miss rays
    (tmax = -1), as the JAX package pads rays for its Pallas grid."""
    N = ro.shape[0]
    pad = -(-N // block) * block - N
    if pad == 0:
        return N, ro, rd, tmin, tmax
    ro = torch.cat([ro, ro.new_zeros((pad, 3))])
    rd = torch.cat([rd, rd.new_zeros((pad, 3))])
    tmin = torch.cat([tmin, tmin.new_zeros(pad)])
    tmax = torch.cat([tmax, tmax.new_full((pad,), -1.0)])
    return N, ro, rd, tmin, tmax


def intersect_scene(scene: Scene, ro, rd, tmin, tmax) -> Hit:
    """Closest-hit query for a batch of rays.

    Args:
        scene: Scene.
        ro, rd: [N, 3] contiguous origins / directions (rd need not be unit
            length — the reference's sphere code divides by dot(d, d)).
        tmin, tmax: [N] parametric range.
    Returns:
        Hit SoA with [N] leading axis.
    """
    tracing.mark("intersect")
    if scene.bvh is not None:
        from take_tpu_torch.geometry.traverse import bvh_intersect

        return bvh_intersect(scene, ro, rd, tmin, tmax)
    g = scene.geometry
    N = ro.shape[0]
    n_tri = scene.meta.n_tri
    if n_tri > 0:
        attrs, tri_t, u, v, tri_hit, _ = _BruteClosest.apply(g.tri_rows, g.tri_attr, n_tri, ro, rd, tmin, tmax)
    else:
        tri_t = ro.new_full((N,), _BIG)
        tri_hit = torch.zeros(N, dtype=torch.bool, device=ro.device)
        attrs = ro.new_zeros((N, ATTR_DIM))
        u = v = ro.new_zeros(N)
    tracing.mark("hit")
    return _merge_and_shade(scene, ro, rd, tmin, tmax, tri_t, tri_hit, attrs, u, v)


class _BruteClosest(torch.autograd.Function):
    """`brute.closest` (K1 on the card, `closest_plain` on the CPU) with the
    gradient scope of take_tpu's `_brute_intersect_hybrid`
    (take_tpu/geometry/intersect.py:220-241): only the EMIT columns of the
    winners' attribute rows are differentiable.

    The forward looks `brute.closest` up at call time, so a patch of the
    module (to the plain twin) is honoured. The backward is plain torch, as
    the JAX package's is XLA (`_hybrid_bwd`; it has no backward kernel):
    the EMIT cotangent of `attrs` is added into `tri_attr[prim, EMIT:+3]`
    for lanes that hit (core.math.add_rows: in float64, the same sum every
    run), and every other column gets none. It gives the rays
    no cotangent: every ray origin and direction is made from the camera,
    from detached sampled directions (integrator/path_tracer.py) and from
    hit points on geometry that is constant under AD (triangles and, here,
    spheres: `_sph_t`), so no scene parameter reaches them. t, u, v, found
    and prim are not differentiable.
    """

    @staticmethod
    def forward(ctx, rows, attr, n_tri, ro, rd, tmin, tmax):
        attrs, t, u, v, found, prim = brute.closest(rows, attr, n_tri, ro, rd, tmin, tmax)
        ctx.save_for_backward(prim)
        ctx.n_rows = attr.shape[0]
        ctx.mark_non_differentiable(t, u, v, found, prim)
        return attrs, t, u, v, found, prim

    @staticmethod
    def backward(ctx, g_attrs, *_):
        (prim,) = ctx.saved_tensors
        g_attr = None
        if ctx.needs_input_grad[1] and g_attrs is not None:
            hit = (prim >= 0)[:, None]
            g_emit = torch.where(hit, g_attrs[:, ATTR_EMIT : ATTR_EMIT + 3], 0.0)
            g_attr = g_attrs.new_zeros((ctx.n_rows, ATTR_DIM))
            g_attr[:, ATTR_EMIT : ATTR_EMIT + 3] = add_rows(ctx.n_rows, prim.clamp(min=0).long(), g_emit)
        return None, g_attr, None, None, None, None, None


def _merge_and_shade(scene: Scene, ro, rd, tmin, tmax, tri_t, tri_hit, attrs, u_best, v_best) -> Hit:
    """Shared epilogue: fold in spheres, pick the winner, build the Hit."""
    g = scene.geometry
    n_sph = scene.meta.n_sph
    N = ro.shape[0]

    if n_sph > 0:
        t_sph, valid_s = _sph_t(g, ro, rd, tmin, tmax, n_sph)
        sph_t, best_sph = torch.where(valid_s, t_sph, _BIG).min(dim=1)
        sph_hit = sph_t < _BIG
    else:
        best_sph = torch.zeros(N, dtype=torch.int64, device=ro.device)
        sph_t = ro.new_full((N,), _BIG)
        sph_hit = torch.zeros(N, dtype=torch.bool, device=ro.device)

    use_sph = sph_hit & (sph_t < tri_t)
    valid = tri_hit | sph_hit
    t = torch.where(use_sph, sph_t, tri_t)
    # shading math uses a safe t, so masked lanes never produce inf/nan
    t_safe = torch.where(valid, t, 1.0)

    hit_tri = shade_triangle_attrs(attrs, u_best, v_best, ro, rd, t_safe)
    if n_sph == 0:
        return hit_tri._replace(valid=valid, t=t)
    hit_sph = shade_sphere_hit(g, best_sph, ro, rd, t_safe)
    sel = use_sph[:, None]
    return Hit(
        valid=valid,
        t=t,
        pos=torch.where(sel, hit_sph.pos, hit_tri.pos),
        geo_n=torch.where(sel, hit_sph.geo_n, hit_tri.geo_n),
        sh_n=torch.where(sel, hit_sph.sh_n, hit_tri.sh_n),
        uv=torch.where(sel, hit_sph.uv, hit_tri.uv),
        mat_id=torch.where(use_sph, hit_sph.mat_id, hit_tri.mat_id),
        light_id=torch.where(use_sph, hit_sph.light_id, hit_tri.light_id),
        front=torch.where(use_sph, hit_sph.front, hit_tri.front),
        emit=torch.where(sel, hit_sph.emit, hit_tri.emit),
        light_geom=torch.where(use_sph, hit_sph.light_geom, hit_tri.light_geom),
    )


def shade_triangle_attrs(attrs, u, v, ro, rd, t) -> Hit:
    """Build the Hit record from the winners' packed attribute rows [N, A]."""
    pos = ro + rd * t[:, None]
    geo_n = attrs[:, ATTR_GEO_N : ATTR_GEO_N + 3]
    # flip toward incoming ray (shape.cpp:84); record the pre-flip side
    front_face = torch.sum(rd * geo_n, dim=-1, keepdim=True) < 0.0
    geo_n = torch.where(front_face, geo_n, -geo_n)

    w = 1.0 - u - v
    flags = attrs[:, ATTR_FLAGS].to(torch.int32)
    has_n = (flags & TRI_HAS_NORMALS) != 0
    sh_interp = normalize(
        w[:, None] * attrs[:, ATTR_N0 : ATTR_N0 + 3]
        + u[:, None] * attrs[:, ATTR_N1 : ATTR_N1 + 3]
        + v[:, None] * attrs[:, ATTR_N2 : ATTR_N2 + 3],
        eps=1e-30,
    )
    sh_n = torch.where(has_n[:, None], sh_interp, geo_n)

    has_uv = (flags & TRI_HAS_UV) != 0
    uv_interp = (
        w[:, None] * attrs[:, ATTR_UV0 : ATTR_UV0 + 2]
        + u[:, None] * attrs[:, ATTR_UV1 : ATTR_UV1 + 2]
        + v[:, None] * attrs[:, ATTR_UV2 : ATTR_UV2 + 2]
    )
    uv = torch.where(has_uv[:, None], uv_interp, torch.stack([u, v], dim=-1))

    light_id = attrs[:, ATTR_LIGHT].to(torch.int32)
    return Hit(
        valid=None, t=t, pos=pos, geo_n=geo_n, sh_n=sh_n, uv=uv,
        mat_id=attrs[:, ATTR_MAT].to(torch.int32),
        light_id=light_id,
        front=front_face[:, 0],
        emit=attrs[:, ATTR_EMIT : ATTR_EMIT + 3],
        light_geom=torch.where(light_id >= 0, attrs[:, ATTR_INV_AREA], 0.0),
    )


def shade_sphere_hit(g, idx, ro, rd, t) -> Hit:
    """Sphere hit attributes from the winners' sph_attr rows; only the EMIT
    columns stay attached to the table (take_tpu's scope)."""
    attrs = torch.cat(
        [g.sph_attr.detach()[idx, :SATTR_EMIT], gather_rows(g.sph_attr[:, SATTR_EMIT : SATTR_EMIT + 3], idx),
         g.sph_attr.detach()[idx, SATTR_EMIT + 3 :]],
        dim=1,
    )
    center = attrs[:, SATTR_CENTER : SATTR_CENTER + 3]
    pos = ro + rd * t[:, None]
    n = normalize(pos - center, eps=1e-30)
    front = torch.sum(rd * n, dim=-1, keepdim=True) < 0.0
    n_flipped = torch.where(front, n, -n)
    light_id = attrs[:, SATTR_LIGHT].to(torch.int32)
    return Hit(
        valid=None, t=t, pos=pos, geo_n=n_flipped, sh_n=n_flipped,
        uv=_sphere_uv(n_flipped),
        mat_id=attrs[:, SATTR_MAT].to(torch.int32),
        light_id=light_id,
        front=front[:, 0],
        emit=attrs[:, SATTR_EMIT : SATTR_EMIT + 3],
        light_geom=torch.where(light_id >= 0, -attrs[:, SATTR_RADIUS], 0.0),
    )


def occluded(scene: Scene, ro, rd, tmin, tmax):
    """Any-hit query: True where something lies in [tmin, tmax]."""
    if scene.bvh is not None:
        from take_tpu_torch.geometry.traverse import bvh_occluded

        return bvh_occluded(scene, ro, rd, tmin, tmax)
    g = scene.geometry
    meta = scene.meta
    occ = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    if meta.n_tri > 0:
        occ = brute.occluded(g.tri_rows, meta.n_tri, ro, rd, tmin, tmax)
    if meta.n_sph > 0:
        occ = occ | _sph_t(g, ro, rd, tmin, tmax, meta.n_sph)[1].any(dim=1)
    return occ
