"""Light selection, surface sampling, and pdfs (port of
take_tpu/lights/lights.py).

Per-light geometry is resolved into a packed table at build time
(LightArrays.attr, slots LATTR_*), so sampling a selected light is one row
gather followed by branch-free warps. Point lights are sampled by NEE (the
reference parses them but never samples them, parse_scene.cpp:723).
"""

from typing import NamedTuple

import torch

from take_tpu_torch.core.math import C_TWOPI, cross, dot, gather_rows, normalize, safe_norm
from take_tpu_torch.core.sampling import sample_sphere_visible, sample_triangle
from take_tpu_torch.scene.types import (
    LATTR_E1,
    LATTR_E2,
    LATTR_INTENSITY,
    LATTR_INV_AREA,
    LATTR_KIND,
    LATTR_N0,
    LATTR_N1,
    LATTR_N2,
    LATTR_POS,
    LATTR_RADIUS,
    LATTR_TAG,
    LATTR_V0,
    LIGHT_AREA,
    LIGHT_POINT,
    SHAPE_SPHERE,
    Scene,
)


class LightSample(NamedTuple):
    position: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3] surface normal at the sample (0 for point)
    is_area: torch.Tensor  # [N] bool
    is_sphere: torch.Tensor  # [N] bool
    intensity: torch.Tensor  # [N, 3]
    inv_area: torch.Tensor  # [N] 1/shape area (tri)
    radius: torch.Tensor  # [N] sphere radius


def select_uniform(scene: Scene, u):
    """Uniform light pick (light.cpp:5-7)."""
    n = scene.meta.n_lights
    return torch.clamp(torch.floor(u * n).to(torch.int32), 0, n - 1)


def select_power(scene: Scene, u):
    """Power-proportional pick by inverting the CDF (light.cpp:9-17, with
    the power table the reference never fills built by scene/build.py)."""
    idx = torch.searchsorted(scene.lights.power_cdf, u, right=True)
    return torch.clamp(idx, 0, scene.meta.n_lights - 1).to(torch.int32)


def power_pmf(scene: Scene, light_id):
    """Selection pmf under power sampling (get_light_pmf, light.cpp:20-24)."""
    return scene.lights.power_pmf[light_id.long()]


def gather_light_attrs(scene: Scene, light_id):
    """Packed light rows [N, LATTR_DIM] for the selected ids [N].

    Only the intensity columns stay attached to the table: the geometry
    columns are detached (visibility and shape derivatives are out of the
    gradients' scope, as in take_tpu/lights/lights.py)."""
    A = scene.lights.attr
    idx = light_id.long()
    la = A.detach()[idx]
    inten = gather_rows(A[:, LATTR_INTENSITY : LATTR_INTENSITY + 3], idx)
    return torch.cat([la[:, :LATTR_INTENSITY], inten, la[:, LATTR_INTENSITY + 3 :]], dim=1)


def sample_on_light(scene: Scene, light_id, ref_pos, u1, u2) -> LightSample:
    """Sample a point on light `light_id` w.r.t. reference point `ref_pos`.

    Triangles use the sqrt warp (shape.cpp:146-169), spheres the
    visible-cap warp (shape.cpp:125-144); point lights return their position.
    """
    la = gather_light_attrs(scene, light_id)
    tag = la[:, LATTR_TAG]
    kind = la[:, LATTR_KIND]

    # --- triangle branch ---
    v0 = la[:, LATTR_V0 : LATTR_V0 + 3]
    e1 = la[:, LATTR_E1 : LATTR_E1 + 3]
    e2 = la[:, LATTR_E2 : LATTR_E2 + 3]
    b1, b2 = sample_triangle(u1, u2)
    p_tri = v0 + b1[..., None] * e1 + b2[..., None] * e2
    n_tri = normalize(cross(e1, e2), eps=1e-30)
    # flip geometric normal toward interpolated shading normal (shape.cpp:168)
    sh = (
        (1.0 - b1 - b2)[..., None] * la[:, LATTR_N0 : LATTR_N0 + 3]
        + b1[..., None] * la[:, LATTR_N1 : LATTR_N1 + 3]
        + b2[..., None] * la[:, LATTR_N2 : LATTR_N2 + 3]
    )
    has_sh = torch.sum(sh * sh, dim=-1) > 1e-12
    flip = torch.where(has_sh, dot(sh, n_tri) > 0.0, True)
    n_tri = torch.where(flip[..., None], n_tri, -n_tri)

    # --- sphere branch ---
    center = la[:, LATTR_POS : LATTR_POS + 3]
    radius = la[:, LATTR_RADIUS]
    if scene.meta.n_sph > 0:
        p_sph, n_sph = sample_sphere_visible(u1, u2, center, radius, ref_pos)
        is_sph = ((kind == SHAPE_SPHERE) & (tag == LIGHT_AREA))[..., None]
        pos = torch.where(is_sph, p_sph, p_tri)
        nrm = torch.where(is_sph, n_sph, n_tri)
    else:
        pos, nrm = p_tri, n_tri

    # --- point branch ---
    is_point = (tag == LIGHT_POINT)[..., None]
    pos = torch.where(is_point, center, pos)
    nrm = torch.where(is_point, 0.0, nrm)

    return LightSample(
        position=pos,
        normal=nrm,
        is_area=tag == LIGHT_AREA,
        is_sphere=(kind == SHAPE_SPHERE) & (tag == LIGHT_AREA),
        intensity=la[:, LATTR_INTENSITY : LATTR_INTENSITY + 3],
        inv_area=la[:, LATTR_INV_AREA],
        radius=radius,
    )


def sphere_cap_pdf(radius, light_pos, ref_pos):
    """Visible-cap pdf 1/(2 pi r^2 (1 - r/d)), d floored at 1e-6."""
    d = torch.clamp(safe_norm(light_pos - ref_pos), min=1e-6)
    denom = C_TWOPI * radius * radius * (1.0 - radius / d)
    return 1.0 / torch.clamp(denom, min=1e-30)


def area_pdf_from_sample(ls: LightSample, light_pos, ref_pos):
    """Per-area pdf of a sampled point (get_light_pdf, light.cpp:32-48).

    Triangles: 1/area. Spheres: visible-cap pdf with d measured to the
    sampled point (light.cpp:43-45). Point lights return 0 (delta).
    """
    pdf_sph = sphere_cap_pdf(ls.radius, light_pos, ref_pos)
    pdf = torch.where(ls.is_sphere, pdf_sph, ls.inv_area)
    return torch.where(ls.is_area, pdf, 0.0)


def area_pdf(scene: Scene, light_id, light_pos, ref_pos):
    """Per-area pdf of a point on light `light_id` (the integrator variants
    look the light up by id)."""
    la = gather_light_attrs(scene, light_id)
    tag = la[:, LATTR_TAG]
    is_sphere = (la[:, LATTR_KIND] == SHAPE_SPHERE) & (tag == LIGHT_AREA)
    pdf_sph = sphere_cap_pdf(la[:, LATTR_RADIUS], light_pos, ref_pos)
    pdf = torch.where(is_sphere, pdf_sph, la[:, LATTR_INV_AREA])
    return torch.where(tag == LIGHT_AREA, pdf, 0.0)


def area_pdf_from_hit_geom(light_geom, light_pos, ref_pos):
    """Per-area pdf from Hit.light_geom: > 0 encodes a triangle's 1/area,
    < 0 encodes -radius of a sphere light (geometry/intersect.py)."""
    pdf_sph = sphere_cap_pdf(-light_geom, light_pos, ref_pos)
    return torch.where(light_geom < 0.0, pdf_sph, light_geom)
