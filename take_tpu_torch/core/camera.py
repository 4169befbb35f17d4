"""Pinhole camera ray generation (port of take_tpu/core/camera.py).

Mirrors the reference's host-side camera math (render.cpp:37-44, 69-75):
basis w = normalize(lookfrom - lookat), u = normalize(cross(up, w)),
v = cross(w, u); viewport height = 2 tan(vfov/2); x jitter in [0,1).

The y-flip of the reference (`img(x, H-1-y)`, render.cpp:78) is applied at
image assembly, not here: ray (x, y) shades output pixel (x, H-1-y).
"""

from dataclasses import dataclass

import torch

from take_tpu_torch.core.math import C_PI, constant, cross, normalize


@dataclass(frozen=True)
class Camera:
    """Static (host-side) camera description; fields mirror camera.h:5-11."""

    width: int
    height: int
    lookfrom: tuple
    lookat: tuple
    up: tuple
    vfov: float  # vertical fov in degrees

    def basis(self, device, dtype=torch.float32):
        lookfrom = constant(self.lookfrom, dtype, device)
        lookat = constant(self.lookat, dtype, device)
        up = constant(self.up, dtype, device)
        w = normalize(lookfrom - lookat)
        u = normalize(cross(up, w))
        v = cross(w, u)
        return u, v, w

    def viewport(self, device, dtype=torch.float32):
        """(width, height) of the viewport at unit distance, computed in
        `dtype` as the JAX version does."""
        theta = self.vfov / 180.0 * C_PI
        h = torch.tan(torch.full((), theta / 2.0, dtype=dtype, device=device))
        viewport_height = 2.0 * h
        viewport_width = viewport_height / self.height * self.width
        return viewport_width, viewport_height


def generate_rays(camera, px, py, jx, jy):
    """Primary rays through pixel (px, py) with sub-pixel jitter (jx, jy).

    Args:
        camera: Camera.
        px, py: [...] float pixel coordinates (x right, y up as in reference).
        jx, jy: [...] uniforms in [0,1), same device and dtype as px.
    Returns:
        (origins [..., 3], directions [..., 3]) — directions normalized.
    """
    device, dtype = px.device, px.dtype
    u, v, w = camera.basis(device, dtype)
    vp_w, vp_h = camera.viewport(device, dtype)
    sx = ((px + jx) / camera.width - 0.5) * vp_w
    sy = ((py + jy) / camera.height - 0.5) * vp_h
    d = normalize(sx[..., None] * u + sy[..., None] * v - w)
    o = constant(camera.lookfrom, dtype, device)
    return o.expand(d.shape).contiguous(), d
