"""Functional scene parameter edits: the inverse-rendering handles. Port of
take_tpu/scene/edit.py.

The compute path reads the packed attribute tables (materials.attr,
lights.attr, geometry.tri_attr / sph_attr); they are the single
differentiable source of truth and the only thing these helpers write.
Each helper returns a new Scene (dataclasses.replace) whose edited table is
a clone written in place, so autograd reaches the value passed in, and
whose other tables, and derived fields (`tri_rows`, the BVH's kernel
layouts), are the original's: no helper touches geometry. After a geometry
edit, rebuild the scene through SceneBuilder. Each edit is a take.edit span
(tracing.py).
"""

import dataclasses

import torch

from take_tpu_torch import tracing
from take_tpu_torch.scene import types as T

MATERIAL_PARAMS = {
    "eta": T.MATTR_ETA,
    "exponent": T.MATTR_EXPONENT,
    "roughness": T.MATTR_ROUGHNESS,
    "subsurface": T.MATTR_SUBSURFACE,
    "anisotropic": T.MATTR_ANISOTROPIC,
    "metallic": T.MATTR_METALLIC,
    "spec_trans": T.MATTR_SPEC_TRANS,
    "specular": T.MATTR_SPECULAR,
    "specular_tint": T.MATTR_SPECULAR_TINT,
    "sheen": T.MATTR_SHEEN,
    "sheen_tint": T.MATTR_SHEEN_TINT,
    "clearcoat": T.MATTR_CLEARCOAT,
    "clearcoat_gloss": T.MATTR_CLEARCOAT_GLOSS,
}


def _value(x, like):
    """`x` as a float32 tensor on `like`'s device (a tensor keeps its graph)."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


@tracing.spanned("take.edit")
def with_material_reflectance(scene, mat_id: int, rgb):
    """A scene with material `mat_id`'s constant reflectance replaced."""
    m = scene.materials
    attr = m.attr.clone()
    attr[mat_id, T.MATTR_TEX_VALUE : T.MATTR_TEX_VALUE + 3] = _value(rgb, attr)
    return dataclasses.replace(scene, materials=dataclasses.replace(m, attr=attr))


@tracing.spanned("take.edit")
def with_material_param(scene, mat_id: int, name: str, value):
    """Set a scalar material parameter (e.g. 'roughness', 'eta')."""
    col = MATERIAL_PARAMS[name]
    m = scene.materials
    attr = m.attr.clone()
    attr[mat_id, col] = _value(value, attr)
    return dataclasses.replace(scene, materials=dataclasses.replace(m, attr=attr))


@tracing.spanned("take.edit")
def with_light_intensity_scale(scene, scale):
    """Scale every light's radiance by `scale` (a scalar or [3]), written
    through to lights.attr and to the emitters' tri_attr / sph_attr rows."""
    L, g = scene.lights, scene.geometry

    def scaled(table, col):
        out = table.clone()
        out[:, col : col + 3] = table[:, col : col + 3] * _value(scale, table)
        return out

    return dataclasses.replace(
        scene,
        lights=dataclasses.replace(L, attr=scaled(L.attr, T.LATTR_INTENSITY)),
        geometry=dataclasses.replace(
            g, tri_attr=scaled(g.tri_attr, T.ATTR_EMIT), sph_attr=scaled(g.sph_attr, T.SATTR_EMIT)),
    )


@tracing.spanned("take.edit")
def with_texture_image(scene, tex_id: int, image):
    """Replace texture `tex_id`'s texels (the image must fit its atlas slot)."""
    tex = scene.textures
    data = tex.data.clone()
    image = _value(image, data)
    data[tex_id, : image.shape[0], : image.shape[1]] = image
    return dataclasses.replace(scene, textures=dataclasses.replace(tex, data=data))


@tracing.spanned("take.edit")
def with_envmap_data(scene, data):
    """Replace the environment map's radiance texels. The sampling tables
    stay as they are (fine for optimisation steps; rebuild the scene for a
    large change of the distribution)."""
    return dataclasses.replace(
        scene, envmap=dataclasses.replace(scene.envmap, data=_value(data, scene.envmap.data)))
