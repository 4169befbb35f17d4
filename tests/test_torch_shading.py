"""take_tpu_torch BSDF, light sampling and texture lookups against take_tpu's,
on the same inputs and uniforms."""

import jax.numpy as jnp
import numpy as np
import torch

from take_tpu.lights import lights as jl
from take_tpu.materials import bsdf as jb
from take_tpu.scene.types import Hit as JHit
from take_tpu_torch.lights import lights as tl
from take_tpu_torch.materials import bsdf as tb
from take_tpu_torch.scene.types import MAT_DIFFUSE, MAT_DISNEY_BSDF, MAT_DISNEY_METAL, MAT_MIRROR, TEX_IMAGE
from take_tpu_torch.scene.types import Hit as THit
from tests.scenes import cornell_box
from tests.torch_parity import port_builder

N = 4096
# measured: sampled directions within 1.2e-7 absolute (7.5e-6 relative on
# components above 1e-3), pdfs within 2.4e-7 relative; the tolerance covers
# XLA's and torch's float32 sin/cos/sqrt, and the absolute floor covers
# components that cancel to ~0
RTOL, ATOL = 1e-5, 1e-6


def _unit(rng_np, n):
    d = rng_np.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _scene_pair(textured=False):
    """cbox builders in both packages, plus an emissive sphere and a point
    light (every sample_on_light arm), and optionally an image texture."""
    builders = (cornell_box(), port_builder(cornell_box))
    img = np.random.default_rng(5).random((7, 5, 3)).astype(np.float32)
    for b in builders:
        m = b.add_material(MAT_DIFFUSE, tex_value=(0.2, 0.4, 0.6))
        b.add_sphere((0.7, 0.6, -0.6), 0.15, m, emission=(2.0, 3.0, 4.0))
        b.add_point_light((0.5, 0.9, -0.5), (1.0, 0.5, 0.25))
        if textured:
            tex = b.add_texture_image(img)
            b.add_material(MAT_DIFFUSE, tex_kind=TEX_IMAGE, tex_image=tex,
                           tex_uvscale=(2.0, 3.0), tex_uvoffset=(0.25, -0.5))
    return builders[0].build(), builders[1].build(device="cpu")


def _shade_points(rng_np, js, ps, mat_id):
    geo_n = _unit(rng_np, N)
    sh_n = _unit(rng_np, N) * 0.2 + geo_n
    sh_n /= np.linalg.norm(sh_n, axis=1, keepdims=True)
    uv = rng_np.uniform(-2.0, 2.0, (N, 2)).astype(np.float32)
    fields = dict(valid=np.ones(N, bool), t=np.ones(N, np.float32),
                  pos=np.zeros((N, 3), np.float32), geo_n=geo_n, sh_n=sh_n, uv=uv,
                  mat_id=mat_id.astype(np.int32), light_id=np.full(N, -1, np.int32),
                  front=np.ones(N, bool), emit=np.zeros((N, 3), np.float32),
                  light_geom=np.zeros(N, np.float32))
    jh = JHit(**{k: jnp.asarray(v) for k, v in fields.items()})
    th = THit(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return jb.make_shade_point(js, jh), tb.make_shade_point(ps, th)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=kw.get("rtol", RTOL), atol=kw.get("atol", ATOL))


def test_diffuse_bsdf_matches(rng_np):
    js, ps = _scene_pair()
    jsp, tsp = _shade_points(rng_np, js, ps, rng_np.integers(0, 5, N))
    dir_in = _unit(rng_np, N)
    u = rng_np.random((4, N)).astype(np.float32)
    jd, jp = jb.bsdf_sample(js, jsp, jnp.asarray(dir_in), *map(jnp.asarray, u))
    td, tp = tb.bsdf_sample(ps, tsp, torch.from_numpy(dir_in), *map(torch.from_numpy, u))
    _close(td, jd)
    _close(tp, jp)
    assert (tp > 0).float().mean() > 0.3  # both hemispheres and rejections occur
    assert (tp == 0).any()

    dir_out = _unit(rng_np, N)
    args_j = (js, jsp, jnp.asarray(dir_in), jnp.asarray(dir_out))
    args_t = (ps, tsp, torch.from_numpy(dir_in), torch.from_numpy(dir_out))
    _close(tb.bsdf_eval(*args_t), jb.bsdf_eval(*args_j))
    _close(tb.bsdf_pdf(*args_t), jb.bsdf_pdf(*args_j))
    np.testing.assert_array_equal(tb.is_specular(tsp).numpy(), np.asarray(jb.is_specular(jsp)))


def test_image_texture_lookup_matches(rng_np):
    js, ps = _scene_pair(textured=True)
    textured = js.meta.n_mat - 1
    jsp, tsp = _shade_points(rng_np, js, ps, np.where(rng_np.random(N) < 0.8, textured, 0))
    assert ps.meta.has_image_textures
    _close(tsp.refl, jsp.refl)
    for field in ("tag", "eta", "exponent", "roughness", "front"):
        np.testing.assert_array_equal(getattr(tsp, field).numpy(), np.asarray(getattr(jsp, field)))


def test_unported_material_raises(rng_np):
    """The Disney lobes once raised here; now a scene mixing them with
    diffuse and mirror dispatches each lane to its own tag's lobe, as
    take_tpu's bsdf.py does (disney_mode="full"): samples, values and pdfs
    agree (tests/test_torch_disney.py holds each arm on its own)."""
    builders = (cornell_box(mirror=True), port_builder(cornell_box, mirror=True))
    for b in builders:
        b.add_material(MAT_DISNEY_METAL, roughness=0.3)
        b.add_material(MAT_DISNEY_BSDF, roughness=0.5, metallic=0.2, clearcoat=0.5)
    js, ps = builders[0].build(), builders[1].build(device="cpu")
    assert {MAT_DIFFUSE, MAT_MIRROR, MAT_DISNEY_METAL, MAT_DISNEY_BSDF} <= set(ps.meta.used_material_tags)
    jsp, tsp = _shade_points(rng_np, js, ps, rng_np.integers(0, ps.meta.n_mat, N))
    dir_in = _unit(rng_np, N)
    dir_in *= np.sign(np.sum(dir_in * np.asarray(jsp.geo_n), axis=1, keepdims=True))
    u = rng_np.random((4, N)).astype(np.float32)
    jd, jp = jb.bsdf_sample(js, jsp, jnp.asarray(dir_in), *map(jnp.asarray, u))
    td, tp = tb.bsdf_sample(ps, tsp, torch.from_numpy(dir_in), *map(torch.from_numpy, u))
    same = (td.numpy() == np.asarray(jd)).all(axis=1)
    assert same.mean() > 0.9 and (tp.numpy()[tsp.tag.numpy() == MAT_DISNEY_METAL] > 0).any()
    _close(td, jd, atol=1e-5)
    _close(tp[same], np.asarray(jp)[same], rtol=1e-4)
    dir_out = _unit(rng_np, N)
    args_j = (js, jsp, jnp.asarray(dir_in), jnp.asarray(dir_out))
    args_t = (ps, tsp, torch.from_numpy(dir_in), torch.from_numpy(dir_out))
    _close(tb.bsdf_eval(*args_t), jb.bsdf_eval(*args_j), rtol=1e-4)
    _close(tb.bsdf_pdf(*args_t), jb.bsdf_pdf(*args_j), rtol=1e-4)


def test_light_sampling_matches(rng_np):
    js, ps = _scene_pair()
    n_lights = ps.meta.n_lights
    u_sel, u1, u2 = rng_np.random((3, N)).astype(np.float32)
    jid = jl.select_uniform(js, jnp.asarray(u_sel))
    tid = tl.select_uniform(ps, torch.from_numpy(u_sel))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert set(np.unique(tid.numpy())) == set(range(n_lights))  # tri, sphere, point arms
    ref = rng_np.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    ref[:, 2] -= 1.0
    # keep reference points 2 radii off the sphere light's centre: the cap
    # pdf 1/(2 pi r^2 (1 - r/d)) loses digits to cancellation as d -> r
    # (measured 1.2e-5 relative for one point at d ~ r)
    center, radius = np.array([0.7, 0.6, -0.6], np.float32), 0.15
    near = np.linalg.norm(ref - center, axis=1) < 2 * radius
    ref[near] = center + np.array([0.0, -0.45, 0.0], np.float32)
    jls = jl.sample_on_light(js, jid, jnp.asarray(ref), jnp.asarray(u1), jnp.asarray(u2))
    tls = tl.sample_on_light(ps, tid, torch.from_numpy(ref), torch.from_numpy(u1), torch.from_numpy(u2))
    for field in ("position", "normal", "intensity", "inv_area", "radius"):
        _close(getattr(tls, field), getattr(jls, field))
    for field in ("is_area", "is_sphere"):
        np.testing.assert_array_equal(getattr(tls, field).numpy(), np.asarray(getattr(jls, field)))
    _close(tl.area_pdf_from_sample(tls, tls.position, torch.from_numpy(ref)),
           jl.area_pdf_from_sample(jls, jls.position, jnp.asarray(ref)))

    geom = np.where(rng_np.random(N) < 0.5, rng_np.uniform(0.5, 5.0, N), -rng_np.uniform(0.05, 0.2, N))
    geom = geom.astype(np.float32)
    _close(tl.area_pdf_from_hit_geom(torch.from_numpy(geom), tls.position, torch.from_numpy(ref)),
           jl.area_pdf_from_hit_geom(jnp.asarray(geom), jls.position, jnp.asarray(ref)))
