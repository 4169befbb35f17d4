"""take_tpu_torch's non-Disney BSDF arms against take_tpu's on the CPU: the
same shade points, directions and uniforms (numpy, from a seed) through
bsdf_sample, bsdf_eval and bsdf_pdf of both packages, for every ported tag;
and scenes/mis/mis.xml (blinn_microfacet plates, sphere lights) rendered by
both."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.core.camera import Camera as JCamera
from take_tpu.materials import bsdf as jb
from take_tpu.render import render_image as j_render
from take_tpu.scene.parse_xml import parse_scene_file as jax_parse
from take_tpu.scene.types import Hit as JHit
from take_tpu.scene.types import RenderOptions as JOptions
from take_tpu_torch.core.camera import Camera as TCamera
from take_tpu_torch.materials import bsdf as tb
from take_tpu_torch.render import render_image as t_render
from take_tpu_torch.scene import types as tt
from take_tpu_torch.scene.types import Hit as THit
from take_tpu_torch.scene.types import RenderOptions as TOptions
from tests.scenes import cornell_box
from tests.torch_parity import port_builder, port_scene, with_res

MIS = os.path.join(os.path.dirname(__file__), "..", "scenes", "mis", "mis.xml")
N = 4096

# Per arm: (materials added to the box, rtol of pdfs and BSDF values, with
# an absolute floor of 1e-6). Sampled directions agree within 1e-5 relative
# / 1e-6 absolute in every arm (XLA's and torch's float32 sin, cos, sqrt and
# pow). Lobes raised to the exponent carry last-bit differences of pow and
# of its cosine argument, amplified by the exponent (~exponent x 6e-8 per
# ulp): measured at the sampled directions, 3.0e-5 (phong), 3.6e-4
# (blinn-phong), 5.4e-4 (microfacet, exponent 3000) relative; every other
# value of every arm is equal to the last bit or within the floor.
ARMS = {
    tt.MAT_MIRROR: ([dict(tex_value=(0.9, 0.5, 0.2)), dict(tex_value=(0.1, 0.2, 0.3))], 1e-5),
    tt.MAT_PLASTIC: ([dict(eta=1.5, tex_value=(0.7, 0.3, 0.2)), dict(eta=1.3)], 1e-5),
    tt.MAT_PHONG: ([dict(exponent=e, tex_value=(0.8, 0.6, 0.4)) for e in (1.0, 20.0, 500.0, 3000.0)], 1e-3),
    tt.MAT_BLINN_PHONG: ([dict(exponent=e) for e in (1.0, 3.0, 100.0, 3000.0)], 1e-3),
    tt.MAT_BLINN_PHONG_MICROFACET: ([dict(exponent=e, tex_value=(0.9,) * 3) for e in (1.0, 20.0, 500.0, 3000.0)],
                                    1e-3),
    tt.MAT_DISNEY_DIFFUSE: ([dict(roughness=r, subsurface=s) for r, s in ((0.1, 0.0), (0.6, 0.4), (1.0, 1.0))],
                            1e-5),
}
DIR_RTOL, DIR_ATOL = 1e-5, 1e-6


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _scene_pair(tag):
    """cbox builders in both packages with the arm's materials added; returns
    the two scenes and the new materials' ids."""
    builders = (cornell_box(8, 8), port_builder(cornell_box, 8, 8))
    for b in builders:
        ids = [b.add_material(tag, **params) for params in ARMS[tag][0]]
    return builders[0].build(), builders[1].build(device="cpu"), np.array(ids)


def _directions(rng, geo_n, n):
    """Unit directions: a third in the front hemisphere of geo_n, a third
    behind it (back faces), a third grazing it (within ~1e-3 of the plane)."""
    d = _unit(rng.normal(size=(n, 3)))
    side = np.sign(np.sum(d * geo_n, axis=1, keepdims=True))
    third = n // 3
    d[:third] *= side[:third]
    d[third:2 * third] *= -side[third:2 * third]
    tangent = _unit(np.cross(geo_n[2 * third:], d[2 * third:]))
    d[2 * third:] = _unit(tangent + rng.uniform(-1e-3, 1e-3, (n - 2 * third, 1)) * geo_n[2 * third:])
    return d


def _shade_points(rng, js, ps, ids):
    geo_n = _unit(rng.normal(size=(N, 3)))
    sh_n = _unit(_unit(rng.normal(size=(N, 3))) * 0.2 + geo_n)
    fields = dict(valid=np.ones(N, bool), t=np.ones(N, np.float32), pos=np.zeros((N, 3), np.float32),
                  geo_n=geo_n, sh_n=sh_n, uv=np.zeros((N, 2), np.float32),
                  mat_id=rng.choice(ids, N).astype(np.int32), light_id=np.full(N, -1, np.int32),
                  front=np.ones(N, bool), emit=np.zeros((N, 3), np.float32),
                  light_geom=np.zeros(N, np.float32))
    jh = JHit(**{k: jnp.asarray(v) for k, v in fields.items()})
    th = THit(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return jb.make_shade_point(js, jh), tb.make_shade_point(ps, th), geo_n


def _close(t, j, rtol, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("tag", sorted(ARMS), ids=[tt.MATERIAL_NAMES[t] for t in sorted(ARMS)])
def test_bsdf_arm_matches_jax(tag):
    rtol = ARMS[tag][1]
    rng = np.random.default_rng(100 + tag)
    js, ps, ids = _scene_pair(tag)
    assert tag in ps.meta.used_material_tags
    jsp, tsp, geo_n = _shade_points(rng, js, ps, ids)
    dir_in = _directions(rng, geo_n, N)
    u = rng.random((4, N)).astype(np.float32)
    j_in, t_in = jnp.asarray(dir_in), torch.from_numpy(dir_in)

    jd, jp = jb.bsdf_sample(js, jsp, j_in, *map(jnp.asarray, u))
    td, tp = tb.bsdf_sample(ps, tsp, t_in, *map(torch.from_numpy, u))
    _close(td, jd, DIR_RTOL, DIR_ATOL)
    _close(tp, jp, rtol)
    assert (tp > 0).any() and (tp == 0).any()  # samples and rejections (back faces)
    # eval of the own sample, with its pdf (Plastic's lobe flag reads it)
    _close(tb.bsdf_eval(ps, tsp, t_in, td, sample_pdf=tp), jb.bsdf_eval(js, jsp, j_in, jd, sample_pdf=jp), rtol)

    dir_out = _directions(rng, geo_n, N)
    args_j = (js, jsp, j_in, jnp.asarray(dir_out))
    args_t = (ps, tsp, t_in, torch.from_numpy(dir_out))
    f_t = tb.bsdf_eval(*args_t)
    _close(f_t, jb.bsdf_eval(*args_j), rtol)
    _close(tb.bsdf_pdf(*args_t), jb.bsdf_pdf(*args_j), rtol)
    np.testing.assert_array_equal(tb.is_specular(tsp).numpy(), np.asarray(jb.is_specular(jsp)))
    if tag == tt.MAT_PLASTIC:
        spec = tp == 1.0  # the specular lobe's flag, both lobes sampled
        assert spec.any() and ((tp > 0) & ~spec).any()
        f_own = tb.bsdf_eval(ps, tsp, t_in, td, sample_pdf=tp)
        assert (f_own[spec & (f_own.sum(dim=1) > 0)] == 1.0).all()
    elif tag != tt.MAT_MIRROR:
        assert (f_t > 0).any()


def test_mis_render_matches_jax():
    """scenes/mis/mis.xml (four blinn_microfacet plates of exponent 20 to
    3000, four sphere lights, brute path) at 24x24, 4 spp, max_depth 6, the
    port against take_tpu.render_image on the CPU. Means within 1e-3
    relative; pixels within 1e-3 relative (floor 1e-4) but for at most 3 of
    576, where an ulp-level difference may send a path another way (spheres,
    ROADMAP queue 3). Measured: one pixel 27% off (a path that went another
    way), every other within 1e-3; means within 1.4e-4."""
    js = with_res(jax_parse(MIS), 24, JCamera)
    ps = with_res(port_scene(jax_parse(MIS)), 24, TCamera)
    assert tt.MAT_BLINN_PHONG_MICROFACET in ps.meta.used_material_tags and ps.bvh is None
    opts = dict(spp=4, max_depth=6, seed=0)
    img_j = j_render(js, JOptions(**opts))
    img_t = t_render(ps, TOptions(**opts))
    assert img_t.shape == img_j.shape == (24, 24, 3) and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t.mean(axis=(0, 1)), img_j.mean(axis=(0, 1)), rtol=1e-3)
    err = (np.abs(img_t - img_j) / np.maximum(np.abs(img_j), 1e-4)).max(axis=-1)
    assert (err > 1e-3).sum() <= 3
