"""take_tpu_torch's environment light against take_tpu's on the CPU: the
alias and pdf tables, and envmap_eval / envmap_sample / envmap_pdf on the
same seeded directions and uniforms; then the port's own mirrors of
tests/test_envmap.py (alias distribution, pdf normalisation, importance
sampling, the env furnace, env plus an area light)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from take_tpu.io.images import imread3 as j_imread3
from take_tpu.lights import envmap as je
from take_tpu_torch.core.camera import Camera
from take_tpu_torch.io.images import imread3 as t_imread3
from take_tpu_torch.lights import envmap as te
from take_tpu_torch.render import render_image
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.scene.types import MAT_DIFFUSE, EnvMap, RenderOptions

SKY = os.path.join(os.path.dirname(__file__), "..", "scenes", "ibl", "assets", "sky_2k.exr")
N = 4096


def _rot_y(angle):
    m = np.eye(4)
    c, s = np.cos(angle), np.sin(angle)
    m[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    return m


def _seeded_map(h=64, w=128, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, 3)) * rng.uniform(0.1, 5.0, (h, 1, 1))).astype(np.float32)


def port_env(tables, device="cpu"):
    """The port's EnvMap from build_envmap's numpy tables."""
    return EnvMap(**{k: torch.from_numpy(np.asarray(v)).to(device) for k, v in tables.items()})


@pytest.mark.parametrize("name", ["seeded", "seeded_rotated_scaled", "odd_sized", "sky_2k"])
def test_tables_match_jax(name):
    """build_envmap's seven tables bit for bit, dtype and shape, sky_2k.exr
    (2048x1024, read by each package's own imread3) included."""
    if name == "sky_2k":
        img_j, img_t, args = j_imread3(SKY), t_imread3(SKY), ()
        np.testing.assert_array_equal(img_t, img_j)
    else:
        img_j = img_t = _seeded_map(33, 65, seed=4) if name == "odd_sized" else _seeded_map()
        args = (_rot_y(0.7), 1.7) if name == "seeded_rotated_scaled" else ()
    want = je.build_envmap(img_j, *args)
    got = te.build_envmap(img_t, *args)
    assert set(got) == {"data", "alias_prob", "alias_idx", "pdf", "to_world", "to_local", "scale"}
    for key, value in got.items():
        ref = np.asarray(getattr(want, key))
        assert np.asarray(value).dtype == ref.dtype and np.shape(value) == ref.shape, key
        np.testing.assert_array_equal(value, ref, err_msg=key)


@pytest.mark.parametrize("to_world", [None, _rot_y(0.7)], ids=["identity", "rotated"])
def test_lookups_match_jax(to_world):
    """envmap_eval, envmap_pdf and envmap_sample on 4096 seeded directions
    and uniforms. XLA's and torch's float32 atan2/acos/sin/cos differ by an
    ulp on some lanes. Measured: (u, v) bit-equal on 83-85% of lanes, and
    there eval is bit-equal; elsewhere v differs by one ulp (1.2e-7), which
    the bilinear slope turns into at most 7.1e-6 of the map's peak radiance
    (held at 1e-5 of the peak; 1.9e-4 relative to a dim texel's own value).
    The texel indices agree on every lane (held: at most 0.1% may pick the
    neighbour at a texel boundary), and where they agree the pdf is within
    8.6e-7 relative (held at 1e-5: the table entry is the same, divided by
    the sin(theta) of an ulp-different v). Sampled directions within 1.8e-7
    absolute (held at 1e-5 relative / 1e-6 absolute), their pdfs within
    1.6e-7 relative (held at 1e-6): the alias picks are the same."""
    img = _seeded_map()
    H, W = img.shape[:2]
    jenv = je.build_envmap(img, to_world, 1.7)
    tenv = port_env(te.build_envmap(img, to_world, 1.7))
    rng = np.random.default_rng(11)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jd, td = jnp.asarray(d), torch.from_numpy(d)

    ju, jv = (np.asarray(x) for x in je._dir_to_uv(jenv, jd))
    tu, tv = (x.numpy() for x in te._dir_to_uv(tenv, td))
    same_uv = (ju == tu) & (jv == tv)
    assert same_uv.mean() > 0.5
    e_j = np.asarray(je.envmap_eval(jenv, jd))
    e_t = te.envmap_eval(tenv, td).numpy()
    np.testing.assert_array_equal(e_t[same_uv], e_j[same_uv])
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=1e-5 * float(img.max()) * 1.7)

    same_texel = ((ju * W).astype(np.int32) == (tu * W).astype(np.int32)) & (
        (jv * H).astype(np.int32) == (tv * H).astype(np.int32))
    assert same_texel.mean() >= 0.999
    p_j = np.asarray(je.envmap_pdf(jenv, jd))
    p_t = te.envmap_pdf(tenv, td).numpy()
    np.testing.assert_allclose(p_t[same_texel], p_j[same_texel], rtol=1e-5)

    u = rng.random((3, N)).astype(np.float32)
    sd_j, sp_j = je.envmap_sample(jenv, *map(jnp.asarray, u))
    sd_t, sp_t = te.envmap_sample(tenv, *map(torch.from_numpy, u))
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sp_t.numpy(), np.asarray(sp_j), rtol=1e-6)


# ---- mirrors of tests/test_envmap.py on the port ----


def _sphere_dirs(rng, n):
    z = 1 - 2 * rng.random(n)
    phi = 2 * np.pi * rng.random(n)
    s = np.sqrt(np.clip(1 - z * z, 0, 1))
    return torch.tensor(np.stack([s * np.cos(phi), s * np.sin(phi), z], -1), dtype=torch.float32)


def test_alias_table_distribution(rng_np):
    w = np.array([1.0, 2.0, 3.0, 4.0])
    prob, alias = te.build_alias_table(w)
    n = 400_000
    u1, u2 = rng_np.random(n), rng_np.random(n)
    slot = np.minimum((u1 * 4).astype(int), 3)
    pick = np.where(u2 > prob[slot], alias[slot], slot)
    np.testing.assert_allclose(np.bincount(pick, minlength=4) / n, w / w.sum(), atol=5e-3)


def test_envmap_pdf_integrates_to_one(rng_np):
    env = port_env(te.build_envmap(rng_np.random((32, 64, 3)).astype(np.float32) + 0.05))
    pdf = te.envmap_pdf(env, _sphere_dirs(rng_np, 400_000)).numpy()
    np.testing.assert_allclose(pdf.mean() * 4 * np.pi, 1.0, rtol=0.02)


def test_envmap_sample_matches_pdf(rng_np):
    """Importance sampling concentrates on the one bright texel, and
    E[L / pdf] matches a uniform-sphere quadrature of the same bilinear
    lookup."""
    img = np.full((16, 32, 3), 0.01, np.float32)
    img[4, 7] = 50.0
    env = port_env(te.build_envmap(img))
    n = 100_000
    d, pdf = te.envmap_sample(env, *(torch.tensor(rng_np.random(n), dtype=torch.float32) for _ in range(3)))
    assert (pdf.numpy() > 3 / (4 * np.pi)).mean() > 0.9
    est = (te.envmap_eval(env, d)[:, 0] / torch.clamp(pdf, min=1e-12)).mean().item()
    ref = te.envmap_eval(env, _sphere_dirs(np.random.default_rng(999), 2_000_000))[:, 0].mean().item() * 4 * np.pi
    np.testing.assert_allclose(est, ref, rtol=0.05)


def test_envmap_round_trip_direction():
    env = port_env(te.build_envmap(np.ones((8, 16, 3), np.float32)))
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    np.testing.assert_allclose(te.envmap_eval(env, d).numpy(), 1.0, atol=1e-5)


def _env_furnace_scene(albedo=0.5, env_value=1.0):
    b = SceneBuilder()
    b.camera = Camera(16, 16, (0, 0, 3), (0, 0, 0), (0, 1, 0), 45.0)
    b.add_sphere((0, 0, 0), 1.0, b.add_material(MAT_DIFFUSE, tex_value=(albedo,) * 3))
    b.envmap = te.build_envmap(np.full((8, 16, 3), env_value, np.float32))
    b.background = np.zeros(3)  # unused with an envmap
    return b.build(device="cpu")


def test_env_furnace():
    """Constant env and a diffuse sphere: the centre is albedo * env and a
    corner is env, so the NEE-env and BSDF-escape MIS weights sum to one."""
    scene = _env_furnace_scene()
    assert scene.meta.has_envmap and scene.envmap is not None
    img = render_image(scene, RenderOptions(spp=256, max_depth=4, seed=4))
    np.testing.assert_allclose(img[0, 0].mean(), 1.0, atol=1e-3)
    np.testing.assert_allclose(img[6:10, 6:10].mean(), 0.5, rtol=0.04)


def test_env_plus_area_light():
    b = SceneBuilder()
    b.camera = Camera(16, 16, (0.5, 0.5, 1.4), (0.5, 0.5, 0), (0, 1, 0), 33.0)
    white = b.add_material(MAT_DIFFUSE, tex_value=(0.7, 0.7, 0.7))
    black = b.add_material(MAT_DIFFUSE, tex_value=(0, 0, 0))
    floor = np.array([[0, 0, 0], [1, 0, 0], [1, 0, -1], [0, 0, -1]], float)
    idx = np.array([[0, 1, 2], [0, 2, 3]])
    b.add_mesh(floor, idx, white)
    b.add_mesh(floor + [0, 0.9, 0], idx[:, ::-1], black, emission=(5.0, 5.0, 5.0))
    b.envmap = te.build_envmap(np.full((8, 16, 3), 0.2, np.float32))
    img = render_image(b.build(device="cpu"), RenderOptions(spp=128, max_depth=3, seed=2))
    assert np.isfinite(img).all() and img.mean() > 0.1
