"""take_tpu_torch.run_configs against benchmarks/run_benchmarks.py, and the
port's pixels at the published specs against take_tpu's own images, on the
CPU.

The configs and parity_stats are run_benchmarks' own; pixel_agreement and
the gates are held on planted divergences; the runner on --device cpu
--pixels writes only under its output directory. Then seeded pixels of four
configs, at the config's full spp, camera and resolution, go through the
port's render_pass (run_configs.render_pixels) and are held against the same
pixels of take_tpu's TPU render (benchmarks/out/<name>.exr, rounded to half
floats as the EXR is) and, for cbox and mis, of take_tpu at HEAD on the CPU
(tests/take_tpu_pixels.py): three-way agreement. A pixel is "beyond" when its
largest channel difference exceeds 1e-3 x max(the reference pixel's largest
channel, 1e-2) (run_configs.pixel_agreement).
"""

import dataclasses
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import run_benchmarks
from take_tpu.lights import envmap as j_envmap
from take_tpu_torch import run_configs as rc
from take_tpu_torch.io.exr import read_exr, write_exr
from take_tpu_torch.scene.types import RenderOptions
from tests.take_tpu_pixels import take_tpu_pixels
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_configs_are_run_benchmarks():
    assert rc.CONFIGS == run_benchmarks.CONFIGS


@pytest.mark.parametrize("ours_shape, ref_shape", [
    ((64, 64), (64, 64)),  # 16 blocks a side
    ((40, 56), (40, 56)),  # H % 16 != 0: 8 blocks a side
    ((32, 48), (64, 144)),  # the reference 2x taller and 3x wider: block means
    ((1080 // 8, 1920 // 8), (1080 // 4, 1920 // 4)),  # room's aspect, 2x
])
def test_parity_stats_is_run_benchmarks(ours_shape, ref_shape):
    rng = np.random.default_rng(3)
    ours = rng.gamma(2.0, 0.2, (*ours_shape, 3)).astype(np.float32)
    ref = rng.gamma(2.0, 0.2, (*ref_shape, 3)).astype(np.float32)
    assert rc.parity_stats(ours, ref) == run_benchmarks.parity_stats(ours, ref)
    assert rc.parity_stats(ref, ref) == run_benchmarks.parity_stats(ref, ref) == {
        "mean_rel_err": 0.0, "block_rel_median": 0.0, "block_rel_p99": 0.0}


def test_pixel_agreement_planted():
    """Seven pixels 2e-3 relative off and one dark pixel 2e-5 off (its bound is
    the floor's 1e-5) are beyond; five pixels 5e-4 off and a dark one 5e-6 off
    are not. The largest difference is the brightest planted pixel."""
    rng = np.random.default_rng(5)
    ref = rng.uniform(0.1, 1.0, (64, 64, 3)).astype(np.float64)
    ref[40, 40] = [1e-4, 2e-4, 5e-5]
    ref[41, 41] = [1e-4, 2e-4, 5e-5]
    ref[9, 9] = [2.0, 0.5, 0.5]
    ours = ref.copy()
    for k, (y, x) in enumerate([(1, 2), (3, 60), (9, 9), (20, 30), (33, 5), (50, 50), (63, 63)]):
        ours[y, x, k % 3] += 2e-3 * ref[y, x].max()
    for y, x in [(2, 2), (4, 4), (6, 6), (8, 8), (10, 10)]:
        ours[y, x, 1] -= 5e-4 * ref[y, x].max()
    ours[40, 40, 1] += 2e-5
    ours[41, 41, 0] -= 5e-6
    a = rc.pixel_agreement(ours, ref)
    assert (a["n_beyond"], a["n_pixels"]) == (8, 4096)
    assert a["share_beyond"] == 8 / 4096
    assert a["max_abs_pixel"] == [9, 9] and a["max_abs"] == pytest.approx(4e-3)
    np.testing.assert_allclose(a["mean_rel"], np.abs(ours.mean((0, 1)) / ref.mean((0, 1)) - 1), rtol=1e-9)
    flat = rc.pixel_agreement(ours.reshape(-1, 3), ref.reshape(-1, 3))  # a set of pixels
    assert flat["n_beyond"] == 8 and flat["max_abs_pixel"] == [9 * 64 + 9]
    with pytest.raises(ValueError, match="shapes differ"):
        rc.pixel_agreement(ours[:32], ref)

    assert rc.agreement_misses("cbox_256_16spp", a) == []
    share = dict(a, share_beyond=0.006, n_beyond=25)
    assert len(rc.agreement_misses("cbox_256_16spp", share)) == 1
    assert len(rc.agreement_misses("room_1080p_64spp", dict(share, mean_rel=[0, 2e-4, 0]))) == 2
    record = dict(rc.GOLDEN_RECORD)
    assert rc.golden_misses(record) == []
    assert len(rc.golden_misses(dict(record, block_rel_p99=0.00365 * 1.25))) == 1


def test_pixel_ids():
    """Seeded ids are a prefix of a larger draw, and image_pixels undoes the y-flip."""
    ids = rc.subset_ids(64 * 32, 100)
    assert len(set(ids.tolist())) == 100 and np.array_equal(rc.subset_ids(64 * 32, 10), ids[:10])
    img = np.arange(32 * 64 * 3, dtype=np.float32).reshape(32, 64, 3)
    flipped = img[::-1].reshape(-1, 3)  # row-major in the camera's y
    np.testing.assert_array_equal(rc.image_pixels(img, ids), flipped[ids])


def _tree(path):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, files in os.walk(path) for f in files}


def test_runner_cpu_writes_only_its_output(tmp_path, capsys):
    """--device cpu --pixels on cbox: the JSON line has run_benchmarks' keys
    and vs_take_tpu, the gates hold (exit 0), and nothing is written but the
    output directory and the --json file; benchmarks/ is untouched."""
    bench = os.path.join(rc.ROOT, "benchmarks")
    before = _tree(bench)
    out, js = tmp_path / "out", tmp_path / "r.json"
    assert rc.main(["--device", "cpu", "--only", "cbox", "--pixels", "64", "--out", str(out), "--json", str(js)]) == 0
    assert _tree(bench) == before
    assert sorted(os.listdir(tmp_path)) == ["out", "r.json"] and os.listdir(out) == ["cbox_256_16spp_pixels64.npz"]
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("cbox_256_16spp "))
    result = json.loads(line.split(" ", 1)[1])
    assert result == json.loads(js.read_text())["cbox_256_16spp"]
    assert {"resolution", "spp", "max_depth", "seconds", "Mpaths_per_sec", "Mrays_per_sec", "mean_radiance",
            "vs_take_tpu"} <= set(result)
    assert result["resolution"] == [256, 256] and (result["spp"], result["max_depth"], result["pixels"]) == (16, 4, 64)
    assert result["vs_take_tpu"]["n_pixels"] == 64 and result["vs_take_tpu"]["n_beyond"] == 0
    saved = np.load(out / "cbox_256_16spp_pixels64.npz")
    np.testing.assert_array_equal(saved["ids"], rc.subset_ids(256 * 256, 64))


def test_runner_refuses(tmp_path, monkeypatch):
    """--pixels with room, a missing reference and a misshapen one are errors."""
    with pytest.raises(SystemExit, match="whole frame"):
        rc.main(["--device", "cpu", "--only", "room", "--pixels", "8", "--out", str(tmp_path)])
    monkeypatch.setattr(rc, "TAKE_TPU_OUT", tmp_path)
    with pytest.raises(FileNotFoundError, match="missing"):
        rc.main(["--device", "cpu", "--only", "cbox", "--pixels", "8", "--out", str(tmp_path)])
    write_exr(str(tmp_path / "cbox_256_16spp.exr"), np.ones((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        rc.main(["--device", "cpu", "--only", "cbox", "--pixels", "8", "--out", str(tmp_path)])


def _port_pixels(name, ids, **options):
    _, rel, res, spp, depth = next(c for c in rc.CONFIGS if c[0] == name)
    scene = rc.config_scene(rel, res, "cpu")
    return rc.render_pixels(scene, RenderOptions(spp=spp, max_depth=depth, seed=0, **options), ids)


def _exr_pixels(name, ids):
    return rc.image_pixels(read_exr(str(rc.TAKE_TPU_OUT / f"{name}.exr")), ids)


def _half(x):
    return x.astype(np.float16)


@pytest.mark.parametrize("name, n, share_port, share_exr, mean_exr", [
    # cbox: 1,024 pixels, 16 spp: no path diverges between the three.
    ("cbox_256_16spp", 1024, 0.0, 0.0, 1e-4),
    # mis: 1,024 pixels, 128 spp. Its sphere lights and exponent lobes carry
    # last-bit differences of sqrt, pow and the sphere-cap pdf into diverging
    # paths. Measured on the CPU: the port against take_tpu at HEAD 5
    # pixels beyond, means 1.4e-5 apart; against the TPU image the port 7 and
    # take_tpu itself 10, means 1.04e-4 and 8.6e-5 apart (one pixel, 6e-3
    # off in both, moves a 1,024-pixel mean by 7e-5).
    ("mis_512_128spp", 1024, 0.01, 0.015, 2e-4),
])
def test_pixels_three_way(name, n, share_port, share_exr, mean_exr):
    """The port, take_tpu at HEAD and take_tpu's TPU image agree on seeded
    pixels: the port against take_tpu with channel means within 1e-4 and at
    most `share_port` of the pixels beyond; each against the TPU image (the
    port's and take_tpu's pixels rounded to half floats, as the image is)
    with means within `mean_exr` and at most `share_exr` beyond."""
    ids = rc.subset_ids(int(np.prod(read_exr(str(rc.TAKE_TPU_OUT / f"{name}.exr")).shape[:2])), n)
    port, jax_ = _port_pixels(name, ids), take_tpu_pixels(name, ids)
    exr = _exr_pixels(name, ids)
    a = rc.pixel_agreement(port, jax_)
    assert max(a["mean_rel"]) <= 1e-4 and a["share_beyond"] <= share_port, a
    for ours in (port, jax_):
        a = rc.pixel_agreement(_half(ours), exr)
        assert max(a["mean_rel"]) <= mean_exr and a["share_beyond"] <= share_exr, a


def test_textured_pixels():
    """textured (an open BVH scene with an image texture; K3's twin): 256
    seeded pixels at 64 spp equal take_tpu's TPU image to its half-float
    rounding on every pixel, the means within 1e-4."""
    ids = rc.subset_ids(512 * 512, 256)
    a = rc.pixel_agreement(_half(_port_pixels("textured_512_64spp", ids)), _exr_pixels("textured_512_64spp", ids))
    assert a["n_beyond"] == 0 and max(a["mean_rel"]) <= rc.MEAN_REL, a


IBL_N = 8  # pixels at 256 spp: ~1 s a pixel through the port on the CPU


def test_ibl_pixels_take_tpu_f32(tmp_path, capsys):
    """ibl's reference file (run_configs.TAKE_TPU_IBL) is take_tpu at HEAD in
    float32: its first IBL_N pixels re-rendered by take_tpu agree within 1e-6
    relative, and the runner (--pixels) gates the port's against them (and
    they agree within 1e-4 relative a pixel). The TPU image differs from the
    file on most pixels (54% of its 1,024): its envmap transforms ran at
    bfloat16 operands."""
    ref = np.load(rc.TAKE_TPU_IBL)
    assert ref["spec"].tolist() == [1024, 1024, 256, 6, 0]
    ids = ref["ids"][:IBL_N]
    np.testing.assert_array_equal(ids, rc.subset_ids(1024 * 1024, IBL_N))
    np.testing.assert_allclose(take_tpu_pixels("ibl_1024_256spp", ids), ref["radiance"][:IBL_N], rtol=1e-6)
    assert rc.main(["--device", "cpu", "--only", "ibl", "--pixels", str(IBL_N), "--out", str(tmp_path)]) == 0
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("ibl_1024_256spp "))
    assert json.loads(line.split(" ", 1)[1])["vs_take_tpu_f32"]["n_pixels"] == IBL_N
    port = np.load(tmp_path / f"ibl_1024_256spp_pixels{IBL_N}.npz")["radiance"]
    np.testing.assert_allclose(port, ref["radiance"][:IBL_N], rtol=1e-4)
    full = rc.pixel_agreement(ref["radiance"], _exr_pixels("ibl_1024_256spp", ref["ids"]))
    assert full["share_beyond"] > 0.25 and max(full["mean_rel"]) > 1e-3, full


def test_ibl_pixels_tpu_bf16(tmp_path, capsys):
    """With the envmap's two direction transforms at bfloat16 operands (the
    TPU's default matmul precision), the port (run_configs
    --tpu-envmap-bf16, gated against the EXR) and take_tpu (its two
    transforms patched the same way) equal the TPU image on IBL_N seeded
    pixels at 256 spp, to its half-float rounding."""
    args = ["--device", "cpu", "--only", "ibl", "--pixels", str(IBL_N), "--tpu-envmap-bf16", "--out", str(tmp_path)]
    assert rc.main(args) == 0
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("ibl_1024_256spp "))
    result = json.loads(line.split(" ", 1)[1])
    assert result["envmap_bf16"] and "vs_take_tpu_f32" not in result
    assert result["vs_take_tpu"]["n_beyond"] == 0, result
    ids = rc.subset_ids(1024 * 1024, IBL_N)

    def bf16(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32)

    dir_to_uv, uv_to_dir = j_envmap._dir_to_uv, j_envmap._uv_to_dir

    def dir_to_uv_bf16(env, d):
        return dir_to_uv(dataclasses.replace(env, to_local=bf16(env.to_local)), bf16(d))

    def uv_to_dir_bf16(env, u, v):
        return bf16(uv_to_dir(dataclasses.replace(env, to_world=jnp.eye(3)), u, v)) @ bf16(env.to_world.T)

    jax.clear_caches()  # the pass traced in float32 by another test
    try:
        with mock.patch.object(j_envmap, "_dir_to_uv", dir_to_uv_bf16), \
                mock.patch.object(j_envmap, "_uv_to_dir", uv_to_dir_bf16):
            jax_ = take_tpu_pixels("ibl_1024_256spp", ids)
    finally:
        jax.clear_caches()
    a = rc.pixel_agreement(_half(jax_), _exr_pixels("ibl_1024_256spp", ids))
    assert a["n_beyond"] == 0, a
