"""take_tpu_torch's CUDA kernels against their plain twins, on the card.

These tests need a CUDA device and skip without one. They import neither
JAX nor take_tpu, so they run where only PyTorch is installed:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import fp32_bounds, near_boundary
from take_tpu_torch.geometry import brute
from take_tpu_torch.scene.parse_xml import parse_scene_file

CBOX = os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox", "cbox.xml")
N = 1 << 16


@pytest.fixture
def cbox_rays():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    scene = parse_scene_file(CBOX, device="cuda")
    rng = np.random.default_rng(1234)
    ro = rng.uniform((1.0, 1.0, 1.0), (555.0, 547.0, 558.0), (N, 3))
    d = rng.normal(size=(N, 3))
    rd = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(N) < 0.1, -3.4e38, rng.uniform(10.0, 2000.0, N))
    tmax[rng.random(N) < 0.5] = np.inf
    rays = [torch.tensor(a, dtype=torch.float32, device="cuda").contiguous()
            for a in (ro, rd, np.full(N, 1e-4), tmax)]
    return scene, rays


@pytest.mark.cuda
def test_closest_kernel_matches_twin(cbox_rays):
    scene, rays = cbox_rays
    g, n_tri = scene.geometry, scene.meta.n_tri
    k = brute.closest(g.tri_affine_o, g.tri_affine_d, g.tri_attr, n_tri, *rays)
    p = brute.closest_plain(g.tri_affine_o, g.tri_affine_d, g.tri_attr, n_tri, *rays)
    torch.cuda.synchronize()
    agree = k[5] == p[5]
    assert agree.float().mean().item() >= 0.9999
    bad = (~agree).nonzero()[:, 0]
    prims = torch.stack([k[5][bad], p[5][bad]], dim=1)
    assert near_boundary(torch, g, n_tri, *(r[bad] for r in rays), prims).all()
    both = agree & k[4]
    bt, bu, bv = fp32_bounds(torch, g, k[5][both], rays[0][both], rays[1][both])
    assert ((k[1] - p[1]).abs()[both] <= bt).all()
    assert ((k[2] - p[2]).abs()[both] <= bu).all()
    assert ((k[3] - p[3]).abs()[both] <= bv).all()
    assert torch.equal(k[0][both], p[0][both])
    dead = rays[3] <= 0
    assert (k[5][dead] == -1).all() and (k[1][dead] == brute.BIG).all()


@pytest.mark.cuda
def test_anyhit_kernel_matches_twin(cbox_rays):
    scene, rays = cbox_rays
    g, n_tri = scene.geometry, scene.meta.n_tri
    k = brute.occluded(g.tri_affine_o, g.tri_affine_d, n_tri, *rays)
    p = brute.occluded_plain(g.tri_affine_o, g.tri_affine_d, n_tri, *rays)
    torch.cuda.synchronize()
    bad = (k != p).nonzero()[:, 0]
    assert bad.numel() <= N // 10000
    assert near_boundary(torch, g, n_tri, *(r[bad] for r in rays), None).all()
    assert not k[rays[3] <= 0].any()


@pytest.mark.cuda
def test_kernel_launches_are_counted_and_checked(cbox_rays):
    scene, rays = cbox_rays
    g, n_tri = scene.geometry, scene.meta.n_tri
    brute.reset_launches()
    brute.closest(g.tri_affine_o, g.tri_affine_d, g.tri_attr, n_tri, *rays)
    brute.occluded(g.tri_affine_o, g.tri_affine_d, n_tri, *rays)
    assert brute.LAUNCHES == {"closest": 1, "anyhit": 1, "closest_plain": 0, "anyhit_plain": 0}
    with pytest.raises(ValueError, match="ro"):
        brute.occluded(g.tri_affine_o, g.tri_affine_d, n_tri, rays[0].double(), *rays[1:])
