"""Wavefront-refill loop: lanes of dead paths adopt paths not yet started
(port of take_tpu/integrator/wavefront.py).

The scan loop (path_tracer.trace_mis) runs max_depth + 1 trips at the full
width of the pass, dead lanes included. This loop keeps a wave of Q lanes
(Q = min(P, WAVE_SIZE)); each iteration traces ONE closest-hit query for
every lane (a bounce ray, or a fresh camera ray), applies the arrival
contributions of whatever the lane was tracing, then runs NEE (one shadow
query) and BSDF sampling for lanes that continue. A lane whose path ends
writes its radiance to that path's own row of a P + 1-row output (the last
row is a dump for lanes with nothing to write) and adopts the next
unstarted path. The loop ends when no lane is occupied.

Per-path RNG is keyed by (pixel, sample, bounce), whatever lane a path runs
in, and the per-path operations are the scan loop's (_arrival_contribs,
_vertex_nee, _vertex_sample), so per-path radiance equals trace_mis's to
the last bit, except under Russian roulette, where the reweight is
associated differently (T * w * 1/p here, T * (w * 1/p) in the scan).

A camera arrival is a bounce arrival with FG = 1, bpdf = 1, spec and
sample_ok set: _arrival_contribs then gives the camera vertex's emission or
background exactly.

In eager torch every iteration costs a fixed number of launches and one
host synchronisation (the number of refilled and occupied lanes, which the
loop needs on the host), whatever its width; with Q = P no lane is ever
refilled and the loop runs at most max_depth + 2 iterations. Camera rays of
refilled lanes are computed at full width, only on iterations that refill
(the JAX package's lax.cond). The query counters are int64 (the JAX
package's int32 counters can wrap).
"""

import torch

from take_tpu_torch.core import rng
from take_tpu_torch.core.camera import generate_rays
from take_tpu_torch.geometry.intersect import intersect_scene
from take_tpu_torch.integrator.path_tracer import (
    C_EPSILON,
    DEAD_TMAX,
    _arrival_contribs,
    _vertex_nee,
    _vertex_sample,
)
from take_tpu_torch.materials.bsdf import is_specular, make_shade_point
from take_tpu_torch.scene.types import RenderOptions, Scene

# Lane capacity of the wave (take_tpu/config.py WAVE_SIZE), chosen on the
# H100 by an interleaved A/B of 2^16, 2^18 and 2^20 on textured: every
# iteration costs ~1000 launches whatever its width, so the widest wave
# renders fastest (PERF.md). Passes hold at most max_rays_per_pass = 2^20
# paths by default, so at this size no lane is refilled unless passes are
# made larger.
WAVE_SIZE = 1 << 20


def trace_wavefront(scene: Scene, options: RenderOptions, pixel_idx, sample_idx, width: int,
                    with_counts: bool = False):
    """Per-path radiance [P, 3] of the paths (pixel_idx[j], sample_idx[j]).

    Makes the camera rays itself, with the scan path's jitter draws. With
    with_counts=True returns (radiance, nominal, active): the queries
    launched (2 per lane per iteration) and those on occupied lanes (the
    bounce queries of occupied lanes and the shadow queries of continuing,
    non-specular ones), as Python ints.
    """
    P = pixel_idx.shape[0]
    Q = min(P, WAVE_SIZE)
    dev = pixel_idx.device
    hi, lo = rng.make_stream(options.seed, pixel_idx, sample_idx)

    def camera_rays(path_ids):
        """(ro, rd, stream hi, stream lo) of the given paths."""
        pid = path_ids.clamp(0, P - 1)
        st = (hi[pid], lo[pid])
        jx = rng.uniform(st, rng.camera_counter(rng.DIM_CAMERA_JITTER_X))
        jy = rng.uniform(st, rng.camera_counter(rng.DIM_CAMERA_JITTER_Y))
        pix = pixel_idx[pid]
        px = (pix % width).to(torch.float32)
        py = torch.div(pix, width, rounding_mode="floor").to(torch.float32)
        ro, rd = generate_rays(scene.meta.camera, px, py, jx, jy)
        return ro, rd, st[0], st[1]

    out = torch.zeros((P + 1, 3), dtype=torch.float32, device=dev)
    iterations, active = 0, torch.zeros((), dtype=torch.int64, device=dev)
    lane_path = torch.arange(Q, device=dev)
    occ = torch.ones(Q, dtype=torch.bool, device=dev)
    pend_ro, pend_rd, shi, slo = camera_rays(lane_path)
    prev_pos = pend_ro
    nextv = torch.zeros(Q, dtype=torch.int64, device=dev)  # vertex index of the arrival
    FG = torch.ones((Q, 3), device=dev)
    bpdf = torch.ones(Q, device=dev)
    spec = torch.ones(Q, dtype=torch.bool, device=dev)  # camera arrival: full credit
    sok = torch.ones(Q, dtype=torch.bool, device=dev)
    c1 = torch.zeros((Q, 3), device=dev)  # NEE of the vertex the ray left
    T = torch.ones((Q, 3), device=dev)
    R = torch.zeros((Q, 3), device=dev)
    nxt = torch.tensor(Q, device=dev)  # next unstarted path
    eps = torch.full((Q,), C_EPSILON, device=dev)
    n_occ = Q
    while n_occ:
        # ---- trace the pending ray of every occupied lane ----
        hit = intersect_scene(scene, pend_ro, pend_rd, eps, torch.where(occ, float("inf"), DEAD_TMAX))
        miss_t, C2_t, contrib = _arrival_contribs(scene, prev_pos, pend_rd, FG, bpdf, spec, sok, occ, hit)
        R = R + T * ((c1 + miss_t) + C2_t)  # the scan's grouping: (C1 + miss) + C2
        T = T * torch.where(occ[:, None], contrib, 1.0)
        cont = occ & sok & hit.valid & (nextv <= options.max_depth)

        # Russian roulette, as path_tracer.rr_step draws it: the weight of
        # bounce i was applied at the arrival of vertex i + 1 = nextv
        if options.rr_depth >= 0:
            bi = nextv - 1
            u_rr = rng.uniform((shi, slo), rng.bounce_counter(bi, rng.DIM_RR))
            p = torch.clamp(torch.amax(T, dim=-1), 0.05, 1.0)
            roll = occ & (bi >= options.rr_depth)
            survive = ~roll | (u_rr < p)
            T = T * torch.where(roll & survive, 1.0 / p, 1.0)[:, None]
            cont = cont & survive

        # ---- NEE and BSDF sampling at the new vertex ----
        sp = make_shade_point(scene, hit)
        specn = is_specular(sp)
        C1n = _vertex_nee(scene, (shi, slo), nextv, hit, sp, specn, cont, pend_ro, pend_rd)
        new_ro, dir_out, FGn, bpdfn, sokn = _vertex_sample(scene, (shi, slo), nextv, hit, sp, pend_rd)

        # ---- flush ended paths to their rows, refill from the pool ----
        died = occ & ~cont
        out[torch.where(died, lane_path, P)] = R
        new_id = nxt + torch.cumsum(died, dim=0) - 1
        refill = died & (new_id < P)
        lane_path = torch.where(refill, new_id, lane_path)
        occ = cont | refill
        n_refill = refill.sum()
        nxt = nxt + n_refill
        if with_counts:
            active = active + occ.sum() + (cont & ~specn).sum()
        n_refill, n_occ = torch.stack([n_refill, occ.sum()]).tolist()
        iterations += 1

        pend_ro, pend_rd, prev_pos = new_ro, dir_out, hit.pos
        FG, bpdf, spec, sok, c1 = FGn, bpdfn, specn, sokn, C1n
        nextv = nextv + 1
        if n_refill:
            cro, crd, nhi, nlo = camera_rays(lane_path)
            rf = refill[:, None]
            shi = torch.where(refill, nhi, shi)
            slo = torch.where(refill, nlo, slo)
            pend_ro = torch.where(rf, cro, pend_ro)
            pend_rd = torch.where(rf, crd, pend_rd)
            prev_pos = torch.where(rf, cro, prev_pos)
            FG = torch.where(rf, 1.0, FG)
            bpdf = torch.where(refill, 1.0, bpdf)
            spec = spec | refill
            sok = sok | refill
            c1 = torch.where(rf, 0.0, c1)
            T = torch.where(rf, 1.0, T)
            R = torch.where(rf, 0.0, R)
            nextv = torch.where(refill, 0, nextv)
    if with_counts:
        return out[:P], 2 * Q * iterations, int(active)
    return out[:P]
