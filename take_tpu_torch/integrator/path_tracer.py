"""Wavefront path tracer with multiple-sample MIS (NEE + BSDF sampling).

Port of take_tpu/integrator/path_tracer.py (the fixed-trip loop `trace_mis` and
its phase helpers). Ray state is SoA over a flat path axis [N]; the bounce
loop is a Python loop of max_depth + 1 trips with an `active` lane mask in
place of every early `break`. Per trip: one NEE shadow query and one BSDF
bounce query, both at full width, exactly like the JAX scan.

MIS semantics (path_tracing.h):
  * power heuristic with squared pdfs on the solid-angle light pdf
    (path_tracing.h:55, :99),
  * specular materials (Mirror/Plastic by tag) skip NEE and weight
    BSDF-hits by 1/bsdf_pdf (path_tracing.h:24-26, :99),
  * the loop runs max_depth + 1 iterations (path_tracing.h:20),
  * a miss adds throughput * background and terminates (:82-87),
  * an emitter hit at the camera vertex adds its radiance (:14-18).
Point lights get a delta-NEE branch (the reference ignores them), and an
environment map is one more NEE slot whose escapes are MIS-weighted (the
JAX package's extensions).

`trace_mis` is differentiable by autograd through its loop (grad.py's "ad"
mode); `trace_mis_replay` computes the same estimator with an early exit
(every trip under a CUDA graph capture) and a path-replay backward (grad.py's
"replay" mode, the module's end).
Primal renders run under torch.inference_mode() (render.py).
"""

import torch

from take_tpu_torch.core import rng
from take_tpu_torch.core.math import constant, dot, normalize, safe_div, safe_norm
from take_tpu_torch.geometry.intersect import intersect_scene, occluded
from take_tpu_torch.lights.envmap import envmap_eval, envmap_pdf, envmap_sample
from take_tpu_torch.lights.lights import (
    area_pdf_from_hit_geom,
    area_pdf_from_sample,
    sample_on_light,
)
from take_tpu_torch.materials.bsdf import (
    bsdf_eval,
    bsdf_pdf,
    bsdf_sample,
    is_specular,
    make_shade_point,
)
from take_tpu_torch.scene.types import (
    MAT_DISNEY_BSDF,
    MAT_DISNEY_CLEARCOAT,
    MAT_DISNEY_GLASS,
    MAT_DISNEY_METAL,
    MAT_DISNEY_SHEEN,
    Hit,
    RenderOptions,
    Scene,
    float_tables,
    replace_tables,
)

# Minimum parametric distance of every ray (take_tpu/config.py C_EPSILON).
C_EPSILON = 1e-4
# Spawn points move RAY_OFFSET_REL * (1 + |p|_inf) along the geometric
# normal (take_tpu/config.py RAY_OFFSET_REL).
RAY_OFFSET_REL = 1.2e-4
# tmax of a lane whose query result is unused: every kernel skips it.
DEAD_TMAX = -3.4e38


def offset_origin(pos, geo_n, direction):
    """Spawn point for secondary rays: offset along the geometric normal,
    signed toward `direction`'s hemisphere, scaled with the position
    magnitude (f32 replacement for the reference's fixed 1e-7 tmin)."""
    delta = RAY_OFFSET_REL * (1.0 + torch.amax(pos.abs(), dim=-1, keepdim=True))
    sign = torch.sign(torch.sum(direction * geo_n, dim=-1, keepdim=True))
    return pos + sign * delta * geo_n


def _background(scene: Scene, rd):
    """Radiance for escaped rays: the environment map if the scene has one,
    else the flat background."""
    if scene.meta.has_envmap:
        return envmap_eval(scene.envmap, rd)
    return scene.background.expand(rd.shape)


def _camera_vertex(scene: Scene, ro, rd):
    """Primary intersection + camera-vertex radiance (path_tracing.h:7-18).

    Returns (radiance0, (ro, rd, hit, active))."""
    N = ro.shape[0]
    tmin0 = ro.new_full((N,), C_EPSILON)
    tmax0 = ro.new_full((N,), float("inf"))
    hit = intersect_scene(scene, ro, rd, tmin0, tmax0)
    v = hit.valid[:, None]
    radiance = torch.where(v, 0.0, _background(scene, rd))
    radiance = radiance + torch.where(v, hit.emit, 0.0)
    return radiance, (ro, rd, hit, hit.valid)


def _vertex_nee(scene: Scene, streams, i, hit, sp, spec, active, ro, rd):
    """NEE at the current vertex -> C1 [N, 3] (path_tracing.h:30-60).

    The environment map joins the lights as one more uniform-selection slot
    (the JAX package's extension; the reference has no environment light),
    so every light pdf divides by n_slots, which equals n_lights without
    one. `i` may be a Python int or a per-lane tensor (the refill loop)."""
    n_lights = scene.meta.n_lights
    n_slots = n_lights + (1 if scene.meta.has_envmap else 0)
    N = ro.shape[0]
    dir_in = -rd
    C1 = torch.zeros_like(ro)
    if n_slots == 0:
        return C1

    u_sel = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LIGHT_SELECT))
    u1 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LIGHT_U1))
    u2 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LIGHT_U2))
    slot = torch.clamp((u_sel * n_slots).to(torch.int32), 0, n_slots - 1)
    if n_lights > 0:
        ls = sample_on_light(scene, torch.clamp(slot, max=n_lights - 1), hit.pos, u1, u2)
        delta = ls.position - hit.pos
        d = safe_norm(delta)
        light_dir = delta / torch.clamp(d, min=1e-30)[:, None]
        tmax_shadow = (1.0 - 1e-3) * d
    else:
        d = ro.new_ones(N)
        light_dir = rd
        tmax_shadow = ro.new_full((N,), float("inf"))
    if scene.meta.has_envmap:
        u3 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_ENV_U3))
        env_dir, env_pdf = envmap_sample(scene.envmap, u1, u2, u3)
        is_env = slot == n_lights
        light_dir = torch.where(is_env[:, None], env_dir, light_dir)
        tmax_shadow = torch.where(is_env, float("inf"), tmax_shadow)
    else:
        is_env = torch.zeros(N, dtype=torch.bool, device=ro.device)

    # Lanes whose NEE result is unused (dead or specular) and lanes whose
    # contribution is zero for every parameter value (a geometric backface
    # of a reflective material, or a light seen from behind) get
    # tmax = DEAD_TMAX, so the any-hit query skips them.
    transmissive = (sp.tag == MAT_DISNEY_GLASS) | (sp.tag == MAT_DISNEY_BSDF)
    full_refl = (
        (sp.tag == MAT_DISNEY_METAL)
        | (sp.tag == MAT_DISNEY_CLEARCOAT)
        | (sp.tag == MAT_DISNEY_SHEEN)
    )
    light_back = dot(sp.geo_n, light_dir) < 0.0
    arr_back = dot(sp.geo_n, dir_in) < 0.0
    zero_contrib = (~transmissive) & (light_back | (arr_back & ~full_refl))
    if n_lights > 0 and scene.meta.has_area_lights:
        zero_contrib = zero_contrib | ((~is_env) & ls.is_area & (dot(-ls.normal, light_dir) <= 0.0))
    shadow_o = offset_origin(hit.pos, hit.geo_n, light_dir)
    nee_live = active & ~spec & ~zero_contrib
    shadow_occ = occluded(
        scene, shadow_o, light_dir, ro.new_full((N,), C_EPSILON),
        torch.where(nee_live, tmax_shadow, DEAD_TMAX),
    )
    FG = bsdf_eval(scene, sp, dir_in, light_dir)
    bp = torch.clamp(bsdf_pdf(scene, sp, dir_in, light_dir), max=1e18)

    if scene.meta.has_area_lights:
        cos_l = torch.clamp(dot(-ls.normal, light_dir), min=0.0)
        apdf = area_pdf_from_sample(ls, ls.position, hit.pos)
        # solid-angle light pdf (path_tracing.h:39), cos floored before the
        # division so a grazing light gets weight -> 0
        lp = torch.clamp(
            safe_div(apdf * d * d, torch.clamp(cos_l, min=1e-12) * n_slots, 0.0),
            max=1e18,
        )
        w = safe_div(lp, lp * lp + bp * bp, 0.0)  # power heuristic / lp
        ok = (~is_env) & ls.is_area & (bp > 0.0) & (cos_l > 0.0) & (~shadow_occ)
        C1 = C1 + FG * ls.intensity * torch.where(ok, w, 0.0)[:, None]
    if scene.meta.has_point_lights:
        # delta light: estimator I/d^2 / pmf_select, no MIS partner
        inv_d2 = safe_div(torch.ones_like(d), d * d, 0.0)
        okp = (~is_env) & (~ls.is_area) & (~shadow_occ)
        C1 = C1 + FG * ls.intensity * torch.where(okp, inv_d2 * n_slots, 0.0)[:, None]
    if scene.meta.has_envmap:
        Li_env = envmap_eval(scene.envmap, light_dir)
        lp_env = torch.clamp(env_pdf / n_slots, max=1e18)
        w_env = safe_div(lp_env, lp_env * lp_env + bp * bp, 0.0)
        ok_env = is_env & (bp > 0.0) & (env_pdf > 0.0) & (~shadow_occ)
        C1 = C1 + FG * Li_env * torch.where(ok_env, w_env, 0.0)[:, None]
    return torch.where((spec | ~active)[:, None], 0.0, C1)


def _vertex_sample(scene: Scene, streams, i, hit, sp, rd):
    """BSDF sampling at the current vertex (path_tracing.h:62-78).

    Returns (new_ro, dir_out, FG, bpdf, sample_ok)."""
    dir_in = -rd
    u_lobe = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LOBE_SELECT))
    ub1 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_BSDF_U1))
    ub2 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_BSDF_U2))
    ub3 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_AUX))
    dir_out, bpdf = bsdf_sample(scene, sp, dir_in, u_lobe, ub1, ub2, ub3)
    sample_ok = bpdf > 0.0
    # failed samples may carry a zero direction: substitute a unit one
    dir_out = torch.where(sample_ok[:, None], dir_out, constant((0.0, 0.0, 1.0), dir_out.dtype, dir_out.device))
    # detached sampling: the sampled direction is a constant under AD (its
    # pdf stays attached), in every loop, as in take_tpu
    # (path_tracer.py:283-290); reparameterisation terms through dir_out
    # would reach later-bounce d^2 and cos terms whose backward overflows
    dir_out = dir_out.detach()
    FG = bsdf_eval(scene, sp, dir_in, dir_out, sample_pdf=bpdf)
    dir_out = normalize(dir_out, eps=1e-30)
    new_ro = offset_origin(hit.pos, hit.geo_n, dir_out)
    return new_ro, dir_out, FG, bpdf, sample_ok


def _arrival_contribs(scene: Scene, prev_pos, dir_out, FG, bpdf, spec, sample_ok, active, new_hit):
    """Contributions found by tracing the sampled ray (path_tracing.h:82-100).

    Returns (miss_term, C2_term, contrib), each lane-masked and not yet
    scaled by the running throughput."""
    n_lights = scene.meta.n_lights
    n_slots = n_lights + (1 if scene.meta.has_envmap else 0)
    contrib = safe_div(FG, bpdf[:, None], 0.0)  # FG / bsdf_pdf
    bpdf_c = torch.clamp(bpdf, max=1e18)

    # miss -> background (path_tracing.h:82-87): an escape toward the
    # environment map is MIS-weighted against its NEE slot; the flat
    # background keeps the reference's full credit
    miss = sample_ok & ~new_hit.valid
    if scene.meta.has_envmap:
        lp_env = torch.clamp(envmap_pdf(scene.envmap, dir_out) / n_slots, max=1e18)
        w_env_bs = torch.where(
            spec,
            safe_div(torch.ones_like(bpdf), bpdf, 0.0),
            safe_div(bpdf_c, lp_env * lp_env + bpdf_c * bpdf_c, 0.0),
        )
        miss_radiance = FG * _background(scene, dir_out) * w_env_bs[:, None]
    else:
        miss_radiance = contrib * _background(scene, dir_out)
    miss_term = torch.where((active & miss)[:, None], miss_radiance, 0.0)

    # emitter hit -> C2 with the power-heuristic weight (path_tracing.h:88-100)
    C2 = torch.zeros_like(prev_pos)
    if n_lights > 0 and scene.meta.has_area_lights:
        hit_em = new_hit.valid & (new_hit.light_id >= 0)
        d2 = safe_norm(new_hit.pos - prev_pos)
        cos_l = torch.clamp(dot(-new_hit.geo_n, dir_out), min=0.0)
        apdf = area_pdf_from_hit_geom(new_hit.light_geom, new_hit.pos, prev_pos)
        apdf = torch.where(hit_em, apdf, 0.0)
        lp = safe_div(apdf * d2 * d2, torch.clamp(cos_l, min=1e-12) * n_slots, 0.0)
        lp = torch.clamp(lp, max=1e18)
        w = torch.where(
            spec,
            safe_div(torch.ones_like(bpdf), bpdf, 0.0),
            safe_div(bpdf_c, lp * lp + bpdf_c * bpdf_c, 0.0),
        )
        C2 = FG * new_hit.emit * torch.where(hit_em & sample_ok, w, 0.0)[:, None]
    C2_term = torch.where(active[:, None], C2, 0.0)
    return miss_term, C2_term, contrib


def _bounce_step(scene: Scene, streams, i, state):
    """One wavefront bounce (the body of path_tracing.h:20-109).

    Args:
        state: (ro, rd, hit, active) — current vertex per lane.
        i: bounce index (Python int) — keys the RNG counters.
    Returns:
        (new_state, c, w): radiance increment `c` [N, 3] and throughput
        factor `w` [N, 3], both excluding the running throughput. Dead lanes
        give c == 0 and w == 1.
    """
    ro, rd, hit, active = state
    N = ro.shape[0]
    sp = make_shade_point(scene, hit)
    spec = is_specular(sp)

    c = _vertex_nee(scene, streams, i, hit, sp, spec, active, ro, rd)
    new_ro, dir_out, FG, bpdf, sample_ok = _vertex_sample(scene, streams, i, hit, sp, rd)
    new_hit = intersect_scene(
        scene, new_ro, dir_out, ro.new_full((N,), C_EPSILON),
        torch.where(active & sample_ok, float("inf"), DEAD_TMAX),
    )
    miss_term, C2_term, contrib = _arrival_contribs(
        scene, hit.pos, dir_out, FG, bpdf, spec, sample_ok, active, new_hit
    )
    c = c + miss_term + C2_term

    # throughput factor (path_tracing.h:107); dead lanes keep w == 1
    w = torch.where(active[:, None], contrib, 1.0)
    new_active = active & sample_ok & new_hit.valid

    # keep state well-defined on dead lanes
    keep = active[:, None]
    ro_n = torch.where(keep, new_ro, ro)
    rd_n = torch.where(keep, dir_out, rd)
    hit_n = Hit(*(
        torch.where(keep if new.dim() == 2 else active, new, old)
        for new, old in zip(new_hit, hit)
    ))
    return (ro_n, rd_n, hit_n, new_active), c, w


def rr_step(options: RenderOptions, streams, i, state, c, w, T):
    """Russian roulette after a bounce's contributions (unbiased).

    At bounce i >= options.rr_depth each live lane survives with
    p = clamp(max-channel of T * w, 0.05, 1) and is reweighted by 1/p.
    p comes from detached T and w: the survival probability is an
    estimator's choice, not a differentiated quantity. Identity when
    rr_depth < 0 (the reference default).
    """
    if options.rr_depth < 0 or i < options.rr_depth:
        return state, c, w
    ro_, rd_, hit_, active_ = state
    u = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_RR))
    p = torch.clamp(torch.amax(T.detach() * w.detach(), dim=-1), 0.05, 1.0)
    survive = u < p
    w = w * torch.where(survive & active_, 1.0 / p, 1.0)[:, None]
    return (ro_, rd_, hit_, active_ & survive), c, w


def trace_mis(scene: Scene, options: RenderOptions, ro, rd, streams):
    """Trace a batch of camera rays to radiance with multi-sample MIS.

    Args:
        scene: device scene.
        ro, rd: [N, 3] primary ray origins/directions (unit).
        streams: per-path RNG streams from rng.make_stream.
    Returns:
        [N, 3] radiance.
    """
    radiance, state = _camera_vertex(scene, ro, rd)
    throughput = torch.ones_like(ro)
    for i in range(options.max_depth + 1):
        state, c, w = _bounce_step(scene, streams, i, state)
        state, c, w = rr_step(options, streams, i, state, c, w, throughput)
        radiance = radiance + throughput * c
        throughput = throughput * w
    return radiance


def trace_query_counts(scene: Scene, options: RenderOptions, ro, rd, streams):
    """Scene-query accounting for a batch of camera rays.

    Returns (nominal, active) Python-int query counts:
      nominal = what the fixed-trip loop launches (1 camera query + per
                trip 1 shadow + 1 bounce query, full width),
      active  = queries on lanes alive at that bounce (shadow queries count
                only non-specular live lanes, the reference's NEE skip,
                path_tracing.h:24-26).
    The JAX version's third count, `swept`, measures the TPU kernels'
    1024-ray dead-block skip and has no counterpart here.
    """
    N = ro.shape[0]
    _, state = _camera_vertex(scene, ro, rd)
    nominal = active_q = N
    for i in range(options.max_depth + 1):
        _, _, hit, active = state
        spec = is_specular(make_shade_point(scene, hit))
        active_q += int(active.sum()) + int((active & ~spec).sum())
        nominal += 2 * N
        state, _, _ = _bounce_step(scene, streams, i, state)
    return nominal, active_q


# ---------------------------------------------------------------------------
# Early-exit loop and path-replay backward
# ---------------------------------------------------------------------------
#
# trace_mis_replay computes trace_mis's estimator with a loop that stops once
# every lane is dead (the JAX while_loop's condition, `_running`: one host
# sync per bounce op by op; every trip inside a CUDA graph capture), and
# differentiates it by PATH REPLAY (take_tpu's
# path_tracer.py:537-731): the forward keeps only its inputs; the backward
# replays the bounce loop with the same RNG counters and takes each bounce's
# vector-Jacobian product on its own, so backward memory is O(wavefront),
# not O(wavefront x depth) like autograd through the scan loop.
#
# Math: L = sum_i T_i c_i with T_0 = 1, T_{i+1} = T_i w_i, (c_i, w_i) from
# _bounce_step. For a parameter theta:
#   dL/dtheta = sum_i T_i dc_i/dtheta + (dw_i/dtheta) T_i S_{i+1},
#   S_{i+1} = sum_{j>i} (prod_{k=i+1..j} w_k) c_j  (the suffix radiance).
# The suffix is exact by a two-pass replay: pass 1 replays without autograd
# and stores the per-bounce (c_i, w_i) stacks ([D, N, 3] each; c = 0 and
# w = 1 on bounces not reached); a reverse fold S_i = c_i + w_i S_{i+1}
# gives S_{i+1}; pass 2 replays each bounce from a detached state and pulls
# (gbar T_i, gbar T_i S_{i+1}) back through it. There is no quotient: the
# single-pass form S_{i+1} = (L - A_{i+1}) / (T_i w_i) is 0/0 wherever a
# throughput factor is exactly 0, and dropped the gradient of a pitch-black
# albedo that autograd through the scan loop matched to finite differences
# (take_tpu's room measurement, benchmarks/room_grad_fd.py). Sampled
# directions are detached (_vertex_sample), so on scenes whose lobe sampling
# does not depend on the parameters (diffuse) replay equals autograd through
# the scan loop to float precision.


def _capturing() -> bool:
    """Whether the current CUDA stream is recording a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _running(active) -> bool:
    """The replay loops' condition before each trip: take_tpu's while_loop
    condition, jnp.any(active), read on the host (one sync) op by op. A
    capture cannot read it, so under one every trip of the static bound
    (max_depth + 1) runs: the same values, since each trip is masked per
    lane by `active` (a dead lane's trip adds c = 0 and multiplies by w =
    1, as in trace_mis's scan); only the work of trips whose every lane is
    dead is spent."""
    return _capturing() or bool(active.any())


def _replay_fwd_loop(scene: Scene, options: RenderOptions, ro, rd, streams):
    """trace_mis's loop, stopping as soon as no lane is active."""
    radiance, state = _camera_vertex(scene, ro, rd)
    throughput = torch.ones_like(ro)
    for i in range(options.max_depth + 1):
        if not _running(state[3]):
            break
        state, c, w = _bounce_step(scene, streams, i, state)
        state, c, w = rr_step(options, streams, i, state, c, w, throughput)
        radiance = radiance + throughput * c
        throughput = throughput * w
    return radiance


def _detach_state(state):
    ro, rd, hit, active = state
    return ro.detach(), rd.detach(), Hit(*(None if x is None else x.detach() for x in hit)), active


class _Replay(torch.autograd.Function):
    """The early-exit forward and the two-pass replay backward. The scene's
    float tables come in as flat inputs (`tables`, keyed by `keys`), so
    autograd sees them; the backward returns their gradients."""

    @staticmethod
    def forward(ctx, scene, options, ro, rd, streams, keys, *tables):
        ctx.scene, ctx.options, ctx.keys = scene, options, keys
        ctx.rays = (ro, rd, streams)  # streams is a tuple of tensors
        return _replay_fwd_loop(scene, options, ro, rd, streams)

    @staticmethod
    def backward(ctx, gbar):
        ro, rd, streams = ctx.rays
        options, keys = ctx.options, ctx.keys
        tables = float_tables(ctx.scene)
        leaves = [tables[k].detach().requires_grad_(ctx.needs_input_grad[6 + j]) for j, k in enumerate(keys)]
        wanted = [x for x in leaves if x.requires_grad]
        scene = replace_tables(ctx.scene, dict(zip(keys, leaves)))
        gbar = gbar.detach()
        acc = [None] * len(wanted)

        def pull(outputs, cotangents):
            pairs = [(o, g) for o, g in zip(outputs, cotangents) if o.requires_grad]
            if not pairs or not wanted:
                return
            grads = torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True)
            for j, g in enumerate(grads):
                if g is not None:
                    acc[j] = g if acc[j] is None else acc[j] + g

        D = options.max_depth + 1
        N = ro.shape[0]
        # 1. the camera vertex (background and first-hit emission); the same
        #    evaluation gives the replay's initial state
        with torch.enable_grad():
            radiance0, state0 = _camera_vertex(scene, ro, rd)
            pull([radiance0], [gbar])
        state0 = _detach_state(state0)

        # 2. pass 1 without autograd: the per-bounce (c, w) stacks
        cs = ro.new_zeros((D, N, 3))
        ws = ro.new_ones((D, N, 3))
        state, T = state0, torch.ones_like(ro)
        with torch.no_grad():
            for i in range(D):
                if not _running(state[3]):
                    break
                state, c, w = _bounce_step(scene, streams, i, state)
                state, c, w = rr_step(options, streams, i, state, c, w, T)
                cs[i], ws[i] = c, w
                T = T * w

        # 3. the reverse fold S_i = c_i + w_i S_{i+1}, then pass 2: each
        #    bounce replayed from a detached state and pulled back through
        S_next = torch.zeros_like(cs)
        S = ro.new_zeros((N, 3))
        for i in range(D - 1, -1, -1):
            S_next[i] = S
            S = cs[i] + ws[i] * S
        state, T = state0, torch.ones_like(ro)
        for i in range(D):
            if not _running(state[3]):
                break
            with torch.enable_grad():
                new_state, c, w = _bounce_step(scene, streams, i, state)
                new_state, c, w = rr_step(options, streams, i, new_state, c, w, T)
                pull([c, w], [gbar * T, gbar * T * S_next[i]])
            state = _detach_state(new_state)
            T = T * w.detach()

        grads = iter(acc)
        out = [next(grads) if x.requires_grad else None for x in leaves]
        return (None, None, None, None, None, None, *out)


def trace_mis_replay(scene: Scene, options: RenderOptions, ro, rd, streams):
    """trace_mis with an early-exit bounce loop and a path-replay backward.

    The same estimator as trace_mis (the same RNG counters and per-bounce
    math), bit for bit in the primal; its backward holds O(wavefront)
    memory whatever the depth. Gradients reach the scene's float tables;
    the rays and streams get none.
    """
    tables = float_tables(scene)
    keys = tuple(tables)
    return _Replay.apply(scene, options, ro, rd, streams, keys, *(tables[k] for k in keys))
