"""Integrator variants: one-sample MIS and no-MIS ("raw"), port of
take_tpu/integrator/variants.py.

Counterparts of path_tracing_one_sample_MIS (path_tracing.h:161-271) and
path_tracing_raw (path_tracing.h:114-157), with the bounce loop a Python
loop of max_depth + 1 trips like trace_mis. As in the JAX package:

  * both variants add emission at the loop top when standing on an emitter
    and then terminate (path_tracing.h:122-128, :170-177),
  * one-sample MIS flips a 50/50 coin between NEE and BSDF sampling
    (path_tracing.h:187); an NEE step traces a ray to the light and lets the
    next loop top collect the emission, with throughput /= (0.5 lp + 0.5 bp)
    (path_tracing.h:212-226),
  * a BSDF step divides by (0.5 bp + 0.5 lp) when it lands on a light
    (path_tracing.h:247-266), by bp alone when specular or lightless,
  * the environment map has no NEE arm here (escapes collect it at full
    BSDF weight), and point lights add nothing: no ray hits one, and an NEE
    arm that picks one ends its path (the reference's semantics).

Every query runs at full width with tmax = +inf. Forward only. With
tracing on, the loops mark their phases as trace_mis does.
"""

import torch

from take_tpu_torch import tracing
from take_tpu_torch.core import rng
from take_tpu_torch.core.math import dot, normalize, safe_div, safe_norm
from take_tpu_torch.geometry.intersect import intersect_scene
from take_tpu_torch.integrator.path_tracer import C_EPSILON, _background, offset_origin
from take_tpu_torch.lights.lights import area_pdf, power_pmf, sample_on_light, select_power, select_uniform
from take_tpu_torch.materials.bsdf import bsdf_eval, bsdf_pdf, bsdf_sample, is_specular, make_shade_point
from take_tpu_torch.scene.types import LIGHT_AREA, Hit, RenderOptions, Scene


def _bsdf_step(scene, streams, i, sp, dir_in):
    """BSDF sample at bounce i: (dir_out unit, FG, bpdf)."""
    tracing.mark("bsdf")
    u_lobe = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LOBE_SELECT))
    ub1 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_BSDF_U1))
    ub2 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_BSDF_U2))
    ub3 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_AUX))
    dir_out, bpdf = bsdf_sample(scene, sp, dir_in, u_lobe, ub1, ub2, ub3)
    FG = bsdf_eval(scene, sp, dir_in, dir_out, sample_pdf=bpdf)
    return normalize(dir_out, eps=1e-30), FG, bpdf


def _keep(active, new, old):
    """Per-lane select of the next state: `new` where active, else `old`."""
    return torch.where(active[:, None] if new.dim() == 2 else active, new, old)


def _first_hit(scene, ro, rd):
    N = ro.shape[0]
    tmin = ro.new_full((N,), C_EPSILON)
    tmax = ro.new_full((N,), float("inf"))
    hit = intersect_scene(scene, ro, rd, tmin, tmax)
    tracing.mark("camera")
    radiance = torch.where(hit.valid[:, None], 0.0, _background(scene, rd))
    return hit, radiance, tmin, tmax


def trace_raw(scene: Scene, options: RenderOptions, ro, rd, streams):
    """Path tracing without MIS (path_tracing.h:114-157)."""
    hit, radiance, tmin, tmax = _first_hit(scene, ro, rd)
    throughput = torch.ones_like(ro)
    active = hit.valid
    for i in range(options.max_depth + 1):
        # loop-top emission + terminate (path_tracing.h:123-128)
        tracing.mark("step")
        on_light = hit.light_id >= 0
        radiance = radiance + torch.where((active & on_light)[:, None], throughput * hit.emit, 0.0)
        active = active & ~on_light

        tracing.mark("shade")
        sp = make_shade_point(scene, hit)
        dir_out, FG, bpdf = _bsdf_step(scene, streams, i, sp, -rd)
        tracing.mark("step")
        sample_ok = bpdf > 0.0
        contrib = safe_div(FG, bpdf[:, None], 0.0)
        new_throughput = torch.where((active & sample_ok)[:, None], throughput * contrib, throughput)

        new_ro = offset_origin(hit.pos, hit.geo_n, dir_out)
        new_hit = intersect_scene(scene, new_ro, dir_out, tmin, tmax)
        tracing.mark("step")
        miss = sample_ok & ~new_hit.valid
        radiance = radiance + torch.where(
            (active & miss)[:, None], new_throughput * _background(scene, dir_out), 0.0
        )
        new_active = active & sample_ok & new_hit.valid

        ro, rd = _keep(active, new_ro, ro), _keep(active, dir_out, rd)
        hit = Hit(*(_keep(active, new, old) for new, old in zip(new_hit, hit)))
        throughput, active = new_throughput, new_active
    return radiance


def trace_one_sample_mis_power(scene: Scene, options: RenderOptions, ro, rd, streams):
    """One-sample MIS with power-proportional light picking
    (path_tracing_one_sample_MIS_power, path_tracing.h:274-380): dead code in
    the reference, whose power table is never filled; here the scene's
    power CDF/PMF exist (scene/build.py), as in the JAX package."""
    return trace_one_sample_mis(scene, options, ro, rd, streams, light_select="power")


def trace_one_sample_mis(scene: Scene, options: RenderOptions, ro, rd, streams, light_select="uniform"):
    """One-sample MIS (path_tracing.h:161-271)."""
    n_lights = scene.meta.n_lights
    N = ro.shape[0]
    hit, radiance, tmin, tmax = _first_hit(scene, ro, rd)
    throughput = torch.ones_like(ro)
    active = hit.valid
    for i in range(options.max_depth + 1):
        # loop-top emission + terminate (path_tracing.h:170-177)
        tracing.mark("step")
        on_light = hit.light_id >= 0
        radiance = radiance + torch.where((active & on_light)[:, None], throughput * hit.emit, 0.0)
        active = active & ~on_light

        dir_in = -rd
        tracing.mark("shade")
        sp = make_shade_point(scene, hit)
        spec = is_specular(sp)
        tracing.mark("light")

        # NEE arm: trace a ray to the light sample; the emission is
        # collected at the next loop top (path_tracing.h:188-227)
        if n_lights > 0:
            u_tech = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_MIS_TECH))
            take_nee = (~spec) & (u_tech <= 0.5)
            u_sel = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LIGHT_SELECT))
            u1 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LIGHT_U1))
            u2 = rng.uniform(streams, rng.bounce_counter(i, rng.DIM_LIGHT_U2))
            if light_select == "power":
                light_id = select_power(scene, u_sel)
                sel_pmf = power_pmf(scene, light_id)
            else:
                light_id = select_uniform(scene, u_sel)
                sel_pmf = ro.new_full((N,), 1.0 / n_lights)
            ls = sample_on_light(scene, light_id, hit.pos, u1, u2)
            delta = ls.position - hit.pos
            d = safe_norm(delta)
            nee_dir = delta / torch.clamp(d, min=1e-30)[:, None]
            cos_l = torch.clamp(dot(-ls.normal, nee_dir), min=0.0)
            apdf = area_pdf(scene, light_id, ls.position, hit.pos)
            # solid-angle pdf x selection pmf (path_tracing.h:309 semantics)
            lp_nee = safe_div(apdf * d * d * sel_pmf, cos_l, 0.0)
            bp_nee = bsdf_pdf(scene, sp, dir_in, nee_dir)
            FG_nee = bsdf_eval(scene, sp, dir_in, nee_dir)
            nee_ok = ls.is_area & (lp_nee > 0.0) & (bp_nee > 0.0)
            w_nee = safe_div(torch.ones_like(lp_nee), 0.5 * lp_nee + 0.5 * bp_nee, 0.0)
        else:
            take_nee = torch.zeros(N, dtype=torch.bool, device=ro.device)
            nee_dir = rd
            FG_nee = torch.zeros_like(throughput)
            w_nee = ro.new_zeros(N)
            nee_ok = torch.zeros(N, dtype=torch.bool, device=ro.device)

        # BSDF arm (path_tracing.h:229-267)
        bs_dir, FG_bs, bpdf = _bsdf_step(scene, streams, i, sp, dir_in)
        bs_ok = bpdf > 0.0

        tracing.mark("step")
        dir_out = torch.where(take_nee[:, None], nee_dir, bs_dir)
        new_ro = offset_origin(hit.pos, hit.geo_n, dir_out)
        new_hit = intersect_scene(scene, new_ro, dir_out, tmin, tmax)

        # the BSDF arm's pdf depends on what it hit
        tracing.mark("light")
        if n_lights > 0:
            hit_em = new_hit.valid & (new_hit.light_id >= 0)
            lid = torch.clamp(new_hit.light_id, min=0)
            d2 = safe_norm(new_hit.pos - hit.pos)
            cos2 = torch.clamp(dot(-new_hit.geo_n, dir_out), min=0.0)
            apdf2 = area_pdf(scene, lid, new_hit.pos, hit.pos)
            hit_pmf = power_pmf(scene, lid) if light_select == "power" else ro.new_full((N,), 1.0 / n_lights)
            lp_bs = safe_div(apdf2 * d2 * d2 * hit_pmf, cos2, 0.0)
            is_area_l = scene.lights.tag[lid.long()] == LIGHT_AREA
            add_lp = (~spec) & hit_em & is_area_l
            pdf_bs = torch.where(spec, bpdf, 0.5 * bpdf) + torch.where(add_lp, 0.5 * lp_bs, 0.0)
        else:
            pdf_bs = bpdf

        # throughput update for both arms
        tracing.mark("step")
        contrib_nee = FG_nee * w_nee[:, None]
        contrib_bs = safe_div(FG_bs, pdf_bs[:, None], 0.0)
        contrib = torch.where(take_nee[:, None], contrib_nee, contrib_bs)
        step_ok = torch.where(take_nee, nee_ok, bs_ok)
        new_throughput = torch.where((active & step_ok)[:, None], throughput * contrib, throughput)

        # miss -> background (only the BSDF arm: an NEE ray hits the light or
        # an occluder, path_tracing.h:214-219)
        miss = step_ok & ~new_hit.valid
        radiance = radiance + torch.where(
            (active & miss & ~take_nee)[:, None], new_throughput * _background(scene, dir_out), 0.0
        )
        new_active = active & step_ok & new_hit.valid

        ro, rd = _keep(active, new_ro, ro), _keep(active, dir_out, rd)
        hit = Hit(*(_keep(active, new, old) for new, old in zip(new_hit, hit)))
        throughput, active = new_throughput, new_active
    return radiance
