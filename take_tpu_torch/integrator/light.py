"""The light phase of a bounce: NEE's light sample, its MIS weights and the
arrival's contributions (path_tracing.h:30-60, :82-100), three calls a trip
of integrator/path_tracer.py's loop.

  * `sample`: the NEE slot picked among the lights and the environment map
    (uniform selection), a point on the slot's light (lights.sample_on_light),
    the shadow ray's direction and range, and what the rest of the phase
    needs (`NeeLight`);
  * `nee`: NEE's contribution C1 from the BSDF's value and pdf at the light
    direction and the shadow query's answer: the power heuristic with
    squared pdfs on the solid-angle light pdf (path_tracing.h:55), delta
    NEE for point lights, the environment map's slot;
  * `arrival`: what tracing the sampled ray found: FG / bpdf, an escape's
    background (MIS-weighted against the environment slot), an emitter
    hit's C2 (path_tracing.h:99).

On CUDA tensors each launches a hand-written kernel of csrc/light.cu, one
launch a call, or raises; under autograd (grad enabled and an input that
requires grad) through an autograd Function whose backward is the plain
version's. On CPU tensors they run the plain versions below
(`_sample_plain`, `_nee_plain`, `_arrival_plain`: path_tracer's code,
factored out), whose arithmetic the kernels repeat. `LAUNCHES` counts what
ran: each kernel launch, and each call of a plain version. The environment
map's sample, lookups and pdf stay with the caller (phase envmap) and come
in as inputs; so do the RNG's draws.
"""

import ctypes
import types
from typing import NamedTuple

import torch

from take_tpu_torch.core.math import dot, gather_rows, safe_div, safe_norm
from take_tpu_torch.geometry._launch import Field, declare, field, raise_on
from take_tpu_torch.lights.lights import area_pdf_from_hit_geom, area_pdf_from_sample, sample_on_light
from take_tpu_torch.scene.types import LATTR_DIM, LATTR_INTENSITY

LAUNCHES = {key: 0 for entry in ("sample", "nee", "arrival") for key in (f"light_{entry}", f"light_{entry}_plain")}


class NeeLight(NamedTuple):
    """`sample`'s result, [N] a lane but light_dir."""

    light_dir: torch.Tensor  # [N, 3] the shadow ray's direction
    tmax: torch.Tensor  # its range: just short of the light; inf toward the environment
    back: torch.Tensor  # bool: an area light seen from behind (its contribution is 0)
    row: torch.Tensor  # int32: the light's row of scene.lights.attr
    is_env: torch.Tensor  # bool: the environment slot
    is_area: torch.Tensor  # bool: an area light
    lit: torch.Tensor  # bool: the cosine at the light's point is positive
    lp: torch.Tensor  # an area light's solid-angle pdf (over the n_slots of the pick)
    inv_d2: torch.Tensor  # 1 / d^2 of the light's point


def slots(meta) -> int:
    """NEE slots: the lights, and the environment map as one more."""
    return meta.n_lights + (1 if meta.has_envmap else 0)


# -- The plain versions (CPU tensors; the Function's backward) --


def _sample_plain(scene, u_sel, u1, u2, pos, rd, env_dir):
    meta = scene.meta
    n_lights, n_slots = meta.n_lights, slots(meta)
    N = pos.shape[0]
    slot = torch.clamp((u_sel * n_slots).to(torch.int32), 0, n_slots - 1)
    if n_lights > 0:
        row = torch.clamp(slot, max=n_lights - 1)
        ls = sample_on_light(scene, row, pos, u1, u2)
        delta = ls.position - pos
        d = safe_norm(delta)
        light_dir = delta / torch.clamp(d, min=1e-30)[:, None]
        tmax = (1.0 - 1e-3) * d
    else:
        row = torch.zeros_like(slot)
        light_dir = rd
        tmax = pos.new_full((N,), float("inf"))
    if meta.has_envmap:
        is_env = slot == n_lights
        light_dir = torch.where(is_env[:, None], env_dir, light_dir)
        tmax = torch.where(is_env, float("inf"), tmax)
    else:
        is_env = torch.zeros(N, dtype=torch.bool, device=pos.device)
    if n_lights == 0:
        no, zero = torch.zeros_like(is_env), pos.new_zeros(N)
        return NeeLight(light_dir, tmax, no, row, is_env, no, no, zero, zero)
    # a light seen from behind gives 0 for every parameter value: the caller
    # skips its shadow query
    cos = dot(-ls.normal, light_dir)
    back = (~is_env) & ls.is_area & (cos <= 0.0)
    cos_l = torch.clamp(cos, min=0.0)
    apdf = area_pdf_from_sample(ls, ls.position, pos)
    # solid-angle light pdf (path_tracing.h:39), cos floored before the
    # division so a grazing light gets weight -> 0
    lp = torch.clamp(
        safe_div(apdf * d * d, torch.clamp(cos_l, min=1e-12) * n_slots, 0.0),
        max=1e18,
    )
    inv_d2 = safe_div(torch.ones_like(d), d * d, 0.0)
    return NeeLight(light_dir, tmax, back, row, is_env, ls.is_area, cos_l > 0.0, lp, inv_d2)


def _nee_plain(scene, lights, row, is_env, is_area, lit, lp, inv_d2, FG, bp, occluded, spec, active, Li_env, env_pdf):
    meta = scene.meta
    n_slots = slots(meta)
    C1 = torch.zeros_like(FG)
    if meta.has_area_lights or meta.has_point_lights:
        # only the intensity columns are differentiable (lights.gather_light_attrs)
        intensity = gather_rows(lights[:, LATTR_INTENSITY : LATTR_INTENSITY + 3], row.long())
    if meta.has_area_lights:
        w = safe_div(lp, lp * lp + bp * bp, 0.0)  # power heuristic / lp
        ok = (~is_env) & is_area & (bp > 0.0) & lit & (~occluded)
        C1 = C1 + FG * intensity * torch.where(ok, w, 0.0)[:, None]
    if meta.has_point_lights:
        # delta light: estimator I/d^2 / pmf_select, no MIS partner
        okp = (~is_env) & (~is_area) & (~occluded)
        C1 = C1 + FG * intensity * torch.where(okp, inv_d2 * n_slots, 0.0)[:, None]
    if meta.has_envmap:
        lp_env = torch.clamp(env_pdf / n_slots, max=1e18)
        w_env = safe_div(lp_env, lp_env * lp_env + bp * bp, 0.0)
        ok_env = is_env & (bp > 0.0) & (env_pdf > 0.0) & (~occluded)
        C1 = C1 + FG * Li_env * torch.where(ok_env, w_env, 0.0)[:, None]
    return torch.where((spec | ~active)[:, None], 0.0, C1)


def _arrival_plain(scene, prev_pos, dir_out, FG, bpdf, spec, sample_ok, active, valid, light_id, hit_pos, geo_n,
                   light_geom, emit, background, env_pdf):
    meta = scene.meta
    n_slots = slots(meta)
    contrib = safe_div(FG, bpdf[:, None], 0.0)  # FG / bsdf_pdf
    bpdf_c = torch.clamp(bpdf, max=1e18)

    # miss -> background (path_tracing.h:82-87): an escape toward the
    # environment map is MIS-weighted against its NEE slot; the flat
    # background keeps the reference's full credit
    miss = sample_ok & ~valid
    if meta.has_envmap:
        lp_env = torch.clamp(env_pdf / n_slots, max=1e18)
        w_env_bs = torch.where(
            spec,
            safe_div(torch.ones_like(bpdf), bpdf, 0.0),
            safe_div(bpdf_c, lp_env * lp_env + bpdf_c * bpdf_c, 0.0),
        )
        miss_radiance = FG * background * w_env_bs[:, None]
    else:
        miss_radiance = contrib * background
    miss_term = torch.where((active & miss)[:, None], miss_radiance, 0.0)

    # emitter hit -> C2 with the power-heuristic weight (path_tracing.h:88-100)
    C2 = torch.zeros_like(prev_pos)
    if meta.n_lights > 0 and meta.has_area_lights:
        hit_em = valid & (light_id >= 0)
        d2 = safe_norm(hit_pos - prev_pos)
        cos_l = torch.clamp(dot(-geo_n, dir_out), min=0.0)
        apdf = area_pdf_from_hit_geom(light_geom, hit_pos, prev_pos)
        apdf = torch.where(hit_em, apdf, 0.0)
        lp = safe_div(apdf * d2 * d2, torch.clamp(cos_l, min=1e-12) * n_slots, 0.0)
        lp = torch.clamp(lp, max=1e18)
        w = torch.where(
            spec,
            safe_div(torch.ones_like(bpdf), bpdf, 0.0),
            safe_div(bpdf_c, lp * lp + bpdf_c * bpdf_c, 0.0),
        )
        C2 = FG * emit * torch.where(hit_em & sample_ok, w, 0.0)[:, None]
    C2_term = torch.where(active[:, None], C2, 0.0)
    return miss_term, C2_term, contrib


_PLAIN = {"sample": _sample_plain, "nee": _nee_plain, "arrival": _arrival_plain}


# -- The kernels (csrc/light.cu) --


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# each entry's tensor arguments after the scene, in its plain version's
# order: (light.cu's Inputs field, dtype, width); "lights" is the light
# table, read whole
_ARGS = {
    "sample": (("u_sel", _F32, 1), ("u1", _F32, 1), ("u2", _F32, 1), ("pos", _F32, 3), ("rd", _F32, 3),
               ("env_dir", _F32, 3)),
    "nee": (("lights", _F32, LATTR_DIM), ("row", _I32, 1), ("is_env", _BOOL, 1), ("is_area", _BOOL, 1),
            ("lit", _BOOL, 1), ("lp", _F32, 1), ("inv_d2", _F32, 1), ("fg", _F32, 3), ("bp", _F32, 1),
            ("occluded", _BOOL, 1), ("spec", _BOOL, 1), ("active", _BOOL, 1), ("li_env", _F32, 3),
            ("env_pdf", _F32, 1)),
    "arrival": (("prev_pos", _F32, 3), ("dir_out", _F32, 3), ("fg", _F32, 3), ("bpdf", _F32, 1),
                ("spec", _BOOL, 1), ("sample_ok", _BOOL, 1), ("active", _BOOL, 1), ("valid", _BOOL, 1),
                ("light_id", _I32, 1), ("hit_pos", _F32, 3), ("geo_n", _F32, 3), ("light_geom", _F32, 1),
                ("emit", _F32, 3), ("background", _F32, 3), ("env_pdf", _F32, 1)),
}
_LANES = {"sample": 3, "nee": 7, "arrival": 2}  # the argument whose rows are the lanes: pos, fg, fg
# each entry's outputs: (light.cu's Outputs field, dtype, width)
_OUTS = {
    "sample": (("light_dir", _F32, 3), ("tmax", _F32, 1), ("back", _BOOL, 1), ("row", _I32, 1), ("is_env", _BOOL, 1),
               ("is_area", _BOOL, 1), ("lit", _BOOL, 1), ("lp", _F32, 1), ("inv_d2", _F32, 1)),
    "nee": (("c1", _F32, 3),),
    "arrival": (("miss", _F32, 3), ("c2", _F32, 3), ("contrib", _F32, 3)),
}
# light.cu's Inputs: each entry's fields in turn, a field two entries read once
_FIELDS = tuple(dict.fromkeys(name for args in _ARGS.values() for name, _, _ in args if name != "lights"))
_META = ("n_lights", "n_slots", "has_envmap", "has_sph", "has_area", "has_point")


class _Inputs(ctypes.Structure):
    _fields_ = ([(name, Field) for name in _FIELDS] + [("lights", ctypes.c_void_p), ("n", ctypes.c_int64)]
                + [(name, ctypes.c_int32) for name in _META])


class _Outputs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for entry in ("sample", "nee", "arrival") for name, _, _ in _OUTS[entry]]


def _table(lights, device):
    """The light table's address: a contiguous float32 [Lpad, LATTR_DIM] tensor on `device`."""
    if (lights.device != device or lights.dtype != _F32 or lights.dim() != 2 or lights.shape[1] != LATTR_DIM
            or not lights.is_contiguous()):
        raise ValueError(f"lights: expected a contiguous float32 [L, {LATTR_DIM}] tensor on {device}, got "
                         f"{lights.dtype} {tuple(lights.shape)} on {lights.device}")
    return lights.data_ptr()


def _launch(entry, scene, *xs):
    """One launch of take_light_<entry>: the tuple of its outputs (_OUTS)."""
    lane = xs[_LANES[entry]]
    n, dev = lane.shape[0], lane.device
    meta = scene.meta
    ins = _Inputs(n=n, n_lights=meta.n_lights, n_slots=slots(meta), has_envmap=meta.has_envmap,
                  has_sph=meta.n_sph > 0, has_area=meta.has_area_lights, has_point=meta.has_point_lights)
    for (name, dtype, width), x in zip(_ARGS[entry], xs):
        if name == "lights":
            ins.lights = _table(x, dev)
        elif x is not None:
            setattr(ins, name, field(name, x, n, dtype, width, dev))
    if entry == "sample":
        ins.lights = _table(scene.lights.attr.detach(), dev)  # geometry only: detached, as lights.gather_light_attrs
    outs = tuple(torch.empty((n,) if width == 1 else (n, width), dtype=dtype, device=dev)
                 for _, dtype, width in _OUTS[entry])
    ptrs = _Outputs(**{name: o.data_ptr() for (name, _, _), o in zip(_OUTS[entry], outs)})
    if n:
        fn = getattr(_lib(), f"tt_light_{entry}")
        raise_on(_lib(), fn(ctypes.byref(ins), ctypes.byref(ptrs), torch.cuda.current_stream(dev).cuda_stream),
                 f"take_light_{entry}")
    return outs


class _Light(torch.autograd.Function):
    """take_light_<entry> forward. The backward computes the plain version
    again on detached inputs and pulls the cotangents through it, so that
    gradients through the kernel are the plain version's.
    apply(entry, scene, *its tensor arguments)."""

    @staticmethod
    def forward(ctx, entry, scene, *xs):
        ctx.entry, ctx.scene = entry, scene
        ctx.save_for_backward(*xs)
        outs = _launch(entry, scene, *xs)
        ctx.mark_non_differentiable(*(o for o in outs if not o.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        xs, need = ctx.saved_tensors, ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if x is None else x.detach().requires_grad_(want) for x, want in zip(xs, need)]
            outs = _PLAIN[ctx.entry](ctx.scene, *leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pulled = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wanted = [x for x in leaves if x is not None and x.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in pulled], wanted, [g for _, g in pulled], allow_unused=True)
                       if pulled and wanted else [None] * len(wanted))
        return (None, None, *[next(got) if want else None for want in need])


def _route(entry, scene, *xs):
    """The kernel for CUDA tensors (through its autograd Function where a
    gradient is wanted), the plain version for CPU tensors. Returns a tuple."""
    key = f"light_{entry}"
    if not xs[_LANES[entry]].is_cuda:
        LAUNCHES[f"{key}_plain"] += 1
        out = _PLAIN[entry](scene, *xs)
        return out if isinstance(out, tuple) else (out,)
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs):
        out = _Light.apply(entry, scene, *xs)
    else:
        out = _launch(entry, scene, *xs)
    LAUNCHES[key] += 1
    return out


def sample(scene, u_sel, u1, u2, pos, rd, env_dir=None) -> NeeLight:
    """NEE's light sample at the vertices `pos` [N, 3] reached along `rd`:
    u_sel picks the slot, u1 and u2 the light's point; `env_dir` [N, 3] is
    the environment map's sample where the scene has one (slot n_lights)."""
    return NeeLight(*_route("sample", scene, u_sel, u1, u2, pos, rd, env_dir))


def nee(scene, ls: NeeLight, FG, bp, occluded, spec, active, Li_env=None, env_pdf=None):
    """NEE's contribution C1 [N, 3] (path_tracing.h:30-60): FG and bp, the
    BSDF's value and clamped pdf toward ls.light_dir; `occluded`, the shadow
    query's answer; 0 on `spec` and inactive lanes. Li_env and env_pdf: the
    environment map's radiance toward ls.light_dir and its sample's pdf."""
    (c1,) = _route("nee", scene, scene.lights.attr, ls.row, ls.is_env, ls.is_area, ls.lit, ls.lp, ls.inv_d2, FG, bp,
                   occluded, spec, active, Li_env, env_pdf)
    return c1


def arrival(scene, prev_pos, dir_out, FG, bpdf, spec, sample_ok, active, new_hit, background, env_pdf=None):
    """(miss_term, C2_term, contrib) of the ray sampled at `prev_pos` along
    `dir_out` that found `new_hit` (path_tracing.h:82-100): `background` is
    the radiance of an escape along dir_out (broadcast to [N, 3]), env_pdf
    the environment map's pdf of dir_out where the scene has one."""
    background = torch.broadcast_tensors(background, FG)[0]
    return _route("arrival", scene, prev_pos, dir_out, FG, bpdf, spec, sample_ok, active, new_hit.valid,
                  new_hit.light_id, new_hit.pos, new_hit.geo_n, new_hit.light_geom, new_hit.emit, background, env_pdf)


def _warm():
    """Each kernel once, on one lane, uncounted."""
    dev = torch.device("cuda", torch.cuda.current_device())
    meta = types.SimpleNamespace(n_lights=1, n_sph=1, has_envmap=True, has_area_lights=True, has_point_lights=True)
    scene = types.SimpleNamespace(meta=meta, lights=types.SimpleNamespace(attr=torch.zeros((8, LATTR_DIM), device=dev)))
    f, v = torch.zeros(1, device=dev), torch.zeros((1, 3), device=dev)
    b, i = torch.zeros(1, dtype=torch.bool, device=dev), torch.zeros(1, dtype=torch.int32, device=dev)
    ls = NeeLight(*_launch("sample", scene, f, f, f, v, v, v))
    _launch("nee", scene, scene.lights.attr, *ls[3:], v, f, b, b, b, v, f)
    _launch("arrival", scene, v, v, v, f, b, b, b, b, i, v, v, f, v, v, f)


_P = ctypes.c_void_p
# light.cu rounds every float operation as torch's separate kernels do: no
# product is contracted into an FMA that the plain version rounds twice
_lib = declare("light", {
    "tt_light_sample": [_P, _P, _P],
    "tt_light_nee": [_P, _P, _P],
    "tt_light_arrival": [_P, _P, _P],
}, launches=LAUNCHES, flags=("--fmad=false",), warm=_warm)
