"""The plain path tracer that decides `correct`: unidirectional path tracing
with next-event estimation and multiple importance sampling by the power
heuristic (Veach 1997, ch. 9), in plain torch.

It computes the estimator that the tracer under test states: the
pinhole camera with jitter in [0, 1) per pixel; per vertex one light
chosen uniformly, a point on it and a shadow ray, and one BSDF sample
whose ray, where it hits an emitter, adds that emitter's radiance with the
complementary weight; a miss adds the background at full weight; a path
ends at max_depth + 1 vertices or when its ray escapes. Secondary rays
start off the surface by 1.2e-4 (1 + |p|_inf) along the geometric normal,
every ray at t >= 1e-4, shadow rays stop short of the light at 0.999 of its
distance. Its draws come from the same counter RNG (rng.py), so that its
paths are the tracer's paths and a pixel can be compared with a pixel.

What is its own: the scene loader (scene.py), the triangle test (Cramer's
rule on the ray-triangle system, every triangle against every ray, in
float64 by default), and the loop, which traces only the lanes still
alive. Analytic shapes, BSDFs and emitters are modules found by type name
(shapes/, materials/, lights/): the loop asks a lane's modules for its
intersections, samples and pdfs, and knows none of their types. Autograd
through it gives the gradients of the same estimator with respect to the
materials' parameters and the emitters' scale (`params`, `light_scale`).
"""

import math

import torch

from portbench.reference import rng
from portbench.reference.frame import dot, normalize, safe_div
from portbench.reference.scene import DeviceScene, module

C_EPSILON = 1e-4  # least t of every ray
RAY_OFFSET_REL = 1.2e-4  # spawn offset per unit of the position's largest coordinate
SHADOW_SHORT = 1.0 - 1e-3  # a shadow ray ends at this share of the light's distance
PAIRS = 1 << 27  # ray-triangle pairs a block of the triangle test holds


def camera_rays(s: DeviceScene, seed: int, pix, samp):
    """Origins, unit directions and RNG streams of the paths (pixel, sample)."""
    h, dt, dev = s.host, s.dtype, pix.device
    streams = rng.make_stream(seed, pix, samp)
    jx = rng.uniform(streams, rng.JITTER_X, dt)
    jy = rng.uniform(streams, rng.JITTER_Y, dt)
    px = (pix % h.width).to(dt)
    py = torch.div(pix, h.width, rounding_mode="floor").to(dt)
    frm, at, up = (torch.tensor(x, dtype=dt, device=dev) for x in (h.lookfrom, h.lookat, h.up))
    w = normalize(frm - at)
    u = normalize(torch.linalg.cross(up, w, dim=-1))
    v = torch.linalg.cross(w, u, dim=-1)
    vp_h = 2.0 * torch.tan(torch.full((), h.vfov / 180.0 * math.pi / 2.0, dtype=dt, device=dev))
    vp_w = vp_h / h.height * h.width
    sx = ((px + jx) / h.width - 0.5) * vp_w
    sy = ((py + jy) / h.height - 0.5) * vp_h
    d = normalize(sx[:, None] * u + sy[:, None] * v - w)
    return frm.expand(d.shape), d, streams


def _system(s: DeviceScene):
    """[10, 4T]: the ray's (o x d, d, o, 1) times these columns give, per
    triangle, the determinant D of [-d, e1, e2] and the numerators of u, v
    and t by Cramer's rule."""
    if getattr(s, "_cramer", None) is None:
        v0, e1, e2 = s.v0, s.e1, s.e2
        n = torch.linalg.cross(e1, e2, dim=-1)
        z = torch.zeros_like(v0)
        rows = [
            torch.cat([z, -n, z, z[:, :1]], 1),  # D = -d.n
            torch.cat([e2, torch.linalg.cross(v0, e2, dim=-1), z, z[:, :1]], 1),  # D u
            torch.cat([-e1, torch.linalg.cross(e1, v0, dim=-1), z, z[:, :1]], 1),  # D v
            torch.cat([z, z, n, -dot(v0, n)[:, None]], 1),  # D t
        ]
        s._cramer = torch.stack(rows, 0).permute(2, 0, 1).reshape(10, -1)  # column j * T + tri
        s._det_eps = 1e-12 * torch.linalg.vector_norm(n, dim=-1)
    return s._cramer, s._det_eps


def _hits(s: DeviceScene, ro, rd, tmin, tmax):
    """(t, u, v, ok) of every ray against every triangle, [R, T] each."""
    M, eps = _system(s)
    gd = M.dtype
    o, d = ro.to(gd), rd.to(gd)
    feats = torch.cat([torch.linalg.cross(o, d, dim=-1), d, o, torch.ones_like(o[:, :1])], 1)
    D, Du, Dv, Dt = (feats @ M).view(-1, 4, M.shape[1] // 4).unbind(1)
    ok = D.abs() > eps
    inv = 1.0 / torch.where(ok, D, torch.ones_like(D))
    u, v, t = Du * inv, Dv * inv, Dt * inv
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin.to(gd)[:, None]) & (t <= tmax.to(gd)[:, None])
    return t, u, v, ok


def _blocks(s: DeviceScene, n):
    step = max(1, PAIRS // max(1, s.v0.shape[0]))
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


def closest(s: DeviceScene, ro, rd, tmin, tmax):
    """(found, t, u, v, tri) of the nearest triangle in [tmin, tmax] of each
    ray; rays with tmax <= 0 are not traced and miss."""
    N, dt, dev = ro.shape[0], s.dtype, ro.device
    found = torch.zeros(N, dtype=torch.bool, device=dev)
    t_out, u_out, v_out = (torch.zeros(N, dtype=dt, device=dev) for _ in range(3))
    tri = torch.zeros(N, dtype=torch.int64, device=dev)
    live = torch.nonzero(tmax > 0.0)[:, 0]
    for b in _blocks(s, live.shape[0]):
        idx = live[b]
        t, u, v, ok = _hits(s, ro[idx], rd[idx], tmin[idx], tmax[idx])
        best_t, best = torch.where(ok, t, math.inf).min(dim=1)
        hit = torch.isfinite(best_t)
        pick = best[:, None]
        found[idx], tri[idx] = hit, best
        t_out[idx] = best_t.to(dt).where(hit, 0.0)
        u_out[idx] = u.gather(1, pick)[:, 0].to(dt).where(hit, 0.0)
        v_out[idx] = v.gather(1, pick)[:, 0].to(dt).where(hit, 0.0)
    return found, t_out, u_out, v_out, tri


def occluded(s: DeviceScene, ro, rd, tmin, tmax):
    """Whether any triangle or primitive lies in [tmin, tmax] of each ray; rays with tmax <= 0 are not traced."""
    occ = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    live = torch.nonzero(tmax > 0.0)[:, 0]
    for b in _blocks(s, live.shape[0]):
        idx = live[b]
        occ[idx] = _hits(s, ro[idx], rd[idx], tmin[idx], tmax[idx])[3].any(dim=1)
    for g in s.groups:
        occ = occ | g.module.occluded(g.data, ro, rd, tmin, tmax)
    return occ


def _where(mask, a, b):
    return torch.where(mask.view(-1, *[1] * (a.dim() - 1)), a, b)


def intersect(s: DeviceScene, ro, rd, tmin, tmax, emit, group_emit):
    """The surface each ray finds: a dict of [N] and [N, 3] tensors. `emit`
    and `group_emit` are the emission of each triangle and of each group's
    primitives."""
    found, t, u, v, tri = closest(s, ro, rd, tmin, tmax)
    shape, prim = torch.zeros_like(tri), tri
    for gi, g in enumerate(s.groups, 1):  # a primitive nearer than the triangle found takes the lane
        f2, t2, p2 = g.module.closest(g.data, ro, rd, tmin, torch.where(found, t.to(tmax.dtype), tmax))
        found, t = found | f2, torch.where(f2, t2.to(t.dtype), t)
        shape, prim = torch.where(f2, gi, shape), torch.where(f2, p2, prim)
    pos = ro + rd * torch.where(found, t, 1.0)[:, None]
    g, mat, light, em, shading = s.geo_n[tri], s.mat[tri], s.light[tri], emit[tri], []
    for gi, (grp, ge) in enumerate(zip(s.groups, group_emit), 1):
        mask = shape == gi
        p = torch.where(mask, prim, 0)
        gn, sn = grp.module.surface(grp.data, p, pos)
        g, em = _where(mask, gn, g), _where(mask, ge[p], em)
        mat, light = torch.where(mask, grp.mat[p], mat), torch.where(mask, grp.light[p], light)
        shading.append((mask, sn))
    front = torch.sum(rd * g, dim=-1, keepdim=True) < 0.0
    geo_n = torch.where(front, g, -g)
    vn = s.normals[tri]
    interp = normalize((1.0 - u - v)[:, None] * vn[:, 0] + u[:, None] * vn[:, 1] + v[:, None] * vn[:, 2], eps=1e-30)
    sh_n = torch.where(s.has_normals[tri][:, None], interp, geo_n)
    for mask, sn in shading:
        sh_n = _where(mask, sn, sh_n)
    return {"valid": found, "pos": pos, "geo_n": geo_n, "sh_n": sh_n, "mat": mat,
            "light": torch.where(found, light, -1), "emit": em, "shape": shape, "prim": prim}


def _offset(pos, geo_n, direction):
    delta = RAY_OFFSET_REL * (1.0 + torch.amax(pos.abs(), dim=-1, keepdim=True))
    return pos + torch.sign(torch.sum(direction * geo_n, dim=-1, keepdim=True)) * delta * geo_n


def _blend(parts):
    """Each lane's value from the part of its type: parts is [(mask, value or tuple)]."""
    out = None
    for mask, val in parts:
        if out is None:
            out = val
        elif isinstance(val, tuple):
            out = tuple(_where(mask, a, b) for a, b in zip(val, out))
        elif isinstance(val, dict):
            out = {k: _where(mask, val[k], out[k]) for k in val}
        else:
            out = _where(mask, val, out)
    return out


def _nee_skip(p, geo_n, dir_in, light_dir):
    return (dot(geo_n, light_dir) < 0.0) | (dot(geo_n, dir_in) < 0.0)


class _Materials:
    """Each lane's BSDF by its material's type module, blended per lane."""

    def __init__(self, s: DeviceScene, params, mat):
        self.kinds = [(module("materials", k), s.mat_kind[mat] == i) for i, k in enumerate(s.kinds)]
        self.p = {name: table[mat] for name, table in params.items()}

    def _call(self, fn, *args, default=None):
        return _blend([(mask, getattr(mod, fn, default)(self.p, *args)) for mod, mask in self.kinds])

    def sample(self, *a):
        return self._call("sample", *a)

    def eval(self, *a):
        return self._call("eval", *a)

    def pdf(self, *a):
        return self._call("pdf", *a)

    def eval_sampled(self, n, geo_n, dir_in, dir_out, pdf):
        return _blend([(mask, mod.eval_sampled(self.p, n, geo_n, dir_in, dir_out, pdf) if hasattr(mod, "eval_sampled")
                        else mod.eval(self.p, n, geo_n, dir_in, dir_out)) for mod, mask in self.kinds])

    def nee_skip(self, *a):
        return self._call("nee_skip", *a, default=_nee_skip)

    def specular(self):
        """Lanes whose sample is a delta lobe, or None where no type has one."""
        if not any(hasattr(mod, "specular") for mod, _ in self.kinds):
            return None
        return _blend([(mask, mod.specular(self.p) if hasattr(mod, "specular") else torch.zeros_like(mask))
                       for mod, mask in self.kinds])


class _Lights:
    """The scene's light slots, one chosen uniformly at each vertex, by their type modules."""

    def __init__(self, s: DeviceScene, light_scale):
        self.s, self.n = s, s.light_kind.shape[0]
        self.emit = s.light_emit if light_scale is None else s.light_emit * light_scale
        self.mods = [module("lights", k) for k in s.light_kinds]
        self.first = [int(torch.nonzero(s.light_kind == i)[0, 0]) for i in range(len(self.mods))]

    def sample(self, slot, pos, draw):
        """(the modules' sample dict, the lanes of delta lights or None)."""
        kind = self.s.light_kind[slot]
        parts, delta = [], None
        for i, mod in enumerate(self.mods):
            mask = kind == i
            own = slot if len(self.mods) == 1 else torch.where(mask, slot, self.first[i])
            parts.append((mask, mod.sample(self.s, own, pos, draw, self.n, self.emit)))
            if getattr(mod, "DELTA", False):
                delta = mask if delta is None else delta | mask
        return _blend(parts), delta

    def hit_pdf(self, hit, em, ref_pos, direction):
        """The light pdf of a BSDF sample that hits an emitter, or None where no light lies on a surface."""
        kind = self.s.light_kind[torch.clamp(hit["light"], min=0)]
        on = [(i, m) for i, m in enumerate(self.mods) if hasattr(m, "hit_pdf")]
        return _blend([(kind == i, m.hit_pdf(self.s, hit, em if len(on) == 1 else em & (kind == i), ref_pos,
                                             direction, self.n)) for i, m in on])

    def escapes(self, dirs):
        """[(radiance, pdf)] of each light at infinity along `dirs`."""
        return [m.escape(self.s, dirs, self.n) for m in self.mods if hasattr(m, "escape")]

    def seen(self, dirs):
        """What a camera ray that escapes sees: the lights at infinity, or the flat background."""
        found = self.escapes(dirs)
        return sum(r for r, _ in found) if found else self.s.background.expand(dirs.shape)


def radiance(s: DeviceScene, seed: int, pix, samp, max_depth: int, params=None, light_scale=None):
    """[N, 3] radiance of the paths (pixel `pix`, sample `samp`): pixel
    index y * width + x, y counted from the bottom row. `params` replaces
    the material parameter tables ({name: [M, ...]}) and `light_scale` (a
    0-d tensor) scales every emitter on a shape: autograd reaches both."""
    params = s.mat_params if params is None else {**s.mat_params, **params}
    emit = s.emit if light_scale is None else s.emit * light_scale
    group_emit = [g.emit if light_scale is None else g.emit * light_scale for g in s.groups]
    lights = _Lights(s, light_scale)
    n_slots = lights.n
    ro, rd, streams = camera_rays(s, seed, pix, samp)
    N, dt, dev = ro.shape[0], s.dtype, ro.device
    inf, dead = torch.full((N,), math.inf, dtype=dt, device=dev), torch.full((N,), -1.0, dtype=dt, device=dev)
    eps = torch.full((N,), C_EPSILON, dtype=dt, device=dev)
    hit = intersect(s, ro, rd, eps, inf, emit, group_emit)
    v = hit["valid"][:, None]
    out = torch.where(v, 0.0, lights.seen(rd)) + torch.where(v, hit["emit"], 0.0)
    active, throughput = hit["valid"], torch.ones_like(ro)
    for i in range(max_depth + 1):
        if not bool(active.any()):
            break

        def draw(dim, i=i):
            return rng.uniform(streams, rng.bounce_counter(i, dim), dt)

        pos, geo_n, dir_in = hit["pos"], hit["geo_n"], -rd
        n = torch.where(torch.sum(hit["sh_n"] * dir_in, dim=-1, keepdim=True) < 0.0, -hit["sh_n"], hit["sh_n"])
        mats = _Materials(s, params, hit["mat"])
        spec = mats.specular()

        # next-event estimation: one light, uniformly
        c = torch.zeros_like(ro)
        if n_slots:
            slot = torch.clamp((draw(rng.LIGHT_SELECT) * n_slots).to(torch.int32), 0, n_slots - 1).long()
            ls, delta = lights.sample(slot, pos, draw)
            ldir = ls["dir"]
            useless = mats.nee_skip(geo_n, dir_in, ldir) | ~ls["valid"]
            if spec is not None:
                useless = useless | spec
            tmax = torch.where(active & ~useless, SHADOW_SHORT * ls["dist"], dead)
            occ = occluded(s, _offset(pos, geo_n, ldir), ldir, eps, tmax)
            fg = mats.eval(n, geo_n, dir_in, ldir)
            bp = torch.clamp(mats.pdf(n, geo_n, dir_in, ldir), max=1e18)
            lp = ls["pdf"]
            w = safe_div(lp, lp * lp + bp * bp)
            ok = (bp > 0.0) & ls["valid"] & ~occ
            if delta is not None:
                w = torch.where(delta, safe_div(torch.ones_like(lp), lp), w)
                ok = ((bp > 0.0) | delta) & ls["valid"] & ~occ
            c = torch.where(active[:, None], fg * ls["radiance"] * torch.where(ok, w, 0.0)[:, None], 0.0)
            if spec is not None:
                c = torch.where(spec[:, None], 0.0, c)

        # one BSDF sample
        dout, bpdf = mats.sample(n, geo_n, dir_in, draw)
        sample_ok = bpdf > 0.0
        dout = torch.where(sample_ok[:, None], dout, torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev))
        fg = mats.eval_sampled(n, geo_n, dir_in, dout, bpdf)
        dout = normalize(dout, eps=1e-30)
        new_ro = _offset(pos, geo_n, dout)
        new = intersect(s, new_ro, dout, eps, torch.where(active & sample_ok, inf, dead), emit, group_emit)
        contrib = safe_div(fg, bpdf[:, None])
        bpdf_c = torch.clamp(bpdf, max=1e18)

        def weight(lp):  # the BSDF sample's power-heuristic weight, 1 / pdf on a delta lobe
            w = safe_div(bpdf_c, lp * lp + bpdf_c * bpdf_c)
            return w if spec is None else torch.where(spec, safe_div(torch.ones_like(bpdf), bpdf), w)

        miss = active & sample_ok & ~new["valid"]
        escapes = lights.escapes(dout)
        for le, lp in escapes:
            c = c + torch.where(miss[:, None], fg * le * weight(lp)[:, None], 0.0)
        if not escapes:
            c = c + torch.where(miss[:, None], contrib * s.background, 0.0)
        if n_slots:
            em = new["valid"] & (new["light"] >= 0)
            lp2 = lights.hit_pdf(new, em, pos, dout)
            if lp2 is not None:
                w2 = weight(lp2)
                c = c + torch.where(active[:, None], fg * new["emit"] * torch.where(em & sample_ok, w2, 0.0)[:, None],
                                    0.0)
        out = out + throughput * c
        throughput = throughput * torch.where(active[:, None], contrib, 1.0)
        keep = active[:, None]
        rd = torch.where(keep, dout, rd)
        hit = {k: torch.where(keep if x.dim() == 2 else active, x, hit[k]) for k, x in new.items()}
        active = active & sample_ok & new["valid"]
    return out


def render_pixels(s: DeviceScene, seed: int, pixels, spp: int, max_depth: int, sample0: int = 0,
                  paths_per_block: int = 1 << 20, params=None, light_scale=None):
    """[P, 3] mean radiance of `pixels` over samples sample0 .. sample0 + spp - 1,
    each pixel's samples added in order, in blocks of paths."""
    out = []
    per = max(1, paths_per_block // spp)
    for a in range(0, pixels.shape[0], per):
        pix = pixels[a:a + per]
        P = pix.shape[0]
        samp = sample0 + torch.arange(spp, device=pix.device)
        rad = radiance(s, seed, pix.repeat_interleave(spp), samp.repeat(P), max_depth, params, light_scale)
        rad = rad.view(P, spp, 3)
        acc = rad[:, 0]
        for k in range(1, spp):
            acc = acc + rad[:, k]
        out.append(acc / spp)
    return torch.cat(out)
