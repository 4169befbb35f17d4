"""The closed loop that drives the program: one user who waits for each
result before asking for the next. A traffic file's `kind` picks which of
the program's two entry points a unit of work calls, and its other keys
set the unit, so that a new mix is a new data file:

  render  `render.render_image(scene, options)` at the configuration's
          estimator; a unit is one image, ending on the host. `seeds`:
          "run" renders every image at the run's seed, "per_unit" image k
          at seed + 1 + k.
  grad    one step of inverse rendering: the scene at the current raw
          parameters, `grad.render_loss_grad` with the L2 loss against a
          target rendered in set-up at the true parameters, `grad.backward`
          into the raw parameters, an Adam step and the loss read on the
          host; a unit is one step. `spp_per_step`, `grad_mode`,
          `target_spp`, `lr`, `setup_steps`; `reload_scene`: load the
          scene file anew each step (else edit the one loaded in set-up);
          `params`: each raw parameter, by its `target` ("material": the
          parameter `param` of the material of XML id `material`;
          "lights": the scale of every emitter on a shape), the `map` from
          raw to value ("sigmoid", "exp", "identity") and its `init` value.

Each loop's set-up warms every graph key its units use, and after the
window hands what the window produced to the comparison with the
reference (`numbers`). The program is looked up through its modules at
call time, so that a test can plant a fault in it.
"""

import dataclasses
import importlib
import math
import statistics
import time

import numpy as np
import torch

from portbench import checks, spec, yardstick
from portbench.reference import scene as ref_scene
from portbench.reference import tracer

WARM_UNITS = 1  # units run in set-up before the window, so that every graph key is captured
TRACED_SECONDS = 1.0  # units run under the profiler after the window, in a traced run
TARGET_SEED_OFFSET = 1  # the target of an optimisation renders at the run's seed plus this

MAPS = {"sigmoid": torch.sigmoid, "exp": torch.exp, "identity": lambda x: x}
INVERSE = {"sigmoid": lambda x: np.log(x / (1.0 - x)), "exp": np.log, "identity": lambda x: x}


def program_module(name):
    """take_tpu_torch.<name> (the package exports a function `render` that
    hides the module of that name from `from take_tpu_torch import render`)."""
    return importlib.import_module(f"take_tpu_torch.{name}")


def program_scene(config, device):
    """The configuration's scene on `device`, seen by its own camera at the configured resolution."""
    from take_tpu_torch import load_scene
    from take_tpu_torch.core.camera import Camera

    scene = load_scene(str(spec.ROOT / config["scene"]), device=device)
    cam = scene.meta.camera
    new = Camera(*config["resolution"], cam.lookfrom, cam.lookat, cam.up, cam.vfov)
    return dataclasses.replace(scene, meta=dataclasses.replace(scene.meta, camera=new))


def reference_scene(config, device, dtype=torch.float32, geom_dtype=torch.float64):
    host = ref_scene.load(spec.ROOT / config["scene"]).with_resolution(*config["resolution"])
    return ref_scene.to_device(host, device, dtype, geom_dtype)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class RenderLoop:
    unit_name = "images"

    def __init__(self, cell, seed, device):
        from take_tpu_torch import RenderOptions

        cfg, tr = cell["config_data"], cell["traffic_data"]
        self.cell, self.cfg, self.seed, self.device = cell, cfg, seed, device
        self.per_unit = {"run": False, "per_unit": True}[tr.get("seeds", "run")]
        self.render = program_module("render")
        self.scene = program_scene(cfg, device)
        self.options = RenderOptions(spp=cfg["spp"], max_depth=cfg["max_depth"], seed=seed,
                                     integrator=cfg["integrator"])
        W, H = cfg["resolution"]
        self.paths_per_unit = W * H * cfg["spp"]
        self.work_per_unit = yardstick.rays_per_image(W, H, cfg["spp"], cfg["max_depth"])
        n = min(cell["limits"]["pixels"], W * H)
        self.pixels = np.sort(np.random.default_rng(seed).choice(W * H, size=n, replace=False))
        self.rows, self.cols = H - 1 - self.pixels // W, self.pixels % W  # the image is y-flipped
        self.kept, self.failed, self.loss_grad_s, self.units = [], 0, [], 0
        for _ in range(WARM_UNITS):
            self.render.render_image(self.scene, self.options)

    def unit_seed(self):
        return self.seed + 1 + self.units if self.per_unit else self.seed

    def unit(self, spans=False):
        seed = self.unit_seed()
        options = dataclasses.replace(self.options, seed=seed) if self.per_unit else self.options
        img = self.render.render_image(self.scene, options)
        self.units += 1
        self.failed += not bool(np.isfinite(img).all())
        return seed, img[self.rows, self.cols]

    def keep(self, out):
        self.kept.append(out)

    def end_to_end(self, window):
        return {"mrays_per_s": len(window["unit_s"]) * self.work_per_unit / window["seconds"] / 1e6}

    def query_counts(self):
        """(nominal, live) scene queries of the first pass of each row band (sample 0)."""
        from take_tpu_torch.core import rng as prng
        from take_tpu_torch.core.camera import generate_rays
        from take_tpu_torch.integrator.path_tracer import trace_query_counts

        cam = self.scene.meta.camera
        W, H = cam.width, cam.height
        rows = max(1, self.options.max_rays_per_pass // W)  # one sample a pass at these sizes
        nominal = live = 0
        with torch.inference_mode():
            for y0 in range(0, H, rows):
                pix = torch.arange(y0 * W, min(y0 + rows, H) * W, dtype=torch.int32, device=self.device)
                streams = prng.make_stream(self.seed, pix, torch.zeros_like(pix))
                jx = prng.uniform(streams, prng.camera_counter(prng.DIM_CAMERA_JITTER_X))
                jy = prng.uniform(streams, prng.camera_counter(prng.DIM_CAMERA_JITTER_Y))
                px = (pix % W).to(torch.float32)
                py = torch.div(pix, W, rounding_mode="floor").to(torch.float32)
                ro, rd = generate_rays(cam, px, py, jx, jy)
                a, b = trace_query_counts(self.scene, self.options, ro, rd, streams)
                nominal, live = nominal + a, live + b
        return {"nominal": nominal, "live": live}

    def free(self):
        self.render.clear_cache()
        self.scene = None

    def numbers(self):
        """The window's images against the reference's render of the same
        pixels at each image's seed: every image, or with a seed per image a
        sample of `images` of them drawn from the run's seed."""
        kept = self.kept
        if self.per_unit and len(kept) > self.cell["limits"].get("images", len(kept)):
            pick = np.random.default_rng(self.seed).choice(len(kept), self.cell["limits"]["images"], replace=False)
            kept = [kept[i] for i in sorted(pick)]
        ref = reference_scene(self.cfg, self.device)
        pix = torch.as_tensor(self.pixels, device=self.device)
        worst = {}
        for seed in dict.fromkeys(s for s, _ in kept):
            out = tracer.render_pixels(ref, seed, pix, self.cfg["spp"], self.cfg["max_depth"])
            got = np.stack([img for s, img in kept if s == seed])
            for k, v in checks.image_numbers(got, out.float().cpu().numpy()).items():
                worst[k] = max(worst.get(k, v), v)
        return worst


def raw(p):
    """A parameter's raw value, from which its map gives `init`."""
    return INVERSE[p["map"]](np.asarray(p["init"], np.float64))


def target_seed(seed):
    return (seed + TARGET_SEED_OFFSET) % (1 << 32)


def param_materials(cfg, tr):
    """{parameter: material id} of the material parameters, by the material's XML id in the scene file."""
    names = ref_scene.load(spec.ROOT / cfg["scene"]).material_ids
    return {k: names[p["material"]] for k, p in tr["params"].items() if p["target"] == "material"}


class GradLoop:
    unit_name = "steps"

    def __init__(self, cell, seed, device):
        from take_tpu_torch import RenderOptions, grad
        from take_tpu_torch.scene import edit

        render = program_module("render")
        cfg, tr = cell["config_data"], cell["traffic_data"]
        self.cell, self.cfg, self.tr, self.seed, self.device = cell, cfg, tr, seed, device
        self.grad, self.render, self.edit = grad, render, edit
        W, H = cfg["resolution"]
        self.paths_per_unit = W * H * tr["spp_per_step"]
        self.scene = program_scene(cfg, device)
        self.mat = param_materials(cfg, tr)
        self.pix = torch.arange(W * H, dtype=torch.int32, device=device)
        img = render.render_image(self.scene, RenderOptions(spp=tr["target_spp"], max_depth=cfg["max_depth"],
                                                            seed=target_seed(seed), integrator=cfg["integrator"]))
        self.target = torch.as_tensor(img[::-1].copy(), device=device).reshape(W * H, 3)  # rows back to y order
        render.clear_cache()  # the target's pass graph serves no step
        self.options = RenderOptions(spp=1, max_depth=cfg["max_depth"], seed=seed, grad_mode=tr["grad_mode"],
                                     integrator=cfg["integrator"])
        self.params = {k: torch.tensor(raw(p), dtype=torch.float32, device=device).requires_grad_(True)
                       for k, p in tr["params"].items()}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=tr["lr"])
        self.step, self.failed, self.loss_grad_s = 0, 0, []
        self.check_at = int(np.random.default_rng(seed).integers(*cell["limits"]["window_step"]))
        self.checked = None
        self.start = {k: v.detach().cpu().numpy().copy() for k, v in self.params.items()}
        self.setup = [self.unit() for _ in range(tr["setup_steps"])]
        self.changed = {k: v.detach().cpu().numpy().copy() for k, v in self.params.items()}
        self.failed = 0  # `failed` counts the window's steps

    def edited(self):
        s = program_scene(self.cfg, self.device) if self.tr.get("reload_scene") else self.scene
        for k, p in self.tr["params"].items():
            x = MAPS[p["map"]](self.params[k])
            if p["target"] == "lights":
                s = self.edit.with_light_intensity_scale(s, x)
            elif p["param"] == "reflectance":
                s = self.edit.with_material_reflectance(s, self.mat[k], x)
            else:
                s = self.edit.with_material_param(s, self.mat[k], p["param"], x)
        return s

    def unit(self, spans=False):
        k, n = self.step, self.tr["spp_per_step"]
        self.opt.zero_grad()
        keep = k <= self.check_at  # the window's step `check_at`, or its last if it ends sooner
        if keep:
            theta = {name: p.detach().clone() for name, p in self.params.items()}
        s = self.edited()
        if spans:
            sync(self.device)
            t0 = time.perf_counter()
        loss, g = self.grad.render_loss_grad(s, self.options, self.pix, self.target, n, sample0=k * n)
        if spans:
            sync(self.device)
            self.loss_grad_s.append(time.perf_counter() - t0)
        self.grad.backward(s, g)
        finite = torch.isfinite(torch.cat([p.grad.reshape(-1) for p in self.params.values()])).all()
        self.opt.step()
        value = float(loss)
        self.failed += not (math.isfinite(value) and bool(finite))
        if keep:
            self.checked = {"step": k, "theta": theta,
                            "grad": {name: p.grad.detach().clone() for name, p in self.params.items()}}
        self.step += 1
        first = None
        if k == 0:  # the first gradient as the optimizer got it, from its state after one step
            beta1 = self.opt.param_groups[0]["betas"][0]
            first = {name: (self.opt.state[p]["exp_avg"].detach().cpu().numpy() / (1.0 - beta1)
                            if "exp_avg" in self.opt.state[p] else np.zeros(p.shape)) for name, p in self.params.items()}
        return {"loss": value, "first": first}

    def end_to_end(self, window):
        steps = window["unit_s"]
        return {"grad_step_s": window["seconds"] / len(steps),
                "grad_step_p95_s": statistics.quantiles(steps, n=100, method="inclusive")[94]
                if len(steps) > 1 else steps[0]}

    def query_counts(self):
        return None

    def keep(self, out):
        """The window's steps are judged by `failed` and by the step kept in `checked`."""

    def free(self):
        self.render.clear_cache()
        self.scene = self.target = None

    def window_step(self):
        """(step, raw parameters, gradients) of the window's kept step, on the host."""
        c = self.checked
        host = {name: {k: v.cpu().numpy() for k, v in c[name].items()} for name in ("theta", "grad")}
        return c["step"], host["theta"], host["grad"]

    def numbers(self):
        ref = ReferenceLoop(self.cell, self.seed, self.device)
        setup = self.setup
        ref_losses, ref_first, ref_change = ref.follow(len(setup))
        got_change = {k: self.changed[k] - self.start[k] for k in self.start}
        step, theta, grads = self.window_step()
        return {"loss_gap": max(abs(a["loss"] - b) / abs(b) for a, b in zip(setup, ref_losses)),
                "grad_gap": checks.leaf_gap(setup[0]["first"], ref_first),
                "change_gap": checks.leaf_gap(got_change, ref_change, checks.moved_leaves(ref_first)),
                "step_grad_gap": checks.leaf_gap(grads, ref.loss_grad(theta, step)[1])}


class ReferenceLoop:
    """The reference's side of the optimisation loop: its own target, loss,
    gradients by autograd through the reference tracer, and Adam in float64."""

    def __init__(self, cell, seed, device, dtype=torch.float32, geom_dtype=torch.float64):
        self.cfg, self.tr, self.seed, self.device = cell["config_data"], cell["traffic_data"], seed, device
        self.mat = param_materials(self.cfg, self.tr)
        self.start = {k: raw(p).astype(np.float32) for k, p in self.tr["params"].items()}
        self.s = reference_scene(self.cfg, device, dtype, geom_dtype)
        W, H = self.cfg["resolution"]
        self.pix = torch.arange(W * H, device=device)
        self.target = tracer.render_pixels(self.s, target_seed(seed), self.pix, self.tr["target_spp"],
                                           self.cfg["max_depth"])

    def loss_grad(self, theta, step):
        """(loss, {param: gradient}) at raw parameters `theta` for step `step`'s samples."""
        dev, dt = self.device, self.s.dtype
        leaves = {k: torch.tensor(np.asarray(v), dtype=dt, device=dev).requires_grad_(True) for k, v in theta.items()}
        n = self.tr["spp_per_step"]
        denom = torch.full((), self.target.numel(), dtype=dt, device=dev)
        total = 0.0
        per = max(1, (1 << 20) // n)
        for a in range(0, self.pix.shape[0], per):
            tables, scale = {}, None
            for k, p in self.tr["params"].items():
                x = MAPS[p["map"]](leaves[k])
                if p["target"] == "lights":
                    scale = x
                    continue
                table = tables.get(p["param"], self.s.mat_params[p["param"]])
                row = (torch.arange(table.shape[0], device=dev) == self.mat[k]).view(-1, *[1] * (table.dim() - 1))
                tables[p["param"]] = torch.where(row, x[None] if x.dim() else x, table)
            img = tracer.render_pixels(self.s, self.seed, self.pix[a:a + per], n, self.cfg["max_depth"],
                                       sample0=step * n, params=tables, light_scale=scale)
            part = torch.sum((img - self.target[a:a + per]) ** 2) / denom
            part.backward()
            total += float(part.detach())
        return total, {k: v.grad.double().cpu().numpy() for k, v in leaves.items()}

    def follow(self, steps, betas=(0.9, 0.999), eps=1e-8):
        """The first `steps` steps from the loop's start with Adam: (losses,
        first gradient, change of the raw parameters)."""
        theta = {k: np.asarray(v, np.float64) for k, v in self.start.items()}
        m = {k: np.zeros_like(v) for k, v in theta.items()}
        v2 = {k: np.zeros_like(v) for k, v in theta.items()}
        losses, first = [], None
        for t in range(steps):
            loss, g = self.loss_grad({k: x.astype(np.float32) for k, x in theta.items()}, t)
            losses.append(loss)
            first = g if first is None else first
            for k in theta:
                m[k] = betas[0] * m[k] + (1 - betas[0]) * g[k]
                v2[k] = betas[1] * v2[k] + (1 - betas[1]) * g[k] ** 2
                mh, vh = m[k] / (1 - betas[0] ** (t + 1)), v2[k] / (1 - betas[1] ** (t + 1))
                theta[k] = theta[k] - self.tr["lr"] * mh / (np.sqrt(vh) + eps)
        return losses, first, {k: theta[k] - self.start[k] for k in theta}


LOOPS = {"render": RenderLoop, "grad": GradLoop}
