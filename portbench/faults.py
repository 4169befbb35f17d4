"""Faults planted under the timed path, to show that the comparison fails
them. Each is a context manager that patches the program where it
produces its answer; the harness looks the program up at call time, so a
run inside the context drives the broken path.

  render.half_batch  each image made of half its samples, their mean
  render.altered     each image off by 1% where render_image returns it
  grad.unchanged     the Adam step leaves the parameters and its state as they were
  grad.half_batch    each step's loss and gradient over the first half of the pixels, their mean
  grad.altered       each step's gradient off by 5% where render_loss_grad returns it

One chip holds no exchange between chips, so that fault has no cell here.
"""

import contextlib
import dataclasses
from unittest import mock

import torch


@contextlib.contextmanager
def plant(name):
    import importlib

    render = importlib.import_module("take_tpu_torch.render")
    grad = importlib.import_module("take_tpu_torch.grad")
    if name == "render.half_batch":
        orig = render.render_image

        def fn(scene, options, *a, **k):
            return orig(scene, dataclasses.replace(options, spp=max(1, options.spp // 2)), *a, **k)

        patch = mock.patch.object(render, "render_image", fn)
    elif name == "render.altered":
        orig = render.render_image
        patch = mock.patch.object(render, "render_image", lambda *a, **k: orig(*a, **k) * 1.01)
    elif name == "grad.unchanged":
        patch = mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif name == "grad.half_batch":
        orig = grad.render_loss_grad

        def fn(scene, options, pix, target, n, sample0=0):
            half = pix.shape[0] // 2
            return orig(scene, options, pix[:half], target[:half], n, sample0=sample0)

        patch = mock.patch.object(grad, "render_loss_grad", fn)
    elif name == "grad.altered":
        orig = grad.render_loss_grad
        types = importlib.import_module("take_tpu_torch.scene.types")

        def fn(*a, **k):
            loss, g = orig(*a, **k)
            return loss, types.replace_tables(g, {key: v * 1.05 for key, v in types.float_tables(g).items()})

        patch = mock.patch.object(grad, "render_loss_grad", fn)
    else:
        raise ValueError(f"no fault {name!r}")
    with patch:
        yield


KINDS = {"render": ("render.half_batch", "render.altered"),
         "grad": ("grad.unchanged", "grad.half_batch", "grad.altered")}
