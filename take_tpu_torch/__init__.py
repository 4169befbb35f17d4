"""take-tpu-torch: the PyTorch/CUDA port of take_tpu, for an NVIDIA H100.

A differentiable path tracer. The scene is a dataclass of tensors on one
device, chosen at build time; plain tensor code is torch, and the scene
queries run in hand-written CUDA kernels for Hopper (geometry/brute.py,
packet.py, cluster.py, sweep.py; csrc/). This package imports neither JAX
nor take_tpu.

Public API:
    take_tpu_torch.load_scene(path, device=...)  -> Scene
    take_tpu_torch.render(scene, **options)      -> [H, W, 3] radiance image
    take_tpu_torch.grad.render_loss_grad(...)    -> (loss, Scene-shaped gradient)
    take_tpu_torch.scene.edit.with_*(scene, ...) -> an edited Scene
    take_tpu_torch.write_exr / read_exr          -> OpenEXR I/O
"""

from take_tpu_torch.scene.types import Scene, RenderOptions
from take_tpu_torch.scene.build import SceneBuilder
from take_tpu_torch.render import render, render_image
from take_tpu_torch.io.exr import read_exr, write_exr
from take_tpu_torch.io.pfm import write_pfm

__version__ = "0.1.0"

__all__ = [
    "Scene",
    "RenderOptions",
    "SceneBuilder",
    "render",
    "render_image",
    "read_exr",
    "write_exr",
    "write_pfm",
    "load_scene",
]


def load_scene(path, device="cuda", **kwargs):
    """Parse a Mitsuba-XML scene file into a Scene on `device` (the card unless
    the caller asks for "cpu"; without a card the default raises torch's error).
    Span take.scene.load."""
    from take_tpu_torch import tracing
    from take_tpu_torch.scene.parse_xml import parse_scene_file

    with tracing.span("take.scene.load"):
        return parse_scene_file(path, device=device, **kwargs)
