"""raytracer_tpu_torch: the renderer on PyTorch and hand-written CUDA kernels.

A port of raytracer_tpu (JAX/Pallas) to PyTorch with CUDA C++ kernels for
NVIDIA Hopper (sm_90a).  The JAX package stays the reference; this package
imports neither jax nor raytracer_tpu.

    python -m raytracer_tpu_torch --scene demo --epochs 100 --out out.png

Importing the package starts nothing: the CUDA kernels are built with nvcc
at their first launch (utils/kernels.py).
"""

from raytracer_tpu_torch.config import NORTH_STAR_CONFIG, REFERENCE_CONFIG, RenderConfig
from raytracer_tpu_torch.render import (
    clip_coords,
    render_distributed_epoch,
    render_epochs,
    render_step,
    render_steps,
    render_whitted,
)
from raytracer_tpu_torch.scene.builder import MaterialSpec, SceneBuilder, square, triangle
from raytracer_tpu_torch.scene.presets import PRESETS, demo_camera, demo_scene
from raytracer_tpu_torch.scene.types import Camera, Hits, Rays, Scene

__all__ = [
    "Camera",
    "Hits",
    "MaterialSpec",
    "NORTH_STAR_CONFIG",
    "PRESETS",
    "Rays",
    "REFERENCE_CONFIG",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "clip_coords",
    "demo_camera",
    "demo_scene",
    "render_distributed_epoch",
    "render_epochs",
    "render_step",
    "render_steps",
    "render_whitted",
    "square",
    "triangle",
]
