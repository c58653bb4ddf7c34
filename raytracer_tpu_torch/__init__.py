"""raytracer_tpu_torch: the renderer on PyTorch and hand-written CUDA kernels.

A port of raytracer_tpu (JAX/Pallas) to PyTorch with CUDA C++ kernels for
NVIDIA Hopper (sm_90a).  The JAX package stays the reference; this package
imports neither jax nor raytracer_tpu.

    python -m raytracer_tpu_torch --scene demo --epochs 100 --out out.png

Importing the package starts nothing: the CUDA kernels are built with nvcc
at their first launch (utils/kernels.py).
"""

from raytracer_tpu_torch.config import RenderConfig

__all__ = ["RenderConfig"]
