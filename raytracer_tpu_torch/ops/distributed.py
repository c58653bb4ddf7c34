"""Distributed (Monte-Carlo) tracer: one stochastic sample per primary ray.

Counterpart of raytracer_tpu/ops/distributed.py:77-131 on its fused-kernel
path: the whole roulette walk runs in ops/mc_kernel.trace (the mega-kernel)
or, for blocked scenes of at least mc_binned.BINNED_MIN_TRIS triangles, in
ops/mc_binned.trace (per-bounce kernels with a sort between bounces), then
the f32::is_normal photon filter (main.rs:1157-1160) zeroes every photon with
a zero, subnormal or non-finite channel — including all-black misses.

The draws are an operand: unifs [depth, 3, N] holds (roulette u, lobe
u_phi, lobe theta in [-pi, pi)) per bounce.  render.py makes them with a
torch.Generator; the tests hand in the JAX package's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import mc_binned, mc_kernel
from raytracer_tpu_torch.scene.types import Scene
from raytracer_tpu_torch.utils.vec import is_normal_f32


class MCResult(NamedTuple):
    photon: torch.Tensor  # [N, 3] (non-is_normal photons zeroed)
    casts: torch.Tensor  # 0-d: rays cast, incl. shadow rays and marches
    filtered: torch.Tensor  # 0-d: photons dropped by the is_normal filter


def trace_distributed(scene: Scene, ray_o, ray_d, unifs,
                      cfg: RenderConfig) -> MCResult:
    """One MC sample per primary ray (main.rs:1150-1160)."""
    use_binned = scene.blocked and scene.n_tri >= mc_binned.BINNED_MIN_TRIS
    tracer = mc_binned.trace if use_binned else mc_kernel.trace
    photon_raw, casts = tracer(
        scene, ray_o, ray_d, unifs, cfg.depth, cfg.max_refract_distance,
        cfg.max_tir_retries,
    )
    ok = torch.all(is_normal_f32(photon_raw), dim=-1)
    photon = torch.where(ok[:, None], photon_raw, 0.0)
    return MCResult(photon=photon, casts=casts, filtered=torch.sum(~ok))
