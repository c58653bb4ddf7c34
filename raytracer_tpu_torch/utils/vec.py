"""Batched 3-vector math on trailing-dim-3 tensors.

Counterpart of raytracer_tpu/utils/vec.py (the reference's cgmath usage):
the parts the port's host code uses; the lane-row forms the sweeps use
(rotate_from_z, reflect3, ...) live in ops/kernel_common.py.
"""

from __future__ import annotations

import numpy as np
import torch

# f32 machine epsilon (Rust's std::f32::EPSILON, materials.rs:61).
F32_EPS = float(np.finfo(np.float32).eps)
# Smallest positive normal f32 — the lower bound of Rust's f32::is_normal().
F32_TINY = float(np.finfo(np.float32).tiny)


def norm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def normalize(a):
    """Normalize [..., 3]; zero vectors produce inf/nan like cgmath."""
    return a / norm(a)[..., None]


def is_normal_f32(x):
    """Rust f32::is_normal(): finite, non-zero, non-subnormal."""
    return torch.isfinite(x) & (torch.abs(x) >= F32_TINY)
