"""Batched 3-vector math on trailing-dim-3 tensors.

Counterpart of raytracer_tpu/utils/vec.py (the reference's cgmath usage):
the [..., 3] forms the port's host code and its unfused path use; the
lane-row forms the fused sweeps use (rotate_from_z, reflect3, ...) live in
ops/kernel_common.py.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

# f32 machine epsilon (Rust's std::f32::EPSILON, materials.rs:61).
F32_EPS = float(np.finfo(np.float32).eps)
# Smallest positive normal f32 — the lower bound of Rust's f32::is_normal().
F32_TINY = float(np.finfo(np.float32).tiny)


def dot(a, b):
    """Row-wise dot product of [..., 3] tensors -> [...]."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    """Row-wise cross product of [..., 3] tensors."""
    return torch.linalg.cross(a, b, dim=-1)


def norm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def distance(a, b):
    """|a - b| for [..., 3] tensors."""
    return norm(a - b)


def reflect(direction, normal):
    """Mirror `direction` about `normal`: l - 2 (l.n) n (main.rs:329)."""
    return direction - 2.0 * dot(direction, normal)[..., None] * normal


def rotate_from_z(n, v):
    """Apply to `v` the rotation that takes +z onto `n` (both [..., 3]):
    cgmath's Quaternion::from_arc(z, n) (materials.rs:40-44,
    main.rs:545-549).  For n ~ -z cgmath rotates by pi about (0, -1, 0),
    which maps v to (-v.x, v.y, -v.z)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    # q = (w, xyz) with w = 1 + z.n, xyz = z x n (unnormalized, qz = 0)
    qw, qx, qy = 1.0 + nz, -ny, nx
    q2 = torch.clamp_min(qw * qw + qx * qx + qy * qy, 1e-12)
    qv = torch.stack([qx, qy, torch.zeros_like(qx)], dim=-1)
    # v' = v + (2/|q|^2) * qv x (qv x v + w v)
    t = torch.linalg.cross(qv, v) + qw[..., None] * v
    rotated = v + (2.0 / q2)[..., None] * torch.linalg.cross(qv, t)
    flipped = torch.stack([-v[..., 0], v[..., 1], -v[..., 2]], dim=-1)
    return torch.where((nz < -1.0 + 1e-6)[..., None], flipped, rotated)


def normalize(a):
    """Normalize [..., 3]; zero vectors produce inf/nan like cgmath."""
    return a / norm(a)[..., None]


def normalize_safe(a, eps: float = 0.0):
    """Normalize [..., 3], dividing by |a| + eps."""
    return a / (norm(a)[..., None] + eps)


def is_normal_f32(x):
    """Rust f32::is_normal(): finite, non-zero, non-subnormal."""
    return torch.isfinite(x) & (torch.abs(x) >= F32_TINY)


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.tanf.argtypes = [ctypes.c_float]
    lib.tanf.restype = ctypes.c_float
    return lib


def tanf(x: float) -> float:
    """tan of the f32 `x` by the C library's tanf, the function Rust's
    f32::tan calls.  At the demo camera's 30 degree half angle it rounds
    to 0.57735032 as the JAX package's tan does, where torch's tan gives
    the correctly rounded 0.57735026: the seam between two floor triangles
    under the frame's centre column then falls on the other side."""
    return _libm().tanf(x)
