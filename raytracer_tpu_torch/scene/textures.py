"""Procedural textures: the demo's stripes and checker.

Counterpart of raytracer_tpu/scene/textures.py.  A texture is a pair of
plain torch functions (u, v) -> three [R] tensors (diffuse rgb, tangent
normal); materials carry an integer texture id, 0 meaning "use the
constant table entry".  The CUDA kernels hold the same two textures as a
switch on the id (csrc/common.cuh), so they run only with DEFAULT_TEXTURES.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Texture:
    name: str
    diffuse_rows: Callable | None = None  # (u, v) -> (r, g, b)
    normal_rows: Callable | None = None  # (u, v) -> (nx, ny, nz)


def _parity_even(x):
    """`(x as i32) % 2 == 0`: truncate toward zero, then test the low bit
    (parity agrees under Rust's sign-preserving % and floor-mod)."""
    return (x.to(torch.int32) & 1) == 0


def stripes_diffuse_rows(u, v):
    """Striped wall diffuse (reference: src/main.rs:848-854)."""
    band = _parity_even(v * 20.0)
    r = torch.where(band, 1.0, 0.5)
    return r, r.clone(), torch.ones_like(u)


def stripes_normal_rows(u, v):
    """Corrugated bump normal, flipped to point outward
    (reference: src/main.rs:855-863)."""
    angle = u * 10.0 * 2.0 * math.pi
    sx, cz = torch.sin(angle), torch.cos(angle)
    flip = torch.where(cz <= 0.0, -1.0, 1.0)
    return sx * flip, torch.zeros_like(u), cz * flip


def checker_diffuse_rows(u, v):
    """Diagonal checker sphere diffuse (reference: src/main.rs:1019-1025)."""
    band = _parity_even((u + v) * 10.0)
    r = torch.where(band, 1.0, 0.1)
    b = torch.where(band, 0.1, 1.0)
    return r, torch.full_like(u, 0.1), b


def _const_normal_rows(u, v):
    z = torch.zeros_like(u)
    return z, z.clone(), torch.ones_like(u)


TEXTURE_STRIPES = 1
TEXTURE_CHECKER = 2

# Index 0 is the constant placeholder (never selected: the table wins).
DEFAULT_TEXTURES: Tuple[Texture, ...] = (
    Texture("const"),
    Texture("stripes", stripes_diffuse_rows, stripes_normal_rows),
    Texture("checker", checker_diffuse_rows, _const_normal_rows),
)
