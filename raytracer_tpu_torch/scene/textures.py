"""Procedural textures: the demo's stripes and checker.

Counterpart of raytracer_tpu/scene/textures.py.  A texture has two forms,
as there: the host forms `diffuse` / `normal` (uv [N, 2] -> [N, 3]), which
the unfused path evaluates (ops/materials.py), and the row forms
`diffuse_rows` / `normal_rows` ((u, v) -> three [R] tensors), which the
fused kernels' plain versions evaluate (ops/kernel_common.py).  Materials
carry an integer texture id, 0 meaning "use the constant table entry".

The CUDA kernels of the fused path hold the demo's two textures as a switch
on the id (csrc/common.cuh), so only a texture set whose row forms ARE
DEFAULT_TEXTURES' takes the fused path (`kernel_textures_ok`); every other
set, a set without row forms included, takes the unfused path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Texture:
    name: str
    diffuse: Callable  # uv [N, 2] -> rgb [N, 3]
    normal: Callable  # uv [N, 2] -> tangent-space normal [N, 3]
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


def _host(rows):
    """The host form uv [N, 2] -> [N, 3] of a row-form function."""
    return lambda uv: torch.stack(rows(uv[:, 0], uv[:, 1]), dim=-1)


stripes_diffuse = _host(stripes_diffuse_rows)
stripes_normal = _host(stripes_normal_rows)
checker_diffuse = _host(checker_diffuse_rows)
_const_normal = _host(_const_normal_rows)

TEXTURE_CONST = 0
TEXTURE_STRIPES = 1
TEXTURE_CHECKER = 2

# Index 0 is the constant placeholder (never selected: the table wins).
DEFAULT_TEXTURES: Tuple[Texture, ...] = (
    Texture("const", diffuse=lambda uv: torch.zeros((uv.shape[0], 3), device=uv.device),
            normal=_const_normal),
    Texture("stripes", diffuse=stripes_diffuse, normal=stripes_normal,
            diffuse_rows=stripes_diffuse_rows, normal_rows=stripes_normal_rows),
    Texture("checker", diffuse=checker_diffuse, normal=_const_normal,
            diffuse_rows=checker_diffuse_rows, normal_rows=_const_normal_rows),
)


def kernel_textures_ok(textures) -> bool:
    """May the fused kernels render this texture set?  Only the set whose
    row functions are DEFAULT_TEXTURES' own, by identity: a texture that
    merely shares a default's name evaluates another function, which the
    kernels' built-in switch does not hold.  (The JAX package asks only
    for row forms, kernel_common.py:219: its kernels trace them.)"""
    return len(textures) == len(DEFAULT_TEXTURES) and all(
        t.diffuse_rows is d.diffuse_rows and t.normal_rows is d.normal_rows
        for t, d in zip(textures, DEFAULT_TEXTURES))


def host_only(textures) -> Tuple[Texture, ...]:
    """The same textures without their row forms: a set the fused kernels
    cannot take, so a scene built with it renders through the unfused path
    (raytracer_tpu/scene/textures.py:26-31)."""
    return tuple(dataclasses.replace(t, diffuse_rows=None, normal_rows=None)
                 for t in textures)
