"""The reference's frame: pixels, camera rays, draws, tone map and u8.

Pixels: clip_x = (x - W/2)/H, clip_y = (H/2 - y)/H (main.rs:1094-1095).
The camera (main.rs:84-127): right = toward x up, up' = right x toward,
both scaled by tan(fovy/2) (the C library's tanf, as the reference's
f32::tan); shoot_focus displaces the origin by the lens sample times blur
and keeps the focal point at `focus`.

Draws: the timed path draws each (seed, epoch, tile) from a generator of
its own on the render device: its pixels in 32x16 block-major order cut
into tiles of `tile_rays` lanes, a splitmix64 chain of (seed, epoch, tile,
sample) as the generator's seed, lens normals [n, 2] then uniforms [depth,
3, n] with the third row mapped to [-pi, pi).  `pixel_draws` works the
same draws out again for any pixels, from those rules alone.

post_process (main.rs:748-762): luma, drop values that are not normal
floats, sort, take index floor(0.99 count) (the product rounded to f32, as
the reference's f32 arithmetic rounds it), divide by it when it exceeds
f32 epsilon.  to_u8: the sRGB transfer function, clamped, times 255,
rounded half to even.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

from reference.world import F32_EPS, F32_TINY, unit

BLOCK_W, BLOCK_H = 32, 16
LUMA = (0.212656, 0.715158, 0.072186)
MASK64 = (1 << 64) - 1


def tanf(x: float) -> float:
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.tanf.argtypes, lib.tanf.restype = [ctypes.c_float], ctypes.c_float
    return lib.tanf(x)


def block_position(width: int, height: int) -> np.ndarray:
    """[H*W]: each row-major pixel's position in 32x16 block-major order."""
    idx = np.arange(height * width, dtype=np.int64).reshape(height, width)
    order = np.concatenate([idx[by:by + BLOCK_H, bx:bx + BLOCK_W].reshape(-1)
                            for by in range(0, height, BLOCK_H)
                            for bx in range(0, width, BLOCK_W)])
    pos = np.empty_like(order)
    pos[order] = np.arange(order.size)
    return pos


def clips(width: int, height: int, pixels: np.ndarray) -> np.ndarray:
    """[P, 2] float32 clip coordinates of row-major pixel indices."""
    y, x = np.divmod(pixels, width)
    return np.stack([(x - width / 2.0) / height, (height / 2.0 - y) / height],
                    axis=-1).astype(np.float32)


def camera_basis(cam: dict, device, dtype):
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
    toward = unit(t(cam["toward"])[None])[0]
    right = unit(torch.linalg.cross(toward, t(cam["up"]))[None])[0]
    up = unit(torch.linalg.cross(right, toward)[None])[0]
    scale = tanf(float(cam["fovy"]) / 2.0)
    origin = t(cam["center"]) + toward * t(cam["near"])
    return toward, right * scale, up * scale, origin


def shoot(cam: dict, clip: torch.Tensor):
    """Pinhole rays (main.rs:84-99) -> (o [P, 3], d [P, 3])."""
    toward, x, y, origin = camera_basis(cam, clip.device, clip.dtype)
    d = unit(clip[:, :1] * x + clip[:, 1:] * y + toward)
    return origin.expand_as(d), d


def shoot_focus(cam: dict, clip: torch.Tensor, lens: torch.Tensor, blur: float, focus: float):
    """Thin-lens rays (main.rs:101-127); lens [P, 2] unscaled normals."""
    toward, x, y, origin = camera_basis(cam, clip.device, clip.dtype)
    d = unit(clip[:, :1] * x + clip[:, 1:] * y + toward)
    xo, yo = lens[:, :1] * blur, lens[:, 1:] * blur
    return origin - (x * xo + y * yo), unit(d * focus + x * xo + y * yo)


def draw_seed(*parts: int) -> int:
    """The splitmix64 chain of (seed, epoch, tile[, sample > 0])."""
    x = 0
    for part in parts:
        x = (x + part + 0x9E3779B97F4A7C15) & MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
        x ^= x >> 31
    return x & 0x7FFFFFFFFFFFFFFF


def pixel_draws(pixels: np.ndarray, width: int, height: int, tile_rays: int, depth: int,
                seed: int, epoch: int, device, sample: int = 0):
    """(lens normals [P, 2], uniforms [depth, 3, P]) of these pixels in epoch
    `epoch`, drawn as the timed path draws its tiles."""
    tile = min(tile_rays, width * height)
    pos = block_position(width, height)[pixels]
    tiles, lanes = np.divmod(pos, tile)
    lens = torch.empty((len(pixels), 2), device=device)
    unifs = torch.empty((depth, 3, len(pixels)), device=device)
    for t in np.unique(tiles):
        g = torch.Generator(device=device)
        parts = (seed, epoch, int(t)) + ((sample,) if sample else ())
        g.manual_seed(draw_seed(*parts))
        normals = torch.randn((tile, 2), generator=g, device=device)
        u = torch.rand((depth, 3, tile), generator=g, device=device)
        u[:, 2] = u[:, 2] * (2.0 * math.pi) - math.pi
        at = np.nonzero(tiles == t)[0]
        lane = torch.as_tensor(lanes[at], device=device)
        idx = torch.as_tensor(at, device=device)
        lens[idx] = normals[lane]
        unifs[:, :, idx] = u[:, :, lane]
    return lens, unifs


def post_process(img: torch.Tensor, percentile: float = 0.99) -> torch.Tensor:
    flat = img.reshape(-1, 3)
    lum = (flat * torch.tensor(LUMA, dtype=img.dtype, device=img.device)).sum(-1)
    valid = torch.isfinite(lum) & (lum.abs() >= F32_TINY)
    count = int(valid.sum())
    if count == 0:
        return img
    ordered = torch.sort(lum[valid]).values
    p = ordered[min(int(np.float32(count) * np.float32(percentile)), count - 1)]
    return img * (1.0 / p) if float(p) > F32_EPS else img


def to_u8(linear: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(linear, 0.0, 1.0)
    s = torch.where(x <= 0.0031308, 12.92 * x, 1.055 * torch.pow(x, 1.0 / 2.4) - 0.055)
    return torch.round(s * 255.0).to(torch.uint8)
