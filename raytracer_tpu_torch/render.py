"""High-level render API: whole frames from the camera and the tracers.

Counterpart of raytracer_tpu/render.py:26-168, 332-358.  The pixel grid is
laid out in 32x16 block-major order and cut into tiles of cfg.tile_rays
rays (the last tile padded with centre rays), exactly as the JAX package
does: the MC pass consumes its draws in this lane order, so the same draws
give the same photons lane for lane.

Draws: each (seed, epoch, tile) seeds its own torch.Generator on the render
device, so an epoch's samples depend on nothing else and a resumed render
redraws exactly what the interrupted one would have.  They are a
different, equally valid realisation from the JAX package's threefry
draws; the tests hand the JAX draws in through `draws=`.

An MC epoch on a route that takes its lanes one by one
(ops/distributed.frame_wide_route: the mega-kernel, and the unfused walk of
a dense scene) lays every tile's draws side by side and traces the whole
frame in one trace_distributed call, as the JAX package gives XLA the
whole frame in one dispatch (raytracer_tpu/render.py `_mc_frame`): a
launch of one tile leaves most of the card idle at its tail, and each tile
costs the host its own camera, filter and sums and, on the unfused walk,
its own thousands of dispatched operations.  The binned route, the unfused walk of a
BVH scene, and the Whitted ladder (whose compaction works per tile) go
tile by tile.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import camera as camera_ops
from raytracer_tpu_torch.ops.distributed import frame_wide_route, trace_distributed
from raytracer_tpu_torch.ops.trace import trace_whitted
from raytracer_tpu_torch.scene.types import Camera, Scene

_BLOCK_W, _BLOCK_H = 32, 16


def clip_coords(width: int, height: int) -> np.ndarray:
    """Pixel grid -> clip coords [H*W, 2], row-major (y, x) like the
    reference's iproduct!(0..h, 0..w) (src/main.rs:1089, 1094-1095)."""
    ys, xs = np.mgrid[0:height, 0:width]
    clip_x = (xs - width / 2.0) / height
    clip_y = (height / 2.0 - ys) / height
    return np.stack([clip_x, clip_y], axis=-1).reshape(-1, 2).astype(np.float32)


def _block_perm(width: int, height: int) -> np.ndarray:
    """Pixel-index permutation into 32x16 block-major order (ragged edge
    blocks are simply smaller)."""
    idx = np.arange(height * width, dtype=np.int64).reshape(height, width)
    order = [
        idx[by:by + _BLOCK_H, bx:bx + _BLOCK_W].reshape(-1)
        for by in range(0, height, _BLOCK_H)
        for bx in range(0, width, _BLOCK_W)
    ]
    return np.concatenate(order)


@functools.lru_cache(maxsize=4)
def _tiled_clips(width: int, height: int, tile_rays: int, device: str):
    """([n_tiles, tile, 2] clips in block-major order, inverse permutation
    [H*W]) on `device`; the tail tile is padded with centre rays."""
    n = width * height
    tile = min(tile_rays, n)
    perm = _block_perm(width, height)
    clips = clip_coords(width, height)[perm]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=perm.dtype)
    pad = (-n) % tile
    if pad:
        clips = np.concatenate([clips, np.zeros((pad, 2), np.float32)])
    return (torch.as_tensor(clips.reshape(-1, tile, 2), device=device),
            torch.as_tensor(inv, device=device))


def _clips(cfg: RenderConfig, device):
    return _tiled_clips(cfg.width, cfg.height, cfg.tile_rays, str(torch.device(device)))


def _to_image(cfg: RenderConfig, tiles, inv):
    flat = torch.cat(tiles)[: cfg.width * cfg.height][inv]
    return flat.reshape(cfg.height, cfg.width, 3)


def render_whitted(scene: Scene, camera: Camera,
                   cfg: RenderConfig) -> Tuple[torch.Tensor, dict]:
    """Whitted pass over the full frame -> ([H, W, 3], stats)."""
    clips, inv = _clips(cfg, scene.device)
    colors, casts, dropped = [], 0, 0
    for clip in clips:
        o, d = camera_ops.shoot(camera, clip)
        res = trace_whitted(scene, o, d, cfg)
        colors.append(res.color)
        casts = casts + res.casts
        dropped = dropped + res.dropped
    return _to_image(cfg, colors, inv), {
        "casts": int(casts), "dropped": int(dropped),
        "primary_rays": cfg.width * cfg.height,
    }


def _seed(seed: int, epoch: int, tile: int) -> int:
    """Generator seed for one (seed, epoch, tile): a splitmix64 chain."""
    x = 0
    for part in (seed, epoch, tile):
        x = (x + part + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x & 0x7FFFFFFFFFFFFFFF


def tile_draws(cfg: RenderConfig, seed: int, epoch: int, tile: int, n: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tile's draws: lens normals [n, 2] (unscaled) and uniforms
    [depth, 3, n] (roulette u, lobe u_phi, lobe theta in [-pi, pi))."""
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, epoch, tile))
    normals = torch.randn((n, 2), generator=g, device=device)
    unifs = torch.rand((cfg.depth, 3, n), generator=g, device=device)
    unifs[:, 2] = unifs[:, 2] * (2.0 * math.pi) - math.pi
    return normals, unifs


def frame_draws(tile_in) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (lens normals [tile, 2], unifs [depth, 3, tile]) laid side
    by side -> (normals [N, 2], unifs [depth, 3, N]) of the whole frame."""
    return (torch.cat([nm for nm, _ in tile_in]),
            torch.cat([u for _, u in tile_in], dim=2).contiguous())


def epoch_frame(scene: Scene, camera: Camera, cfg: RenderConfig, clips, tile_in):
    """The epoch's tiles traced in ONE trace_distributed call -> (photon
    [N, 3] in tile order, casts, filtered)."""
    normals, unifs = frame_draws(tile_in)
    o, d = camera_ops.shoot_focus(camera, clips.reshape(-1, 2), normals * cfg.blur, cfg.focus)
    res = trace_distributed(scene, o, d, unifs, cfg)
    return res.photon, res.casts, res.filtered


def epoch_tiles(scene: Scene, camera: Camera, cfg: RenderConfig, clips, tile_in):
    """The epoch traced tile by tile -> (photon [N, 3] in tile order,
    casts, filtered)."""
    photons, casts, filtered = [], 0, 0
    for clip, (normals, unifs) in zip(clips, tile_in):
        o, d = camera_ops.shoot_focus(camera, clip, normals * cfg.blur, cfg.focus)
        res = trace_distributed(scene, o, d, unifs, cfg)
        photons.append(res.photon)
        casts = casts + res.casts
        filtered = filtered + res.filtered
    return torch.cat(photons), casts, filtered


def render_distributed_epoch(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed: int = 0,
    epoch: int = 0, draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> Tuple[torch.Tensor, dict]:
    """One stochastic epoch: one is_normal-filtered photon per pixel
    (main.rs:1131-1160) -> ([H, W, 3], stats).

    draws: optional per-tile (lens normals [tile, 2], unifs [depth, 3,
    tile]) in place of the generator's."""
    clips, inv = _clips(cfg, scene.device)
    if draws is not None and len(draws) != len(clips):
        raise ValueError(f"draws for {len(draws)} tiles, the frame has {len(clips)}")
    tile_in = draws if draws is not None else [
        tile_draws(cfg, seed, epoch, t, clip.shape[0], clip.device)
        for t, clip in enumerate(clips)]
    run = epoch_frame if frame_wide_route(scene) else epoch_tiles
    photon, casts, filtered = run(scene, camera, cfg, clips, tile_in)
    # stats include the padding rays of a ragged last tile
    return _to_image(cfg, [photon], inv), {
        "casts": int(casts), "filtered": int(filtered),
        "primary_rays": cfg.width * cfg.height,
    }
