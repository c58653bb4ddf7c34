"""High-level render API: whole frames from the camera and the tracers.

Counterpart of raytracer_tpu/render.py:26-358.  The pixel grid is
laid out in 32x16 block-major order and cut into tiles of cfg.tile_rays
rays (the last tile padded with centre rays), exactly as the JAX package
does: the MC pass consumes its draws in this lane order, so the same draws
give the same photons lane for lane.  The Whitted ladder leaves the
padding out (`_whitted`).

Draws: each (seed, epoch, tile) seeds its own torch.Generator on the render
device, so an epoch's samples depend on nothing else and a resumed render
redraws exactly what the interrupted one would have, and a rank that traces
a subset of the tiles (parallel/mesh.py) draws what one card draws for
them; a further sample of the same pixels (sample s > 0) seeds from (seed,
epoch, tile, s).  They are a
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
from raytracer_tpu_torch.utils import tracing

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


def _whitted(scene: Scene, camera: Camera, cfg: RenderConfig,
             tiles: Optional[Sequence[int]] = None):
    """The Whitted frame -> ([H, W, 3], casts, dropped), the counters as
    device tensors (reading them waits for the device).  The last tile's
    padding is not traced (the ladder takes any width): its copies of the
    centre ray only cost casts, and where the centre sees a mirror or glass
    their children overflowed the pools (03-recursive at 320x240: 24,402
    rays dropped, every one a padding ray's).

    tiles: trace only these tile indices; the frame is zero outside them
    and the counters are theirs.  Each tile keeps its own pools, so its
    pixels are the whole frame's bit for bit."""
    clips, inv = _clips(cfg, scene.device)
    n = cfg.width * cfg.height
    keep = None if tiles is None else set(tiles)
    colors, casts, dropped = [], 0, 0
    for t, clip in enumerate(clips):
        width = min(clip.shape[0], n - t * clip.shape[0])
        if keep is not None and t not in keep:
            colors.append(clip.new_zeros((width, 3)))
            continue
        with tracing.span("rt.whitted.tile", tile=t):
            with tracing.span("rt.whitted.shoot"):
                o, d = camera_ops.shoot(camera, clip[:width])
            res = trace_whitted(scene, o, d, cfg)
        colors.append(res.color)
        casts = casts + res.casts
        dropped = dropped + res.dropped
    with tracing.span("rt.whitted.assemble"):
        img = _to_image(cfg, colors, inv)
    return img, casts, dropped


def render_whitted(scene: Scene, camera: Camera,
                   cfg: RenderConfig) -> Tuple[torch.Tensor, dict]:
    """Whitted pass over the full frame -> ([H, W, 3], stats).  Under a
    recording torch.profiler the frame is a unit of utils/tracing; its
    `rt.whitted.read` span is the host waiting on the card for the stats."""
    with tracing.unit("rt.whitted.frame"):
        img, casts, dropped = _whitted(scene, camera, cfg)
        with tracing.span("rt.whitted.read"):
            stats = {"casts": int(casts), "dropped": int(dropped),
                     "primary_rays": cfg.width * cfg.height}
            tracing.settle()
    return img, stats


def _seed(seed: int, epoch: int, tile: int, sample: int = 0) -> int:
    """Generator seed for one (seed, epoch, tile) and, for sample > 0, that
    further sample of the tile's pixels: a splitmix64 chain."""
    x = 0
    for part in (seed, epoch, tile) + ((sample,) if sample else ()):
        x = (x + part + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x & 0x7FFFFFFFFFFFFFFF


def tile_draws(cfg: RenderConfig, seed: int, epoch: int, tile: int, n: int,
               device, sample: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tile's draws: lens normals [n, 2] (unscaled) and uniforms
    [depth, 3, n] (roulette u, lobe u_phi, lobe theta in [-pi, pi)).
    `sample` s > 0 draws the s-th further sample of the same pixels (the
    sample-parallel ranks of parallel/mesh.py)."""
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, epoch, tile, sample))
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


Draws = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _epoch(scene: Scene, camera: Camera, cfg: RenderConfig, seed: int, epoch: int,
           draws: Optional[Draws], tiles: Optional[Sequence[int]] = None, sample: int = 0):
    """One MC epoch -> ([H, W, 3] photons, casts, filtered), the counters
    as device tensors.

    tiles: trace only these tile indices (draws[t] for each, when given),
    in one call or tile by tile as the whole frame's route takes them; the
    photons are zero outside them and the counters are theirs.  A lane's
    photon does not depend on the other lanes of its call, so each
    traced pixel is the whole frame's bit for bit.  sample: the draws'
    sample index (tile_draws)."""
    clips, inv = _clips(cfg, scene.device)
    if draws is not None and len(draws) != len(clips):
        raise ValueError(f"draws for {len(draws)} tiles, the frame has {len(clips)}")
    picked = range(len(clips)) if tiles is None else sorted(tiles)
    with tracing.span("rt.epoch.draws"):
        tile_in = [draws[t] if draws is not None else
                   tile_draws(cfg, seed, epoch, t, clips.shape[1], clips.device, sample)
                   for t in picked]
    if not tile_in:
        return (torch.zeros((cfg.height, cfg.width, 3), device=clips.device),
                torch.zeros((), dtype=torch.int64, device=clips.device),
                torch.zeros((), dtype=torch.int64, device=clips.device))
    run = epoch_frame if frame_wide_route(scene) else epoch_tiles
    traced = clips if tiles is None else clips[list(picked)]
    with tracing.span("rt.epoch.walk"):
        photon, casts, filtered = run(scene, camera, cfg, traced, tile_in)
    with tracing.span("rt.epoch.assemble"):
        if tiles is not None:
            full = photon.new_zeros((clips.shape[0], clips.shape[1], 3))
            full[list(picked)] = photon.view(len(picked), clips.shape[1], 3)
            photon = full.view(-1, 3)
        img = _to_image(cfg, [photon], inv)
    return img, casts, filtered


def _epoch_draws(draws: Optional[Sequence[Draws]], n: int, what: str):
    """The per-epoch draws lists of a multi-epoch call (None: the
    generator's), checked against the count."""
    if draws is None:
        return [None] * n
    if len(draws) != n:
        raise ValueError(f"draws for {len(draws)} {what}, asked for {n}")
    return draws


def render_distributed_epoch(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed: int = 0,
    epoch: int = 0, draws: Optional[Draws] = None,
) -> Tuple[torch.Tensor, dict]:
    """One stochastic epoch: one is_normal-filtered photon per pixel
    (main.rs:1131-1160) -> ([H, W, 3], stats).

    draws: optional per-tile (lens normals [tile, 2], unifs [depth, 3,
    tile]) in place of the generator's."""
    img, casts, filtered = _epoch(scene, camera, cfg, seed, epoch, draws)
    # stats include the padding rays of a ragged last tile
    return img, {
        "casts": int(casts), "filtered": int(filtered),
        "primary_rays": cfg.width * cfg.height,
    }


def render_step(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed: int = 0, epoch: int = 0,
    draws: Optional[Draws] = None,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One progressive step: the Whitted frame and one MC epoch, as
    render_whitted followed by render_distributed_epoch(seed, epoch,
    draws) -> ([H, W, 3] whitted, [H, W, 3] photons, stats); `casts` sums
    both passes (raytracer_tpu/render.py:182-212)."""
    img, w_casts, dropped = _whitted(scene, camera, cfg)
    photons, e_casts, filtered = _epoch(scene, camera, cfg, seed, epoch, draws)
    return img, photons, {
        "casts": int(w_casts + e_casts), "dropped": int(dropped),
        "filtered": int(filtered), "primary_rays": cfg.width * cfg.height,
    }


def render_steps(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed: int, n_steps: int,
    epoch: int = 0, draws: Optional[Sequence[Draws]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """n_steps progressive steps (the bench harness's unit,
    raytracer_tpu/render.py:270-295): step i renders the Whitted frame and
    MC epoch `epoch + i` (draws[i] when given) -> the LAST step's
    (whitted, photons) and the counters summed over the steps.  Each step
    renders its own Whitted frame."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    casts = dropped = filtered = 0
    for i, step_draws in enumerate(_epoch_draws(draws, n_steps, "steps")):
        img, w_casts, w_dropped = _whitted(scene, camera, cfg)
        photons, e_casts, e_filtered = _epoch(scene, camera, cfg, seed, epoch + i, step_draws)
        casts = casts + w_casts + e_casts
        dropped = dropped + w_dropped
        filtered = filtered + e_filtered
    return img, photons, {
        "casts": int(casts), "dropped": int(dropped), "filtered": int(filtered),
        "primary_rays": cfg.width * cfg.height * n_steps, "steps": n_steps,
    }


def render_epochs(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed: int, n_epochs: int,
    epoch: int = 0, draws: Optional[Sequence[Draws]] = None,
) -> Tuple[torch.Tensor, dict]:
    """n_epochs MC epochs, `epoch` .. `epoch + n_epochs - 1` (draws[i]
    when given), their photons added in order onto zeros, with no
    renormalisation: the reference's epoch loop without its per-epoch tone
    map and PNG (raytracer_tpu/render.py:298-330) -> ([H, W, 3], stats)."""
    accum = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=scene.device)
    casts = filtered = 0
    for i, epoch_draws in enumerate(_epoch_draws(draws, n_epochs, "epochs")):
        photons, e_casts, e_filtered = _epoch(scene, camera, cfg, seed, epoch + i, epoch_draws)
        accum = accum + photons
        casts = casts + e_casts
        filtered = filtered + e_filtered
    return accum, {
        "casts": int(casts), "filtered": int(filtered),
        "primary_rays": cfg.width * cfg.height * n_epochs, "epochs": n_epochs,
    }
