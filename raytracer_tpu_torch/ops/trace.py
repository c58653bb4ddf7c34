"""Wavefront Whitted tracer: the level ladder over the level kernel.

Counterpart of raytracer_tpu/ops/trace.py:359-542 (_trace_whitted_packed).
The reference's per-pixel recursion (src/main.rs:466-519, depth 5)
flattens into a fixed-depth loop of levels over bounded ray pools:

  * level 0 runs the primary rays at exact width and delivers straight
    into the framebuffer (identity slots);
  * level 1 is peeled: level 0 emits exactly 2n children, which is already
    a valid pool (capacity_factor 2), so it runs uncompacted and delivers
    with two plain adds;
  * deeper levels run in narrower pools (deep_capacity, then
    tail_capacity, plus fixed slacks), entered through group compaction;
    their radiance rides the `pending` rows down the wavefront, and the
    peeled final level delivers every chain with ONE scatter-add.

Group compaction keeps a group of `group` lanes iff any lane is alive or
owes pending radiance; destinations are a cumsum prefix sum; groups past
the pool's capacity are dropped and COUNTED (`dropped`), never silently.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops.level_kernel import (
    F_PEND,
    I_ALIVE,
    I_SLOT,
    N_I,
    Pool,
    process_level,
)
from raytracer_tpu_torch.scene.types import NO_EXCLUDE, Scene


class TraceResult(NamedTuple):
    color: torch.Tensor  # [N, 3]
    casts: torch.Tensor  # 0-d: rays cast, incl. shadow rays and marches
    dropped: torch.Tensor  # 0-d: rays lost to pool overflow (want 0)


def _group(cfg: RenderConfig) -> int:
    """Compaction group width (cfg.compact_group; 0 = auto).

    The JAX package's auto rule takes 32-lane groups from n >= 65536 to
    amortise the TPU's per-row scatter cost (raytracer_tpu/ops/trace.py:
    359-362).  Here compaction is a prefix sum and one index_copy whose
    cost hardly depends on the width, while 32-lane groups overflow the
    pools on the reference schedule itself (1280x960 in 65536-ray tiles:
    14102 rays dropped, in 3 of 19 tiles, on an H100); 8-lane groups, the
    JAX rule's value below 65536, drop none there.  So auto is 8 at every
    tile size."""
    return cfg.compact_group or 8


def _round128(x: int) -> int:
    return max(128, -(-x // 128) * 128)


def _pack_primary(ray_o, ray_d) -> Pool:
    n = ray_o.shape[0]
    dev = ray_o.device
    f = torch.cat([
        ray_o.t(), ray_d.t(),
        torch.ones((2, n), device=dev),  # c, s
        torch.zeros((3, n), device=dev),  # pending
    ]).contiguous()
    i = torch.zeros((N_I, n), dtype=torch.int32, device=dev)  # face FRONT, excl_face
    i[1] = NO_EXCLUDE
    i[I_SLOT] = torch.arange(n, dtype=torch.int32, device=dev)
    i[I_ALIVE] = 1
    return Pool(f, i)


def _cat(a: Pool, b: Pool) -> Pool:
    return Pool(torch.cat([a.f, b.f], dim=1), torch.cat([a.i, b.i], dim=1))


def _pad(pool: Pool, k: int) -> Pool:
    extra = k - pool.width
    return Pool(torch.nn.functional.pad(pool.f, (0, extra)),
                torch.nn.functional.pad(pool.i, (0, extra)))


def _compact(cands: Pool, k: int, group: int):
    """Group compaction into a k-lane pool -> (Pool, dropped 0-d)."""
    assert k % group == 0, (k, group)
    c = cands.width
    if c % group:
        cands = _pad(cands, c + (-c) % group)
        c = cands.width
    keep = (cands.i[I_ALIVE] != 0) | torch.any(cands.f[F_PEND:F_PEND + 3] != 0.0, dim=0)
    ng_in, ng_out = c // group, k // group
    gkeepl = keep.view(ng_in, group)
    gkeep = gkeepl.any(dim=1)
    gcount = gkeepl.sum(dim=1)
    order = torch.cumsum(gkeep.to(torch.int64), dim=0) - 1
    fits = gkeep & (order < ng_out)
    dropped = torch.where(gkeep & ~fits, gcount, 0).sum()
    # one extra trash group takes every group that is not kept or not fit
    dest = torch.where(fits, order, ng_out)

    def move(x):
        rows = x.shape[0]
        out = x.new_zeros((rows, ng_out + 1, group))
        out.index_copy_(1, dest, x.view(rows, ng_in, group))
        return out[:, :ng_out].reshape(rows, k).contiguous()

    return Pool(move(cands.f), move(cands.i)), dropped


def trace_whitted(scene: Scene, ray_o, ray_d, cfg: RenderConfig,
                  level_fn=process_level) -> TraceResult:
    """Whitted-trace a primary ray batch [N, 3] -> per-ray linear RGB.

    Equivalent to World::ray_trace(depth=cfg.depth, contribution=1) per
    pixel (src/main.rs:1096-1102).  `level_fn` runs one level
    (level_kernel.process_level's signature); a caller that compares the
    kernel with its plain version on the card passes a plain stand-in."""

    def level(pool, last, direct):
        return level_fn(scene, pool, last, direct, cfg.threshold,
                        cfg.max_refract_distance, cfg.max_tir_retries)

    n = ray_o.shape[0]
    k = _round128(int(n * cfg.capacity_factor))
    group = _group(cfg)
    dropped = torch.zeros((), dtype=torch.int64, device=ray_o.device)

    contrib, rch, fch, casts = level(_pack_primary(ray_o, ray_d), cfg.depth == 0, True)
    img = contrib.t()  # identity slots: the contribution IS the framebuffer
    if cfg.depth == 0:
        return TraceResult(img, casts, dropped)

    # level 1 peel: the 2n candidates already form a pool
    cands = _cat(rch, fch)
    doubled = k >= 2 * n
    if doubled:
        cands = _pad(cands, k)
    else:
        cands, drop = _compact(cands, k, group)
        dropped = dropped + drop
    last1 = cfg.depth == 1
    contrib, rch, fch, c1 = level(cands, last1, doubled or last1)
    casts = casts + c1
    if doubled:
        img = img + contrib[:, :n].t() + contrib[:, n:2 * n].t()
    elif last1:
        img = img.index_add(0, cands.i[I_SLOT].long(), contrib.t())
    if last1:
        return TraceResult(img, casts, dropped)

    # deep levels (>= 2): narrower pool
    k2 = _round128(int(n * cfg.deep_capacity) + cfg.deep_slack)
    pool, drop = _compact(_cat(rch, fch), k2, group)
    dropped = dropped + drop
    last2 = cfg.depth == 2
    contrib, rch, fch, c2 = level(pool, last2, last2)
    casts = casts + c2
    if last2:
        img = img.index_add(0, pool.i[I_SLOT].long(), contrib.t())
        return TraceResult(img, casts, dropped)

    # tail levels (>= 3): narrower once more; the slack absorbs lanes that
    # only carry pending radiance
    k3 = _round128(int(n * cfg.tail_capacity) + cfg.tail_slack)
    pool, drop = _compact(_cat(rch, fch), k3, group)
    dropped = dropped + drop
    for _ in range(3, cfg.depth):
        _, rch, fch, ci = level(pool, False, False)
        casts = casts + ci
        pool, drop = _compact(_cat(rch, fch), k3, group)
        dropped = dropped + drop
    # final level peeled: no children; ONE scatter delivers every chain
    contrib, _, _, cl = level(pool, True, True)
    casts = casts + cl
    img = img.index_add(0, pool.i[I_SLOT].long(), contrib.t())
    return TraceResult(img, casts, dropped)

