"""Rendering over several cards (or CPU processes) with torch.distributed.

Counterpart of raytracer_tpu/parallel/mesh.py, with its names.  The JAX
package runs one controller over a 2D device mesh; here each card has a
process of its own (a rank), NCCL's model and the one that also spans
hosts (init_multihost), and the ranks form a (dp, sp) mesh:

  * ``dp``: data parallel over pixel tiles.  Whole tiles of the
    single-card layout (render._clips: 32x16 block-major lanes in tiles of
    cfg.tile_rays) are dealt to the ranks in tile order (rank_tiles).
  * ``sp``: sample parallel.  The sp ranks of one dp group trace the same
    tiles, each with its own sample of the draws (render.tile_draws
    `sample`), so an epoch gives |sp| photons a pixel.

Rank r is (dp_idx, sp_idx) = divmod(r, sp), as the JAX mesh's
reshape(dp, sp) orders its devices.  A rank traces its tiles into a
full-frame buffer that is zero elsewhere, and ONE all_reduce(SUM) gathers
the frame and sums the sp samples of each pixel; the counters take a
second, int64 all_reduce.  Adding exact zeros changes nothing, so a
dp-only Whitted frame, MC epoch and train step equal the single card's bit
for bit: the draws are keyed per (seed, epoch, tile), not per rank as the
JAX package folds in the dp index (raytracer_tpu/parallel/mesh.py:224).
With sp = 2 each pixel sums two samples, which no order changes; with sp >
2 the collective's order is its own.

The accumulator of the progressive render is replicated: every rank holds
the whole [H, W, 3] frame (14.7 MB at 1280x960), adds the reduced photons
and renormalises it itself, so the percentile is the whole frame's and no
rank waits for another's sort.  The JAX package shards the accumulator
over dp and lets XLA sort across devices; on cards whose frame fits many
times over, the replicated frame costs one buffer and saves that sort's
traffic.

No fallback: a failed collective raises, and a rank on a card never runs
on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops.tonemap import post_process
from raytracer_tpu_torch.render import Draws, _clips, _epoch, _whitted
from raytracer_tpu_torch.scene.types import Camera, Scene
from raytracer_tpu_torch.utils import tracing
from raytracer_tpu_torch.utils.color import linear_to_u8


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A (dp, sp) mesh of ranks, seen from rank `rank`.  `group` is the
    process group the collectives run on (None: the mesh's rank bodies
    only, as a test or an emulation on one device runs them)."""

    dp: int
    sp: int
    rank: int = 0
    group: Any = None

    @property
    def world(self) -> int:
        return self.dp * self.sp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def index(self) -> tuple:
        """(dp_idx, sp_idx) of this rank."""
        return divmod(self.rank, self.sp)


def init_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device: str = "cuda") -> torch.device:
    """Join this process to the render's process group (mesh.py:39) ->
    the rank's device.

    NCCL on cards, gloo on the CPU.  With a coordinator ("host:port") the
    group meets there as world_size=num_processes, rank=process_id;
    without, torchrun's environment says where (env://).  On cards the
    rank takes cuda:<LOCAL_RANK> (torchrun's), else cuda:<process_id>
    modulo the host's cards."""
    cuda = torch.device(device).type == "cuda"
    kwargs = {"backend": "nccl" if cuda else "gloo"}
    if coordinator is not None:
        kwargs.update(init_method=f"tcp://{coordinator}", world_size=num_processes,
                      rank=process_id)
    else:
        kwargs["init_method"] = "env://"
    dev = torch.device("cpu")
    if cuda:
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local is not None else (process_id or 0) % torch.cuda.device_count()
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group(**kwargs)
    return dev


def make_render_mesh(n_devices: Optional[int] = None, sp: Optional[int] = None) -> RenderMesh:
    """A (dp, sp) mesh of n_devices ranks (mesh.py:122): sp = 2 when the
    count is even, else 1; dp the rest.  In a process group the count
    defaults to its world size, must equal it, and the mesh holds this
    rank and the group; outside one (n_devices given) it is rank 0's view
    with no group."""
    group = dist.group.WORLD if dist.is_initialized() else None
    if group is None and n_devices is None:
        raise ValueError("make_render_mesh: no process group; give n_devices")
    n = n_devices or dist.get_world_size()
    if group is not None and n != dist.get_world_size():
        raise ValueError(f"{n} devices asked for in a process group of {dist.get_world_size()}")
    if sp is None:
        sp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // sp
    assert dp * sp == n, f"{n} devices do not factor into dp={dp} x sp={sp}"
    return RenderMesh(dp=dp, sp=sp, rank=dist.get_rank() if group is not None else 0,
                      group=group)


def rank_tiles(n_tiles: int, parts: int, index: int) -> range:
    """The tiles part `index` of `parts` traces: whole tiles in tile order,
    contiguous and balanced (the first n_tiles % parts parts take one
    more).  The lanes keep the single card's 32x16 block-major order, so no
    padding is needed beyond the last tile's own (in place of
    sharded_clips / _pad_to, mesh.py:140-170)."""
    base, extra = divmod(n_tiles, parts)
    start = index * base + min(index, extra)
    return range(start, start + base + (index < extra))


def _my_tiles(cfg: RenderConfig, device, parts: int, index: int) -> Optional[range]:
    """rank_tiles of the frame's tiles, or None where the part holds every
    tile (one rank traces the whole frame, with no zero-and-scatter)."""
    n_tiles = _clips(cfg, device)[0].shape[0]
    tiles = rank_tiles(n_tiles, parts, index)
    return None if len(tiles) == n_tiles else tiles


def whitted_body(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: RenderMesh):
    """Rank `mesh.rank`'s part of the Whitted frame: its tiles of the
    flattened dp x sp world -> ([H, W, 3] zero outside them, int64 [2]
    (casts, dropped))."""
    tiles = _my_tiles(cfg, scene.device, mesh.world, mesh.rank)
    img, casts, dropped = _whitted(scene, camera, cfg, tiles)
    return img, _counters(casts, dropped, img.device)


def epoch_body(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: RenderMesh, seed: int,
               epoch: int, draws: Optional[Draws] = None):
    """Rank (d, s)'s part of an MC epoch: dp group d's tiles with sample
    s's draws (`draws`: every tile's, for sample 0) -> ([H, W, 3] photons
    zero outside them, int64 [2] (casts, filtered))."""
    d, s = mesh.index
    if draws is not None and s:
        raise ValueError("draws are sample 0's")
    tiles = _my_tiles(cfg, scene.device, mesh.dp, d)
    photons, casts, filtered = _epoch(scene, camera, cfg, seed, epoch, draws, tiles, s)
    return photons, _counters(casts, filtered, photons.device)


def _counters(a, b, device):
    return torch.stack([torch.as_tensor(x, device=device).to(torch.int64) for x in (a, b)])


def _reduce(mesh: RenderMesh, *tensors):
    """Sum each tensor over the mesh's ranks, in place."""
    if mesh.world == 1 and mesh.group is None:
        return
    if mesh.group is None:
        raise ValueError("a mesh of several ranks needs its process group")
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)


def render_whitted_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: RenderMesh):
    """The Whitted frame over every rank of the mesh (mesh.py:192): the
    deterministic pass has no use for samples, so the tiles are dealt over
    the flattened dp x sp world -> ([H, W, 3] on every rank, stats)."""
    with tracing.unit("rt.whitted.frame"):
        img, counters = whitted_body(scene, camera, cfg, mesh)
        _reduce(mesh, img, counters)
        with tracing.span("rt.whitted.read"):
            casts, dropped = counters.tolist()
            tracing.settle()
    return img, {"casts": casts, "dropped": dropped, "primary_rays": cfg.width * cfg.height}


def _mc_epoch(scene, camera, cfg, mesh, seed, epoch):
    photons, counters = epoch_body(scene, camera, cfg, mesh, seed, epoch)
    _reduce(mesh, photons, counters)
    return photons, counters


def render_mc_epoch_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: RenderMesh,
                            seed: int = 0, epoch: int = 0):
    """One sample-parallel MC epoch (mesh.py:247): |sp| photons a pixel,
    summed -> ([H, W, 3] on every rank, stats)."""
    photons, counters = _mc_epoch(scene, camera, cfg, mesh, seed, epoch)
    casts, filtered = counters.tolist()
    n = cfg.width * cfg.height
    return photons, {"casts": casts, "filtered": filtered, "samples_per_pixel": mesh.sp,
                     "primary_rays": n * mesh.sp}


def train_step_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: RenderMesh,
                       accum: torch.Tensor, seed: int, epoch: int):
    """One progressive step on every rank (mesh.py:270): epoch `epoch`'s
    reduced photons added to the replicated accumulator [H, W, 3], the sum
    renormalised by the whole frame's percentile (post_process) and
    encoded as sRGB u8 -> (accum', u8 [H, W, 3], int64 [2] (casts,
    filtered) on the device: reading them waits for it)."""
    return train_steps_sharded(scene, camera, cfg, mesh, accum, seed, 1, epoch)


def train_steps_sharded(scene: Scene, camera: Camera, cfg: RenderConfig, mesh: RenderMesh,
                        accum: torch.Tensor, seed: int, k: int, start_epoch: int = 0,
                        check: Optional[Callable[[torch.Tensor, int], None]] = None):
    """k train steps, epochs start_epoch .. start_epoch + k - 1
    (mesh.py:305): each renormalises as one step does, so the result is k
    train_step_sharded calls' -> (accum', u8 of the last, int64 [2]
    (casts, filtered) summed on the device over the group, for one read).

    check: called as check(photons, epoch) with each epoch's reduced
    photons before they are accumulated (progressive's debug_nans).

    Under a recording torch.profiler each epoch is a unit of utils/tracing
    (id: the epoch), and so is the group's encoding (id: its first epoch)."""
    counters = torch.zeros((2,), dtype=torch.int64, device=accum.device)
    for epoch in range(start_epoch, start_epoch + k):
        with tracing.unit("rt.step.epoch", epoch):
            photons, c = _mc_epoch(scene, camera, cfg, mesh, seed, epoch)
            if check is not None:
                check(photons, epoch)
            with tracing.span("rt.step.renormalise"):
                accum = post_process(accum + photons, cfg.percentile)
            counters = counters + c
    with tracing.unit("rt.step.encode", start_epoch):
        u8 = linear_to_u8(accum)
    return accum, u8, counters


# The JAX package's name for the Whitted frame over processes on several
# hosts (mesh.py:84): a process group already spans hosts, so it is the
# same function.
render_whitted_multihost = render_whitted_sharded
