"""Progressive accumulation with checkpoint/resume, on one card or a mesh.

Counterpart of raytracer_tpu/parallel/progressive.py:45-434.  The
reference's main() (src/main.rs:1084-1173): a Whitted pass fills the
framebuffer, then every stochastic epoch adds one photon per pixel,
re-runs the percentile normalizer on the ACCUMULATED buffer in place
(main.rs:1171) and atomically rewrites out.png, so a killed render leaves a
valid image.  Added here: an epoch-granular checkpoint of (image, epoch,
seed) — each epoch's draws depend only on (seed, epoch, tile)
(render.tile_draws), so a resumed render continues exactly.

With png_every=k the PNG and the checkpoint are written once per group of
k epochs; every epoch still accumulates and renormalizes, so the image is
the same.

One schedule serves one card and a mesh (parallel/mesh.py: one process a
rank; one card is the mesh of one rank, whose collectives do nothing): the
Whitted frame through render_whitted_sharded, each group of epochs
through train_steps_sharded on the replicated accumulator; rank 0 alone
logs and writes the PNG and the checkpoint, and on resume reads the
checkpoint and broadcasts it (raytracer_tpu/parallel/progressive.py:
253-360).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops.tonemap import post_process
from raytracer_tpu_torch.parallel.mesh import (
    RenderMesh,
    render_whitted_sharded,
    train_steps_sharded,
)
from raytracer_tpu_torch.scene.types import Camera, Scene
from raytracer_tpu_torch.utils import tracing
from raytracer_tpu_torch.utils.color import linear_to_u8
from raytracer_tpu_torch.utils.png import write_png_atomic


@dataclasses.dataclass
class ProgressiveState:
    img: torch.Tensor  # [H, W, 3] accumulated (and renormalized) buffer
    epoch: int
    seed: int


def save_checkpoint(path: str, img: np.ndarray, epoch: int, seed: int) -> None:
    """Atomic npz checkpoint (tmp file + fsync + rename)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, img=img, epoch=epoch, seed=seed)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str, device) -> Optional[ProgressiveState]:
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return ProgressiveState(
            img=torch.as_tensor(data["img"], device=device),
            epoch=int(data["epoch"]),
            seed=int(data["seed"]),
        )


def write_image(path: str, img: torch.Tensor) -> None:
    """Linear [H, W, 3] buffer -> sRGB u8 PNG, written atomically
    (main.rs:764-776)."""
    write_png_atomic(path, linear_to_u8(img).cpu().numpy())


class _AsyncWriter:
    """One background thread for per-epoch output (PNG + checkpoint), so
    PNG encoding and the checkpoint fsync overlap the next epoch's device
    work.  Jobs run in order; after a failure no later job runs (a later
    checkpoint must not advance past the failure) and the error is raised
    on the main thread.  Queue depth 1 bounds host memory."""

    def __init__(self) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: list = []
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            if self._err:
                continue
            try:
                job()
            except Exception as e:  # re-raised on the main thread
                self._err.append(e)

    def submit(self, job: Callable[[], None]) -> None:
        if self._err:
            raise self._err[0]
        self._q.put(job)

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err[0]


def check_finite(x: torch.Tensor, stage: str, epoch: int) -> None:
    """Raise FloatingPointError if `x` holds a NaN or an infinity (waits
    for the device)."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite value in {stage} (epoch {epoch})")


def _output_job(out_path, checkpoint_path, on_epoch, log, u8, snap, epoch, seed, stats, dt):
    """The writer thread's work after a group of epochs: the throughput
    line, the PNG, the checkpoint, the callback.  A unit of utils/tracing
    (`rt.png.job`, id: the epoch) when the caller's thread records: the
    profiler does not see the writer's."""
    recorded = tracing.recording()

    def job():
        with tracing.unit("rt.png.job", epoch, recorded=recorded):
            kept = stats["primary_rays"] - stats["filtered"]
            log(f"{kept} rays in {dt * 1e3:.0f} ms ({stats['casts'] / dt:,.0f} casts/s)")
            write_png_atomic(out_path, u8)
            if checkpoint_path:
                save_checkpoint(checkpoint_path, snap, epoch, seed)
            if on_epoch:
                on_epoch(epoch, stats)
    return job


def _broadcast_state(mesh: RenderMesh, state: Optional[ProgressiveState], cfg: RenderConfig,
                     device) -> Optional[ProgressiveState]:
    """Rank 0's checkpointed state (or None) on every rank of the mesh."""
    if mesh.group is None:
        if mesh.world > 1:
            raise ValueError("a mesh of several ranks needs its process group")
        return state
    meta = [None if state is None else (state.epoch, state.seed)]
    dist.broadcast_object_list(meta, src=0, group=mesh.group, device=device)
    if meta[0] is None:
        return None
    img = state.img if mesh.rank == 0 else torch.empty(
        (cfg.height, cfg.width, 3), dtype=torch.float32, device=device)
    dist.broadcast(img, src=0, group=mesh.group)
    return ProgressiveState(img=img, epoch=meta[0][0], seed=meta[0][1])


def render_progressive(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    out_path: str = "out.png",
    seed: int = 0,
    checkpoint_path: Optional[str] = None,
    on_epoch: Optional[Callable[[int, dict], None]] = None,
    log: Callable[[str], None] = print,
    png_every: int = 1,
    debug_nans: bool = False,
    mesh: Optional[RenderMesh] = None,
) -> ProgressiveState:
    """The full reference schedule: Whitted pass + cfg.epochs stochastic
    epochs, a PNG (and checkpoint) after each group of png_every epochs.
    Renders on scene.device.

    debug_nans: stop at the first non-finite value (FloatingPointError
    naming the stage and epoch), checked in the Whitted frame's colours and
    in each epoch's photons before they are accumulated; each check waits
    for the device.

    mesh: this process's rank of a parallel.mesh.RenderMesh; every rank
    calls this with the same arguments and returns the same state, and the
    stats passed to on_epoch gain samples_per_pixel.  None: one card, the
    mesh of one rank."""
    stats_sp = {} if mesh is None else {"samples_per_pixel": mesh.sp}
    mesh = RenderMesh(dp=1, sp=1) if mesh is None else mesh
    device, lead = scene.device, mesh.rank == 0
    loaded = load_checkpoint(checkpoint_path, device) if lead and checkpoint_path else None
    state = _broadcast_state(mesh, loaded, cfg, device)
    if state is None:
        t0 = time.time()
        img, stats = render_whitted_sharded(scene, camera, cfg, mesh)
        if debug_nans:
            check_finite(img, "the whitted frame", 0)
        dt = max(time.time() - t0, 1e-9)
        img = post_process(img, cfg.percentile)
        if lead:
            log(f"{stats['primary_rays']} rays in {dt * 1e3:.0f} ms "
                f"({stats['casts'] / dt:,.0f} casts/s)")
            if stats["dropped"]:
                log(f"warning: {stats['dropped']} rays dropped by pool overflow")
            write_image(out_path, img)
            if checkpoint_path:
                save_checkpoint(checkpoint_path, img.cpu().numpy(), 0, seed)
        state = ProgressiveState(img=img, epoch=0, seed=seed)
    elif lead:
        log(f"resumed at epoch {state.epoch}")

    check = (lambda photons, epoch: check_finite(photons, "the photons", epoch)) \
        if debug_nans else None
    n_pix = cfg.width * cfg.height
    writer = _AsyncWriter() if lead else None
    try:
        while state.epoch < cfg.epochs:
            t0 = time.time()
            k = max(1, min(png_every, cfg.epochs - state.epoch))
            img, u8, counters = train_steps_sharded(scene, camera, cfg, mesh, state.img,
                                                    state.seed, k, state.epoch, check)
            state = ProgressiveState(img=img, epoch=state.epoch + k, seed=state.seed)
            casts, filtered = counters.tolist()  # one read a group; waits for the device
            tracing.settle()  # the group's device counts, while the host waits anyway
            if not lead:
                continue
            u8 = u8.cpu().numpy()
            snap = img.cpu().numpy() if checkpoint_path else None
            dt = max(time.time() - t0, 1e-9)
            stats = {"casts": casts, "filtered": filtered, **stats_sp,
                     "primary_rays": n_pix * mesh.sp * k}
            writer.submit(_output_job(out_path, checkpoint_path, on_epoch, log, u8, snap,
                                      state.epoch, state.seed, stats, dt))
    finally:
        if writer is not None:
            writer.close()
    return state
