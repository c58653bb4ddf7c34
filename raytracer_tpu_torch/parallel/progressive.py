"""Progressive accumulation with checkpoint/resume (single device).

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

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops.tonemap import post_process
from raytracer_tpu_torch.render import render_distributed_epoch, render_whitted
from raytracer_tpu_torch.scene.types import Camera, Scene
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


def _u8(img: torch.Tensor) -> np.ndarray:
    return linear_to_u8(img).cpu().numpy()


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
) -> ProgressiveState:
    """The full reference schedule: Whitted pass + cfg.epochs stochastic
    epochs, a PNG (and checkpoint) after each group of png_every epochs.
    Renders on scene.device.

    debug_nans: stop at the first non-finite value (FloatingPointError
    naming the stage and epoch), checked in the Whitted frame's colours and
    in each epoch's photons before they are accumulated; each check waits
    for the device."""
    device = scene.device
    state = load_checkpoint(checkpoint_path, device) if checkpoint_path else None
    if state is None:
        t0 = time.time()
        img, stats = render_whitted(scene, camera, cfg)
        if debug_nans:
            check_finite(img, "the whitted frame", 0)
        dt = max(time.time() - t0, 1e-9)
        log(f"{stats['primary_rays']} rays in {dt * 1e3:.0f} ms "
            f"({stats['casts'] / dt:,.0f} casts/s)")
        if stats["dropped"]:
            log(f"warning: {stats['dropped']} rays dropped by pool overflow")
        img = post_process(img, cfg.percentile)
        write_png_atomic(out_path, _u8(img))
        state = ProgressiveState(img=img, epoch=0, seed=seed)
        if checkpoint_path:
            save_checkpoint(checkpoint_path, img.cpu().numpy(), 0, seed)
    else:
        log(f"resumed at epoch {state.epoch}")

    n_pix = cfg.width * cfg.height
    writer = _AsyncWriter()
    try:
        while state.epoch < cfg.epochs:
            t0 = time.time()
            k = max(1, min(png_every, cfg.epochs - state.epoch))
            img = state.img
            stats = {"casts": 0, "filtered": 0, "primary_rays": n_pix * k}
            for epoch in range(state.epoch, state.epoch + k):
                photons, st = render_distributed_epoch(
                    scene, camera, cfg, seed=state.seed, epoch=epoch)
                if debug_nans:
                    check_finite(photons, "the photons", epoch)
                img = post_process(img + photons, cfg.percentile)
                stats["casts"] += st["casts"]
                stats["filtered"] += st["filtered"]
            state = ProgressiveState(img=img, epoch=state.epoch + k, seed=state.seed)
            u8 = _u8(img)  # waits for the device
            snap = img.cpu().numpy() if checkpoint_path else None
            dt = max(time.time() - t0, 1e-9)

            def job(u8=u8, snap=snap, epoch=state.epoch, seed=state.seed, stats=stats,
                    dt=dt):
                kept = stats["primary_rays"] - stats["filtered"]
                log(f"{kept} rays in {dt * 1e3:.0f} ms "
                    f"({stats['casts'] / dt:,.0f} casts/s)")
                write_png_atomic(out_path, u8)
                if checkpoint_path:
                    save_checkpoint(checkpoint_path, snap, epoch, seed)
                if on_epoch:
                    on_epoch(epoch, stats)

            writer.submit(job)
    finally:
        writer.close()
    return state
