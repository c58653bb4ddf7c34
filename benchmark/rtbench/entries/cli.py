"""Traffic entry `cli`: what `python -m raytracer_tpu_torch` runs by default
(raytracer_tpu_torch/cli.py): `parallel.progressive.render_progressive`, a
Whitted frame and then the configuration's epochs, a PNG after every epoch
(png_every 1) written by the program's writer thread, whole schedules back
to back in a closed loop.  Every schedule writes one out.png in a temporary
directory, through the Python encoder where the checkout has no
native/libraytpu_host.so (a checkout from git has none).  The throughput
line of each epoch is made and dropped.

Set-up runs a short schedule, the checked one (below): the Whitted frame
and `checked_epochs` epochs, which warms every shape and the writer.  Its
pace sets the window's count of whole schedules to last `--seconds`, and
the window runs more while it has not yet lasted `--seconds` (a traced
run: `trace_units` schedules).  epoch_ms: the window's wall time over the
epochs it completed.

The check watches the set-up's schedule without changing it: the program's
`train_steps_sharded` (one epoch a call at png_every 1) is wrapped so that
each epoch's photons, its starting and resulting accumulator and its u8
frame are kept, and the writer's per-epoch callback keeps out.png as
written after that epoch.
Then, each number against the cell's limit:
  photon_bad_share, accum_rel_err, u8_bad_share
                  the progressive entry's numbers (rtbench/entries/
                  progressive.py), each checked epoch a group of one; the
                  window's last frame is the last schedule's final out.png;
  png_bad_share   the worst checked epoch's share of u8 values in its
                  out.png, decoded by utils/png.decode_png_rgb8, that
                  differ from the u8 frame those checks hold (1 where the
                  file does not decode to a frame of the right shape).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import shutil
import struct
import tempfile
import time
import zlib

import torch

from rtbench.entries import progressive
from rtbench.trace import mark


class Loop:
    unit = "schedule"

    def __init__(self, run):
        self.run = run
        self.epochs = run.cfg.epochs
        self.n_checked = int(run.traffic["checked_epochs"])
        self.dir = tempfile.mkdtemp(prefix="rtbench-cli-")
        self.out = os.path.join(self.dir, "out.png")
        self.checked, self.pngs = [], {}
        self.last = None

    def _schedule(self, observe=False):
        """One schedule (observed: the checked one, of n_checked epochs) ->
        its final state (render_progressive's)."""
        from raytracer_tpu_torch.parallel import progressive as prog

        r = self.run
        cfg = dataclasses.replace(r.cfg, epochs=self.n_checked) if observe else r.cfg
        with self._observed(prog) if observe else contextlib.nullcontext():
            return prog.render_progressive(r.scene, r.camera, cfg, out_path=self.out, seed=r.seed,
                                           log=lambda msg: None, png_every=1,
                                           on_epoch=self._keep_png if observe else None)

    @contextlib.contextmanager
    def _observed(self, prog):
        """The program's epochs seen through a wrapper of the
        train_steps_sharded that render_progressive calls."""
        steps = prog.train_steps_sharded

        def watched(scene, camera, cfg, mesh, accum, seed, k, start_epoch=0, check=None):
            photons = []

            def keep(p, epoch):
                photons.append(p.cpu())
                if check is not None:
                    check(p, epoch)

            start = accum.cpu()
            out = steps(scene, camera, cfg, mesh, accum, seed, k, start_epoch, keep)
            self.checked.append({"epoch": start_epoch, "start": start, "photons": photons,
                                 "accum": out[0].cpu(), "u8": out[1].cpu()})
            return out

        prog.train_steps_sharded = watched
        try:
            yield
        finally:
            prog.train_steps_sharded = steps

    def _keep_png(self, epoch, stats):
        """The writer's callback, after the PNG of the group ending at
        `epoch` (one epoch: it began at epoch - 1) was written."""
        with open(self.out, "rb") as f:
            self.pngs[epoch - 1] = f.read()

    def setup(self):
        t = time.perf_counter()
        self._schedule(observe=True)
        self.unit_s = (time.perf_counter() - t) * self.epochs / self.n_checked  # a schedule

    def window(self, seconds=None, units=None):
        n = units or max(1, math.ceil(seconds / self.unit_s))
        done = 0
        t0 = time.perf_counter()
        with mark("window"):
            while done < n or (not units and time.perf_counter() - t0 < seconds):
                with mark("schedule"):
                    state = self._schedule()
                done += 1
            self.run.sync()
        wall = time.perf_counter() - t0
        with open(self.out, "rb") as f:
            self.last = {"accum": state.img.cpu(), "png": f.read()}
        return {"units": done * self.epochs, "wall_s": wall}

    def end_to_end(self, win) -> dict:
        return {"epoch_ms": win["wall_s"] / win["units"] * 1e3}

    def outputs(self):
        shutil.rmtree(self.dir, ignore_errors=True)
        return {"checked": self.checked, "pngs": self.pngs, "k": 1,
                "last": {"accum": self.last["accum"], "u8": _decoded(self.last["png"])}}


def _decoded(data):
    from raytracer_tpu_torch.utils.png import decode_png_rgb8

    try:
        return torch.as_tensor(decode_png_rgb8(data))
    except (ValueError, struct.error, zlib.error) as e:
        return e


def check(run, outputs, control=False) -> dict:
    """The cell's numbers (see the module's docstring).  control=True puts
    the plain reference in bfloat16 in the program's place, as the
    progressive entry does; the PNGs are then held against its encoding."""
    from reference import frame

    last = outputs["last"]
    if not isinstance(last["u8"], torch.Tensor):  # the final PNG did not decode
        last = dict(last, u8=torch.zeros_like(last["accum"], dtype=torch.uint8))
    numbers = progressive.check(run, dict(outputs, last=last), control)
    # an epoch the wrapper did not see is an epoch not checked
    shares = [1.0] if len(outputs["checked"]) != int(run.traffic["checked_epochs"]) else []
    for group in outputs["checked"]:
        png = _decoded(outputs["pngs"].get(group["epoch"], b""))
        want = group["u8"]
        if control:
            want = frame.to_u8(group["accum"].to(run.device, torch.bfloat16)).cpu()
        if not isinstance(png, torch.Tensor) or png.shape != want.shape:
            shares.append(1.0)
        else:
            shares.append(float((png != want.to(png.dtype)).float().mean()))
    numbers["png_bad_share"] = max(shares)
    return numbers
