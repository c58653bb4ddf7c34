"""Traffic entry `whitted`: the deterministic Whitted pass (main.rs:1084-1111)
re-rendered back to back.

Closed loop: `render.render_whitted` of the configuration's camera, each
frame timed from its call to a sync after its return.  A Whitted frame has
no draws: the seed changes only which frame and which pixels the check
looks at.  Set-up renders `warm_frames` frames.

The check (after the window), each number against the cell's limit:
  pixel_bad_share  levels, compaction and delivery: at `pixels` pixels
                   drawn from the seed, in the window's last frame and in
                   one more drawn from the seed, the share whose colour
                   differs from the plain reference's by more than 1e-3 +
                   2e-2 |ref| in a channel;
  dropped          rays the pools lost, summed over every frame (the
                   guarantee that no ray is lost silently: limit 0).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench.trace import mark

ATOL, RTOL = 1e-3, 2e-2


class Loop:
    unit = "frame"

    def __init__(self, run):
        self.run = run
        self.dropped = 0
        self.kept = {}

    def _frame(self):
        from raytracer_tpu_torch.render import render_whitted

        r = self.run
        t0 = time.perf_counter()
        img, stats = render_whitted(r.scene, r.camera, r.cfg)
        r.sync()
        self.dropped += stats["dropped"]
        return img, time.perf_counter() - t0

    def setup(self):
        for _ in range(int(self.run.traffic.get("warm_frames", 1))):
            self._frame()

    def window(self, seconds=None, units=None):
        rng = np.random.default_rng(self.run.seed)
        pick = None
        lat = []
        t0 = time.perf_counter()
        with mark("window"):
            while True:
                with mark("frame"):
                    img, dt = self._frame()
                lat.append(dt)
                n = len(lat)
                # one frame kept by reservoir sampling from the seed, and the last
                if pick is None or rng.random() < 1.0 / n:
                    pick = img
                done = (time.perf_counter() - t0 >= seconds) if seconds else n >= units
                if done:
                    break
        wall = time.perf_counter() - t0
        self.kept = {"drawn": pick.cpu(), "last": img.cpu()}
        return {"units": len(lat), "wall_s": wall, "latencies_s": lat}

    def end_to_end(self, win) -> dict:
        return {"frame_ms": win["wall_s"] / win["units"] * 1e3,
                "frame_p95_ms": float(np.percentile(win["latencies_s"], 95)) * 1e3}

    def outputs(self):
        return {"frames": self.kept, "dropped": self.dropped}


def check(run, outputs, control=False) -> dict:
    from reference import frame, world

    cfg, raw, dev = run.cfg, run.raw, run.device
    n_pix = cfg.width * cfg.height
    rng = np.random.default_rng(run.seed)
    pixels = np.sort(rng.choice(n_pix, size=min(int(run.traffic["pixels"]), n_pix),
                                replace=False))
    clip = torch.as_tensor(frame.clips(cfg.width, cfg.height, pixels), device=dev)
    o, d = frame.shoot(raw.camera, clip)
    with world.tf32_off():
        ref = world.whitted(world.World(raw, dev), o, d, cfg.depth)
        if control:
            bf = torch.bfloat16
            ctl = world.whitted(world.World(raw, dev, bf), o.to(bf), d.to(bf), cfg.depth).float()
    shares = []
    for img in outputs["frames"].values():
        got = ctl if control else img.reshape(-1, 3)[torch.as_tensor(pixels)].to(dev)
        bad = ((got - ref).abs() > ATOL + RTOL * ref.abs()).any(dim=1)
        shares.append(float(bad.float().mean()))
    return {"pixel_bad_share": max(shares), "dropped": float(outputs["dropped"])}
