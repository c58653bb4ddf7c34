"""Traffic entry `progressive`: the reference's epoch loop as the CLI runs it
(main.rs:1129-1171, raytracer_tpu_torch.parallel.progressive), without the
Whitted pass and without the PNG.

Closed loop: `parallel.mesh.train_steps_sharded` in groups of
`group_epochs` epochs on a RenderMesh of one rank, epochs numbered on from
0 under `--seed`, every epoch accumulated and renormalised; once a group
its counters are read and its u8 frame is fetched to the host, as
render_progressive does.  Nothing is written.

Two groups go through the same call with the program's per-epoch hook
(`check=`) keeping each epoch's photons, outside the window: set-up's
first group (epochs 0 .., from a zero accumulator) and, once the window
has closed, one more from the window's accumulator and epoch.  The check
judges both.

The check (after the window, once the program's state is freed), each
number against the cell's limit:
  photon_bad_share  the MC walk: at `pixels` pixels drawn from the seed,
                    in every epoch of both checked groups, the share whose
                    photon differs from the plain reference's
                    (benchmark/reference, the same draws worked out again)
                    by more than 1e-3 + 2e-2 |ref| in a channel (the worse
                    group's);
  accum_rel_err     accumulate and renormalise: each checked group's frame
                    against the reference's post_process chain from the
                    group's starting accumulator over the program's
                    photons (the percentile needs every pixel, which the
                    reference cannot trace in time), max |diff| / max |ref|;
  u8_bad_share      the encode: the share of u8 values of each checked
                    group's frame and of the window's last that differ
                    from the reference's sRGB encoding of their frames.

On several cards every rank drives the loop on its own card through the
same mesh; the numbers above are rank 0's (its reduced photons and its
accumulator), and rtbench/ranks.World.spread adds
  rank_accum_diff   the replicated accumulator: the largest |accum_r -
                    accum_0| over the ranks, after each checked group and
                    after the window (`replicated`).
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.trace import mark

ATOL, RTOL = 1e-3, 2e-2


class Loop:
    unit = "group"

    def __init__(self, run):
        self.run = run
        self.k = int(run.traffic["group_epochs"])
        self.accum = torch.zeros((run.cfg.height, run.cfg.width, 3), dtype=torch.float32,
                                 device=run.device)
        self.epoch = 0
        self.casts = 0
        self.checked = []
        self.last = None

    def _group(self, hook=None):
        from raytracer_tpu_torch.parallel import mesh

        r = self.run
        accum, u8, counters = mesh.train_steps_sharded(r.scene, r.camera, r.cfg, r.mesh,
                                                       self.accum, r.seed, self.k, self.epoch,
                                                       hook)
        casts, _ = counters.tolist()  # one read a group; waits for the device
        self.accum, self.epoch = accum, self.epoch + self.k
        self.casts += casts
        return u8.cpu()

    def _checked_group(self) -> dict:
        """One group with the hook keeping each epoch's photons on the host."""
        start = {"epoch": self.epoch, "start": self.accum.cpu()}
        photons = []
        u8 = self._group(lambda p, epoch: photons.append(p.cpu()))
        return dict(start, photons=photons, accum=self.accum.cpu(), u8=u8)

    def setup(self):
        import time

        self.checked.append(self._checked_group())
        for _ in range(int(self.run.traffic.get("warm_groups", 1))):
            t = time.perf_counter()
            self._group()
            self.unit_s = (time.perf_counter() - t) / self.k  # an epoch, the last warm group's

    def window(self, seconds=None, units=None):
        import time

        n, casts0 = 0, self.casts
        t0 = time.perf_counter()
        with mark("window"):
            while True:
                with mark("group"):
                    u8 = self._group()
                n += 1
                if (time.perf_counter() - t0 >= seconds) if seconds else n * self.k >= units:
                    break
            self.run.sync()
        wall = time.perf_counter() - t0
        self.last = {"accum": self.accum.cpu(), "u8": u8}
        return {"units": n * self.k, "wall_s": wall, "casts": self.casts - casts0}

    def end_to_end(self, win) -> dict:
        return {"epoch_ms": win["wall_s"] / win["units"] * 1e3}

    def outputs(self):
        self.checked.append(self._checked_group())
        self.accum = None
        return {"checked": self.checked, "last": self.last, "k": self.k}


def replicated(outputs) -> dict:
    """What every rank of a run on several cards holds alike: the replicated
    accumulator after each checked group and after the window."""
    return {"rank_accum_diff": [g["accum"] for g in outputs["checked"]]
            + [outputs["last"]["accum"]]}


def check(run, outputs, control=False) -> dict:
    """The cell's numbers (see the module's docstring).  control=True puts
    the plain reference in bfloat16 in the program's place, stage by
    stage: its photons, its accumulate and renormalise, its encoding."""
    numbers = {"photon_bad_share": 0.0, "accum_rel_err": 0.0}
    for group in outputs["checked"]:
        got = _group_numbers(run, group, outputs["k"], control)
        numbers = {k: max(v, got[k]) for k, v in numbers.items()}
    from reference import frame

    shares = []
    for out in outputs["checked"] + [outputs["last"]]:
        acc = out["accum"].to(run.device)
        want = frame.to_u8(acc)
        got8 = frame.to_u8(acc.to(torch.bfloat16)) if control else out["u8"].to(run.device)
        shares.append(float((got8 != want).float().mean()))
    numbers["u8_bad_share"] = max(shares)
    return numbers


def _group_numbers(run, group, k, control) -> dict:
    """photon_bad_share and accum_rel_err of one checked group."""
    from reference import frame, world

    cfg, raw, dev = run.cfg, run.raw, run.device
    if len(group["photons"]) != k:  # the hook saw fewer epochs than the group holds
        return {"photon_bad_share": 1.0, "accum_rel_err": 1.0}
    n_pix = cfg.width * cfg.height
    rng = np.random.default_rng([run.seed, group["epoch"]])
    pixels = np.sort(rng.choice(n_pix, size=min(int(run.traffic["pixels"]), n_pix),
                                replace=False))
    clip = torch.as_tensor(frame.clips(cfg.width, cfg.height, pixels), device=dev)
    rays = []
    for e in range(group["epoch"], group["epoch"] + k):
        lens, unifs = frame.pixel_draws(pixels, cfg.width, cfg.height, cfg.tile_rays, cfg.depth,
                                        run.seed, e, dev)
        o, d = frame.shoot_focus(raw.camera, clip, lens, cfg.blur, cfg.focus)
        rays.append((o, d, unifs))
    o = torch.cat([r[0] for r in rays])
    d = torch.cat([r[1] for r in rays])
    unifs = torch.cat([r[2] for r in rays], dim=2)
    with world.tf32_off():
        ref = world.distributed(world.World(raw, dev), o, d, unifs, cfg.depth)
        if control:
            bf = torch.bfloat16
            got = world.distributed(world.World(raw, dev, bf), o.to(bf), d.to(bf), unifs.to(bf),
                                    cfg.depth)
        else:
            got = torch.cat([p.reshape(-1, 3)[torch.as_tensor(pixels)] for p in group["photons"]])
            got = got.to(dev)
    bad = ((got - ref).abs() > ATOL + RTOL * ref.abs()).any(dim=1)

    chain = group["start"].to(dev)
    alt = chain.to(torch.bfloat16)
    for p in group["photons"]:
        chain = frame.post_process(chain + p.to(dev), cfg.percentile)
        if control:
            alt = frame.post_process(alt + p.to(dev, torch.bfloat16), cfg.percentile)
    prog = alt.float() if control else group["accum"].to(dev)
    return {"photon_bad_share": float(bad.float().mean()),
            "accum_rel_err": float((prog - chain).abs().max() / chain.abs().max())}
