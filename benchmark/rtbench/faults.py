"""Faults planted under the timed path, for the harness's own tests: each
must turn `correct` false in a cell that can have it.

  state_unchanged  a progressive step returns the accumulator it was given;
                   a Whitted frame returns the buffer unwritten (zeros)
  half_batch       the walk or the ladder leaves out the second half of its
                   lanes and doubles the first half (the mean over the rest)
  answer_altered   a photon or a colour is altered where it is produced
  no_exchange      on several cards: the exchange between the ranks left
                   out (parallel/mesh._reduce does nothing), so each rank
                   keeps its own tiles' photons and counters
  accum_drift      on several cards: the last rank's accumulator drifts
                   from the others' (scaled by 1 + 2**-20 after each group)
"""

from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "no_exchange", "accum_drift")


def _halved(x):
    n = x.shape[0]
    keep = torch.arange(n, device=x.device) < n // 2
    return torch.where(keep[:, None], 2.0 * x, 0.0)


def plant(name: str):
    """Plant fault `name` -> a function that takes it out again."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.parallel import mesh
    from raytracer_tpu_torch.utils.color import linear_to_u8

    walk, ladder, steps = render.trace_distributed, render.trace_whitted, mesh.train_steps_sharded
    saved = [(m, a, getattr(m, a)) for m, a in ((render, "trace_distributed"),
                                                (render, "trace_whitted"), (render, "_whitted"),
                                                (mesh, "train_steps_sharded"), (mesh, "_reduce"))]

    def undo():
        for m, a, v in saved:
            setattr(m, a, v)
    if name == "state_unchanged":
        def same_state(scene, camera, cfg, rmesh, accum, *args, **kw):
            _, _, counters = steps(scene, camera, cfg, rmesh, accum, *args, **kw)
            return accum, linear_to_u8(accum), counters
        mesh.train_steps_sharded = same_state
        render._whitted = lambda scene, camera, cfg, tiles=None: (
            torch.zeros((cfg.height, cfg.width, 3), device=scene.device), 0, 0)
    elif name == "half_batch":
        render.trace_distributed = lambda *a: (lambda r: r._replace(photon=_halved(r.photon)))(walk(*a))
        render.trace_whitted = lambda *a: (lambda r: r._replace(color=_halved(r.color)))(ladder(*a))
    elif name == "answer_altered":
        def bump(x):
            return x + torch.tensor([0.01, 0.0, 0.0], device=x.device)
        render.trace_distributed = lambda *a: (lambda r: r._replace(photon=bump(r.photon)))(walk(*a))
        render.trace_whitted = lambda *a: (lambda r: r._replace(color=bump(r.color)))(ladder(*a))
    elif name == "no_exchange":
        mesh._reduce = lambda rmesh, *tensors: None
    elif name == "accum_drift":
        def drifting(scene, camera, cfg, rmesh, accum, *args, **kw):
            accum, u8, counters = steps(scene, camera, cfg, rmesh, accum, *args, **kw)
            if rmesh.world > 1 and rmesh.rank == rmesh.world - 1:
                accum = accum * (1 + 2.0 ** -20)
            return accum, u8, counters
        mesh.train_steps_sharded = drifting
    else:
        raise ValueError(f"unknown fault {name!r}; have {FAULTS}")
    return undo
