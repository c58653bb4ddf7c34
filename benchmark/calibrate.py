#!/usr/bin/env python3
"""Readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload demo.progressive --seeds 11,12,13 --control 3

For each seed: the cell's set-up from that seed (the checked first group,
or the warm-up frames), a short window at the cell's own load (one group
of epochs, or `--frames` Whitted frames), and the check's numbers: the
sound runs' readings, the lower ones.  For the first `--control` seeds
also the control's: the plain reference in bfloat16 put in the program's
place (rtbench/entries/*.check(control=True)), the upper ones.  One JSON
line a reading on standard output.  The scene is built once.  Runs on the
first card (device="cpu": the harness's tests); a cell of several cards
runs on as many ranks (rtbench/ranks.py), each building its scene once and
driving every seed, rank 0 judging and printing, with the cell's
`rank_accum_diff` beside the program's readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rtbench import core, runner, scenes, spawn  # noqa: E402


def readings(workload: str, seeds, n_control: int, device: str = "cuda", config=None,
             frames: int = 3, world=None):
    """Yield {"seed", "kind": "program" | "control", numbers...} per reading
    (world: this rank of a run on several cards; only rank 0 yields)."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.parallel.mesh import RenderMesh

    spec = runner.Spec(workload=workload, seed=0, seconds=0, trace=False, t0=time.time(),
                       device=device, config=config)
    if world is not None:
        dev = world.device
    else:
        dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    run = runner.Run(spec, dev)
    run.mesh = RenderMesh(dp=1, sp=1) if world is None else world.mesh
    run.cfg = RenderConfig(**run.config["render"])
    run.raw = scenes.load(run.config["scene"])
    run.scene, run.camera = scenes.program_scene(run.raw, dev, run.config.get("bvh", "auto"))
    entry = core.entry(run.traffic["entry"])
    for i, seed in enumerate(seeds):
        run.seed = seed
        loop = entry.Loop(run)
        loop.setup()
        loop.window(units=loop.k if hasattr(loop, "k") else frames)
        outputs = loop.outputs()
        spread = world.spread(entry, outputs) if world is not None else {}
        if world is not None and world.rank != 0:
            continue
        yield {"seed": seed, "kind": "program", **entry.check(run, outputs), **spread}
        if i < n_control:
            yield {"seed": seed, "kind": "control", **entry.check(run, outputs, control=True)}


def on_rank(spec: runner.Spec, world, out, seeds, n_control: int, frames: int) -> None:
    """The body of a rank of on_ranks() (rtbench/ranks.main): readings() on
    its card, rank 0 printing."""
    for r in readings(spec.workload, seeds, n_control, spec.device, spec.config, frames, world):
        print(json.dumps(r), flush=True)
    world.agree(0)  # the other ranks wait for rank 0's last check


def on_ranks(workload: str, seeds, n_control: int, chips: int, device: str = "cuda",
             config=None, frames: int = 3) -> None:
    """readings() of a cell of several cards on `chips` spawned ranks, rank 0
    printing each reading as a JSON line."""
    spec = dict(workload=workload, seed=0, seconds=0, trace=False, t0=time.time(),
                device=device, config=config)
    spawn.on_ranks(spec, chips, 600 + 120 * len(seeds), "calibrate:on_rank", seeds, n_control,
                   frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="control readings on the first N seeds")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)
    chips = int(core.cell(core.benchmark_json(), args.workload)["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        core.log(f"{args.workload} needs {chips} CUDA card(s); found {cards}")
        return 2
    core.cache_dirs()
    seeds = [int(s) for s in args.seeds.split(",")]
    if chips > 1:
        try:
            on_ranks(args.workload, seeds, args.control, chips, frames=args.frames)
        except spawn.Failed as e:
            core.log(str(e))
            return e.code
        return 0
    for r in readings(args.workload, seeds, args.control, frames=args.frames):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
