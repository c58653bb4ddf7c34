"""One run of a cell: set-up, the window, the trace's reading and the check;
on one card in the process that prints the result, on several in each rank
(rtbench/ranks.py).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import torch

from rtbench import core, scenes, trace


@dataclasses.dataclass
class Spec:
    """What a run is given."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    t0: float  # time.time() when the process started
    device: str = "cuda"  # "cpu" in the harness's tests
    config: Optional[dict] = None  # the cell's configuration (default: its file)
    fault: Optional[str] = None  # rtbench/faults.py: a planted fault (tests only)


class Run:
    """The run's view of the cell: its files, its scene, its mesh."""

    def __init__(self, spec: Spec, device: torch.device):
        bench = core.benchmark_json()
        self.cell = core.cell(bench, spec.workload)
        self.config = spec.config or core.config(self.cell["config"])
        self.traffic = core.traffic(self.cell["traffic"])
        self.seed, self.device = spec.seed, device
        self.spans = {}
        self.raw = self.scene = self.camera = self.cfg = self.mesh = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(spec: Spec, world=None) -> dict:
    """Run the cell once -> its record.  world: this rank of a run on
    several cards (rtbench/ranks.World), None on one card.  Rank 0's record
    holds every rank's readings ("ranks") and the check; another rank's
    record is None."""
    if world is not None:
        device = world.device
    else:
        device = torch.device("cuda", 0) if spec.device == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
    undo = None
    if spec.fault:
        from rtbench import faults
        undo = faults.plant(spec.fault)
    try:
        return _run(spec, Run(spec, device), world)
    finally:
        if undo is not None:
            undo()


def _run(spec: Spec, run: Run, world) -> Optional[dict]:
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.parallel.mesh import RenderMesh

    run.mesh = RenderMesh(dp=1, sp=1) if world is None else world.mesh
    run.cfg = RenderConfig(**run.config["render"])
    run.raw = scenes.load(run.config["scene"])
    t = time.perf_counter()
    run.scene, run.camera = scenes.program_scene(run.raw, run.device,
                                                 run.config.get("bvh", "auto"))
    run.sync()
    run.spans["scene_build_s"] = time.perf_counter() - t
    entry = core.entry(run.traffic["entry"])
    loop = entry.Loop(run)
    t_warm = time.time()
    loop.setup()
    units = int(run.traffic["trace_units"]) if spec.trace else None
    if world is not None:  # every rank runs rank 0's count of units
        units = world.agree(units or max(1, round(spec.seconds / loop.unit_s)))
    run.sync()
    setup_s = time.time() - spec.t0
    if world is None or world.rank == 0:
        core.log(f"set-up {setup_s:.2f} s: {t_warm - spec.t0:.2f} s to the scene built "
                 f"({run.spans['scene_build_s']:.2f} s of it the build), "
                 f"{time.time() - t_warm:.2f} s the checked group and warm-up")

    summary = None
    if spec.trace:
        with trace.profiled(run.device.type) as prof:
            win = loop.window(units=units)
        summary = trace.summary(prof, loop.unit)
    elif units:
        win = loop.window(units=units)
    else:
        win = loop.window(seconds=spec.seconds)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0

    e2e = loop.end_to_end(win)
    outputs = loop.outputs()
    spread = world.spread(entry, outputs) if world is not None else {}
    run.scene = run.camera = loop = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if world is None or world.rank == 0:
        t = time.perf_counter()
        numbers = dict(entry.check(run, outputs), **spread)
        run.spans["check_s"] = time.perf_counter() - t
    ranks = None
    if world is not None:  # the other ranks wait here for rank 0's check
        ranks = world.gather(peak, summary)
        if world.rank != 0:
            return None
        peak = max(r["peak"] for r in ranks)
    correct, checks = core.judge(numbers, core.limits(spec.workload))
    return {"correct": correct, "checks": checks, "win": win, "e2e": e2e, "setup_s": setup_s,
            "peak": peak, "trace": summary, "run": run, "ranks": ranks}
