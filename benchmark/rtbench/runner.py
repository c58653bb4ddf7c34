"""One run of a cell on one card, in the process that prints the result:
set-up, the window, the trace's reading and the check.
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
    """The run's view of the cell: its files, its scene, its one-rank mesh."""

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


def run_cell(spec: Spec) -> dict:
    """Run the cell once -> its record."""
    device = torch.device("cuda", 0) if spec.device == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    undo = None
    if spec.fault:
        from rtbench import faults
        undo = faults.plant(spec.fault)
    try:
        return _run(spec, Run(spec, device))
    finally:
        if undo is not None:
            undo()


def _run(spec: Spec, run: Run) -> dict:
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.parallel.mesh import RenderMesh

    run.mesh = RenderMesh(dp=1, sp=1)
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
    run.sync()
    setup_s = time.time() - spec.t0
    core.log(f"set-up {setup_s:.2f} s: {t_warm - spec.t0:.2f} s to the scene built "
             f"({run.spans['scene_build_s']:.2f} s of it the build), "
             f"{time.time() - t_warm:.2f} s the checked group and warm-up")

    summary = None
    if spec.trace:
        with trace.profiled(run.device.type == "cuda") as prof:
            win = loop.window(units=int(run.traffic["trace_units"]))
        summary = trace.summary(prof, loop.unit) if prof is not None else None
    else:
        win = loop.window(seconds=spec.seconds)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0

    e2e = loop.end_to_end(win)
    outputs = loop.outputs()
    run.scene = run.camera = loop = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = entry.check(run, outputs)
    run.spans["check_s"] = time.perf_counter() - t
    correct, checks = core.judge(numbers, core.limits(spec.workload))
    return {"correct": correct, "checks": checks, "win": win, "e2e": e2e, "setup_s": setup_s,
            "peak": peak, "trace": summary, "run": run}
