"""A rank of a run on several cards: one process a card, each a rank of the
port's own multi-card path.

rtbench/spawn.py starts the ranks (`main`) at once, each running a body:
a run of the cell (`cell`), or calibrate.py's readings.  Rank 0 counts the
cards and builds or finds the kernel library while the others import torch
(`start`); then each rank joins the group through
`parallel.mesh.init_multihost` on a free local port, takes its mesh from
`make_render_mesh(chips, sp=<the configuration's "mesh" sp>)`, builds the
scene on its own card and drives the same entry (rtbench/runner.run_cell
with its `World`):

  set-up    every rank's own; then one all_reduce gives every rank rank 0's
            count of units (from its last warm unit's time and --seconds,
            or the traffic's `trace_units`) and closes set-up as a barrier;
  window    that many units on every rank, with no collective of the
            harness's inside it (the port's own all_reduces hold the ranks
            in step); under --trace 1 every rank records under a profiler;
  after     the numbers that hold the ranks to one another (`spread`);
            rank 0's check while the others wait; then every rank's
            readings gathered on rank 0 (`gather`): its peak memory, its
            card, the modules it holds and, traced, its busy time, window
            and device time of each operation, which the multi-card
            readers read (rtbench/readings.rank_traces, `pacing`).  Rank 0
            makes the result line, checks the modules once its readers have
            loaded, and hands the line to the parent.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import torch

from rtbench import core, result, runner


@dataclasses.dataclass
class World:
    """This rank of a run on several cards."""

    rank: int
    size: int
    device: torch.device
    mesh: Any  # raytracer_tpu_torch.parallel.mesh.RenderMesh

    def agree(self, count: int) -> int:
        """Rank 0's `count` on every rank: one all_reduce (MAX, the other
        ranks giving 0), which no rank leaves before all have entered it, so
        it also closes set-up as a barrier."""
        import torch.distributed as dist

        t = torch.tensor([count if self.rank == 0 else 0], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    def spread(self, entry, outputs) -> dict:
        """For each thing that every rank holds alike (the entry's
        `replicated(outputs)`: name -> tensors), the largest |x_r - x_0|
        over the ranks and the tensors, on every rank."""
        import torch.distributed as dist

        numbers = {}
        for name, tensors in entry.replicated(outputs).items():
            worst = torch.zeros((1,), dtype=torch.float64, device=self.device)
            for t in tensors:
                mine = t.to(self.device)
                first = mine.clone()
                dist.broadcast(first, src=0)
                worst = torch.maximum(worst, (mine - first).abs().max().double().reshape(1))
            dist.all_reduce(worst, op=dist.ReduceOp.MAX)
            numbers[name] = float(worst.item())
        return numbers

    def gather(self, peak: int, summary) -> list:
        """Every rank's readings, on rank 0 (None on the others)."""
        import torch.distributed as dist

        mine = {"rank": self.rank, "peak": peak, "found": core.forbidden_modules(),
                "device": _device(self.device),
                "trace": None if summary is None else
                {k: summary[k] for k in ("busy_s", "window_s", "op_us")}}
        got = [None] * self.size
        dist.all_gather_object(got, mine)
        return got if self.rank == 0 else None


def _device(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu"}
    return core.device_line()


def start(rank: int, ready, spec: runner.Spec, chips: int, port: int) -> World:
    """Make this process rank `rank` of the run -> its World.  Rank 0 first
    counts the cards (too few: exit 2, before any rank touches one) and
    builds or finds the kernel library, once for all ranks, then lets the
    others go on.  The mesh is the configuration's "mesh" ({"dp", "sp"})
    over the `chips` ranks."""
    from raytracer_tpu_torch.parallel.mesh import init_multihost, make_render_mesh

    if rank == 0:
        if spec.device == "cuda":
            cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if cards < chips:
                core.log(f"{spec.workload} needs {chips} CUDA card(s); found {cards}")
                raise SystemExit(2)
            from raytracer_tpu_torch.utils import kernels

            t = time.time()
            path, build_s = kernels.build()
            core.log(f"kernels: {path.rsplit('/', 1)[-1]} ("
                     f"{'built in %.1f s' % build_s if build_s else 'cached'}; "
                     f"{time.time() - t:.2f} s)")
        ready.set()
    ready.wait()
    device = init_multihost(f"127.0.0.1:{port}", chips, rank, device=spec.device)
    config = spec.config or core.config(core.cell(core.benchmark_json(), spec.workload)["config"])
    mesh = make_render_mesh(chips, sp=int(config["mesh"]["sp"]))
    if mesh.shape != config["mesh"]:
        raise ValueError(f"{chips} ranks make the mesh {mesh.shape}, not {config['mesh']}")
    return World(rank, chips, device, mesh)


def main(rank: int, ready, out, spec: dict, chips: int, port: int,
         body: str = "rtbench.ranks:cell", *args) -> None:
    """Rank `rank` of a run on `chips` cards (rtbench/spawn.on_ranks): joins
    the group, runs `body(spec, world, out, *args)` ("module:function"),
    and leaves the group."""
    import importlib

    import torch.distributed as dist

    spec = runner.Spec(**spec)
    torch.set_num_threads(2)
    t_imported = time.time()
    world = start(rank, ready, spec, chips, port)
    core.log(f"rank {rank}: {t_imported - spec.t0:.2f} s from the start to its imports, "
             f"{time.time() - spec.t0:.2f} s to its group and card")
    module, name = body.split(":")
    try:
        getattr(importlib.import_module(module), name)(spec, world, out, *args)
    finally:
        dist.destroy_process_group()


def cell(spec: runner.Spec, world: World, out) -> None:
    """One run of the cell on this rank.  Rank 0 makes the result line and
    hands it back, once it has checked, after the line's readers have
    loaded, that no rank holds a forbidden module (exit 3)."""
    rec = runner.run_cell(spec, world)
    if world.rank != 0:
        return
    device = dict(rec["ranks"][0]["device"], count=world.size)
    device.pop("power_limit", None)
    line = result.result_line(core.benchmark_json(), rec, device, spec.trace)
    result.detail(rec, spec.trace)
    found = sorted({m for r in rec["ranks"] for m in r["found"]} | set(core.forbidden_modules()))
    if found:
        core.log(f"forbidden modules loaded: {found}")
        raise SystemExit(3)
    out.put(json.dumps(line))
