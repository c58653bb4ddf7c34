#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload demo.progressive --seed 7 --seconds 20 --trace 0

Builds or loads the port's kernels (raytracer_tpu_torch/_build/, inside
the checkout), builds the cell's scene on the card from its configuration,
warms up the cell's own shapes, drives the cell's entry in a closed loop
for --seconds (--trace 1: for the traffic's `trace_units` under
torch.profiler), checks what the timed path produced against the plain
reference (benchmark/reference/), and prints detail on standard error and,
as the last line of standard output, one JSON object: correct, attempted,
failed, metrics (--trace 0: the cell's end-to-end metrics; --trace 1: its
per-layer metrics), device, with --trace 1 breakdown, and last `checks`,
each number compared beside its limit.  Exits 2 without as many cards as
the cell's `chips`, 3 if a JAX module was loaded.

A cell of one card runs in this process.  A cell of several cards runs in
one spawned process a card (rtbench/spawn.py, rtbench/ranks.py), each a
rank of the port's multi-card path, and this process imports no torch:
rank 0 counts the cards and builds or finds the kernel library, and makes
the result line, which this process prints once every rank has ended, or
it fails within 2 x --seconds + 600 s.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtbench import core, spawn  # noqa: E402


def prepare(cell: dict) -> None:
    """The card counted and the kernel library built or found."""
    import torch

    t_imported = time.time()
    if not torch.cuda.is_available():
        raise spawn.Failed(f"{cell['name']} needs a CUDA card; found none", 2)
    torch.set_num_threads(2)
    t = time.time()
    from raytracer_tpu_torch.utils import kernels

    t_port = time.time()
    path, build_s = kernels.build()
    core.log(f"kernels: {os.path.basename(path)} ({'built in %.1f s' % build_s if build_s else 'cached'}"
             f"; {time.time() - T0:.2f} s from the process's start: {t_imported - T0:.2f} s "
             f"torch's import, {t_port - t:.2f} s the port's, {time.time() - t_port:.2f} s the library)")


def one_card(bench: dict, spec: dict) -> dict:
    """The cell run in this process, on the first card -> its result line."""
    from rtbench import result, runner

    rec = runner.run_cell(runner.Spec(**spec))
    device = core.device_line()
    core.log(f"device: {device}")
    device.pop("power_limit")
    line = result.result_line(bench, rec, device, spec["trace"])
    result.detail(rec, spec["trace"])
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = core.benchmark_json()
    cell = core.cell(bench, args.workload)
    core.cache_dirs()  # before any rank starts: the ranks inherit the environment
    spec = dict(workload=args.workload, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), t0=T0)
    try:
        if int(cell["chips"]) > 1:
            line = spawn.run_cell(spec, int(cell["chips"]), 2 * args.seconds + 600)
        else:
            prepare(cell)
            line = one_card(bench, spec)
    except spawn.Failed as e:
        core.log(str(e))
        return e.code
    found = core.forbidden_modules()
    if found:
        core.log(f"forbidden modules loaded: {found}")
        return 3
    for name, c in line["checks"].items():
        core.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
