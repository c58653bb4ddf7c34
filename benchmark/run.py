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
each number compared beside its limit.  Exits 2 without a card, 3 if a
JAX module was loaded.  A cell runs on one card.
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

import torch  # noqa: E402

from rtbench import core, runner  # noqa: E402

T_IMPORTED = time.time()


def per_layer(bench: dict, rec: dict) -> dict:
    """The cell's per-layer metrics, each from its reader in benchmark/metrics/."""
    run = rec["run"]
    ctx = {"cell": run.cell["name"], "entry": run.traffic["entry"],
           "units": rec["win"]["units"], "wall_s": rec["win"]["wall_s"],
           "casts": rec["win"].get("casts"), "trace": rec["trace"], "spans": run.spans,
           "cfg": run.cfg, "raw": run.raw, "blocked": run.config.get("bvh") is True}
    out = {}
    for m in core.cell_metrics(bench, run.cell["name"], "per_layer"):
        value = core.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench: dict, rec: dict, device: dict, traced: bool) -> dict:
    run = rec["run"]
    if traced:
        metrics = per_layer(bench, rec)
        tr = rec["trace"]
        device = dict(device, busy_s=tr["busy_s"], window_s=tr["window_s"])
    else:
        values = dict(rec["e2e"], setup_s=rec["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in core.cell_metrics(bench, run.cell["name"], "end_to_end")}
    line = {"correct": rec["correct"], "attempted": rec["win"]["units"], "failed": 0,
            "metrics": metrics, "device": dict(device, memory_peak_bytes=rec["peak"])}
    if traced:
        line["breakdown"] = {"device_ops": tr["top_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = rec["checks"]
    return line


def detail(rec: dict, traced: bool) -> None:
    """Detail lines on standard error."""
    run = rec["run"]
    core.log(f"cell {run.cell['name']}: {rec['win']['units']} {run.traffic['entry']} units "
             f"in {rec['win']['wall_s']:.3f} s; setup {rec['setup_s']:.3f} s; "
             f"scene build {run.spans['scene_build_s']:.3f} s; check {run.spans['check_s']:.3f} s; "
             f"peak {rec['peak']} B")
    core.log("end to end: " + ", ".join(f"{k} {v!r}" for k, v in rec["e2e"].items()))
    if "latencies_s" in rec["win"]:
        lat = sorted(rec["win"]["latencies_s"])
        core.log(f"frame latencies ms: min {lat[0] * 1e3:.2f} median "
                 f"{lat[len(lat) // 2] * 1e3:.2f} max {lat[-1] * 1e3:.2f}")
    if traced:
        tr = rec["trace"]
        core.log(f"trace: window {tr['window_s']:.4f} s busy {tr['busy_s']:.4f} s "
                 f"device ops {tr['device_ops']}")
        for i, (host, busy, ops) in enumerate(tr["units"]):
            core.log(f"  unit {i}: {host * 1e3:.3f} ms host, {busy * 1e3:.3f} ms busy "
                     f"({100 * (1 - busy / host):.1f} % idle), {ops} device ops")
        for name, sec in tr["top_ops"]:
            core.log(f"  op {sec * 1e3:10.3f} ms {name[:110]}")
        for name, sec in tr["idle_gaps"]:
            core.log(f"  idle {sec * 1e3:10.3f} ms during {name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = core.benchmark_json()
    cell = core.cell(bench, args.workload)
    if cell["chips"] != 1:
        raise SystemExit(f"{cell['name']}: the harness runs a cell on one card")
    if not torch.cuda.is_available():
        core.log(f"{cell['name']} needs a CUDA card; found none")
        return 2
    core.cache_dirs()
    torch.set_num_threads(2)
    t = time.time()
    from raytracer_tpu_torch.utils import kernels

    t_port = time.time()
    path, build_s = kernels.build()
    core.log(f"kernels: {os.path.basename(path)} ({'built in %.1f s' % build_s if build_s else 'cached'}"
             f"; {time.time() - T0:.2f} s from the process's start: {T_IMPORTED - T0:.2f} s "
             f"torch's import, {t_port - t:.2f} s the port's, {time.time() - t_port:.2f} s the library)")
    spec = runner.Spec(workload=args.workload, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), t0=T0)
    rec = runner.run_cell(spec)
    device = core.device_line()
    core.log(f"device: {device}")
    device.pop("power_limit")
    line = result_line(bench, rec, device, bool(args.trace))
    detail(rec, bool(args.trace))
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
