"""The result of a run: its per-layer metrics, the JSON line that the
benchmark prints last on standard output, and the detail on standard error."""

from __future__ import annotations

from rtbench import core, readings


def per_layer(bench: dict, rec: dict) -> dict:
    """The cell's per-layer metrics, each from its reader in benchmark/metrics/."""
    run = rec["run"]
    ctx = {"cell": run.cell["name"], "entry": run.traffic["entry"],
           "units": rec["win"]["units"], "wall_s": rec["win"]["wall_s"],
           "casts": rec["win"].get("casts"), "trace": rec["trace"], "spans": run.spans,
           "cfg": run.cfg, "raw": run.raw, "blocked": run.config.get("bvh") is True,
           "ranks": rec.get("ranks")}
    out = {}
    for m in core.cell_metrics(bench, run.cell["name"], "per_layer"):
        value = core.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench: dict, rec: dict, device: dict, traced: bool) -> dict:
    """The result line.  Of a run on several cards (rec["ranks"]: each
    rank's readings), `memory_peak_bytes` is the fullest card's and
    `busy_s` the mean over the cards; the rest is rank 0's."""
    run = rec["run"]
    if traced:
        metrics = per_layer(bench, rec)
        tr = rec["trace"]
        busy = [r["trace"]["busy_s"] for r in rec["ranks"]] if rec.get("ranks") else [tr["busy_s"]]
        device = dict(device, busy_s=sum(busy) / len(busy), window_s=tr["window_s"])
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
    for r in rec.get("ranks") or []:
        s = r["trace"]
        core.log(f"rank {r['rank']}: {r['device']}, peak {r['peak']} B" + (
            "" if s is None else
            f", busy {s['busy_s']:.4f} s (own {readings.own_ms(s):.2f} ms, NCCL "
            f"{readings.device_ms(s, readings.NCCL_KERNELS):.2f} ms, MC "
            f"{readings.device_ms(s, readings.MC_KERNELS):.2f} ms) in a window of "
            f"{s['window_s']:.4f} s"))
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
