"""Profiling: trace a render with torch.profiler and list its top operations.

Counterpart of raytracer_tpu/utils/profiling.py (jax.profiler and xprof).
The reference's only observability is a stopwatch line per pass
(src/main.rs:1110-1111), which the progressive driver keeps; this adds a
trace of everything a block of code runs: `profile_trace(log_dir)` writes
a Chrome trace (chrome://tracing, Perfetto) and a summary of the
operations into `log_dir`, and `top_ops` / `print_profile` read the
summary back.  The summary keeps operations that spent host time alone,
among them the program's own spans (utils/tracing, `rt.` names), which
`print_profile` lists by self host time after the top operations, with
the counters the traced render recorded.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import List, Optional, Tuple

import torch

from raytracer_tpu_torch.utils import tracing

TRACE = "trace.json"
SUMMARY = "ops.json"


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


@contextlib.contextmanager
def profile_trace(log_dir: str, cuda: Optional[bool] = None):
    """Context manager: trace everything inside with torch.profiler -> the
    profiler.  Records CPU activity, and CUDA activity when `cuda` (default:
    a card is available); on leaving, waits for the card and writes
    `log_dir`/trace.json (the Chrome trace) and `log_dir`/ops.json (each
    operation's self device and CPU microseconds, total CPU microseconds
    and calls, and the program's counters from utils/tracing)."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE))
    ops = [{"name": e.key, "device_us": float(_self_device_us(e)),
            "cpu_us": float(e.self_cpu_time_total),
            "cpu_total_us": float(e.cpu_time_total), "count": int(e.count)}
           for e in prof.key_averages()]
    counters = tracing.take().counters
    with open(os.path.join(log_dir, SUMMARY), "w") as f:
        json.dump({"cuda": cuda, "ops": ops, "counters": counters}, f)


def top_ops(log_dir: str, limit: int = 20) -> Tuple[str, List[Tuple[float, str, int]]]:
    """("device" or "cpu", [(self ms, operation, calls)]) of the trace in
    `log_dir`, largest first: by self device time where the trace recorded
    the card, else by self CPU time."""
    with open(os.path.join(log_dir, SUMMARY)) as f:
        data = json.load(f)
    by = "device" if data["cuda"] else "cpu"
    items = [(op[f"{by}_us"] / 1e3, op["name"], op["count"]) for op in data["ops"]
             if op[f"{by}_us"] > 0]
    items.sort(key=lambda x: -x[0])
    return by, items[:limit]


def print_profile(log_dir: str, limit: int = 20) -> None:
    if not os.path.exists(os.path.join(log_dir, SUMMARY)):
        print(f"no trace found under {log_dir}")
        return
    by, items = top_ops(log_dir, limit)
    print(f"top {limit} operations by self {by} time ({os.path.join(log_dir, TRACE)}):")
    for ms, name, count in items:
        print(f"  {ms:9.3f} ms  x{count:<6d} {name[:100]}")
    with open(os.path.join(log_dir, SUMMARY)) as f:
        data = json.load(f)
    spans = sorted((op for op in data["ops"] if op["name"].startswith(tracing.PREFIX)),
                   key=lambda op: -op["cpu_us"])
    if spans:
        print("program spans by self host time (total host time):")
        for op in spans:
            print(f"  {op['cpu_us'] / 1e3:9.3f} ms  ({op['cpu_total_us'] / 1e3:9.3f} ms)  "
                  f"x{op['count']:<6d} {op['name']}")
    for name, value in sorted(data["counters"].items()):
        print(f"  counter {name}: {value}")
