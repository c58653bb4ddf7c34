"""What every cell shares: the benchmark's files found by name, the device
line, the forbidden-module check, and the result line.

Files, all found from the names in BENCHMARK.json:
  benchmark/configs/<config>.json   a deployment: scene file, render
                                    settings, source, reduced
  benchmark/scenes/<scene>.json     its scene as data (rtbench/scenes.py)
  benchmark/traffic/<mix>.json      a traffic mix: which entry the loop
                                    drives (rtbench/entries/<entry>.py) and
                                    its parameters
  benchmark/metrics/<metric>.py     a per-layer metric's reader: read(ctx)
                                    -> a number, or None when nothing in
                                    this cell's trace is its to read
  benchmark/limits/<cell>.json      the limit of each number that decides
                                    `correct` in that cell
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
# modules the process that prints the result may not hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


def log(msg: str) -> None:
    sys.stderr.write(msg + "\n")  # one write: the ranks of a run share standard error
    sys.stderr.flush()


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return read_json(ROOT, "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return read_json(BENCH, "configs", f"{name}.json")


def traffic(name: str) -> dict:
    return read_json(BENCH, "traffic", f"{name}.json")


def limits(cell_name: str) -> dict:
    return read_json(BENCH, "limits", f"{cell_name}.json")


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    """The loop of a traffic mix: rtbench/entries/<name>.py."""
    return _load_file(os.path.join(BENCH, "rtbench", "entries", f"{name}.py"),
                      f"rtbench_entry_{name}")


def metric_reader(name: str):
    return _load_file(os.path.join(BENCH, "metrics", f"{name}.py"),
                      "rtbench_metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, cell_name: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") that this cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_line() -> dict:
    """platform, kind (torch's name of the card), count (one card), and
    nvidia-smi's power limit for the log (found by the card's UUID)."""
    import torch  # not at the top: run.py starts a cell's ranks before it imports torch

    index = torch.cuda.current_device()
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(index), "count": 1}
    try:
        uuid = str(torch.cuda.get_device_properties(index).uuid)
        smi_id = uuid if uuid.startswith(("GPU-", "MIG-")) else f"GPU-{uuid}"
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", f"--id={smi_id}", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = None
    return out


def cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths.  The
    port's own kernels build into raytracer_tpu_torch/_build/ (its code
    fixes that path, inside the checkout)."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"


def judge(checks: dict, lim: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its limit."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = lim[name]["limit"]
        out[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, out
