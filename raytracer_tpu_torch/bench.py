"""Benchmark harness of the port: the JAX package's bench.py on the card.

Counterpart of bench.py (the JAX package's harness), section for section,
at its sizes (BenchSpec's defaults):

  warm-up      the kernels build at first use (utils/kernels.build), then
               one untimed Whitted frame and one untimed MC epoch of the
               demo at 1024x1024, depth 5, tile_rays 65536 (bench.py:55-64);
  step         render_step (Whitted frame + one MC epoch) x3, seed r for
               rep r, the least time -> frame_seconds, rays_per_frame
               (bench.py:66-83);
  batched      render_epochs(10) x3, seeds 100 + r, the best rate -> the
               headline value (Mrays/s) and batched_seconds_per_epoch
               (bench.py:85-104).  The port's render_epochs is a Python loop
               of epochs, each its own dispatch, not one program as in the
               JAX package;
  steps        render_steps(5) x3, seeds 200 + r, dropped must be 0 ->
               whitted_mc_step_mrays_per_sec (bench.py:106-126);
  roofline     the headline against dense_attainable_casts at the H100's
               rates (utils/roofline.py) -> roofline_attainable_mrays,
               roofline_frac (bench.py:128-140);
  meshes       mesh_scene(75) (11,262 triangles: "mesh11k") and
               mesh_scene(160) (51,212: "mesh51k") at 1024x1024: a warm-up
               frame, the least of 3 / 2 Whitted frames, a warm-up epoch,
               the least of 3 / 2 MC epochs (seeds 200 + r, 300 + r)
               (bench.py:158-239);
  schedule     the reference schedule, demo 1280x960, Whitted + 100 epochs
               through render_progressive into a temp dir with a PNG every
               epoch, then with a PNG every 10 epochs, each after an untimed
               warm-up (bench.py:241-283).

RAYTPU_BENCH_FAST=1 skips the meshes and the schedule, as in the JAX bench.
Every timed window is a host clock around work that ends in
torch.cuda.synchronize() (a stats counter's read waits for the counter, not
for the accumulate after it); on the CPU the same code runs without a sync.

Prints ONE JSON line on stdout, the JAX bench's keys less vs_baseline (it
divided by a target set for a TPU), plus `device` (platform, nvidia-smi's
name and power limit, device count) and `png_writer` ("native" or
"python": the schedule's PNG route).  Detail lines go to stderr.  METRICS
says for each measured key its unit and which direction is better;
DESCRIPTORS lists the keys that describe the run.  With --prev PATH, a
prior line of this harness on the same card, every metric that worsened by
more than 10 % is listed under `regressions`; a prior from another device
(the JAX bench's BENCH_r*.json ran on a TPU) is not compared.

    python -m raytracer_tpu_torch.bench [--prev PATH]
    python -m raytracer_tpu_torch.bench --device cpu   # the plain path; tests pass a small BenchSpec

The harness requires CUDA unless given --device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Callable, ContextManager, NamedTuple, Optional

import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class BenchSpec:
    """The harness's sizes; the defaults are the JAX bench's.  meshes:
    (mesh_scene grid, timed reps) pairs; fast: skip the meshes and the
    schedule (RAYTPU_BENCH_FAST)."""

    width: int = 1024
    height: int = 1024
    depth: int = 5
    tile_rays: int = 1 << 16
    reps: int = 3
    batched_epochs: int = 10
    steps: int = 5
    meshes: tuple = ((75, 3), (160, 2))
    schedule_width: int = 1280
    schedule_height: int = 960
    schedule_epochs: int = 100
    fast: bool = False
    device: str = "cuda"


# the grouped schedule's PNG interval (full_schedule_png10_seconds)
PNG_GROUP = 10
# a metric that worsened by more than this (%) against --prev is a regression
REGRESSION_PCT = 10.0


class Metric(NamedTuple):
    unit: str
    better: str  # "higher" or "lower"


# Every measured key of the harness's line (and of scripts/bench_torch_mesh.py's)
# with its unit and direction.  A mesh's keys carry its tag, mesh<thousands of
# triangles>k (mesh11k, mesh51k), written here as mesh{n}k (metric_name).
METRICS = {
    "value": Metric("Mrays/s", "higher"),
    "roofline_frac": Metric("fraction of the dense-sweep bound", "higher"),
    "frame_seconds": Metric("s", "lower"),
    "batched_seconds_per_epoch": Metric("s", "lower"),
    "whitted_mc_step_mrays_per_sec": Metric("Mrays/s", "higher"),
    "mesh{n}k_mrays_per_sec": Metric("Mrays/s", "higher"),
    "mesh{n}k_frame_seconds": Metric("s", "lower"),
    "mesh{n}k_mc_epoch_seconds": Metric("s", "lower"),
    "full_schedule_seconds": Metric("s", "lower"),
    "full_schedule_png10_seconds": Metric("s", "lower"),
    # scripts/bench_torch_mesh.py
    "mesh{n}k_whitted_seconds": Metric("s", "lower"),
    "mesh{n}k_whitted_mrays": Metric("Mrays/s", "higher"),
    "mesh{n}k_mc_mrays": Metric("Mrays/s", "higher"),
}
# Numeric keys that describe the run rather than measure it.
# roofline_attainable_mrays is the bound the card's peak rate sets for the
# scene, not a measured rate (the JAX gate's key-substring rule compared it).
DESCRIPTORS = ("roofline_attainable_mrays", "rays_per_frame", "batched_epochs", "depth",
               "mesh{n}k_tris", "full_schedule_epochs")


def metric_name(key: str) -> str:
    """The tables' name of an output key: a mesh tag as mesh{n}k."""
    return re.sub(r"^mesh\d+k_", "mesh{n}k_", key)


def mesh_tag(scene) -> str:
    """mesh11k for 11,262 triangles (the JAX scripts' tags)."""
    return f"mesh{scene.n_tri // 1000}k"


def sync(device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device) -> dict:
    """The device a run's figures belong to: on a card nvidia-smi's name and
    power limit, the card picked by its UUID (nvidia-smi numbers cards in
    its own order, which need not be CUDA's), and the host's device count."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None, "count": 1}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    uuid = str(torch.cuda.get_device_properties(index).uuid)
    smi_id = uuid if uuid.startswith(("GPU-", "MIG-")) else f"GPU-{uuid}"
    line = subprocess.run(
        ["nvidia-smi", f"--id={smi_id}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, power = (s.strip() for s in line.rsplit(",", 1))
    return {"platform": "gpu", "name": name, "power_limit": power,
            "count": torch.cuda.device_count()}


def timed(device, fn):
    """(fn()'s result, host seconds until the device finished it)."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def fastest(calls: list) -> dict:
    """The call of least seconds."""
    return min(calls, key=lambda x: x["seconds"])


def _no_hook(name: str) -> ContextManager:
    return contextlib.nullcontext()


def mesh_section(grid: int, cfg, seeds, warm_seed: int, mc_only: bool = False,
                 hook: Callable[[str], ContextManager] = _no_hook,
                 device="cuda") -> tuple[str, int, dict]:
    """One large mesh as bench.py:158-239 and scripts/bench_mesh.py time it:
    mesh_scene(grid) built on the host (its seconds logged), then inside
    hook(tag) an untimed Whitted frame and len(seeds) timed ones (no frame
    with mc_only), an untimed MC epoch at warm_seed and one timed epoch at
    each of seeds -> (the tag, the triangles, {"frames": [...], "epochs":
    [...]}: each timed call's seconds and counters)."""
    from raytracer_tpu_torch.render import render_distributed_epoch, render_whitted
    from raytracer_tpu_torch.scene.presets import mesh_scene

    dev = torch.device(device)
    t0 = time.perf_counter()
    scene, cam = mesh_scene(grid, device=dev)
    tag = mesh_tag(scene)
    log(f"{tag} (mesh_scene({grid}), {scene.n_tri} triangles): host build "
        f"{time.perf_counter() - t0:.2f}s")
    frames, epochs = [], []
    with hook(tag):
        if not mc_only:
            _, dt = timed(dev, lambda: render_whitted(scene, cam, cfg))
            log(f"{tag} whitted first frame: {dt:.2f}s")
            for _ in seeds:
                (_, stats), dt = timed(dev, lambda: render_whitted(scene, cam, cfg))
                frames.append({"seconds": dt, **stats})
            best = fastest(frames)
            log(f"{tag} whitted frame: {best['seconds'] * 1e3:.0f} ms, "
                f"{best['casts'] / best['seconds'] / 1e6:.1f} Mrays/s, "
                f"dropped={best['dropped']}")
        _, dt = timed(dev, lambda: render_distributed_epoch(scene, cam, cfg, warm_seed))
        log(f"{tag} MC first epoch: {dt:.2f}s")
        for seed in seeds:
            (_, stats), dt = timed(dev, lambda: render_distributed_epoch(scene, cam, cfg, seed))
            epochs.append({"seed": seed, "seconds": dt, **stats})
        best = fastest(epochs)
        log(f"{tag} MC epoch: {best['seconds'] * 1e3:.0f} ms, "
            f"{best['casts'] / best['seconds'] / 1e6:.1f} Mrays/s")
    return tag, scene.n_tri, {"frames": frames, "epochs": epochs}


def run(spec: BenchSpec = BenchSpec(),
        hook: Callable[[str], ContextManager] = _no_hook) -> tuple[dict, dict]:
    """Every section of the harness on spec.device -> (the result line
    without the gate's keys, the record: each section's calls with their
    seeds, seconds and counters).  hook(section) wraps each section
    (warmup, step, batched, steps, one a mesh by its tag, schedule,
    schedule_png10): chip_smoke.py counts the kernels' launches there."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render import (
        render_distributed_epoch,
        render_epochs,
        render_step,
        render_steps,
        render_whitted,
    )
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene
    from raytracer_tpu_torch.utils import native
    from raytracer_tpu_torch.utils.roofline import dense_attainable_casts

    dev = torch.device(spec.device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    device = device_info(dev)
    log(f"device: {device}")
    cfg = RenderConfig(width=spec.width, height=spec.height, depth=spec.depth,
                       tile_rays=spec.tile_rays)
    scene, camera = demo_scene(device=dev), demo_camera(device=dev)
    record = {}

    # --- warm-up (not timed): the kernels' build, then a frame and an epoch ---
    with hook("warmup"):
        if dev.type == "cuda":
            from raytracer_tpu_torch.utils import kernels

            path, build_s = kernels.build()
            log(f"kernels: {os.path.basename(path)} ({build_s:.1f} s to build)")
        (_, stats), dt = timed(dev, lambda: render_whitted(scene, camera, cfg))
        log(f"whitted first frame: {dt:.2f}s, stats={stats}")
        (_, mc_stats), mc_dt = timed(dev, lambda: render_distributed_epoch(scene, camera, cfg, 0))
        log(f"mc first epoch: {mc_dt:.2f}s, stats={mc_stats}")
        record["warmup"] = [{"call": "render_whitted", "seconds": dt, **stats},
                            {"call": "render_distributed_epoch", "seed": 0, "seconds": mc_dt,
                             **mc_stats}]

    # --- timed 1: one step's latency (Whitted frame + one MC epoch) ---
    with hook("step"):
        reps = []
        for r in range(spec.reps):
            (_, _, stats), dt = timed(dev, lambda: render_step(scene, camera, cfg, r))
            log(f"step rep {r}: {dt * 1e3:.0f} ms, {stats['casts'] / 1e6:.1f} Mrays, "
                f"{stats['casts'] / dt / 1e6:.1f} Mrays/s, dropped={stats['dropped']}")
            reps.append({"seed": r, "seconds": dt, **stats})
        record["step"] = reps
    best_step = fastest(reps)

    # --- timed 2: HEADLINE, the sustained rate of the epoch loop (trace +
    # accumulate; the tone map and PNG are outside it, as in the reference's
    # own stopwatch, main.rs:1157-1171) ---
    n_epochs = spec.batched_epochs
    with hook("batched"):
        reps = []
        for r in range(spec.reps):
            (_, stats), dt = timed(
                dev, lambda: render_epochs(scene, camera, cfg, 100 + r, n_epochs))
            rate = stats["casts"] / dt / 1e6
            log(f"batched {n_epochs} MC epochs rep {r}: {dt * 1e3:.0f} ms total, "
                f"{dt / n_epochs * 1e3:.1f} ms/epoch, {rate:.1f} Mrays/s")
            reps.append({"seed": 100 + r, "seconds": dt, "mrays_per_sec": rate, **stats})
        record["batched"] = reps
    best_batched = max(reps, key=lambda x: x["mrays_per_sec"])

    # --- timed 3: Whitted + MC steps, every step re-tracing the frame ---
    with hook("steps"):
        reps = []
        for r in range(spec.reps):
            (_, _, stats), dt = timed(
                dev, lambda: render_steps(scene, camera, cfg, 200 + r, spec.steps))
            if stats["dropped"]:
                raise RuntimeError(f"render_steps dropped rays: {stats}")
            rate = stats["casts"] / dt / 1e6
            log(f"batched {spec.steps} whitted+MC steps rep {r}: {dt * 1e3:.0f} ms total, "
                f"{dt / spec.steps * 1e3:.0f} ms/step, {rate:.1f} Mrays/s, "
                f"dropped={stats['dropped']}")
            reps.append({"seed": 200 + r, "seconds": dt, "mrays_per_sec": rate, **stats})
        record["steps"] = reps

    mrays = best_batched["mrays_per_sec"]
    # the dense sweep's arithmetic alone at the H100's FP32 rate
    # (utils/roofline.py); everything else a walk does counts against it
    attainable = dense_attainable_casts(scene.n_tri, scene.n_sph)
    log(f"roofline: dense-sweep attainable {attainable / 1e6:.0f} Mrays/s "
        f"-> measured/attainable {mrays * 1e6 / attainable:.3f}")
    result = {
        "metric": "mrays_per_sec",
        "value": mrays,
        "unit": "Mrays/s",
        "roofline_attainable_mrays": attainable / 1e6,
        "roofline_frac": mrays * 1e6 / attainable,
        "frame_seconds": best_step["seconds"],
        "rays_per_frame": best_step["casts"],
        "batched_epochs": n_epochs,
        "batched_seconds_per_epoch": best_batched["seconds"] / n_epochs,
        "whitted_mc_step_mrays_per_sec": max(x["mrays_per_sec"] for x in record["steps"]),
        "resolution": f"{cfg.width}x{cfg.height}",
        "depth": cfg.depth,
        "device": device,
        "png_writer": "native" if native.available() else "python",
    }
    if spec.fast:
        return result, record

    # --- the large meshes: the blocked kernels on 11k- and 51k-triangle
    # terrains (the JAX bench's mesh11k and mesh51k) ---
    for i, (grid, n_reps) in enumerate(spec.meshes):
        seeds = [200 + 100 * i + r for r in range(n_reps)]
        tag, n_tri, rec = mesh_section(grid, cfg, seeds, 0, hook=hook, device=dev)
        if tag in record:
            raise ValueError(f"mesh_scene({grid}) is {tag} again: the line keys meshes by tag")
        record[tag] = rec
        best, e_best = fastest(rec["frames"]), fastest(rec["epochs"])
        result[f"{tag}_mrays_per_sec"] = best["casts"] / best["seconds"] / 1e6
        result[f"{tag}_frame_seconds"] = best["seconds"]
        result[f"{tag}_tris"] = n_tri
        result[f"{tag}_mc_epoch_seconds"] = e_best["seconds"]

    # --- the FULL reference schedule, end to end (src/main.rs:1084-1173):
    # wall clock incl. the tone map and a PNG every epoch; then the same
    # epochs with a PNG every PNG_GROUP ---
    from raytracer_tpu_torch.parallel.progressive import render_progressive

    sched_cfg = RenderConfig(width=spec.schedule_width, height=spec.schedule_height,
                             depth=spec.depth, epochs=spec.schedule_epochs,
                             tile_rays=spec.tile_rays)
    quiet = lambda m: None
    with tempfile.TemporaryDirectory() as tmp:
        out_png = os.path.join(tmp, "bench_schedule.png")
        with hook("schedule"):
            render_whitted(scene, camera, sched_cfg)  # warm-up at this size
            render_distributed_epoch(scene, camera, sched_cfg, 0)
            _, sched_dt = timed(dev, lambda: render_progressive(
                scene, camera, sched_cfg, out_path=out_png, seed=0, log=quiet))
        log(f"full schedule (whitted + {sched_cfg.epochs} epochs @{sched_cfg.width}x"
            f"{sched_cfg.height}, PNG each epoch, {result['png_writer']} writer): "
            f"{sched_dt:.2f}s")
        with hook("schedule_png10"):
            warm_cfg = dataclasses.replace(sched_cfg, epochs=min(PNG_GROUP, sched_cfg.epochs))
            render_progressive(scene, camera, warm_cfg, out_path=out_png, seed=0, log=quiet,
                               png_every=PNG_GROUP)
            _, png10_dt = timed(dev, lambda: render_progressive(
                scene, camera, sched_cfg, out_path=out_png, seed=0, log=quiet,
                png_every=PNG_GROUP))
        log(f"batched schedule (PNG every {PNG_GROUP}): {png10_dt:.2f}s")
    record["schedule"] = {"seconds": sched_dt, "png10_seconds": png10_dt}
    result["full_schedule_seconds"] = sched_dt
    result["full_schedule_epochs"] = sched_cfg.epochs
    result["full_schedule_png10_seconds"] = png10_dt
    return result, record


def read_line(path: str) -> dict:
    """A prior result: the file's JSON object (the harness's line), or a
    driver file's "parsed" object."""
    with open(path) as f:
        prev = json.load(f)
    if isinstance(prev, dict) and isinstance(prev.get("parsed"), dict):
        prev = prev["parsed"]
    if not isinstance(prev, dict):
        raise ValueError("not a JSON object")
    return prev


def _same_device(a, b) -> bool:
    keys = ("platform", "name", "power_limit")
    return (isinstance(a, dict) and isinstance(b, dict)
            and all(a.get(k) == b.get(k) for k in keys))


def prior_round_deltas(result: dict, prev_path: Optional[str]) -> dict:
    """The regression gate: each METRICS key that worsened by more than
    REGRESSION_PCT against the prior line at prev_path, in METRICS'
    direction.  Only a prior of this harness on the same device (platform,
    name, power limit) is compared; any other adds prev_round_error and
    flags nothing.  No prior -> {}."""
    if prev_path is None:
        return {}
    name = os.path.basename(prev_path)
    try:
        prev = read_line(prev_path)
    except (OSError, ValueError) as e:
        return {"prev_round_file": name, "prev_round_error": str(e), "regressions": {}}
    if not _same_device(prev.get("device"), result.get("device")):
        return {"prev_round_file": name, "regressions": {},
                "prev_round_error": f"the prior ran on {prev.get('device', 'no device named')}, "
                                    f"this run on {result.get('device')}: not compared"}
    number = lambda x: isinstance(x, (int, float)) and not isinstance(x, bool)
    regressions = {}
    for k, now in result.items():
        metric = METRICS.get(metric_name(k))
        old = prev.get(k)
        if metric is None or not number(now) or not number(old) or old == 0:
            continue
        worse_pct = (now - old) / old * 100.0
        if metric.better == "higher":
            worse_pct = -worse_pct
        if worse_pct > REGRESSION_PCT:
            regressions[k] = {"prev": old, "now": now, "worse_pct": round(worse_pct, 1)}
            log(f"REGRESSION {k}: {old} -> {now} ({worse_pct:+.1f}% worse than {name})")
    return {"prev_round_file": name, "regressions": regressions}


def main(argv=None, spec: BenchSpec = BenchSpec()) -> int:
    ap = argparse.ArgumentParser(description="The port's benchmark harness (one JSON line).")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--prev", metavar="PATH",
                    help="a prior line of this harness on the same card, for the regression gate")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("bench: CUDA is not available (--device cpu runs the plain PyTorch path)",
              file=sys.stderr)
        return 2
    spec = dataclasses.replace(spec, device=args.device,
                               fast=spec.fast or bool(os.environ.get("RAYTPU_BENCH_FAST")))
    result, _ = run(spec)
    result.update(prior_round_deltas(result, args.prev))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
