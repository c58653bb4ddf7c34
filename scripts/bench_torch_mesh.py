"""Focused large-mesh benchmark of the port: a Whitted frame and an MC
epoch on the 11k- and 51k-triangle terrains, without the demo sections of
raytracer_tpu_torch/bench.py.

Counterpart of scripts/bench_mesh.py, with its flags.  Each grid is
raytracer_tpu_torch.bench.mesh_section, the harness's own mesh timing: one
untimed frame, the least of --reps frames (dropped must be 0 here), one
untimed epoch, the least of --reps epochs, all at seed 7, epoch 0; each
timed window ends in torch.cuda.synchronize().  Prints one JSON line: per mesh
tag (mesh11k for 11,262 triangles) {tag}_whitted_seconds,
{tag}_whitted_mrays, {tag}_mc_epoch_seconds, {tag}_mc_mrays, {tag}_tris,
and `device` (bench.device_info); the units and directions are in
raytracer_tpu_torch.bench.METRICS.  Requires CUDA unless given --device cpu.

    python scripts/bench_torch_mesh.py [--grids 75,160] [--reps 3] [--depth 5] [--size 1024] [--mc-only]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytracer_tpu_torch.bench import device_info, fastest, log, mesh_section  # noqa: E402

SEED = 7


def run(grids, reps: int, depth: int, size: int, mc_only: bool, device) -> tuple[dict, dict]:
    """bench.mesh_section for each grid, every epoch at SEED -> (the result
    line under scripts/bench_mesh.py's keys, the record: each grid's timed
    calls with their seconds and counters, by tag)."""
    from raytracer_tpu_torch.config import RenderConfig

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    out = {"device": device_info(dev)}
    log(f"device: {out['device']}")
    cfg = RenderConfig(width=size, height=size, depth=depth, tile_rays=1 << 16)
    record = {}
    for grid in grids:
        tag, n_tri, record[tag] = mesh_section(grid, cfg, [SEED] * reps, SEED, mc_only,
                                               device=dev)
        if not mc_only:
            best = fastest(record[tag]["frames"])
            if best["dropped"]:
                raise RuntimeError(f"{tag}: the Whitted frame dropped rays: {best}")
            out[f"{tag}_whitted_seconds"] = best["seconds"]
            out[f"{tag}_whitted_mrays"] = best["casts"] / best["seconds"] / 1e6
        best = fastest(record[tag]["epochs"])
        out[f"{tag}_mc_epoch_seconds"] = best["seconds"]
        out[f"{tag}_mc_mrays"] = best["casts"] / best["seconds"] / 1e6
        out[f"{tag}_tris"] = n_tri
    return out, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", default="75,160")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--mc-only", action="store_true",
                    help="skip the whitted frames (MC-epoch tuning sweeps)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("bench_torch_mesh: CUDA is not available (--device cpu runs the plain PyTorch "
              "path)", file=sys.stderr)
        return 2
    out, _ = run([int(g) for g in args.grids.split(",")], args.reps, args.depth, args.size,
                 args.mc_only, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
