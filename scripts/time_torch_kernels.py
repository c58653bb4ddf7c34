#!/usr/bin/env python3
"""Device time of the PyTorch/CUDA port's dense level and MC kernels on one
tile of the demo frame, for comparing two checkouts on the same card.

    python3 scripts/time_torch_kernels.py [--tree DIR] [--reps 20] [--rounds 3]

Imports raytracer_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels there, and times on the first 65536-ray tile
of the 1280x960 demo frame, depth 5: the primary Whitted level
(level_kernel.process_level) and the MC walk (mc_kernel.trace).  Each time
is the mean device milliseconds per launch, from torch.profiler over
`reps` launches after a warm-up, taken `rounds` times.  Needs a CUDA card.
Prints the card's name and power limit, then one JSON line.  To compare
two checkouts, run this once per checkout in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(fn, reps, name):
    """Mean device milliseconds per fn() call of the kernels whose name
    holds `name` (torch.profiler, after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if name in e.key)
    assert us > 0, f"the profiler saw no device time of {name}"
    return us / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE, help="checkout to import the port from")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_torch_kernels: CUDA is not available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import level_kernel, mc_kernel
    from raytracer_tpu_torch.ops.trace import _pack_primary
    from raytracer_tpu_torch.render import _clips, tile_draws
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene
    from raytracer_tpu_torch.utils import kernels

    assert os.path.dirname(os.path.abspath(kernels.__file__)).startswith(tree), kernels.__file__
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _, build_s = kernels.build()
    dev = torch.device("cuda")
    scene, cam = demo_scene().to(dev), demo_camera().to(dev)
    cfg = RenderConfig(depth=5)  # 1280x960, tile_rays 65536
    clip = _clips(cfg, dev)[0][0]
    normals, unifs = tile_draws(cfg, 0, 0, 0, clip.shape[0], dev)
    o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
    o, d = o.contiguous(), d.contiguous()
    md, mr = cfg.max_refract_distance, cfg.max_tir_retries
    pool = _pack_primary(*camera_ops.shoot(cam, clip))
    level = lambda: level_kernel.process_level(scene, pool, False, True, cfg.threshold, md, mr)
    mc = lambda: mc_kernel.trace(scene, o, d, unifs, cfg.depth, md, mr)
    out = {"tree": args.tree, "build_s": build_s, "rays": clip.shape[0], "reps": args.reps,
           "level_ms": [], "mc_ms": []}
    for _ in range(args.rounds):
        out["level_ms"].append(device_ms(level, args.reps, "level_kernel"))
        out["mc_ms"].append(device_ms(mc, args.reps, "mc_kernel"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
