#!/usr/bin/env python3
"""Device time of the PyTorch/CUDA port's kernels on one tile of the demo
frame and one tile of the mesh11k frame, for comparing two checkouts on the
same card.

    python3 scripts/time_torch_kernels.py [--tree DIR] [--reps 20] [--rounds 3]
                                          [--mesh-reps 5] [--no-mesh]

Imports raytracer_tpu_torch from DIR (default: the checkout holding this
script), builds its kernels there, and times

  * on the first 65536-ray tile of the 1280x960 demo frame, depth 5: the
    primary Whitted level (level_kernel.process_level) and the MC walk
    (mc_kernel.trace), dense;
  * on the first 65536-ray tile of the 1024x1024 frame of mesh_scene(75)
    (11,262 triangles), depth 5: the blocked MC walk (mc_kernel.trace) and
    each binned kernel on the states of one captured walk of that tile (the
    primary, the five bounces, the terminal).

Each time is the mean device milliseconds per launch after a warm-up, taken
`rounds` times: from torch.profiler over `reps` launches (the kernels'
own device time), and for the mesh kernels also from CUDA events around
`mesh-reps` back-to-back launches (which includes what the wrapper
launches around the kernel).  Needs a CUDA card.  Prints the card's name
and power limit, then one JSON line.  To compare two checkouts, run this
once per checkout in the order A, B, B, A.
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
    """Mean device milliseconds per launch of the kernel whose name holds
    `name` (fn() launches it once), over the launches torch.profiler reports
    of reps calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key]
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in events)
    seen = sum(e.count for e in events)
    assert us > 0 and seen > 0, f"the profiler saw no device time of {name}"
    return us / seen / 1e3


def event_ms(fn, reps):
    """Mean milliseconds per fn() call between two CUDA events around reps
    back-to-back calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def mesh_times(dev, reps, rounds):
    """The blocked MC walk and the binned kernels on one mesh11k tile ->
    {name: {"profiler_ms": [...], "events_ms": [...]}}."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import mc_binned, mc_kernel
    from raytracer_tpu_torch.render import _clips, tile_draws
    from raytracer_tpu_torch.scene.presets import mesh_scene

    scene, cam = (x.to(dev) for x in mesh_scene(75))
    cfg = RenderConfig(width=1024, height=1024, depth=5)
    depth, md, mr = cfg.depth, cfg.max_refract_distance, cfg.max_tir_retries
    clip = _clips(cfg, dev)[0][0]
    normals, unifs = tile_draws(cfg, 0, 0, 0, clip.shape[0], dev)
    o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
    o, d = o.contiguous(), d.contiguous()
    o_t, d_t = o.t().contiguous(), d.t().contiguous()
    calls = {"mc_blk": ("mc_kernel", lambda: mc_kernel.trace(scene, o, d, unifs, depth, md, mr)),
             "binned_primary": ("binned_primary", lambda: mc_binned.primary(scene, o_t, d_t))}
    sf, si, _ = mc_binned.primary(scene, o_t, d_t)
    for step in range(depth):
        sf, si = mc_binned.sort_state(scene, sf, si, unifs[step])
        if hasattr(mc_binned, "deal_lanes"):  # the walk's own order, in either checkout
            sf, si = mc_binned.deal_lanes(sf, si)
        u = unifs[step][:, si[mc_binned.I_SLOT].long()].contiguous()
        calls[f"binned_bounce_{step}"] = ("binned_bounce", lambda sf=sf, si=si, u=u, step=step:
                                          mc_binned.bounce(scene, sf, si, u, step == 0, md, mr))
        sf, si, _ = mc_binned.bounce(scene, sf, si, u, step == 0, md, mr)
    calls["binned_terminal"] = ("binned_terminal",
                                lambda: mc_binned.terminal(scene, sf, si, depth == 0))
    out = {name: {"profiler_ms": [], "events_ms": []} for name in calls}
    for _ in range(rounds):
        for name, (kernel, fn) in calls.items():
            out[name]["profiler_ms"].append(device_ms(fn, reps, kernel))
            out[name]["events_ms"].append(event_ms(fn, reps))
    bounces = [out[f"binned_bounce_{s}"] for s in range(depth)]
    out["binned_bounce_mean"] = {k: [sum(b[k][r] for b in bounces) / depth for r in range(rounds)]
                                 for k in ("profiler_ms", "events_ms")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE, help="checkout to import the port from")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--mesh-reps", type=int, default=5)
    ap.add_argument("--no-mesh", action="store_true", help="the dense demo kernels only")
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
    if not args.no_mesh:
        out["mesh11k"] = mesh_times(dev, args.mesh_reps, args.rounds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
