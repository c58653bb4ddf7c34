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
    (11,262 triangles), depth 5: the blocked level kernel on each of the six
    pools that the tile's Whitted ladder hands it (trace_whitted with a
    recording level_fn: the primary level, the level-1 peel, the deep level,
    two tail levels and the last level), with each pool's width, the tests
    its lanes ran and the bound of one launch; the blocked MC walk
    (mc_kernel.trace) and each binned kernel on the states of one captured
    walk of that tile (the primary, the five bounces, the terminal).  Where
    the checkout has them, the per-thread yardsticks of the cooperative
    kernels are timed on the same inputs (`*_thread`);
  * the whole mesh11k Whitted frame: its host seconds and the blocked level
    kernel's mean device time per launch over the frame's 96 levels.

Each time is the mean device milliseconds per launch after a warm-up, taken
`rounds` times: from torch.profiler over the launches it reports of `reps`
(the kernels' own device time; chip_smoke.device_ms, which falls back to
CUDA events, and says so, where the profiler reports none in three tries),
and for the mesh kernels also from CUDA events around
`mesh-reps` back-to-back launches (which includes what the wrapper
launches around the kernel).  Needs a CUDA card.  Prints the card's name
and power limit, then one JSON line.  To compare two checkouts, run this
once per checkout in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# this checkout's chip_smoke.py as a module (its timing, bound and
# level-pool helpers), whichever tree the port is imported from
_SPEC = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(SMOKE)


def level_work(scene, pools, cfg):
    """Per level: the pool's width, its lanes' test totals and the bound of
    one launch (chip_smoke.bound: the bytes chip_smoke.level_bytes counts,
    the counted tests at the FP32 peak)."""
    from raytracer_tpu_torch.ops import level_kernel
    from raytracer_tpu_torch.utils import kernels

    out = []
    for pool, last, direct in pools:
        k = pool.width
        work = torch.zeros((len(kernels.WORK_ROWS), k), dtype=torch.int32, device=pool.f.device)
        level_kernel.process_level(scene, pool, last, direct, cfg.threshold,
                                   cfg.max_refract_distance, cfg.max_tir_retries, work=work)
        io = SMOKE.level_bytes(scene, pool)
        b_ms, b_by, ops = SMOKE.bound(io, work)
        out.append({"k": k, "last": last, "direct": direct, "tests": SMOKE.totals(work),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": ops})
    return out


def mesh_times(dev, reps, rounds):
    """The blocked level kernel, the blocked MC walk and the binned kernels
    on one mesh11k tile -> {name: {"profiler_ms": [...], "events_ms":
    [...]}}, the means over the six levels and the five bounces, and the
    levels' widths, tests and bounds ("level_blk_work")."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import level_kernel, mc_binned, mc_kernel
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
    lv = (cfg.threshold, md, mr)
    pools = SMOKE.level_pools(scene, cam, clip, cfg)
    calls = {}
    walks = [("level_blk", level_kernel.process_level)]
    if hasattr(level_kernel, "process_level_per_thread"):
        walks.append(("level_blk_thread", level_kernel.process_level_per_thread))
    for name, fn in walks:
        for i, (pool, last, direct) in enumerate(pools):
            calls[f"{name}_{i}"] = ("level_kernel", lambda fn=fn, p=pool, l=last, dr=direct:
                                    fn(scene, p, l, dr, *lv))
    calls["mc_blk"] = ("mc_kernel", lambda: mc_kernel.trace(scene, o, d, unifs, depth, md, mr))
    calls["binned_primary"] = ("binned_primary", lambda: mc_binned.primary(scene, o_t, d_t))
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
    if hasattr(mc_binned, "terminal_per_thread"):
        calls["binned_terminal_thread"] = (
            "binned_terminal", lambda: mc_binned.terminal_per_thread(scene, sf, si, depth == 0))
    out = {name: {"profiler_ms": [], "events_ms": []} for name in calls}
    for _ in range(rounds):
        for name, (kernel, fn) in calls.items():
            out[name]["profiler_ms"].append(SMOKE.device_ms(fn, reps, kernel))
            out[name]["events_ms"].append(SMOKE.cuda_ms(fn, reps))

    def mean(prefix, count):
        runs = [out[f"{prefix}_{i}"] for i in range(count)]
        return {k: [sum(b[k][r] for b in runs) / count for r in range(rounds)]
                for k in ("profiler_ms", "events_ms")}

    out["binned_bounce_mean"] = mean("binned_bounce", depth)
    for name, _ in walks:
        out[f"{name}_mean"] = mean(name, len(pools))
    out["level_blk_work"] = level_work(scene, pools, cfg)
    out["whitted_frame"] = frame_times(scene, cam, cfg, rounds)
    return out


def frame_times(scene, cam, cfg, rounds):
    """The whole 1024x1024 Whitted frame: host seconds between two
    synchronisations (the least of three, `rounds` times), and the blocked
    level kernel's device milliseconds per launch over one profiled frame
    (all tiles' levels) with the launches the profiler reported."""
    import time

    from raytracer_tpu_torch.render import render_whitted

    frame = lambda: render_whitted(scene, cam, cfg)
    frame()
    out = {"host_s": [], "level_ms": [], "level_launches": []}
    for _ in range(rounds):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        out["host_s"].append(min(walls))
        ms, seen = SMOKE.profiled_ms(frame, "level_kernel")
        out["level_ms"].append(ms)
        out["level_launches"].append(seen)
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
        out["level_ms"].append(SMOKE.device_ms(level, args.reps, "level_kernel"))
        out["mc_ms"].append(SMOKE.device_ms(mc, args.reps, "mc_kernel"))
    if not args.no_mesh:
        out["mesh11k"] = mesh_times(dev, args.mesh_reps, args.rounds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
