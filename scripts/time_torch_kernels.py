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
    kernel's mean device time per launch over the frame's 96 levels; the
    whole mesh11k MC epoch through the blocked MC kernel (host seconds,
    device busy and idle share);
  * the dense MC kernel at 1, 4 and 19 tiles' rays in one launch (the
    demo tile's rays and draws repeated: 19 tiles are the 1280x960 frame's),
    per launch and per 65,536 rays; on the frame's own rays and draws in
    one launch and in 19 launches of a tile; the dense level kernel on each of the
    six pools of the demo tile's Whitted ladder; where the checkout has
    them, the dense kernels' per-thread yardsticks on the same inputs; the
    dense kernels' registers and blocks per SM; where the checkout counts
    them, where the dense kernels' threads spend their cycles (nearest
    sweeps, shadow tests, marches, the rest) and their blocks' durations on
    the demo tile;
  * the whole 1280x960 demo Whitted frame and MC epoch: host seconds,
    device busy and idle share, and the dense kernels' mean device time
    per launch over them (the frame's 114 level launches, the epoch's MC
    launches).

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
    out["mc_epoch_mega"] = mega_epoch(scene, cam, cfg, rounds)
    return out


def mega_epoch(scene, cam, cfg, rounds):
    """The whole 1024x1024 MC epoch through the blocked MC kernel (the
    binned route switched off): host seconds, device busy and idle share
    (chip_smoke.profile_breakdown), `rounds` times."""
    from raytracer_tpu_torch.ops import mc_binned
    from raytracer_tpu_torch.render import render_distributed_epoch

    threshold, mc_binned.BINNED_MIN_TRIS = mc_binned.BINNED_MIN_TRIS, 1 << 30
    try:
        return [SMOKE.profile_breakdown(
            "mesh11k mc epoch (blocked mc kernel)",
            lambda: render_distributed_epoch(scene, cam, cfg, epoch=7)) for _ in range(rounds)]
    finally:
        mc_binned.BINNED_MIN_TRIS = threshold


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


def dense_sizes(scene, o, d, unifs, cfg, reps, rounds, tiles=(1, 4, 19), per_thread=False):
    """The dense MC kernel (per_thread: its per-thread yardstick) on 1, 4
    and 19 copies of one tile's rays and draws side by side (19 tiles: the
    1280x960 frame's padded rays in one launch) -> {copies: {"ms": [...],
    "ms_per_65536": [...]}}: device milliseconds per launch (CUDA events
    around `reps` launches), and per 65,536 rays."""
    from raytracer_tpu_torch.ops import mc_kernel

    n = o.shape[0]
    md, mr = cfg.max_refract_distance, cfg.max_tir_retries
    trace = mc_kernel.trace_per_thread if per_thread else mc_kernel.trace
    out = {}
    for k in tiles:
        ok, dk = o.repeat(k, 1).contiguous(), d.repeat(k, 1).contiguous()
        uk = unifs.repeat(1, 1, k).contiguous()
        run = lambda: trace(scene, ok, dk, uk, cfg.depth, md, mr)
        ms = [SMOKE.cuda_ms(run, max(5, reps // k)) for _ in range(rounds)]
        out[k] = {"rays": k * n, "ms": ms, "ms_per_65536": [m * 65536 / (k * n) for m in ms]}
    return out


def dense_frame(scene, cam, cfg, reps, rounds):
    """The dense MC kernel on the 1280x960 frame's own rays and draws (19
    tiles, each tile's generator as an epoch draws them): in one launch, in
    19 launches of a tile each (as an epoch took it before it went to one
    launch), and, where the checkout has it, the per-thread yardstick in one
    launch -> {name: [device ms per frame, CUDA events around `reps`
    frames]}."""
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import mc_kernel
    from raytracer_tpu_torch.render import _clips, tile_draws

    dev = torch.device("cuda")
    clips = _clips(cfg, dev)[0]
    tile_in = [tile_draws(cfg, 0, 7, t, clip.shape[0], dev) for t, clip in enumerate(clips)]
    normals = torch.cat([nm for nm, _ in tile_in])
    unifs = torch.cat([u for _, u in tile_in], dim=2).contiguous()
    o, d = camera_ops.shoot_focus(cam, clips.reshape(-1, 2), normals * cfg.blur, cfg.focus)
    o, d = o.contiguous(), d.contiguous()
    md, mr, n = cfg.max_refract_distance, cfg.max_tir_retries, clips.shape[1]
    tiles = [(o[t * n:(t + 1) * n].contiguous(), d[t * n:(t + 1) * n].contiguous(), u)
             for t, (_, u) in enumerate(tile_in)]
    runs = {"one_launch": lambda: mc_kernel.trace(scene, o, d, unifs, cfg.depth, md, mr),
            "tile_launches": lambda: [mc_kernel.trace(scene, *x, cfg.depth, md, mr)
                                      for x in tiles]}
    if hasattr(mc_kernel, "COUNTS_THREAD"):
        runs["per_thread_one_launch"] = lambda: mc_kernel.trace_per_thread(
            scene, o, d, unifs, cfg.depth, md, mr)
    return {name: [SMOKE.cuda_ms(run, max(5, reps // 4)) for _ in range(rounds)]
            for name, run in runs.items()}


def dense_work(scene, cam, clip, o, d, unifs, cfg):
    """Where the dense kernels' threads spend their cycles on one demo tile
    (chip_smoke.walk_phases) and the spread of their blocks' durations
    (chip_smoke.block_spread): the MC walk, and the Whitted ladder's six
    levels; None where the checkout's counters have no phase rows."""
    from raytracer_tpu_torch.ops import level_kernel, mc_kernel
    from raytracer_tpu_torch.utils import kernels

    if "cyc_near" not in kernels.WORK_ROWS:
        return None
    new = lambda n: torch.zeros((len(kernels.WORK_ROWS), n), dtype=torch.int32, device=o.device)
    md, mr = cfg.max_refract_distance, cfg.max_tir_retries
    work = new(o.shape[0])
    mc_kernel.trace(scene, o, d, unifs, cfg.depth, md, mr, work=work)
    out = {"mc": {"phases": SMOKE.walk_phases(work), "block_us": SMOKE.block_spread(work),
                  "tests": SMOKE.totals(work)}, "levels": []}
    for pool, last, direct in SMOKE.level_pools(scene, cam, clip, cfg):
        work = new(pool.width)
        level_kernel.process_level(scene, pool, last, direct, cfg.threshold, md, mr, work=work)
        out["levels"].append({"k": pool.width, "phases": SMOKE.walk_phases(work),
                              "block_us": SMOKE.block_spread(work)})
    return out


def dense_levels(scene, cam, clip, cfg, reps, rounds):
    """The dense level kernel on each of the six pools that the demo tile's
    Whitted ladder hands it, and (where the checkout has it) its per-thread
    yardstick on the same pools -> {"level_i" / "level_thread_i":
    [profiler ms per round]} and the means over the six ("*_mean")."""
    from raytracer_tpu_torch.ops import level_kernel

    lv = (cfg.threshold, cfg.max_refract_distance, cfg.max_tir_retries)
    pools = SMOKE.level_pools(scene, cam, clip, cfg)
    walks = [("level", level_kernel.process_level)]
    if hasattr(level_kernel, "COUNTS_THREAD"):
        walks.append(("level_thread", level_kernel.process_level_per_thread))
    out = {"widths": [p.width for p, _, _ in pools]}
    for name, fn in walks:
        for i, (pool, last, direct) in enumerate(pools):
            run = lambda: fn(scene, pool, last, direct, *lv)
            out[f"{name}_{i}"] = [SMOKE.device_ms(run, reps, "level_kernel") for _ in range(rounds)]
        out[f"{name}_mean"] = [sum(out[f"{name}_{i}"][r] for i in range(len(pools))) / len(pools)
                               for r in range(rounds)]
    return out


def demo_frames(scene, cam, cfg, rounds):
    """The 1280x960 demo Whitted frame and MC epoch: host seconds, device
    busy milliseconds and idle share (chip_smoke.profile_breakdown), and the
    dense level kernel's device milliseconds per launch over one profiled
    frame's launches, with the launches the profiler reported."""
    from raytracer_tpu_torch.render import render_distributed_epoch, render_whitted

    frame = lambda: render_whitted(scene, cam, cfg)
    epoch = lambda: render_distributed_epoch(scene, cam, cfg, epoch=7)
    out = {"whitted": [], "mc_epoch": [], "level_ms": [], "level_launches": [],
           "mc_ms": [], "mc_launches": []}
    for _ in range(rounds):
        out["whitted"].append(SMOKE.profile_breakdown("demo whitted frame", frame))
        out["mc_epoch"].append(SMOKE.profile_breakdown("demo mc epoch", epoch))
        for key, fn, name in (("level", frame, "level_kernel"), ("mc", epoch, "mc_kernel")):
            ms, seen = SMOKE.profiled_ms(fn, name)
            out[key + "_ms"].append(ms)
            out[key + "_launches"].append(seen)
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
    # the staged dense walks at the demo's rows, where the checkout takes a
    # triangle count
    n_tri = (scene.n_tri,) if hasattr(kernels, "ATTRS_N_TRI") else ()
    out["attrs"] = {k: kernels.kernel_attrs(k, *n_tri)
                    for k in ("mc", "level", "mc_thread", "level_thread") if k in kernels.ATTRS}
    out["mc_sizes"] = dense_sizes(scene, o, d, unifs, cfg, args.reps, args.rounds)
    if hasattr(mc_kernel, "COUNTS_THREAD"):  # the dense per-thread yardsticks
        thread = lambda: mc_kernel.trace_per_thread(scene, o, d, unifs, cfg.depth, md, mr)
        out["mc_thread_ms"] = [SMOKE.device_ms(thread, args.reps, "mc_kernel")
                               for _ in range(args.rounds)]
        out["mc_thread_sizes"] = dense_sizes(scene, o, d, unifs, cfg, args.reps, args.rounds,
                                             per_thread=True)
    out["dense_levels"] = dense_levels(scene, cam, clip, cfg, args.reps, args.rounds)
    out["mc_frame"] = dense_frame(scene, cam, cfg, args.reps, args.rounds)
    out["dense_work"] = dense_work(scene, cam, clip, o, d, unifs, cfg)
    out["demo_frames"] = demo_frames(scene, cam, cfg, args.rounds)
    if not args.no_mesh:
        out["mesh11k"] = mesh_times(dev, args.mesh_reps, args.rounds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
