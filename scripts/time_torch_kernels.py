#!/usr/bin/env python3
"""Device time of the PyTorch/CUDA port's kernels on one tile of the demo
frame and one tile of the mesh11k frame, for comparing two checkouts on the
same card.

    python3 scripts/time_torch_kernels.py [--tree DIR] [--reps 20] [--rounds 3]
                                          [--mesh-reps 5] [--route-grids 75,160]
                                          [--sections dense,mesh,unfused,routes,edges]

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
    walk of that tile (the primary, the five bounces, the terminal), and
    the primary also on each of the 16 tiles of the frame's epoch, with its
    registers, blocks per SM and block durations.  Where the checkout has
    them, the per-thread yardsticks of the cooperative kernels are timed on
    the same inputs (`*_thread`);
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
    launches);
  * (section "unfused") the unfused path's nearest-hit (#3), shadow (#5)
    and march (#6) kernels on the calls that the demo's unfused MC epoch
    (host-only textures, 1280x960) makes on tile 9 and frame-wide, and on
    tile 9's primary hits; the any-hit kernel (#4) on those hits' shadow
    rays, a launch per light, and on random rays; #3 over the unfused
    Whitted frame's tile calls; that epoch's host seconds, device busy and
    idle share, tile by tile and frame-wide, its peak device memory, and
    the unfused Whitted frame's host seconds (unfused_kernels);
  * (section "routes") the 1024x1024 MC epoch of mesh_scene(grid) for each
    of --route-grids through both MC routes, the binned walk and the
    blocked MC kernel, whatever the checkout's BINNED_MIN_TRIS says
    (mc_routes);
  * (section "edges", not timed) the share of lanes on which the nearest-hit
    and any-hit kernels agree with their plain versions on a 1,812-triangle
    dense table, chip_smoke.py's holds without their gate (edge_holds).

Each time is the mean device milliseconds per launch after a warm-up, taken
`rounds` times: from torch.profiler over the launches it reports of `reps`
(the kernels' own device time; chip_smoke.device_ms, which falls back to
CUDA events, and says so, where the profiler reports none in three tries;
CUDA events around back-to-back calls of a wrapper read the host's pace
once its kernel is shorter than the wrapper's host work).  Needs a CUDA card.  Prints the card's name
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


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, path))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # its dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


# this checkout's chip_smoke.py (its timing and level-pool helpers) and
# roofline (the bound) as modules, whichever tree the port is imported from
SMOKE = _module("chip_smoke", "chip_smoke.py")
ROOFLINE = _module("roofline", "raytracer_tpu_torch/utils/roofline.py")


def level_work(scene, pools, cfg):
    """Per level: the pool's width, its lanes' test totals and the bound of
    one launch (roofline.bound: the bytes chip_smoke.level_bytes counts,
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
        b_ms, b_by, ops = ROOFLINE.bound(io, work)
        out.append({"k": k, "last": last, "direct": direct, "tests": SMOKE.totals(work),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": io, "ops": ops})
    return out


def mesh_times(dev, reps, rounds):
    """The blocked level kernel, the blocked MC walk and the binned kernels
    on one mesh11k tile -> {name: {"profiler_ms": [...]}}, the means over the six levels and the five bounces, and the
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
    # the primary, and its per-thread yardstick where the checkout has it
    calls["binned_primary"] = ("binned_primary", lambda: mc_binned.primary(scene, o_t, d_t))
    if hasattr(mc_binned, "primary_per_thread"):
        calls["binned_primary_thread"] = (
            "binned_primary", lambda: mc_binned.primary_per_thread(scene, o_t, d_t))
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
    out = {name: {"profiler_ms": []} for name in calls}
    for _ in range(rounds):
        for name, (kernel, fn) in calls.items():
            out[name]["profiler_ms"].append(SMOKE.device_ms(fn, reps, kernel))

    def mean(prefix, count):
        runs = [out[f"{prefix}_{i}"] for i in range(count)]
        return {k: [sum(b[k][r] for b in runs) / count for r in range(rounds)]
                for k in ("profiler_ms",)}

    out["binned_bounce_mean"] = mean("binned_bounce", depth)
    for name, _ in walks:
        out[f"{name}_mean"] = mean(name, len(pools))
    out["level_blk_work"] = level_work(scene, pools, cfg)
    out["binned_primary_work"] = primary_work(scene, o_t, d_t)
    out["binned_primary_epoch"] = primary_epoch(scene, cam, cfg, dev, reps, rounds)
    out["whitted_frame"] = frame_times(scene, cam, cfg, rounds)
    out["mc_epoch_mega"] = mega_epoch(scene, cam, cfg, rounds)
    return out


def primary_work(scene, o_t, d_t):
    """The binned primary (#7) on one tile's rays through its counting
    instantiation -> block durations (median, longest us), test totals and
    bound, and the compiled attributes of the primary and, where the
    checkout has it, of its per-thread yardstick ("attrs")."""
    from raytracer_tpu_torch.ops import mc_binned
    from raytracer_tpu_torch.utils import kernels

    n = o_t.shape[1]
    work = SMOKE.work_for(n, o_t.device)
    mc_binned.primary(scene, o_t, d_t, work=work)
    io = SMOKE.nbytes(o_t, d_t, *SMOKE.scene_tables(scene)) + (21 + 5 + 1) * 4 * n
    b_ms, b_by, ops = ROOFLINE.bound(io, work)
    tests = SMOKE.totals(work)
    if hasattr(mc_binned, "primary_lanes"):  # the columns in the threads' order
        work = work[:, mc_binned.primary_lanes(n, o_t.device).clamp(max=n - 1)]
    out = {"attrs": {k: kernels.kernel_attrs(k) for k in ("binned_primary",
                                                          "binned_primary_thread")
                     if k in kernels.ATTRS},
           "block_us_median_longest": SMOKE.block_spread(work), "tests": tests,
           "sharing": SMOKE.sharing(tests), "bound_ms": b_ms, "bound_by": b_by, "bytes": io,
           "ops": ops}
    print(f"binned_primary: {out}", flush=True)
    return out


def primary_epoch(scene, cam, cfg, dev, reps, rounds):
    """The binned primary (#7), and its per-thread yardstick where the
    checkout has it, on each of the 16 tiles of the 1024x1024 epoch (the
    draws of epoch 0) -> {name: [[device ms per tile], ...] `rounds` times}."""
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import mc_binned
    from raytracer_tpu_torch.render import _clips, tile_draws

    tiles = []
    for t, clip in enumerate(_clips(cfg, dev)[0]):
        normals, _ = tile_draws(cfg, 0, 0, t, clip.shape[0], dev)
        o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
        tiles.append((o.t().contiguous(), d.t().contiguous()))
    fns = {"binned_primary": mc_binned.primary}
    if hasattr(mc_binned, "primary_per_thread"):
        fns["binned_primary_thread"] = mc_binned.primary_per_thread
    out = {name: [[SMOKE.device_ms(lambda: fn(scene, *tile), reps, "binned_primary")
                   for tile in tiles] for _ in range(rounds)] for name, fn in fns.items()}
    print("binned_primary over the epoch's tiles, ms: "
          + ", ".join(f"{k} {[round(sum(r), 4) for r in v]}" for k, v in out.items()), flush=True)
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


def edge_holds():
    """chip_smoke.py's holds of the nearest-hit and any-hit kernels on a
    dense table too large to stage (mesh_scene(30) without its BVH: 1,812
    triangles), the 64x48 frame's primary rays and their shadow rays to
    each light, with no gate -> {label: share of lanes on which kernel and
    plain version agree}, and the shadow kernel's share of (light, lane)
    pairs equal to its plain version.  A fine grid: these rays cross edges
    that two triangles share, where a contracted multiply-add and PyTorch's
    separately rounded operations may land on either side."""
    import dataclasses

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.render import _clips
    from raytracer_tpu_torch.scene.presets import mesh_scene
    from raytracer_tpu_torch.scene.textures import host_only
    from raytracer_tpu_torch.scene.types import BVH_FIELDS

    big, cam = mesh_scene(30)
    big = dataclasses.replace(big, textures=host_only(big.textures),
                              **{f: None for f in BVH_FIELDS})
    small = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
    ub = SMOKE.Unfused(big, *camera_ops.shoot(cam, _clips(small, big.device)[0][0]))
    out = {}
    SMOKE.hold_nearest("nearest", big, ub.rays, ub.active, share=0.0, record=out)
    for li, rays in enumerate(ub.shadow):
        SMOKE.hold_any(f"any light {li}", big, rays, ub.considers[li], ub.limits[li], share=0.0,
                       record=out)
    h = ub.hits
    args = (h.pos, ub.to_light, h.prim, ub.limits, ub.considers)
    out["shadow"] = SMOKE.agree(ik.shadow_any_hit(big, *args),
                                ik.shadow_any_hit_plain(big.tables, *args))
    out["n_tri"] = big.n_tri
    return out


def warp_share(mask):
    """Share of the warps of 32 consecutive lanes that hold a set lane."""
    n = mask.shape[-1]
    pad = torch.nn.functional.pad(mask.reshape(-1, n).any(0).to(torch.uint8), (0, (-n) % 32))
    return float(pad.view(-1, 32).any(1).float().mean())


def thread_cycles(work):
    """(mean cycles a thread, mean over the threads that did work) from a
    `work` output's cyc_all row and its test rows (a column a thread)."""
    from raytracer_tpu_torch.utils import kernels

    cyc = work[kernels.WORK_ROWS.index("cyc_all")].double()
    tests = work[:kernels.WORK_ROWS.index("sph") + 1].sum(0) > 0
    return float(cyc.mean()), float(cyc[tests].mean()) if bool(tests.any()) else 0.0


def unfused_kernels(reps, rounds):
    """#3 (nearest hit), #4 (any hit), #5 (shadow) and #6 (march) on the
    inputs the unfused path of the demo scene with host-only textures
    (1280x960, depth 5) hands them: the MC epoch's calls on one mid-frame
    tile (tile 9, as the tile loop makes them) and the calls of the
    frame-wide epoch (render.epoch_frame: 1,245,184 lanes: a primary and
    five advance casts, six shades, five marches), and the kernels on
    chip_smoke.Unfused's inputs (tile 9's primary hits: the kernel table's
    rows; #4 one launch per light there, as cast_any_hit makes them, and on
    the tile's count of random rays with and without a limit).  Per call:
    lanes, the share of active lanes (nearest, any hit), wanted lanes
    (march) or active (light, lane) pairs and lanes with an active light
    (shadow), the share of warps of 32 lanes in lane order that hold one;
    device ms per launch (torch.profiler, the kernel alone; where the
    checkout lists the lanes first, the list_lanes launch apart), the
    wrapper's device ms (chip_smoke.queued_ms: every kernel it launches),
    where the checkout has it the per-thread yardstick's; a thread's
    cycles from the counting instantiation.  Then #3 over the unfused
    Whitted frame's 114 tile calls (whitted_nearest: the mean per launch
    over one profiled pass of all of them), the epoch itself
    (render_distributed_epoch: host s, busy, idle), the same epoch tile by
    tile and frame-wide and the Whitted frame (host s, the least of
    three), and the kernels' registers and blocks per SM."""
    import dataclasses

    import numpy as np

    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import intersect_kernel, march_kernel
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene
    from raytracer_tpu_torch.scene.textures import host_only
    from raytracer_tpu_torch.utils import kernels

    dev = torch.device("cuda")
    demo = demo_scene().to(dev)
    scene = dataclasses.replace(demo, textures=host_only(demo.textures))
    cam = demo_camera().to(dev)
    cfg = RenderConfig(depth=5)
    clips = render._clips(cfg, dev)[0]
    tile_in = [render.tile_draws(cfg, 0, 7, t, clip.shape[0], dev)
               for t, clip in enumerate(clips)]
    ik = intersect_kernel
    hooks = [(march_kernel, "march"), (ik, "shadow_any_hit"), (ik, "nearest_hit")]
    sets = {
        "tile9": SMOKE.capture(hooks, lambda: render.epoch_tiles(scene, cam, cfg, clips[9:10],
                                                           tile_in[9:10])),
        "frame": SMOKE.capture(hooks, lambda: render.epoch_frame(scene, cam, cfg, clips, tile_in)),
    }
    u = SMOKE.Unfused(scene, *camera_ops.shoot(cam, clips[9]))
    rays, active, limit = SMOKE.random_rays(scene.n_prim, u.n, np.random.default_rng(0), dev)
    sets["primary_tile9"] = {
        "march": [((scene, *u.march_in, cfg.max_refract_distance, cfg.max_tir_retries), {})],
        "shadow_any_hit": [((scene, u.hits.pos, u.to_light, u.hits.prim, u.limits,
                             u.considers), {})],
        "nearest_hit": [((scene, u.rays, u.active), {})],
        "any_hit": [((scene, u.shadow[li], u.considers[li], u.limits[li]), {})
                    for li in range(scene.n_light)]}
    sets["random"] = {"any_hit": [((scene, rays, active, limit), {}),
                                  ((scene, rays, active, None), {})]}
    kinds = ("march", "shadow_any_hit", "nearest_hit", "any_hit")
    yard = {k: getattr(march_kernel if k == "march" else ik, f"{k}_per_thread", None)
            for k in kinds}
    fns = {k: getattr(march_kernel if k == "march" else ik, k) for k in kinds}
    names = {"march": "march_kernel", "shadow_any_hit": "shadow_kernel",
             "nearest_hit": "nearest_kernel", "any_hit": "any_kernel"}
    thread_names = {k: v.replace("_kernel", "_thread_kernel") for k, v in names.items()}

    def lanes_row(kind, args):
        """The call's lanes and the shares of them, and of warps, with work."""
        if kind == "shadow_any_hit":
            actives = args[5]
            return {"n": actives.shape[1], "pairs": float(actives.float().mean()),
                    "lanes": float(actives.any(0).float().mean()),
                    "warps": warp_share(actives)}
        mask = args[6] if kind == "march" else args[2]
        return {"n": mask.shape[0], "wanted" if kind == "march" else "active":
                float(mask.float().mean()), "warps": warp_share(mask)}

    out = {}
    for label, calls in sets.items():
        for kind, cs in calls.items():
            rows = []
            for args, kwargs in cs:
                fn = fns[kind]
                run = lambda fn=fn, a=args, k=kwargs: fn(*a, **k)
                row = lanes_row(kind, args)
                work = torch.zeros((len(kernels.WORK_ROWS), row["n"]), dtype=torch.int32,
                                   device=dev)
                fn(*args, **kwargs, work=work)
                row["thread_cycles"], row["working_thread_cycles"] = thread_cycles(work)
                row["tests"] = SMOKE.totals(work)
                row["ms"] = [SMOKE.device_ms(run, reps, names[kind]) for _ in range(rounds)]
                row["queued_ms"] = [SMOKE.queued_ms(run, reps) for _ in range(rounds)]
                if yard[kind] is not None:  # the listed kernel: its lane list, its yardstick
                    row["list_ms"] = [SMOKE.device_ms(run, reps, "list_lanes")
                                      for _ in range(rounds)]
                    thread = lambda fn=yard[kind], a=args, k=kwargs: fn(*a, **k)
                    row["thread_ms"] = [SMOKE.device_ms(thread, reps, thread_names[kind])
                                        for _ in range(rounds)]
                    row["thread_queued_ms"] = [SMOKE.queued_ms(thread, reps)
                                               for _ in range(rounds)]
                rows.append(row)
            out[f"{kind}_{label}"] = rows
            total = lambda key: [sum(r[key][i] for r in rows) for i in range(rounds)]
            out[f"{kind}_{label}_sum"] = {key: total(key) for key in rows[0]
                                          if key.endswith("ms")}
            print(f"{kind} {label}: " + "; ".join(
                f"{r['n']} lanes, {r.get('active', r.get('wanted', r.get('lanes')))} with work "
                f"in {r['warps']} of warps, {r['ms']} ms" + (f" + list {r['list_ms']}, "
                f"yardstick {r['thread_ms']}" if "list_ms" in r else "") for r in rows),
                flush=True)
    # #3 over the unfused Whitted frame's tile calls (6 levels a tile)
    frame = lambda: render.render_whitted(scene, cam, cfg)
    calls = SMOKE.capture([(ik, "nearest_hit")], frame)["nearest_hit"]
    masks = [a[2] for a, _ in calls]
    runs = [lambda a=a, k=k: ik.nearest_hit(*a, **k) for a, k in calls]
    each = lambda fns: (lambda: [f() for f in fns])
    wn = {"calls": len(calls), "lanes": sum(m.shape[0] for m in masks),
          "active": float(sum(int(m.sum()) for m in masks)) / sum(m.shape[0] for m in masks),
          "ms": [], "launches_seen": []}
    timed_names = [("ms", names["nearest_hit"], runs)]
    if yard["nearest_hit"] is not None:
        wn.update(list_ms=[], thread_ms=[])
        timed_names += [("list_ms", "list_lanes", runs),
                        ("thread_ms", thread_names["nearest_hit"],
                         [lambda a=a, k=k: yard["nearest_hit"](*a, **k) for a, k in calls])]
    for _ in range(rounds):
        for key, name, fns_ in timed_names:
            each(fns_)()
            torch.cuda.synchronize()
            ms, seen = SMOKE.profiled_ms(each(fns_), name)
            wn[key].append(ms)
            if key == "ms":
                wn["launches_seen"].append(seen)
    out["whitted_nearest"] = wn
    print(f"nearest_hit over the unfused whitted frame's {wn['calls']} calls: {wn}", flush=True)
    del calls, masks, runs, timed_names
    n_tri = (scene.n_tri,) if hasattr(kernels, "ATTRS_N_TRI") else ()
    out["attrs"] = {k: kernels.kernel_attrs(k, *n_tri)
                    for k in ("march", "march_thread", "shadow_any_hit", "shadow_any_hit_thread",
                              "nearest_hit", "nearest_hit_thread", "any_hit", "any_hit_thread")
                    if k in kernels.ATTRS}
    print(f"attrs: {out['attrs']}", flush=True)
    epoch = lambda: render.render_distributed_epoch(scene, cam, cfg, epoch=7)
    out["epoch"] = [SMOKE.profile_breakdown("demo unfused mc epoch", epoch)
                    for _ in range(rounds)]
    for name, fn in (("epoch_tiles_s", render.epoch_tiles), ("epoch_frame_s", render.epoch_frame)):
        out[name] = [min(SMOKE.timed(lambda: fn(scene, cam, cfg, clips, tile_in))[1]
                         for _ in range(3)) for _ in range(rounds)]
    frame()  # first-call set-up
    out["whitted_frame_s"] = [min(SMOKE.timed(frame)[1] for _ in range(3))
                              for _ in range(rounds)]
    print(f"unfused epoch frame-wide {out['epoch_frame_s']} s, tile by tile "
          f"{out['epoch_tiles_s']} s; whitted frame {out['whitted_frame_s']} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    render.epoch_frame(scene, cam, cfg, clips, tile_in)
    out["epoch_frame_peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def mc_routes(grids, rounds):
    """The 1024x1024 MC epoch of mesh_scene(grid) through both routes,
    whatever BINNED_MIN_TRIS says: the binned walk (threshold 0) and the
    blocked MC kernel (threshold 1 << 30) -> {grid: {"n_tri", "binned_s",
    "mega_s": host seconds between two synchronisations, the least of
    three, `rounds` times; "casts" of each route}}."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import mc_binned
    from raytracer_tpu_torch.render import render_distributed_epoch
    from raytracer_tpu_torch.scene.presets import mesh_scene

    dev = torch.device("cuda")
    cfg = RenderConfig(width=1024, height=1024, depth=5)
    out = {}
    saved = mc_binned.BINNED_MIN_TRIS
    try:
        for grid in grids:
            scene, cam = (x.to(dev) for x in mesh_scene(grid))
            row = {"n_tri": scene.n_tri}
            for name, threshold in (("binned", 0), ("mega", 1 << 30)):
                mc_binned.BINNED_MIN_TRIS = threshold
                epoch = lambda: render_distributed_epoch(scene, cam, cfg, epoch=7)
                _, stats = epoch()  # first-call set-up
                row[f"{name}_casts"] = stats["casts"]
                row[f"{name}_s"] = [min(SMOKE.timed(epoch)[1] for _ in range(3))
                                    for _ in range(rounds)]
            out[grid] = row
            print(f"mc epoch mesh_scene({grid}) ({scene.n_tri} triangles) 1024x1024: binned "
                  f"{row['binned_s']} s, blocked mc kernel {row['mega_s']} s", flush=True)
            del scene, cam
    finally:
        mc_binned.BINNED_MIN_TRIS = saved
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE, help="checkout to import the port from")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--mesh-reps", type=int, default=5)
    ap.add_argument("--route-grids", default="75,160",
                    help="mesh_scene grids whose MC epoch the routes section times")
    ap.add_argument("--sections", default="dense,mesh,unfused,routes",
                    help="comma-separated: dense (the demo's fused kernels and frames), mesh "
                         "(mesh11k kernels and frames), unfused, routes, edges")
    args = ap.parse_args()
    sections = set(args.sections.split(","))
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
    if "edges" in sections:
        out["edges"] = edge_holds()
    if "dense" in sections:
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
    if "mesh" in sections:
        out["mesh11k"] = mesh_times(dev, args.mesh_reps, args.rounds)
    if "unfused" in sections:
        out["unfused"] = unfused_kernels(args.reps, args.rounds)
    if "routes" in sections:
        out["mc_routes"] = mc_routes([int(g) for g in args.route_grids.split(",") if g],
                                     args.rounds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
