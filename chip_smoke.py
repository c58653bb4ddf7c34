#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port on one NVIDIA GPU, then drive its
main paths once.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase graph       # phase 5b alone, one card
    python3 chip_smoke.py --phase spd         # phase 5c alone, one card
    python3 chip_smoke.py --phase multicard   # phase 7 alone, 2-4 cards
    python3 chip_smoke.py --phase schedule    # phase 8 alone, one card
    python3 chip_smoke.py --phase bench       # phase 9 alone, one card

Phases (each asserts; none catches a failure):
  1. device and toolchain: nvidia-smi name and power limit, CUDA and nvcc
     versions; build the kernels (raytracer_tpu_torch/csrc, nvcc, sm_90a)
     and print each instantiation's registers, local (spill) bytes and
     dynamic shared bytes;
  2. each kernel against its plain PyTorch version on the card, same
     inputs: the demo scene (dense kernels) at 64x48, 256x192 and one
     65536-ray tile of 1280x960, and there the staged dense walks against
     their per-thread instantiations (outputs and casts equal on every
     lane, test totals equal: MC, and every level's pool), also on a ragged
     tile, level pools with 30 % of lanes killed owing radiance, the whole
     1280x960 frame's rays in one MC launch, and an epoch in one launch
     against the same epoch tile by tile; mesh_scene(24) at 64x48 and one
     65536-ray tile of the 1024x1024 mesh11k frame (blocked level kernel,
     blocked MC kernel, the three binned kernels), and the binned path
     against the blocked MC kernel; the warp-cooperative walks (blocked
     level kernel, blocked MC kernel, binned primary, bounce and terminal)
     against their per-thread instantiations on the same inputs (outputs
     and casts equal on every lane, test totals equal to the unit): every
     level's pool of those tiles, a ragged pool and pools with 30 % of lanes
     killed but owing radiance (direct and pooled levels); MC on those tiles
     and a ragged tile; the primary casts of those tiles, of a ragged tile
     and of all 16 tiles of a mesh11k epoch (and against the plain version:
     >= 99.9 % of lanes); bounces and terminals in dealt, sorted and pixel order,
     ragged and with dead lanes scattered through the state; and the MC
     walks' two traversal counters against the plain versions' chunk log;
     the four standalone kernels of the
     unfused path (nearest hit, any hit, multi-light shadow, interior
     march) on the demo's primary hits at 64x48 and on that 65536-ray tile
     (their shadow rays to all three lights, the glass lanes' marches) and
     on random rays with random face, exclusion and limit, and the shadow
     kernel against one any-hit launch per light through cast_any_hit;
     the four listed kernels (nearest hit, any hit, shadow, march) also
     against their per-thread yardsticks (every lane equal, test totals
     equal) on each of those inputs, on a dense table too large to stage,
     and, with their plain versions, on every call that the unfused MC
     epoch makes of the nearest-hit, shadow and march kernels, on tile 9
     through the tile loop and frame-wide (1,245,184 lanes), and on ragged
     cuts; the unfused epoch in one call against the tile loop;
  3. the committed goldens (tests/golden) at 64x48, depth 5, with the
     gates of scripts/tpu_check.py: the demo's and the meshes'
     (whitted_mesh{24,96,160}, mc_mesh24); then the demo's goldens through
     the unfused path (the demo's textures without row forms) and
     whitted_mesh24 through its BVH-only route (no blocked layout);
  4. presets, scene files, render_* and the CLI: the five depth-5 oracle
     goldens (tests/golden/oracle_*_64x48_d5.npy: 01-spheres,
     02-triangles, 03-recursive, 06-obj, demo) rendered through the dense
     level kernel at 64x48 and gated as the demo's Whitted golden (psnr
     printed), the same frames through the plain versions on the card, and
     one MC epoch of each kernel against plain; the four degenerate scenes
     of tests/test_degenerate_scenes.py (sphere-only, triangle-only,
     empty, a glass sphere alone) built from JSON: a Whitted frame and an
     epoch each, finite, nothing dropped, kernel against plain, and the
     empty scene sky everywhere with no kernel launched; the demo's
     builder written by dump_builder and read back renders the preset's
     frame and epoch, and with "bvh": true goes through the blocked
     kernels; at 1280x960 on the demo, render_epochs(3) equals three
     render_distributed_epoch calls summed, render_step equals
     render_whitted plus one epoch, render_steps(2)'s counters are the
     sums; each preset's Whitted frame and MC epoch at 1280x960 (host
     seconds, least of three, and device busy); four CLI processes at
     once (a preset, a scene file, --warm-cache, --profile);
  5. the main paths, each with the kernels' launch counts set to 0 just
     before it and read just after: the reference schedule
     (render_progressive on the demo scene, 1280x960, depth 5, Whitted +
     3 epochs: the staged level kernel 114 times, the staged MC kernel once
     an epoch, no per-thread yardstick); the mesh11k path (render_whitted and
     render_distributed_epoch on mesh_scene(75), 1024x1024, depth 5,
     tile_rays 65536: the cooperative blocked level kernel 96 times a frame,
     the blocked MC kernel once an epoch, no per-thread yardstick), and the
     same epoch through the binned route (BINNED_MIN_TRIS lowered: the
     three binned kernels); an MC epoch of mesh_scene(24) at 1024x1024 (the
     blocked MC kernel); a Whitted frame of mesh_scene(160); the MC epoch
     of mesh_scene(24/75/160/320) through both routes (the route table);
     the unfused path (render_progressive on the demo
     scene with row-less textures, 1280x960, depth 5, Whitted + 2 epochs:
     nearest-hit, shadow and march kernels tile by tile in the Whitted
     frame and once each a bounce in an epoch, no fused kernel, no
     per-thread yardstick; its peak device memory), its frame
     and one epoch held against the fused path's on the same draws; the
     per-light shadow test of a tile through cast_any_hit (the any-hit
     kernel); then frame / epoch and per-launch times of
     kernels (device time, torch.profiler) and plain versions (CUDA
     events) at the main paths' shapes (the blocked level kernel on each of
     the six pools of the first mesh11k tile; the unfused kernels on the
     frame-wide epoch's calls), the mesh11k epoch also
     through the binned route, the cooperative and listed kernels' per-thread
     yardsticks on the same inputs, and each kernel's bound (the least time
     the card could take for its work).
  5b. the Whitted ladder as CUDA graphs (ops/ladder_graph.py): the demo's
     1280x960 frame and mesh11k's 1024x1024 frame (tiles of 65536) rendered
     eagerly (the graph route turned off), then twice through the graphs
     (the first call captures one graph per tile width, the second replays
     them): both the eager frame bit for bit, with its stats and its
     launches (the level kernel six times a tile, the delivery once, nothing
     else); then each capture's seconds, each graph's replay, plain and
     counted (device ms, CUDA events), and the frame's host ms eager and
     graphed.
     `python3 chip_smoke.py --phase graph` builds the kernels and runs this
     phase alone.
  5c. the SPD sphereflake (7,381 spheres; the scene carries the sphere
     chunk table) at its benchmark cell's shapes, 512x512, depth 5: one
     epoch's rays through the MC wrapper with the launch counts set to 0
     just before and read just after (one launch, the gated staged walk by
     its kernel name), against the plain version at the cell's photon
     tolerance and against the linear walk (the scene without the table)
     bit for bit; sphere and box tests a cast; the device ms of both walks;
     render_distributed_epoch's launches; the gated instantiations'
     registers.  `python3 chip_smoke.py --phase spd` runs it alone.
  6. multi-card rendering (parallel/mesh.py) on the one card: the demo's
     1280x960 Whitted frame rendered twice, equal bit for bit, and the
     ordered delivery kernel (csrc/deliver.cu) against the CPU's index_add
     on tile 9's last-level pool and on a synthetic pool with runs of 1-32
     lanes scattered over it (bit for bit); the rank bodies of the (4, 1),
     (2, 2) and (8, 1) worlds one after another on the demo at 1280x960
     (the Whitted frame and the dp-only MC epoch the single card's bit for
     bit; at (2, 2) samples 0 and 1 summed) and of (4, 1) on mesh11k
     1024x1024 (blocked kernels); an NCCL world of one (init_multihost on a
     free local port): render_whitted_sharded, train_steps_sharded(k=3) and,
     with the counts set to 0 just before and read just after,
     render_progressive (Whitted + 3 epochs: the level kernel 114 times,
     the MC kernel once an epoch, the delivery once a tile, no per-thread
     yardstick), each the single card's bit for bit; that world's Whitted
     frame and epoch times beside the single card's, and the all_reduce of
     the frame buffer; the CLI at 320x240: --devices 1 writes --devices
     0's PNG byte for byte, and --devices 2 fails with the device count on a
     host with one card (runs, where there are two).
  7. multi-card rendering on the host's cards, on a host with two or more
     (else one line says it did not run): one process a card up to four
     (init_multihost on a free local port, NCCL), the references made on
     cuda:0 and handed over in a file.  Each rank checks that it runs on
     its own card (current device, scene and outputs on cuda:<rank>) and
     that its launches on the dp-only world's render_progressive are its
     tiles' (level kernel six times a Whitted tile, the delivery once a
     tile, the MC kernel once an epoch; the world's sum printed); the demo
     at 1280x960 on the dp-only world ((4, 1); (2, 1) on two cards):
     render_whitted_sharded, train_steps_sharded(k=3) and render_progressive
     and its PNG the single card's bit for bit, counters equal, nothing
     dropped; on the sample-parallel world ((2, 2); (1, 2)): the Whitted
     frame the single card's, the MC epoch and train_steps_sharded(k=3) the
     emulated rank bodies' (rank_sum); mesh11k at 1024x1024 on the dp-only
     world: frame, epoch and binned epoch the single card's; a
     render_progressive of one epoch with a checkpoint, resumed to three,
     writes the uninterrupted render's PNG byte for byte; then the CLI
     (--devices 4 and 2, or 2) writes the PNG of the same world shape's
     render_progressive byte for byte, phase 6's CLI check runs its
     --devices 2 arm, and the CLI's wall over 100 epochs is taken with
     --devices N and 0.  Numbers: each world's Whitted frame and epoch
     (host seconds, the slowest rank's, least of three) beside the single
     card's, each rank's device busy (torch.profiler), the all_reduce of the
     frames and counters (CUDA events) beside the NVLink bound.
     `python3 chip_smoke.py --phase multicard` builds the kernels and runs
     this phase alone.
  8. the full reference schedule (after phase 5's checks and the kernels'
     timing): the demo at 1280x960, depth 5, Whitted + 100 epochs,
     rendered twice, seed 0 through the CLI with its defaults (a PNG every
     epoch) and seed 1 through render_progressive(png_every=100), and
     scored with scripts/psnr_torch_vs_reference.py: each against the JAX
     package's render of the same seed (artifacts/out.png,
     artifacts/out_seed1.png) and the two against each other; the
     decoded pixels of both renders hashed.  Gates: with the counts set
     to 0 just before and read just after, seed 1's render launched the
     level kernel 114 times (six a tile), the MC kernel once an epoch, the
     delivery once a tile and nothing else; every port-vs-JAX score >= the
     JAX two-seed floor (artifacts/PSNR.json self_psnr_*) - 0.6 dB at raw,
     down4 and down8, the port's own floor within 0.6 dB of the JAX floor
     at each, nothing dropped in either Whitted pass.  Then the epoch loop
     profiled (schedule_profile: --png-every 1 over 20 epochs and 10 over
     60, at least five groups past the first): one render_progressive
     under torch.profiler, read from the loop's own spans (utils/tracing),
     on a JSON line each: a group's epochs less their waits, the waits, the
     u8 encode, the main thread's unspanned rest (the reads and the
     writer's hand-over), the writer thread's job with its PNG encode and
     write, and render_progressive's wall.
     `python3 chip_smoke.py --phase schedule` builds the kernels and runs
     this phase alone.
  9. the benchmark harness (raytracer_tpu_torch/bench.py, after phase 8):
     bench.run in process at the JAX bench's sizes (BenchSpec()), the
     kernels' counts set to 0 just before each section and read just
     after: the warm-up, render_step x3, render_epochs(10) x3 and
     render_steps(5) x3 on the demo at 1024x1024 (the dense level kernel
     96 times a frame, the delivery 16, the dense MC kernel once an epoch),
     mesh11k and mesh51k (the blocked level kernel 96 times a frame, the
     blocked MC kernel once an epoch), the 1280x960 schedule with a PNG
     every epoch and every 10 (114 / 19 a frame); every other kernel,
     yardstick and plain call 0.  The demo's Whitted frame, traced again
     level by level, drops nothing, its levels sum to the harness's count,
     and its primary level casts the JAX bench's 3,009,477 rays (the JAX
     bench's count on the TPU equals that level's); its MC epoch casts within
     1 % of 9,793,125.  Then `python -m raytracer_tpu_torch.bench` (with
     RAYTPU_BENCH_FAST=1) and `scripts/bench_torch_mesh.py --grids 75
     --reps 1` as a user starts them: every numeric key of each line is in
     bench.METRICS or bench.DESCRIPTORS, and its device.name is
     nvidia-smi's.  The harness's line is printed on a line of its own.
     `python3 chip_smoke.py --phase bench` builds the kernels and runs this
     phase alone.
The line before the last is a JSON object with each kernel's launches,
error, times and bound; the last line is {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")

DEPTH, MD, MR = 5, 100.0, 10
NVLINK_BYTES_S = 450e9  # H100 SXM: NVLink 4, 900 GB/s a card, 450 each way


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    peak = max(float(b.max()), 1e-6)
    return 10 * np.log10(peak * peak / mse)


def frac_close(a, b):
    """Fraction of rows whose every channel is within 1e-3 + 2e-2 |ref|."""
    close = np.all(np.abs(a - b) <= 1e-3 + 2e-2 * np.abs(b), axis=-1)
    return float(close.mean())


def casts_close(a, b):
    return abs(int(a) - int(b)) <= max(0.01 * int(b), 16)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """Mean device milliseconds of everything fn() enqueues, over reps
    calls queued behind a device-side sleep (torch.cuda._sleep) that lasts
    longer than the host takes to enqueue them: the CUDA events then time
    the device's work back to back, not the host's pace (cuda_ms around a
    short kernel whose wrapper takes longer on the host than the kernel on
    the device reads the wrapper)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * (2 * host_ms + 1)))  # >= 2 cycles a ns: longer than that
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, name):
    """fn() once under torch.profiler -> (mean device milliseconds per
    launch of the kernels whose name holds `name`, the launches the profiler
    reported).  The mean is over the launches it reports: late in a long
    process it has reported 0 to 4 of 5, and dividing by the launches made
    then read up to 5 times too low."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if name in e.key]
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in events)
    seen = sum(e.count for e in events)
    return (us / seen / 1e3 if seen else 0.0), seen


def device_ms(fn, reps, name):
    """Mean device milliseconds per launch of the kernel whose name holds
    `name` (fn() launches it once), from torch.profiler over reps calls
    after a warm-up (CUDA events around a short kernel measure the host's
    launch pace; profiled_ms).  Where three passes report no launch at
    all, the time is taken with CUDA events instead, and says so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        ms, seen = profiled_ms(lambda: [fn() for _ in range(reps)], name)
        if seen != reps:
            print(f"(torch.profiler reported {seen} of {reps} launches of {name})")
        if ms > 0:
            return ms
    print(f"(no device time of {name} from torch.profiler: CUDA events instead)")
    return cuda_ms(fn, reps)


def profile_breakdown(label, fn):
    """fn() after a warm-up, three times unprofiled (the least host seconds
    between two synchronisations: a single run right after the plain
    versions has read 40x the frame's usual time) and once under
    torch.profiler: device busy milliseconds (the sum of every kernel's and
    copy's device time), the idle share of the unprofiled seconds (the
    profiler slows the host), the number of device operations (kernel
    launches and copies) and the five largest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    wall = min(timed(fn)[1] for _ in range(3))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    evs = sorted(prof.key_averages(), key=dev, reverse=True)
    busy = sum(dev(e) for e in evs) / 1e3
    top = [(e.key[:60], dev(e) / 1e3, e.count) for e in evs[:5]]
    idle = max(0.0, 1 - busy / 1e3 / wall)
    n_ops = sum(e.count for e in evs if dev(e) > 0)
    print(f"profile {label}: {wall:.3f} s host, device busy {busy:.1f} ms in {n_ops} device "
          f"operations ({100 * idle:.0f} % idle); top: "
          + "; ".join(f"{k} {ms:.1f} ms x{c}" for k, ms, c in top))
    return {"wall_s": wall, "device_busy_ms": busy, "device_ops": n_ops, "idle": idle,
            "top": top}


def timed(fn):
    """(result, host seconds) of fn() between two synchronisations."""
    torch.cuda.synchronize()
    t = time.time()
    r = fn()
    torch.cuda.synchronize()
    return r, time.time() - t


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def scene_tables(scene):
    """The scene tables a kernel reads: the dense ones, or the blocked rows
    and boxes with the spheres, materials and lights."""
    tb = scene.tables
    if scene.blocked:
        bt = scene.blk_tables
        return [bt.tri, bt.box, bt.sup, tb.sph, tb.mat, tb.lights]
    return [tb.tri, tb.sph, tb.mat, tb.lights]


def level_bytes(scene, pool):
    """The bytes one launch of the level kernel must move on `pool`: the
    alive row of every lane; a dead lane's pending radiance and slot; every
    input row of a live lane, and the scene tables if any lane is live;
    every output row of every lane (contrib, both children, casts)."""
    from raytracer_tpu_torch.ops.level_kernel import I_ALIVE, N_F, N_I

    k = pool.width
    live = int((pool.i[I_ALIVE] != 0).sum())
    rows_in = N_F + N_I
    read = 4 * k + 4 * 4 * (k - live) + 4 * (rows_in - 1) * live
    tables = nbytes(*scene_tables(scene)) if live else 0
    return read + tables + (3 + 2 * rows_in + 1) * 4 * k


def march_bytes(scene, want):
    """The bytes one launch of the march kernel must move: every lane's
    want flag and outputs (escape flag, travel, exit origin and direction,
    exit primitive, casts: 37 B); a wanted lane's position, normal,
    direction and k (40 B); the scene tables if any lane marches."""
    n, wanted = want.numel(), int(want.sum())
    tables = nbytes(scene.tables.tri, scene.tables.sph) if wanted else 0
    return (1 + 37) * n + 40 * wanted + tables


def sweep_bytes(scene, active, out_bytes, limited=False):
    """The bytes one launch of the nearest-hit (out_bytes 10: t, index,
    backface, valid) or any-hit kernel (1: blocked; `limited`: a limit a
    lane) must move on `active` [N]: every lane's active flag and outputs;
    an active lane's ray (origin, direction, face, exclusion: 36 B) and
    limit; the scene tables if any lane is active."""
    n, act = active.numel(), int(active.sum())
    tables = nbytes(scene.tables.tri, scene.tables.sph) if act else 0
    return (1 + out_bytes) * n + (36 + 4 * limited) * act + tables


def shadow_bytes(scene, actives):
    """The bytes one launch of the shadow kernel must move on `actives`
    [L, N]: every (light, lane) pair's active and blocked flags; the
    position and excluded primitive (16 B) of a lane with an active light,
    and each active pair's direction and limit (16 B); the scene tables if
    any pair is active."""
    n_light, n = actives.shape
    lanes, pairs = int(actives.any(0).sum()), int(actives.sum())
    tb = scene.tables
    tables = nbytes(tb.tri, tb.sph, tb.lights) if pairs else 0
    return 2 * n_light * n + 16 * lanes + 16 * pairs + tables


def level_pools(scene, cam, clip, cfg):
    """The pools that one tile's Whitted ladder hands the level kernel (the
    primary level, the level-1 peel, the deep level, the tail levels and the
    last level) -> [(pool, last, direct)], in level order."""
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import level_kernel
    from raytracer_tpu_torch.ops.trace import trace_whitted

    pools = []

    def record(sc, pool, last, direct, *args):
        pools.append((pool, last, direct))
        return level_kernel.process_level(sc, pool, last, direct, *args)

    trace_whitted(scene, *camera_ops.shoot(cam, clip), cfg, level_fn=record)
    return pools


def totals(work):
    """{row name: total} of the counting rows of a `work` output."""
    from raytracer_tpu_torch.utils.kernels import WORK_ROWS

    counts = WORK_ROWS.index("t_in")  # the rows before the clocks are counts
    return dict(zip(WORK_ROWS[:counts], work[:counts].sum(1).tolist()))


def sharing(tests):
    """Chunks staged by warps x 32 over the chunks single rays entered: 1
    when all 32 lanes of a warp enter the same chunks, 32 when no two do
    (below 1 where a shading point's rays to several lights share)."""
    return tests["wchunk"] * 32 / max(tests["chunk"], 1)


def phase_shares(work):
    """Where the warps of a cooperative launch spent their cycles, from the
    cycle rows of its `work` (one thread a warp: a column is a thread, and
    the cycles are alike across a warp): the shares of box tests and
    votes, of waiting for staged chunks, of testing staged rows, and of all
    the rest (shading, sampling, state), and the mean cycles a warp lived."""
    from raytracer_tpu_torch.utils.kernels import WORK_ROWS

    rows = work[:, ::32].double()
    total = rows[WORK_ROWS.index("cyc_all")].sum()
    out = {k: float(rows[WORK_ROWS.index("cyc_" + k)].sum() / total)
           for k in ("box", "stage", "rows")}
    out["rest"] = 1.0 - sum(out.values())
    out["warp_cycles"] = float(total / rows.shape[1])
    return out


def walk_phases(work):
    """Where the threads of a launch spent their cycles by phase of the walk,
    from the cycle rows of its `work` (a column a thread): the shares of
    nearest-hit sweeps, shadow tests, interior marches and all the rest
    (shading, materials, sampling, the state), and the mean cycles a thread
    lived."""
    from raytracer_tpu_torch.utils.kernels import WORK_ROWS

    rows = work.double()
    total = rows[WORK_ROWS.index("cyc_all")].sum()
    out = {k: float(rows[WORK_ROWS.index("cyc_" + k)].sum() / total)
           for k in ("near", "shadow", "march")}
    out["rest"] = 1.0 - sum(out.values())
    out["thread_cycles"] = float(total / rows.shape[1])
    return out


def block_spread(work, threads=128):
    """(median, longest) microseconds from a block's first thread's start to
    its last thread's end, from the clock rows of one launch's `work` (a
    column is a thread; `threads` a block)."""
    from raytracer_tpu_torch.utils.kernels import WORK_ROWS

    t_in = work[WORK_ROWS.index("t_in")].to(torch.int64) & 0xFFFFFFFF
    t_out = work[WORK_ROWS.index("t_out")].to(torch.int64) & 0xFFFFFFFF
    base = t_in.min()
    n = work.shape[1] // threads * threads  # whole blocks
    start = ((t_in - base) & 0xFFFFFFFF)[:n].view(-1, threads).min(dim=1).values
    end = ((t_out - base) & 0xFFFFFFFF)[:n].view(-1, threads).max(dim=1).values
    dur = (end - start).float() / 1e3
    return float(dur.median()), float(dur.max())


def golden_gate(img, name, min_psnr, max_bad):
    g = np.load(os.path.join(GOLDEN, name))
    a = img.cpu().numpy()
    p, bad = psnr(a, g), float((np.abs(a - g).max(axis=-1) > 0.1).mean())
    return p, bad, p >= min_psnr and bad <= max_bad


def agree(a, b):
    """Fraction of equal elements of two tensors."""
    return float((a == b).float().mean())


def work_for(n, device):
    """A zeroed `work` output for a launch of n lanes."""
    from raytracer_tpu_torch.utils.kernels import WORK_ROWS

    return torch.zeros((len(WORK_ROWS), n), dtype=torch.int32, device=device)


def capture(modules_names, fn):
    """fn() with each (module, name) wrapper wrapped to record the
    arguments of every call -> {name: [(args, kwargs), ...]}."""
    calls = {name: [] for _, name in modules_names}
    saved = [(m, name, getattr(m, name)) for m, name in modules_names]

    def recorder(name, orig):
        def wrapped(*args, **kwargs):
            calls[name].append((args, kwargs))
            return orig(*args, **kwargs)
        return wrapped

    for m, name, orig in saved:
        setattr(m, name, recorder(name, orig))
    try:
        fn()
    finally:
        for m, name, orig in saved:
            setattr(m, name, orig)
    return calls


def hold_shadow(label, scene, args):
    """The shadow kernel on `args` (pos [N, 3], dirs [L, N, 3], excl_prim,
    limits [L, N], actives [L, N]) against its per-thread yardstick (every
    (light, lane) pair equal, the test totals equal) and its plain version
    (>= 99.9 % of pairs equal; nothing blocked that is not active) -> the
    largest |kernel - plain|."""
    from raytracer_tpu_torch.ops import intersect_kernel as ik

    actives = args[4]
    wk, wt = work_for(actives.shape[1], actives.device), work_for(actives.shape[1],
                                                                  actives.device)
    got = ik.shadow_any_hit(scene, *args, work=wk)
    yard = ik.shadow_any_hit_per_thread(scene, *args, work=wt)
    ref = ik.shadow_any_hit_plain(scene.tables, *args)
    torch.cuda.synchronize()
    tk, tt = totals(wk), totals(wt)
    print(f"shadow_any_hit {label} ({actives.shape[1]} lanes, {int(actives.sum())} active pairs): "
          f"listed kernel vs per-thread yardstick {agree(got, yard):.6f} of pairs equal, tests "
          f"{tk} vs {tt}; {agree(got, ref):.5f} equal the plain version")
    assert torch.equal(got, yard) and tk == tt, (label, agree(got, yard), tk, tt)
    assert agree(got, ref) >= 0.999 and not bool(got[~actives].any()), label
    return float((got != ref).float().max())


def hold_nearest(label, scene, rays, active, atol=None, share=0.999, record=None):
    """The nearest-hit kernel on `rays` under `active` [N] against its
    per-thread yardstick (every lane's t, index, backface and valid equal,
    the test totals equal) and its plain version.  Given `atol`: valid,
    index and backface equal on >= 99.9 % of lanes and, on every lane where
    both hit, t within 1e-5 |t| + atol.  Else `share` of the lanes hold
    the same hit: valid equal and, where both hit, t within 1e-5 |t| +
    1e-5 (a ray leaving a surface meets the next one at small t, where
    d - n.o cancels: random_rays' tolerance) and the same primitive and
    backface, or a primitive that the plain version's own candidates tie
    with its winner (t within the same tolerance, the same backface: a ray
    through the edge two triangles share, where the kernel contracts
    multiply-adds that PyTorch rounds one by one).  A miss is t = +inf,
    idx = -1 -> the largest |t - t_plain| where both hit.  `record` (a
    dict), if given, takes the share of lanes with the same hit."""
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops import kernel_common as kc

    n = active.shape[0]
    wk, wt = work_for(n, active.device), work_for(n, active.device)
    got = ik.nearest_hit(scene, rays, active, work=wk)
    yard = ik.nearest_hit_per_thread(scene, rays, active, work=wt)
    tp, ip, bp, vp = ik.nearest_hit_plain(scene.tables, rays, active)
    torch.cuda.synchronize()
    t, idx, bf, valid = got
    same = all(torch.equal(a, b) for a, b in zip(got, yard))
    tk, tt = totals(wk), totals(wt)
    both = valid & vp
    tol = lambda ref: 1e-5 * ref.abs() + (1e-5 if atol is None else atol)
    close = (t - tp).abs() <= tol(tp)
    winner = (valid == vp) & (idx == ip) & (bf == bp)
    agree_hit = winner & (close | ~both)
    tied = 0
    if atol is None:  # a winner the plain version ties with its own
        other = torch.nonzero(both & close & (idx != ip)).squeeze(1)
        if other.numel():
            cols = lambda x: (x[other, 0], x[other, 1], x[other, 2])
            args = (cols(rays.o), cols(rays.d), rays.face[other], rays.excl_prim[other],
                    rays.excl_face[other], active[other], scene.tables)
            (tc, bc), (sc, sb) = kc.tri_candidates(*args), kc.sph_candidates(*args)
            at = idx[other].long()[None]
            t_cand = torch.cat([tc, sc]).gather(0, at)[0]
            bf_cand = torch.cat([bc, sb]).gather(0, at)[0]
            tie = ((t_cand - tp[other]).abs() <= tol(tp[other])) & (bf_cand == bf[other])
            agree_hit[other] |= tie
            tied = int(tie.sum())
    agreed = float(agree_hit.float().mean())
    if record is not None:
        record[label] = agreed
    err = float((t - tp).abs()[both].max()) if bool(both.any()) else 0.0
    print(f"nearest_hit {label}: {int(active.sum())} of {n} lanes active, {int(both.sum())} "
          f"hits; listed kernel vs per-thread yardstick: "
          f"{'every lane equal' if same else 'DIFFERENT'}, tests {tk} vs {tt}; vs plain: "
          f"{float(winner.float().mean()):.6f} of lanes the same winner, {tied} ties, "
          f"{agreed:.6f} the same hit, max |t err| {err:.3g}")
    assert same and tk == tt, (label, tk, tt)
    assert agreed >= share, (label, agreed)
    if atol is not None:
        assert bool(close[both].all()), label
    assert bool(torch.isinf(t[~valid]).all()) and bool((idx[~valid] == -1).all())
    assert not bool(valid[~active].any()), label
    return err


def hold_any(label, scene, rays, active, limit, share=0.999, record=None):
    """The any-hit kernel on `rays` under `active` [N] and `limit` [N] (None:
    any hit at all) against its per-thread yardstick (every lane equal, the
    test totals equal) and its plain version (`share` of the lanes equal;
    nothing blocked that is not active) -> the largest |kernel - plain|.
    `record` (a dict), if given, takes the share of lanes equal."""
    from raytracer_tpu_torch.ops import intersect_kernel as ik
    from raytracer_tpu_torch.ops.kernel_common import BIG

    n = active.shape[0]
    wk, wt = work_for(n, active.device), work_for(n, active.device)
    got = ik.any_hit(scene, rays, active, limit, work=wk)
    yard = ik.any_hit_per_thread(scene, rays, active, limit, work=wt)
    lim = torch.full_like(rays.o[:, 0], BIG) if limit is None else limit.clamp(max=BIG)
    ref = ik.any_hit_plain(scene.tables, rays, active, lim)
    torch.cuda.synchronize()
    tk, tt = totals(wk), totals(wt)
    print(f"any_hit {label}: {int(got.sum())} blocked of {int(active.sum())} active lanes of {n}; "
          f"listed kernel vs per-thread yardstick {agree(got, yard):.6f} of lanes equal, tests "
          f"{tk} vs {tt}; {agree(got, ref):.5f} equal the plain version")
    if record is not None:
        record[label] = agree(got, ref)
    assert torch.equal(got, yard) and tk == tt, (label, agree(got, yard), tk, tt)
    assert agree(got, ref) >= share and not bool(got[~active].any()), label
    return float((got != ref).float().max())


def hold_march(label, scene, args, share=None):
    """The march kernel on `args` (pos, normal, ray_d [N, 3], prim, k,
    want [N]) against its per-thread yardstick (every lane's outputs and
    casts equal, the test totals equal) and its plain version: escape flags
    differ on < 1 % of marching lanes, summed casts within 1 %, no lane
    escapes that did not march, and on lanes that escape in both: travel
    and exit ray within 1e-4 and the exit primitive equal, on every such
    lane or, given `share`, on that share of them with travel within 1e-4 +
    1e-4 |travel| (tests/test_torch_march.py's tolerance): the frame-wide
    calls hold 10^5 escaping lanes whose travel reaches the budget of 100,
    and the kernel contracts multiply-adds where PyTorch rounds each
    operation -> the largest error against the plain version."""
    from raytracer_tpu_torch.ops import march_kernel as mk

    pos, normal, ray_d, prim, k, want = args
    n = pos.shape[0]
    wk, wt = work_for(n, pos.device), work_for(n, pos.device)
    got = mk._launch("rt_march", True, mk.COUNTS, scene, pos, normal, ray_d, k, want, MD, MR, wk)
    yard = mk._launch("rt_march_thread", False, mk.COUNTS_THREAD, scene, pos, normal, ray_d, k,
                      want, MD, MR, wt)
    esc_p, travel_p, eo_p, ed_p, eprim_p, iters_p = mk.march_plain(
        scene.tables, pos, normal, ray_d, k, want, MD, MR)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, yard))
    tk, tt = totals(wk), totals(wt)
    esc, travel, eo, ed, eprim, iters = got
    n_want = int(want.sum())
    flips = int((esc != esc_p).sum())
    both = esc & esc_p
    d_travel = (travel - travel_p).abs()
    d_ray = torch.maximum((eo - eo_p).abs().amax(dim=1), (ed - ed_p).abs().amax(dim=1))
    err = float(torch.maximum(d_travel, d_ray)[both].max()) if bool(both.any()) else 0.0
    tol = 1e-4 + (1e-4 * travel_p.abs() if share else 0.0)
    close = (d_travel <= tol) & (d_ray <= 1e-4) & (eprim == eprim_p)
    n_both, n_close = int(both.sum()), int((close & both).sum())
    agree_share = n_close / n_both if n_both else 1.0
    casts, casts_p = int(iters.sum()), int(iters_p.sum())
    print(f"march {label}: {n_want} of {n} lanes march; listed kernel vs per-thread yardstick: "
          f"{'every lane equal' if same else 'DIFFERENT'}, tests {tk} vs {tt}; vs plain: "
          f"{flips} escape flags differ, {n_both} escape in both, "
          f"{agree_share:.6f} of them agree, max |err| {err:.3g}, casts {casts} vs {casts_p}")
    assert same and tk == tt, (label, tk, tt)
    assert n_want > 0 and flips < 0.01 * n_want, (flips, n_want)
    assert n_close == n_both if share is None else agree_share >= share, (label, agree_share)
    assert abs(casts - casts_p) <= 0.01 * casts_p
    assert not bool(esc[~want].any())
    return err


class Unfused:
    """The inputs the unfused path hands its four kernels for one batch of
    primary rays, and each kernel held against its plain version on them.
    Tolerances: nearest hit - valid, index and backface equal on >= 99.9 %
    of lanes, t within rtol 1e-5 where both hit (random rays: + atol 1e-5,
    since d - n.o cancels for origins far from a plane it hits close by,
    and the kernel contracts that into one multiply-add); any hit and shadow - equal
    on >= 99.9 % of lanes / (light, lane) pairs; march - escape flags differ
    on < 1 % of marching lanes, travel and exit ray within 1e-4 and the
    exit primitive equal on lanes that escape in both, summed casts within
    1 %.  (The kernels contract multiply-adds where PyTorch rounds each
    operation, so a razor-edge lane may fall the other way.)  Each listed
    kernel is also held to its per-thread yardstick: every lane equal, the
    test totals equal (hold_nearest, hold_any, hold_shadow, hold_march)."""

    def __init__(self, scene, o, d):
        from raytracer_tpu_torch.ops import materials as mat_ops
        from raytracer_tpu_torch.ops.intersect import cast
        from raytracer_tpu_torch.ops.shade import shadow_rays
        from raytracer_tpu_torch.scene.types import FACE_BACK, Rays

        self.scene, self.n = scene, o.shape[0]
        self.rays = Rays.primary(o.contiguous(), d.contiguous())
        self.active = torch.ones((self.n,), dtype=torch.bool, device=o.device)
        h = self.hits = cast(scene, self.rays)
        mat = mat_ops.eval_material(scene, scene.textures, h.obj, h.uv)
        n_adj = mat_ops.adjust_normal(mat, h.normal)
        _, to_light, self.considers, self.limits = shadow_rays(scene, h.pos, n_adj, h.valid)
        self.to_light = to_light.contiguous()
        back = torch.full((self.n,), FACE_BACK, dtype=torch.int32, device=o.device)
        self.shadow = [Rays(o=h.pos, d=self.to_light[li], face=back, excl_prim=h.prim,
                            excl_face=back) for li in range(scene.n_light)]
        self.want = h.valid & (mat.transparency > 0.0)
        self.march_in = (h.pos, h.normal, self.rays.d, h.prim, mat.refraction, self.want)

    def check_nearest(self, label, rays=None, active=None, atol=0.0):
        """hold_nearest on the primary rays (or `rays` under `active`)."""
        rays = self.rays if rays is None else rays
        active = self.active if active is None else active
        return hold_nearest(label, self.scene, rays, active, atol)

    def check_any(self, label, rays, active, limit, share=0.999):
        return hold_any(label, self.scene, rays, active, limit, share)

    def check_shadow(self, label):
        """The shadow kernel against its yardstick and plain version
        (hold_shadow), and against one any-hit launch per light through
        cast_any_hit (other arithmetic: direct t against the factored
        target)."""
        from raytracer_tpu_torch.ops import intersect_kernel as ik
        from raytracer_tpu_torch.ops.intersect import cast_any_hit

        h = self.hits
        args = (h.pos, self.to_light, h.prim, self.limits, self.considers)
        err = hold_shadow(label, self.scene, args)
        got = ik.shadow_any_hit(self.scene, *args)
        per_light = torch.stack([
            cast_any_hit(self.scene, self.shadow[li], active=self.considers[li],
                         limit=self.limits[li]) for li in range(self.scene.n_light)])
        torch.cuda.synchronize()
        print(f"shadow_any_hit {label}: {agree(got, per_light):.5f} of (light, lane) pairs equal "
              f"the per-light any-hit kernel; {int(got.sum())} blocked of "
              f"{int(self.considers.sum())} shadow rays")
        assert agree(got, per_light) >= 0.999
        return err

    def check_march(self, label):
        return hold_march(label, self.scene, self.march_in)


def random_rays(n_prim, n, rng, dev):
    """Rays with random face, exclusion and limit, as tests/test_pallas.py
    makes them -> (Rays, active [n], limit [n])."""
    from raytracer_tpu_torch.scene.types import Rays

    o = rng.normal(size=(n, 3)).astype(np.float32) * 2 + np.array([0.5, 1, 0.5], np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ints = lambda lo, hi: torch.as_tensor(rng.integers(lo, hi, size=n).astype(np.int32),
                                          device=dev)
    rays = Rays(o=torch.as_tensor(o, device=dev), d=torch.as_tensor(d, device=dev),
                face=ints(0, 3), excl_prim=ints(-1, n_prim), excl_face=ints(0, 3))
    active = torch.as_tensor(rng.uniform(size=n) < 0.9, device=dev)
    limit = torch.as_tensor(rng.uniform(0.1, 10.0, size=n).astype(np.float32), device=dev)
    return rays, active, limit


# The preset scenes with committed depth-5 oracle renders
# (tests/golden/oracle_<name>_64x48_d5.npy), as (name, maker in
# scene/presets.py); 08-full / full / demo are one scene
ORACLE_PRESETS = (("01-spheres", "spheres_scene"), ("02-triangles", "triangles_scene"),
                  ("03-recursive", "recursive_scene"), ("06-obj", "obj_scene"),
                  ("demo", "demo_scene"))
# tests/test_degenerate_scenes.py's scenes as JSON (scene/serialize.py)
_LIGHT = [{"type": "directional", "direction": [0, -1, 0], "color": [1, 1, 1]}]
DEGENERATE = {
    "sphere-only": {"objects": [{"material": {"diffuse_color": [1, 0, 0], "shiness": 0.2},
                                 "spheres": [{"center": [0, 0.5, 0], "radius": 0.5}]}],
                    "lights": _LIGHT},
    "triangle-only": {"objects": [{"material": {"diffuse_color": [0, 1, 0], "shiness": 0.3},
                                   "squares": [[[-2, 0, -2], [-2, 0, 2], [2, 0, 2],
                                                [2, 0, -2]]]}],
                      "lights": _LIGHT},
    "empty": {"lights": _LIGHT},
    "glass sphere only": {"objects": [{"material": {
        "diffuse_color": [1, 1, 1], "shiness": 1.0, "smoothness": 0.001,
        "refraction_index": 1.12, "opaque_decay": 0.3, "transparency": 0.96},
        "spheres": [{"center": [0, 0.5, 0], "radius": 0.5}]}], "lights": _LIGHT},
}


def whitted_vs_plain(label, scene, cam, cfg):
    """The Whitted frame tile by tile through the kernels and through their
    plain versions on the card (ops/level_kernel.process_level_plain):
    >= 97 % of pixels within 1e-3 + 2e-2 |ref|, casts within 1 %, nothing
    dropped, every colour finite -> (share of pixels that agree, casts)."""
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import level_kernel
    from raytracer_tpu_torch.ops.trace import trace_whitted
    from raytracer_tpu_torch.render import _clips

    def plain_level(sc, pool, last, direct, thr, md, mr):
        c, r, f, casts = level_kernel.process_level_plain(
            sc.geom, sc.textures, pool, last, direct, thr, md, mr)
        return c, r, f, casts.sum()

    got, ref, casts = [], [], [0, 0]
    for clip in _clips(cfg, scene.device)[0]:
        o, d = camera_ops.shoot(cam, clip)
        for out, i, kw in ((got, 0, {}), (ref, 1, {"level_fn": plain_level})):
            res = trace_whitted(scene, o, d, cfg, **kw)
            assert int(res.dropped) == 0, (label, i)
            out.append(res.color)
            casts[i] += int(res.casts)
    a, b = torch.cat(got).cpu().numpy(), torch.cat(ref).cpu().numpy()
    fc = frac_close(a, b)
    print(f"whitted {label}, kernel vs plain: {fc:.5f} of pixels agree, casts {casts[0]} vs "
          f"{casts[1]}, max |err| {np.abs(a - b).max():.3g}")
    assert np.isfinite(a).all() and fc >= 0.97, (label, fc)
    assert casts_close(casts[0], casts[1]), (label, casts)
    return fc, casts[0]


def mc_vs_plain(label, scene, cam, cfg, seed=0, epoch=0):
    """One MC epoch's lanes (the generator's draws of `seed`, `epoch`) through
    mc_kernel.trace and its plain version on the card: >= 99 % of lanes
    within 1e-3 + 2e-2 |ref|, casts within 1 %, every photon finite ->
    (share of lanes that agree, casts)."""
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import mc_kernel
    from raytracer_tpu_torch.render import _clips, frame_draws, tile_draws

    clips = _clips(cfg, scene.device)[0]
    normals, unifs = frame_draws([tile_draws(cfg, seed, epoch, t, c.shape[0], scene.device)
                                  for t, c in enumerate(clips)])
    o, d = camera_ops.shoot_focus(cam, clips.reshape(-1, 2), normals * cfg.blur, cfg.focus)
    o, d = o.contiguous(), d.contiguous()
    got, got_casts = mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR)
    ref, ref_casts = mc_kernel.trace_plain(scene.geom, scene.textures, o, d, unifs, DEPTH, MD,
                                           MR)
    a, b = got.cpu().numpy(), ref.cpu().numpy()
    fc = frac_close(a, b)
    print(f"mc {label}, kernel vs plain: {fc:.5f} of lanes agree, casts {int(got_casts)} vs "
          f"{int(ref_casts)}")
    assert np.isfinite(a).all() and fc >= 0.99, (label, fc)
    assert casts_close(got_casts, ref_casts), (label, int(got_casts), int(ref_casts))
    return fc, int(got_casts)


def same_whitted(a, b):
    """Assert that two renders of one Whitted frame are equal bit for bit:
    the ladder delivers each pixel's lanes in lane order (ops/trace.deliver),
    so nothing in a frame depends on the order threads run in."""
    assert torch.equal(a, b), int(((a - b).abs().amax(dim=-1) > 0).sum())


@contextlib.contextmanager
def eager_ladder():
    """render_whitted with its ladder run eagerly, tile by tile, as on the
    CPU: the CUDA graph route (ops/ladder_graph.engages) turned off, so that
    a wrapper of the ladder's functions sees every call."""
    from raytracer_tpu_torch.ops import ladder_graph

    saved = ladder_graph.engages
    ladder_graph.engages = lambda *args, **kwargs: False
    try:
        yield
    finally:
        ladder_graph.engages = saved


def presets_phase(dev, reset_counts, read_counts, fused_kernels):
    """Phase 4: the presets, the JSON scene files and the render_* functions
    on the card (module docstring) -> the preset timings, by name."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render import (
        _clips,
        render_distributed_epoch,
        render_epochs,
        render_step,
        render_steps,
        render_whitted,
    )
    from raytracer_tpu_torch.scene import presets
    from raytracer_tpu_torch.scene.serialize import dump_builder, load_scene_dict

    small = RenderConfig(width=64, height=48, depth=DEPTH, tile_rays=64 * 48)
    full = RenderConfig(depth=DEPTH)  # 1280x960, tile_rays 65536
    cam = presets.demo_camera()  # the makers and loaders build on the card unasked

    # the oracle goldens through the kernels, gated as scripts/tpu_check.py
    # gates the demo's Whitted golden, the same frame through the plain
    # versions, and one MC epoch kernel against plain
    scenes = {name: getattr(presets, maker)() for name, maker in ORACLE_PRESETS}
    assert cam.fovy.is_cuda and all(s.tri_v.is_cuda for s in scenes.values())
    for name, scene in scenes.items():
        reset_counts()
        img, stats = render_whitted(scene, cam, small)
        launches = read_counts()
        p, bad, ok = golden_gate(img, f"oracle_{name}_64x48_d5.npy", 38.0, 0.02)
        print(f"golden oracle {name} ({scene.n_tri} triangles, {scene.n_sph} spheres) 64x48 "
              f"depth 5: psnr {p:.1f} dB, bad {bad:.4f}, dropped {stats['dropped']}; "
              f"level kernel launches {launches['level']}")
        assert ok and stats["dropped"] == 0, (name, p, bad)
        assert launches["level"] == DEPTH + 1 and launches["level_blk"] == 0, launches
        whitted_vs_plain(f"{name} 64x48", scene, cam, small)
        reset_counts()
        render_distributed_epoch(scene, cam, small)
        assert read_counts()["mc"] == 1
        mc_vs_plain(f"{name} 64x48", scene, cam, small)

    # the degenerate scenes from JSON: an empty triangle or sphere table,
    # no primitive at all (the unfused path, where nothing is cast)
    for name, data in DEGENERATE.items():
        scene = load_scene_dict(data)[0]
        assert scene.sph_c.is_cuda, name
        reset_counts()
        img, stats = render_whitted(scene, cam, small)
        photons, est = render_distributed_epoch(scene, cam, small)
        launches = read_counts()
        assert torch.isfinite(img).all() and torch.isfinite(photons).all(), name
        assert stats["dropped"] == 0, name
        print(f"degenerate scene {name} ({scene.n_tri} triangles, {scene.n_sph} spheres) "
              f"64x48: whitted casts {stats['casts']}, epoch casts {est['casts']}, filtered "
              f"{est['filtered']}; launches {launches}")
        if scene.n_prim == 0:  # sky everywhere, and no kernel launched on it
            assert not img.any() and not photons.any()
            # nothing is traced; the ladder only delivers its (black) lanes
            assert not any(v for k, v in launches.items() if k != "deliver"), launches
            cpu_img, _ = render_whitted(scene.to("cpu"), cam.to("cpu"), small)
            assert not cpu_img.any()
            continue
        assert launches["level"] == DEPTH + 1 and launches["mc"] == 1, launches
        whitted_vs_plain(f"{name} 64x48", scene, cam, small)
        mc_vs_plain(f"{name} 64x48", scene, cam, small)

    # a scene file: the demo's builder written as JSON and read back renders
    # the preset's frame and epoch; with "bvh": true, the blocked kernels
    builder = presets.demo_builder()
    data = json.loads(json.dumps(dump_builder(builder, presets.demo_camera())))
    loaded, file_cam = load_scene_dict(data)
    assert loaded.tri_v.is_cuda and file_cam.fovy.is_cuda
    demo = scenes["demo"]
    same_whitted(render_whitted(loaded, file_cam, small)[0], render_whitted(demo, cam, small)[0])
    assert torch.equal(render_distributed_epoch(loaded, file_cam, small, seed=5, epoch=2)[0],
                       render_distributed_epoch(demo, cam, small, seed=5, epoch=2)[0])
    print("scene file (dump_builder of the demo, read back): whitted frame and epoch equal "
          "bit for bit")
    blocked = load_scene_dict(dict(data, bvh=True))[0]
    assert blocked.blocked
    reset_counts()
    _, bst = render_whitted(blocked, file_cam, small)
    render_distributed_epoch(blocked, file_cam, small)
    launches = read_counts()
    print(f"scene file with \"bvh\": true ({blocked.blk_tables.n_chunks} chunk): launches "
          f"{launches}")
    assert launches["level_blk"] == DEPTH + 1 and launches["mc_blk"] == 1, launches
    assert launches["level"] == 0 and launches["mc"] == 0, launches
    whitted_vs_plain("demo 64x48 from a file with \"bvh\": true", blocked, file_cam, small)
    mc_vs_plain("demo 64x48 from a file with \"bvh\": true", blocked, file_cam, small)

    # render_step / render_steps / render_epochs on the demo at 1280x960
    reset_counts()
    accum, st = render_epochs(demo, cam, full, 4, 3, epoch=10)
    epochs_launches = read_counts()
    ref = torch.zeros_like(accum)
    singles = []
    for e in (10, 11, 12):
        photons, est = render_distributed_epoch(demo, cam, full, seed=4, epoch=e)
        ref = ref + photons
        singles.append(est)
    assert torch.equal(accum, ref), "render_epochs"
    assert st["casts"] == sum(s["casts"] for s in singles)
    assert st["filtered"] == sum(s["filtered"] for s in singles)
    assert epochs_launches["mc"] == 3 and not any(
        epochs_launches[k] for k in fused_kernels if k != "mc"), epochs_launches
    reset_counts()
    w_img, photons, step = render_step(demo, cam, full, seed=4, epoch=10)
    step_launches = read_counts()
    ref_img, wst = render_whitted(demo, cam, full)
    ref_ph, est = render_distributed_epoch(demo, cam, full, seed=4, epoch=10)
    same_whitted(w_img, ref_img)
    assert torch.equal(photons, ref_ph), "render_step's epoch"
    assert step["casts"] == wst["casts"] + est["casts"] and step["dropped"] == 0
    tiles = len(_clips(full, dev)[0])
    assert step_launches["level"] == tiles * (DEPTH + 1) and step_launches["mc"] == 1
    reset_counts()
    _, _, steps = render_steps(demo, cam, full, 4, 2, epoch=10)
    steps_launches = read_counts()
    ref_step = render_step(demo, cam, full, seed=4, epoch=11)[2]
    for k in ("casts", "filtered"):
        assert steps[k] == step[k] + ref_step[k], (k, steps, step, ref_step)
    assert steps["dropped"] == 0 and steps["steps"] == 2
    assert steps["primary_rays"] == 2 * full.width * full.height
    assert steps_launches["level"] == 2 * tiles * (DEPTH + 1) and steps_launches["mc"] == 2
    print(f"render_epochs(3) at 1280x960 = three render_distributed_epoch calls summed, bit for "
          f"bit; render_step = render_whitted + one epoch (bit for bit); render_steps(2)'s "
          f"counters the sums {steps}")

    # each preset at 1280x960, depth 5: host seconds (least of three) and
    # device busy of the Whitted frame and one MC epoch
    times = {}
    for name, scene in scenes.items():
        _, wst = render_whitted(scene, cam, full)
        _, est = render_distributed_epoch(scene, cam, full, epoch=7)
        w = profile_breakdown(f"{name} whitted frame 1280x960",
                              lambda: render_whitted(scene, cam, full))
        e = profile_breakdown(f"{name} mc epoch 1280x960",
                              lambda: render_distributed_epoch(scene, cam, full, epoch=7))
        times[name] = {"whitted_s": w["wall_s"], "whitted_busy_ms": w["device_busy_ms"],
                       "whitted_idle": w["idle"], "whitted_casts": wst["casts"],
                       "epoch_s": e["wall_s"], "epoch_busy_ms": e["device_busy_ms"],
                       "epoch_idle": e["idle"], "epoch_casts": est["casts"]}
        t = times[name]
        print(f"preset {name} 1280x960: whitted {t['whitted_s']:.4f} s "
              f"({t['whitted_casts'] / t['whitted_s']:,.0f} casts/s, busy "
              f"{t['whitted_busy_ms']:.2f} ms), mc epoch {t['epoch_s']:.4f} s "
              f"({t['epoch_casts'] / t['epoch_s']:,.0f} casts/s, busy "
              f"{t['epoch_busy_ms']:.2f} ms)")
    return times


def cli_phase():
    """The CLI on the card, four subprocesses at once: a preset, a scene
    file, --warm-cache (which writes no --out) and --profile (whose trace
    exists and whose printed top operations include the MC kernel).  A
    process that fails, or warns of a dropped ray, fails the run."""
    small = ["--width", "320", "--height", "240", "--epochs", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        out = lambda name: os.path.join(tmp, name)
        runs = {
            "preset": ["--scene", "03-recursive", *small, "--out", out("preset.png")],
            "scene file": ["--scene-file", os.path.join(HERE, "assets", "scene_spheres.json"),
                           *small, "--out", out("file.png")],
            "warm cache": ["--scene", "01-spheres", *small, "--png-every", "2", "--warm-cache",
                           "--out", out("never.png")],
            "profile": ["--scene", "06-obj", *small, "--out", out("profile.png"), "--profile",
                        out("prof")],
        }
        procs = {k: subprocess.Popen([sys.executable, "-m", "raytracer_tpu_torch", *args],
                                     cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True) for k, args in runs.items()}
        results = {}
        try:
            for k, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=300)
                results[k] = stdout
                print(f"cli {k} (rc {proc.returncode}): " + stdout.strip().replace("\n", " | ")
                      [:600])
                assert proc.returncode == 0, (k, stderr[-3000:])
                assert "dropped" not in stdout, (k, stdout[-3000:])
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        from raytracer_tpu_torch.utils.png import read_png_rgb8

        for name in ("preset.png", "file.png", "profile.png"):
            png = read_png_rgb8(out(name))
            assert png.shape == (240, 320, 3) and png.max() > 0, (name, png.shape)
        assert not os.path.exists(out("never.png"))
        assert "warm-cache:" in results["warm cache"]
        assert os.path.exists(out("prof/trace.json"))
        top = results["profile"].split("top 20 operations by self device time", 1)
        assert len(top) == 2 and "mc_kernel" in top[1], results["profile"][-2000:]


def delivery_pool(rng, n_pix, runs, dev):
    """A synthetic last-level pool: `runs` pixels, each with 1..32 lanes
    scattered over the pool, radiance over six decades -> (img [n_pix, 3],
    slot [K] int32, contrib [K, 3]) on `dev`."""
    pix = rng.choice(n_pix, size=runs, replace=False)
    slot = np.repeat(pix, rng.integers(1, 33, size=runs)).astype(np.int32)
    rng.shuffle(slot)
    contrib = rng.uniform(size=(slot.size, 3)) * 10.0 ** rng.integers(-3, 3, size=(slot.size, 1))
    return (torch.as_tensor(rng.uniform(size=(n_pix, 3)), dtype=torch.float32, device=dev),
            torch.as_tensor(slot, device=dev),
            torch.as_tensor(contrib, dtype=torch.float32, device=dev))


def binned_route(fn):
    """fn() with every blocked scene sent to the binned route
    (BINNED_MIN_TRIS lowered to 0), which the binned kernels' checks and
    timings take: by default every blocked scene walks through the blocked
    MC kernel."""
    from raytracer_tpu_torch.ops import mc_binned

    threshold, mc_binned.BINNED_MIN_TRIS = mc_binned.BINNED_MIN_TRIS, 0
    try:
        return fn()
    finally:
        mc_binned.BINNED_MIN_TRIS = threshold


def rank_sum(parts):
    """The ranks' buffers summed in rank order (the all_reduce, emulated)."""
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def nvidia_smi():
    """Each card's name and power limit, as nvidia-smi gives them, printed
    a line a card -> the lines."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for line in lines:
        print(line)
    return lines


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_devices_phase():
    """The CLI at 320x240: --devices 1 writes --devices 0's PNG byte for
    byte; --devices 2 runs on a host with two cards or more and fails with
    the device count on a host with one."""
    small = ["--width", "320", "--height", "240", "--epochs", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        runs = {n: ["--devices", str(n), *small, "--out", os.path.join(tmp, f"d{n}.png")]
                for n in (0, 1, 2)}
        procs = {n: subprocess.Popen([sys.executable, "-m", "raytracer_tpu_torch", *args],
                                     cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True) for n, args in runs.items()}
        results = {}
        try:
            for n, proc in procs.items():
                results[n] = (*proc.communicate(timeout=300), proc.returncode)
                print(f"cli --devices {n} (rc {results[n][2]}): "
                      + (results[n][0] + results[n][1][-300:]).strip().replace("\n", " | ")[:600])
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n in (0, 1):
            assert results[n][2] == 0, (n, results[n][1][-3000:])
        assert "mesh: {'dp': 1, 'sp': 1}" in results[1][0]
        with open(os.path.join(tmp, "d0.png"), "rb") as f, open(os.path.join(tmp, "d1.png"),
                                                                  "rb") as g:
            assert f.read() == g.read(), "--devices 1 and --devices 0 wrote other PNGs"
        if torch.cuda.device_count() >= 2:
            assert results[2][2] == 0 and "mesh: {'dp': 1, 'sp': 2}" in results[2][0], results[2]
        else:
            assert results[2][2] != 0 and "CUDA device(s)" in results[2][1], results[2]


def spd_phase(dev):
    """Phase 5c: the SPD sphereflake (presets.spd_balls_scene, 7,381 spheres
    over 2 floor triangles), whose scene carries the sphere chunk table, at
    the spd-balls.progressive cell's shapes (512x512, depth 5, one epoch of
    262,144 rays): the epoch's rays through mc_kernel.trace, the kernels'
    launch counts set to 0 just before it and read just after (one launch
    of the staged MC walk, its gated instantiation by the profiler's kernel
    name, nothing else), held against the plain version on the same inputs
    at the cell's photon tolerance (1e-3 + 2e-2 |ref| in every channel, on
    all but 0.5 % of lanes; casts within 1 %) and against the same scene
    without the table (the linear walk), photons and casts equal; the sphere
    and box tests a cast, counted; render_distributed_epoch's launches; and
    the gated instantiations' registers.  -> the numbers printed."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import mc_kernel
    from raytracer_tpu_torch.render import _clips, frame_draws, render_distributed_epoch, tile_draws
    from raytracer_tpu_torch.scene.presets import spd_balls_scene
    from raytracer_tpu_torch.utils import kernels

    counts = kernel_counts()

    def launched(fn):
        for c in counts.values():
            c.launches = c.plain = 0
        out = fn()
        torch.cuda.synchronize()
        assert all(c.plain == 0 for c in counts.values()), {k: c.plain for k, c in counts.items()}
        return out, {k: c.launches for k, c in counts.items() if c.launches}

    cfg = RenderConfig(width=512, height=512, depth=DEPTH)
    scene, cam = spd_balls_scene(device=dev)
    assert scene.sph_perm is not None and not scene.blocked
    linear = dataclasses.replace(scene, sph_perm=None, sph_box=None)
    seed, epoch = 2**31 + 12345, 3
    clips = _clips(cfg, dev)[0]
    normals, unifs = frame_draws([tile_draws(cfg, seed, epoch, t, c.shape[0], dev)
                                  for t, c in enumerate(clips)])
    o, d = camera_ops.shoot_focus(cam, clips.reshape(-1, 2), normals * cfg.blur, cfg.focus)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    walk = lambda sc, **kw: mc_kernel.trace(sc, o, d, unifs, DEPTH, MD, MR, **kw)

    (got, casts), ran = launched(lambda: walk(scene))
    assert ran == {"mc": 1}, ran
    _, seen = profiled_ms(lambda: walk(scene), "SphGatedGeom")
    assert seen == 1, seen
    lin, lin_casts = walk(linear)
    assert torch.equal(got, lin) and int(casts) == int(lin_casts), "gated vs linear"
    t0 = time.perf_counter()
    ref, ref_casts = mc_kernel.trace_plain(scene.geom, scene.textures, o, d, unifs, DEPTH, MD,
                                           MR)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    a, b = got.cpu().numpy(), ref.cpu().numpy()
    bad = 1.0 - frac_close(a, b)
    tests, boxes = (torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(2))
    counted, _ = walk(scene, sph_tests=tests, sph_box_tests=boxes)
    assert torch.equal(counted, got)
    per_cast = lambda x: float(x.sum()) / int(casts)
    gated_ms = device_ms(lambda: walk(scene), 3, "SphGatedGeom")
    linear_ms = device_ms(lambda: walk(linear), 1, "mc_kernel_staged")
    (img, stats), ran_epoch = launched(
        lambda: render_distributed_epoch(scene, cam, cfg, seed=seed, epoch=epoch))
    attrs = {k: kernels.kernel_attrs(k, scene.n_tri) for k in ("mc", "mc_gated", "mc_thread",
                                                               "mc_gated_thread")}
    print(f"spd-balls {cfg.width}x{cfg.height} ({scene.n_sph} spheres, {scene.sph_box.shape[0]} sphere chunks), "
          f"one epoch's {n} rays through mc_kernel.trace: launches {ran} (the gated staged "
          f"walk); kernel vs plain: {bad:.6f} of lanes off (limit 0.005), casts {int(casts)} vs "
          f"{int(ref_casts)}, max |err| {np.abs(a - b).max():.3g}, plain {plain_s:.1f} s; gated "
          f"vs linear walk: photons and casts equal; {per_cast(tests):.2f} sphere and "
          f"{per_cast(boxes):.2f} box tests a cast; device ms gated {gated_ms:.3f}, linear "
          f"{linear_ms:.3f}; render_distributed_epoch launches {ran_epoch}, casts "
          f"{stats['casts']}")
    for k, v in attrs.items():
        print(f"spd-balls {k} kernel: {v['registers']} registers/thread, {v['local_bytes']} "
              f"local bytes/thread, {v['blocks_per_sm']} blocks of 128 threads an SM")
    assert bad <= 0.005 and np.isfinite(a).all(), bad
    assert casts_close(casts, ref_casts), (int(casts), int(ref_casts))
    assert ran_epoch == {"mc": 1}, ran_epoch
    assert torch.isfinite(img).all() and float(img.max()) > 0
    return {"lanes_off": bad, "casts": int(casts), "plain_casts": int(ref_casts),
            "sph_tests_per_cast": per_cast(tests), "box_tests_per_cast": per_cast(boxes),
            "gated_ms": gated_ms, "linear_ms": linear_ms, "attrs": attrs}


def ladder_graph_phase(dev, cases):
    """Phase 5b: the Whitted ladder as CUDA graphs (module docstring) ->
    {case: its numbers}.  cases: (label, scene, camera, cfg)."""
    from raytracer_tpu_torch.ops import ladder_graph
    from raytracer_tpu_torch.render import _clips, render_whitted

    counts = kernel_counts()
    out = {}
    for label, scene, cam, cfg in cases:
        scene = dataclasses.replace(scene)  # an object of its own: no ladder captured for it yet
        tiles = len(_clips(cfg, dev)[0])

        def frame():
            """(image, stats, launches by kernel, host seconds) of one frame."""
            before = {k: c.launches for k, c in counts.items()}
            (img, stats), s = timed(lambda: render_whitted(scene, cam, cfg))
            ran = {k: c.launches - before[k] for k, c in counts.items() if c.launches != before[k]}
            return img, stats, ran, s

        with eager_ladder():
            eager = frame()
        level = "level_blk" if scene.blocked else "level"
        assert eager[1]["dropped"] == 0 and eager[2] == {level: tiles * (DEPTH + 1),
                                                          "deliver": tiles}, eager[1:3]
        capture_s, capture = [], ladder_graph._capture

        def timed_capture(*args):
            res, s = timed(lambda: capture(*args))
            capture_s.append(s)
            return res

        ladder_graph._capture = timed_capture
        try:
            first = frame()
        finally:
            ladder_graph._capture = capture
        second = frame()
        for got in (first, second):
            same_whitted(got[0], eager[0])
            assert got[1:3] == eager[1:3], (got[1:3], eager[1:3])
        ladders = {k[3]: v for k, v in ladder_graph._LADDERS.items() if k[0] == id(scene)}
        replay_ms = {width: cuda_ms(v.plain.graph.replay, 20) for width, v in ladders.items()}
        counted_ms = {width: cuda_ms(v.counted.graph.replay, 20) for width, v in ladders.items()}
        with eager_ladder():
            eager_s = min(frame()[3] for _ in range(3))
        graph_s = min(frame()[3] for _ in range(3))
        widths = [min(cfg.tile_rays, cfg.width * cfg.height - t * cfg.tile_rays)
                  for t in range(tiles)]
        busy_ms = sum(replay_ms[w] for w in widths)
        print(f"whitted ladder as CUDA graphs, {label}: the first graphed frame (it captures "
              f"{len(capture_s)} ladders, widths {sorted(ladders)}) and the second (replays) = "
              f"the eager frame bit for bit, stats and launches {eager[2]} too; capture "
              + ", ".join(f"{s:.3f}" for s in capture_s) + " s (the tile's eager run on a side "
              "stream and both graphs included); replay a tile " + ", ".join(
                  f"{w} rays {ms:.3f} ms (counted {counted_ms[w]:.3f})"
                  for w, ms in sorted(replay_ms.items()))
              + f" (device, CUDA events), {busy_ms:.2f} ms a frame; frame {eager_s * 1e3:.2f} ms "
              f"eager, {graph_s * 1e3:.2f} ms graphed (host, least of three)")
        out[label] = {"capture_s": capture_s, "replay_ms": replay_ms, "counted_ms": counted_ms,
                      "replays_ms": busy_ms, "eager_s": eager_s, "graph_s": graph_s,
                      "launches": eager[2]}
    return out


def mesh_phase(dev, reset_counts, read_counts, demo, cam, full, mesh11k, mesh11k_cam, mesh_cfg,
               single_state, single_png, smi):
    """Phase 6: multi-card rendering on the one card (module docstring) ->
    (its times, the launches of the world of one's render_progressive)."""
    import torch.distributed as dist

    from raytracer_tpu_torch.ops import trace as trace_ops
    from raytracer_tpu_torch.ops.camera import shoot
    from raytracer_tpu_torch.ops.tonemap import post_process
    from raytracer_tpu_torch.parallel import mesh as pm
    from raytracer_tpu_torch.parallel.progressive import render_progressive
    from raytracer_tpu_torch.render import _clips, _epoch, render_distributed_epoch, render_whitted
    from raytracer_tpu_torch.utils.color import linear_to_u8
    from raytracer_tpu_torch.utils.png import read_png_rgb8

    t_phase = time.time()
    rng = np.random.default_rng(6)
    tiles = len(_clips(full, dev)[0])
    # A1: the Whitted frame repeats, and the delivery kernel sums as the
    # CPU's index_add does, on a real tile's last pool and a synthetic one
    ref, ref_st = render_whitted(demo, cam, full)
    same_whitted(render_whitted(demo, cam, full)[0], ref)
    calls = capture([(trace_ops, "deliver")], lambda: trace_ops.trace_whitted(
        demo, *shoot(cam, _clips(full, dev)[0][9]), full))["deliver"]
    assert len(calls) == 1, len(calls)
    pools = {"tile 9's last level": calls[0][0],
             "synthetic, runs of 1-32 lanes": delivery_pool(rng, 65536, 20000, dev)}
    for label, (img, slot, contrib) in pools.items():
        got = trace_ops.deliver(img, slot, contrib).cpu()
        want = img.cpu().index_add(0, slot.cpu().long(), contrib.cpu())
        atomics = img.index_add(0, slot.long(), contrib).cpu()
        print(f"deliver, {label} ({slot.numel()} lanes into {int(slot.unique().numel())} pixels): "
              f"kernel vs the CPU's index_add {'bit for bit' if torch.equal(got, want) else 'DIFFERENT'}; "
              f"the card's index_add moves {int((atomics != want).any(dim=1).sum())} pixels")
        assert torch.equal(got, want), label
    print("whitted frame 1280x960 rendered twice: equal bit for bit")

    # larger worlds, their rank bodies one after another on this card
    single_epoch, single_est = render_distributed_epoch(demo, cam, full, seed=2, epoch=5)
    sample1 = _epoch(demo, cam, full, 2, 5, None, sample=1)[0]
    for dp, sp in ((4, 1), (2, 2), (8, 1)):
        ranks = [pm.RenderMesh(dp=dp, sp=sp, rank=r) for r in range(dp * sp)]
        w = [pm.whitted_body(demo, cam, full, m) for m in ranks]
        e = [pm.epoch_body(demo, cam, full, m, 2, 5) for m in ranks]
        assert torch.equal(rank_sum([x[0] for x in w]), ref), (dp, sp)
        assert rank_sum([x[1] for x in w]).tolist() == [ref_st["casts"], 0], (dp, sp)
        want = single_epoch if sp == 1 else single_epoch + sample1
        assert torch.equal(rank_sum([x[0] for x in e]), want), (dp, sp)
        if sp == 1:
            assert rank_sum([x[1] for x in e]).tolist() == [single_est["casts"],
                                                            single_est["filtered"]]
        print(f"emulated world ({dp}, {sp}), demo 1280x960: whitted frame = the single card's bit "
              f"for bit, casts summed; mc epoch = "
              f"{'the single card' if sp == 1 else 'samples 0 + 1'} bit for bit")
    m_ref, m_st = render_whitted(mesh11k, mesh11k_cam, mesh_cfg)
    m_ep, m_est = render_distributed_epoch(mesh11k, mesh11k_cam, mesh_cfg, seed=2, epoch=5)
    ranks = [pm.RenderMesh(dp=4, sp=1, rank=r) for r in range(4)]
    w = [pm.whitted_body(mesh11k, mesh11k_cam, mesh_cfg, m) for m in ranks]
    e = [pm.epoch_body(mesh11k, mesh11k_cam, mesh_cfg, m, 2, 5) for m in ranks]
    assert torch.equal(rank_sum([x[0] for x in w]), m_ref)
    assert rank_sum([x[1] for x in w]).tolist() == [m_st["casts"], 0]
    assert torch.equal(rank_sum([x[0] for x in e]), m_ep)
    assert rank_sum([x[1] for x in e]).tolist() == [m_est["casts"], m_est["filtered"]]
    print("emulated world (4, 1), mesh11k 1024x1024 (blocked kernels): whitted frame and mc "
          "epoch = the single card's bit for bit")

    # an NCCL world of one: the collective functions and the main path
    pm.init_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    times = {}
    try:
        mesh = pm.make_render_mesh()
        assert mesh.shape == {"dp": 1, "sp": 1} and mesh.group is not None
        img, st = pm.render_whitted_sharded(demo, cam, full, mesh)
        assert torch.equal(img, ref) and st == ref_st, (st, ref_st)
        accum = post_process(ref)
        a3, u3, c3 = pm.train_steps_sharded(demo, cam, full, mesh, accum, 0, 3, 0)
        a, counters = accum, [0, 0]
        for epoch in range(3):
            photons, est = render_distributed_epoch(demo, cam, full, seed=0, epoch=epoch)
            a = post_process(a + photons)
            counters = [counters[0] + est["casts"], counters[1] + est["filtered"]]
        assert torch.equal(a3, a) and torch.equal(u3, linear_to_u8(a))
        assert c3.tolist() == counters, (c3.tolist(), counters)
        lines = []
        reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "mesh.png")
            state = render_progressive(demo, cam, full, out_path=out, log=lines.append,
                                       mesh=mesh)
            launches = read_counts()
            png = read_png_rgb8(out)
        print(f"main path (demo, an NCCL world of one): render_progressive whitted + "
              f"{full.epochs} epochs at 1280x960; launches {launches}")
        assert torch.equal(state.img, single_state.img), "render_progressive's frame"
        assert np.array_equal(png, single_png), "render_progressive's PNG"
        assert launches["level"] == tiles * (DEPTH + 1) and launches["mc"] == full.epochs
        assert launches["deliver"] == tiles, launches
        assert not any("dropped" in m for m in lines), lines
        print("world of one (NCCL): render_whitted_sharded, train_steps_sharded(k=3) and "
              "render_progressive = the single card bit for bit")
        # times: the world of one against the single card, and the
        # all_reduce of the 1280x960 frame buffer
        best = lambda fn: min(timed(fn)[1] for _ in range(3))
        times = {
            "whitted_single_s": best(lambda: render_whitted(demo, cam, full)),
            "whitted_world1_s": best(lambda: pm.render_whitted_sharded(demo, cam, full, mesh)),
            "epoch_single_s": best(lambda: render_distributed_epoch(demo, cam, full, epoch=7)),
            "epoch_world1_s": best(lambda: pm.render_mc_epoch_sharded(demo, cam, full, mesh, 0,
                                                                       7)),
        }
        buf = torch.rand((full.height, full.width, 3), device=dev)
        times["all_reduce_frame_ms"] = cuda_ms(
            lambda: dist.all_reduce(buf, group=mesh.group), 20)
        times["all_reduce_bytes"] = nbytes(buf)
    finally:
        dist.destroy_process_group()
    print(f"{smi}: whitted frame 1280x960 single card {times['whitted_single_s']:.4f} s, world of "
          f"one {times['whitted_world1_s']:.4f} s; mc epoch single card "
          f"{times['epoch_single_s']:.4f} s, world of one {times['epoch_world1_s']:.4f} s (host "
          f"seconds, least of three); all_reduce of the {times['all_reduce_bytes']:,} B frame "
          f"buffer (a world of one) {times['all_reduce_frame_ms']:.4f} ms (CUDA events)")

    cli_devices_phase()
    times["phase_s"] = time.time() - t_phase
    print(f"phase 6 took {times['phase_s']:.1f} s")
    return times, launches


# ---- phase 7: a real world on the host's cards ------------------------------

@dataclasses.dataclass(frozen=True)
class MulticardSpec:
    """Phase 7's work: the demo at `demo` (Whitted + demo.epochs epochs of
    `seed`, from epoch 0), mesh_scene(`grid`) at `mesh`, on `device`
    ("cuda": rank r on cuda:r, NCCL; "cpu": gloo, the rehearsal); host
    seconds the least of `reps`; the CLI's wall over `wall_epochs` epochs."""

    demo: RenderConfig
    grid: int
    mesh: RenderConfig
    seed: int = 0
    reps: int = 3
    device: str = "cuda"
    wall_epochs: int = 100


def card_spec():
    """Phase 7 on the cards: the demo at 1280x960, depth 5, 3 epochs;
    mesh11k (mesh_scene(75)) at 1024x1024, depth 5; tiles of 65536."""
    from raytracer_tpu_torch.config import RenderConfig

    return MulticardSpec(demo=RenderConfig(depth=DEPTH, epochs=3), grid=75,
                         mesh=RenderConfig(width=1024, height=1024, depth=DEPTH))


def _to(x, dev):
    """A reference (a tensor, or a tuple of them and numbers) on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    return x


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """Host seconds of fn() between two synchronisations of `dev`."""
    _sync(dev)
    t = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t


def _barrier(dev, group):
    """Every rank of `group` here, and this device idle."""
    import torch.distributed as dist

    _sync(dev)
    dist.all_reduce(torch.zeros(1, device=dev), group=group)
    _sync(dev)


def multicard_refs(dev, spec, world):
    """Phase 7's references on one device, for a world of `world` ranks:
    the single device's demo Whitted frame, its epochs and the train
    steps over them (accumulator, u8, counters: render_progressive's state
    and PNG), the same epochs and steps over the emulated rank bodies of the
    world's sample-parallel mesh (make_render_mesh: samples 0 and 1 summed,
    as phase 6 sums them), and mesh_scene(grid)'s frame, first epoch and
    that epoch on the binned route -> a dict of CPU tensors and numbers."""
    from raytracer_tpu_torch.ops.tonemap import post_process
    from raytracer_tpu_torch.parallel import mesh as pm
    from raytracer_tpu_torch.parallel.progressive import write_image
    from raytracer_tpu_torch.render import render_distributed_epoch, render_whitted
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene, mesh_scene
    from raytracer_tpu_torch.utils.color import linear_to_u8

    cfg, seed = spec.demo, spec.seed
    demo, cam = demo_scene(device=dev), demo_camera(device=dev)
    whitted, wst = render_whitted(demo, cam, cfg)
    sp_mesh = pm.make_render_mesh(world)
    ranks = [pm.RenderMesh(dp=sp_mesh.dp, sp=sp_mesh.sp, rank=r) for r in range(world)]
    accum = emulated = post_process(whitted)
    epochs, epoch_stats, emulated_epochs, counters = [], [], [], [0, 0]
    for epoch in range(cfg.epochs):
        photons, est = render_distributed_epoch(demo, cam, cfg, seed=seed, epoch=epoch)
        epochs.append(photons)
        epoch_stats.append(est)
        counters = [counters[0] + est["casts"], counters[1] + est["filtered"]]
        accum = post_process(accum + photons)
        parts = [pm.epoch_body(demo, cam, cfg, m, seed, epoch)[0] for m in ranks]
        emulated_epochs.append(rank_sum(parts))
        emulated = post_process(emulated + emulated_epochs[-1])
    with tempfile.TemporaryDirectory() as tmp:
        write_image(os.path.join(tmp, "ref.png"), accum)
        with open(os.path.join(tmp, "ref.png"), "rb") as f:
            png = f.read()
    scene, mcam = mesh_scene(spec.grid, device=dev)
    m_whitted, m_wst = render_whitted(scene, mcam, spec.mesh)
    m_epoch, m_est = render_distributed_epoch(scene, mcam, spec.mesh, seed=seed)
    b_epoch, b_est = binned_route(lambda: render_distributed_epoch(scene, mcam, spec.mesh,
                                                                   seed=seed))
    cpu = lambda t: t.cpu()
    return {"whitted": cpu(whitted), "whitted_stats": wst, "epochs": tuple(map(cpu, epochs)),
            "epoch_stats": epoch_stats, "steps": (cpu(accum), cpu(linear_to_u8(accum)), counters),
            "png": png, "emulated_epochs": tuple(map(cpu, emulated_epochs)),
            "emulated_steps": (cpu(emulated), cpu(linear_to_u8(emulated))),
            "mesh_whitted": cpu(m_whitted), "mesh_whitted_stats": m_wst,
            "mesh_epoch": cpu(m_epoch), "mesh_epoch_stats": m_est, "binned_epoch": cpu(b_epoch),
            "binned_epoch_stats": b_est}


def multicard_body(dev, mesh, spec, refs, out_dir):
    """Phase 7 on rank mesh.rank of a world of mesh.world processes, one a
    device; `mesh` is the world's sample-parallel mesh (make_render_mesh:
    (2, 2) on four ranks, (1, 2) on two) and `refs` multicard_refs'
    (module docstring, phase 7).  Rank 0 writes the PNGs into `out_dir`:
    dp.png (the dp-only world's render_progressive), full.png and part.png
    (the sample-parallel world's, uninterrupted and resumed) and, in a
    world of more than two, pair.png (ranks 0 and 1 as a (1, 2) mesh).
    Every check raises; host seconds, each rank's device busy and the
    all_reduces' times come back -> a dict of numbers."""
    import torch.distributed as dist

    from raytracer_tpu_torch.ops import level_kernel, mc_kernel
    from raytracer_tpu_torch.ops import trace as trace_ops
    from raytracer_tpu_torch.ops.tonemap import post_process
    from raytracer_tpu_torch.parallel import mesh as pm
    from raytracer_tpu_torch.parallel.progressive import render_progressive
    from raytracer_tpu_torch.render import _clips
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene, mesh_scene

    n, rank, group, lead = mesh.world, mesh.rank, mesh.group, mesh.rank == 0
    on_card = dev.type == "cuda"
    cfg, seed, depth = spec.demo, spec.seed, spec.demo.depth
    dp_only = pm.RenderMesh(dp=n, sp=1, rank=rank, group=group)
    pair_group = dist.new_group([0, 1]) if n > 2 else None  # every rank joins it
    pair = pm.RenderMesh(dp=1, sp=2, rank=rank, group=pair_group) if n > 2 and rank < 2 \
        else None
    refs = {k: _to(v, dev) for k, v in refs.items()}
    out = {"rank": rank, "world": n, "device": str(dev)}

    def on_mine(*ts):
        for t in ts:
            assert t.device == dev, (t.device, dev)

    # 1. this rank's own device, and the scene on it
    if on_card:
        assert torch.cuda.current_device() == rank == dev.index, (torch.cuda.current_device(),
                                                                   rank, dev)
        out["device_name"] = torch.cuda.get_device_name(dev)
    demo, cam = demo_scene(device=dev), demo_camera(device=dev)
    assert demo.device == dev, demo.device

    # 2. the dp-only world = the single device, bit for bit
    img, st = pm.render_whitted_sharded(demo, cam, cfg, dp_only)
    on_mine(img)
    assert torch.equal(img, refs["whitted"]) and st == refs["whitted_stats"], st
    assert st["dropped"] == 0
    photons, est = pm.render_mc_epoch_sharded(demo, cam, cfg, dp_only, seed, 0)
    on_mine(photons)
    assert torch.equal(photons, refs["epochs"][0])
    assert dict(est, samples_per_pixel=None) == dict(refs["epoch_stats"][0],
                                                     samples_per_pixel=None), est
    accum = post_process(img)
    steps = pm.train_steps_sharded(demo, cam, cfg, dp_only, accum, seed, cfg.epochs, 0)
    on_mine(*steps)
    assert torch.equal(steps[0], refs["steps"][0]) and torch.equal(steps[1], refs["steps"][1])
    assert steps[2].tolist() == refs["steps"][2], (steps[2].tolist(), refs["steps"][2])
    counts = {"level": level_kernel.COUNTS, "mc": mc_kernel.COUNTS,
              "deliver": trace_ops.DELIVER_COUNTS, "level_thread": level_kernel.COUNTS_THREAD,
              "mc_thread": mc_kernel.COUNTS_THREAD}
    for c in counts.values():
        c.launches = c.plain = 0
    lines, stats = [], []
    state = render_progressive(demo, cam, cfg, out_path=os.path.join(out_dir, "dp.png"),
                               seed=seed, log=lines.append,
                               on_epoch=lambda e, s: stats.append(s), mesh=dp_only)
    ran = {k: (c.launches, c.plain) for k, c in counts.items()}
    got = {k: v[0 if on_card else 1] for k, v in ran.items()}
    assert all(v[1 if on_card else 0] == 0 for v in ran.values()), ran
    n_tiles = len(_clips(cfg, dev)[0])
    mine = len(pm.rank_tiles(n_tiles, n, rank))
    assert got == {"level": mine * (depth + 1), "mc": cfg.epochs, "deliver": mine,
                   "level_thread": 0, "mc_thread": 0}, (rank, got)
    out["launches"] = got
    total = torch.tensor([got["level"], got["mc"], got["deliver"]], device=dev)
    dist.all_reduce(total, group=group)
    assert total.tolist() == [n_tiles * (depth + 1), n * cfg.epochs, n_tiles], total.tolist()
    out["launches_world"] = dict(zip(("level", "mc", "deliver"), total.tolist()))
    assert torch.equal(state.img, refs["steps"][0])
    if lead:
        with open(os.path.join(out_dir, "dp.png"), "rb") as f:
            assert f.read() == refs["png"], "the dp-only world's PNG"
        assert [(s["casts"], s["filtered"]) for s in stats] == [
            (s["casts"], s["filtered"]) for s in refs["epoch_stats"]], stats
        assert not any("dropped" in m for m in lines), lines

    # 3. the sample-parallel world = the emulated rank bodies, bit for bit
    img, st = pm.render_whitted_sharded(demo, cam, cfg, mesh)
    assert torch.equal(img, refs["whitted"]) and st["dropped"] == 0
    photons, est = pm.render_mc_epoch_sharded(demo, cam, cfg, mesh, seed, 0)
    assert torch.equal(photons, refs["emulated_epochs"][0]) and est["samples_per_pixel"] == 2
    steps = pm.train_steps_sharded(demo, cam, cfg, mesh, accum, seed, cfg.epochs, 0)
    assert torch.equal(steps[0], refs["emulated_steps"][0])
    assert torch.equal(steps[1], refs["emulated_steps"][1])

    # 4. mesh_scene(grid) on the dp-only world: frame, epoch, binned epoch
    scene, mcam = mesh_scene(spec.grid, device=dev)
    assert scene.blocked and scene.device == dev
    img, st = pm.render_whitted_sharded(scene, mcam, spec.mesh, dp_only)
    assert torch.equal(img, refs["mesh_whitted"]) and st == refs["mesh_whitted_stats"], st
    photons, est = pm.render_mc_epoch_sharded(scene, mcam, spec.mesh, dp_only, seed, 0)
    assert torch.equal(photons, refs["mesh_epoch"]) and est["casts"] == refs[
        "mesh_epoch_stats"]["casts"]
    photons, est = binned_route(lambda: pm.render_mc_epoch_sharded(scene, mcam, spec.mesh,
                                                                   dp_only, seed, 0))
    assert torch.equal(photons, refs["binned_epoch"]) and est["casts"] == refs[
        "binned_epoch_stats"]["casts"]

    # 5. checkpoint across ranks: one epoch, then resumed to all of them,
    # writes the uninterrupted render's PNG byte for byte
    path = lambda name: os.path.join(out_dir, name)
    run = lambda epochs, name, ckpt, log: render_progressive(
        demo, cam, dataclasses.replace(cfg, epochs=epochs), out_path=path(name), seed=seed,
        checkpoint_path=path("ck.npz") if ckpt else None, log=log, mesh=mesh)
    full = run(cfg.epochs, "full.png", False, lambda m: None)
    assert torch.equal(full.img, refs["emulated_steps"][0])
    run(1, "part.png", True, lambda m: None)
    lines = []
    resumed = run(cfg.epochs, "part.png", True, lines.append)
    assert torch.equal(resumed.img, full.img)
    if lead:
        with open(path("part.png"), "rb") as f, open(path("full.png"), "rb") as g:
            assert f.read() == g.read(), "the resumed PNG"
        assert "resumed at epoch 1" in lines, lines
    if pair is not None:  # the CLI's --devices 2 on a larger host
        state = render_progressive(demo, cam, cfg, out_path=path("pair.png"), seed=seed,
                                   log=lambda m: None, mesh=pair)
        assert torch.equal(state.img, refs["emulated_steps"][0])

    # the numbers: host seconds (the slowest rank's, the least of reps),
    # each rank's device busy, the all_reduces
    def world_s(fn):
        best = float("inf")
        for _ in range(spec.reps):
            _barrier(dev, group)
            t = time.perf_counter()
            fn()
            _sync(dev)
            dt = torch.tensor([time.perf_counter() - t], dtype=torch.float64, device=dev)
            dist.all_reduce(dt, op=dist.ReduceOp.MAX, group=group)
            best = min(best, float(dt))
        return best

    def busy_ms(fn):
        """(this rank's own device ms, NCCL's, its own device operations)
        over one fn(), from torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        _barrier(dev, group)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            _sync(dev)
        own = comm = 0.0
        ops = 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            if "nccl" in e.key.lower():
                comm += us / 1e3
            else:
                own += us / 1e3
                ops += e.count if us > 0 else 0
        return own, comm, ops

    timed_calls = {"demo (%d, 1)" % n: (demo, cam, cfg, dp_only),
                   "demo (%d, %d)" % (mesh.dp, mesh.sp): (demo, cam, cfg, mesh),
                   "mesh (%d, 1)" % n: (scene, mcam, spec.mesh, dp_only)}
    out["times"] = {}
    for label, (sc, ca, cf, m) in timed_calls.items():
        whitted = lambda: pm.render_whitted_sharded(sc, ca, cf, m)
        epoch = lambda: pm.render_mc_epoch_sharded(sc, ca, cf, m, seed, 7)
        row = {"whitted_s": world_s(whitted), "epoch_s": world_s(epoch),
               "samples_per_pixel": m.sp}
        if on_card:
            for kind, fn in (("whitted", whitted), ("epoch", epoch)):
                busy = busy_ms(fn)
                row.update(zip((f"{kind}_busy_ms", f"{kind}_nccl_ms", f"{kind}_ops"), busy))
        out["times"][label] = row
    if on_card:
        bufs = {"demo frame": torch.rand((cfg.height, cfg.width, 3), device=dev),
                "mesh frame": torch.rand((spec.mesh.height, spec.mesh.width, 3), device=dev),
                "counters": torch.zeros((2,), dtype=torch.int64, device=dev)}
        out["all_reduce"] = {}
        def reduce_ms(buf, g):
            """all_reduce(buf) over group g, 20 times: the device's time
            (queued behind a sleep) and, back to back, the host's pace."""
            row = {"bytes": nbytes(buf), "ranks": dist.get_world_size(g)}
            _barrier(dev, g)
            row["ms"] = queued_ms(lambda: dist.all_reduce(buf, group=g), 20)
            _barrier(dev, g)
            row["back_to_back_ms"] = cuda_ms(lambda: dist.all_reduce(buf, group=g), 20)
            return row

        out["all_reduce"] = {label: reduce_ms(buf, group) for label, buf in bufs.items()}
        if pair is not None:
            out["all_reduce"]["demo frame, 2 ranks"] = reduce_ms(bufs["demo frame"], pair_group)
    _barrier(dev, group)
    return out


def _multicard_worker(rank, world, port, tmp, spec):
    """Rank `rank` of phase 7's world: join it on this host's `port`, run
    multicard_body on its device with the references in tmp/refs.pt, and
    write what it returns into tmp/result<rank>.json."""
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from raytracer_tpu_torch.parallel import mesh as pm

    dev = pm.init_multihost(f"127.0.0.1:{port}", world, rank, device=spec.device)
    try:
        refs = torch.load(os.path.join(tmp, "refs.pt"), weights_only=False)
        out = multicard_body(dev, pm.make_render_mesh(), spec, refs, tmp)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result{rank}.json"), "w") as f:
        json.dump(out, f)


def _stamped(args, env):
    """Run the CLI with `args` -> (rc, [(seconds since the start, stdout
    line)], seconds to exit, stderr's tail).  Lines are stamped as they
    arrive (the child writes unbuffered)."""
    with tempfile.TemporaryFile("w+") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "raytracer_tpu_torch", *args], cwd=HERE,
                                stdout=subprocess.PIPE, stderr=err, text=True,
                                env=dict(os.environ, PYTHONUNBUFFERED="1", **env))
        try:
            lines = [(time.perf_counter() - t0, line.rstrip("\n")) for line in proc.stdout]
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        end = time.perf_counter() - t0
        err.seek(0)
        return rc, lines, end, err.read()[-3000:]


def _wall_parts(lines, end):
    """A render's wall in parts from its stamped lines: `start` (to the
    Whitted pass's beginning: imports, spawn and group init, scene build),
    `whitted` (its own log line's ms), `epochs` (the Whitted line to the
    last epoch's), `exit`; and, with --devices, `spawn_init` (to rank 0's
    mesh line)."""
    rays = [(t, float(re.search(r" rays in (\d+) ms", line).group(1)) / 1e3)
            for t, line in lines if " rays in " in line]
    parts = {"start_s": rays[0][0] - rays[0][1], "whitted_s": rays[0][1],
             "epochs_s": rays[-1][0] - rays[0][0], "exit_s": end - rays[-1][0], "wall_s": end,
             "epoch_lines": len(rays) - 1}
    mesh = [t for t, line in lines if line.startswith("mesh: ")]
    if mesh:
        parts["spawn_init_s"] = mesh[0]
    return parts


def multicard_phase(spec, smi):
    """Phase 7 (module docstring) over every device up to 4: the
    references and the single card's times on the first device, the world
    spawned (one process a device), then the CLI -> its numbers."""
    import torch.multiprocessing as mp

    from raytracer_tpu_torch.render import render_distributed_epoch, render_whitted
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene, mesh_scene

    t_phase = time.time()
    on_card = spec.device == "cuda"
    world = min(torch.cuda.device_count(), 4) if on_card else 4
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    refs = multicard_refs(dev, spec, world)
    # the single device's same calls, the least of reps
    single = {}
    demo, cam = demo_scene(device=dev), demo_camera(device=dev)
    scene, mcam = mesh_scene(spec.grid, device=dev)
    for label, (sc, ca, cf) in {"demo": (demo, cam, spec.demo),
                                "mesh": (scene, mcam, spec.mesh)}.items():
        best = lambda fn: min(_timed(dev, fn) for _ in range(spec.reps))
        single[label] = {"whitted_s": best(lambda: render_whitted(sc, ca, cf)),
                         "epoch_s": best(lambda: render_distributed_epoch(sc, ca, cf, spec.seed,
                                                                          7))}
    del demo, cam, scene, mcam
    out = {"world": world, "single": single, "smi": smi}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(refs, os.path.join(tmp, "refs.pt"))
        t = time.time()
        mp.start_processes(_multicard_worker, args=(world, free_port(), tmp, spec),
                           nprocs=world, start_method="spawn")
        out["world_s"] = time.time() - t
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.json")) as f:
                ranks.append(json.load(f))
        print(f"phase 7: a world of {world} ({spec.device}; "
              + ", ".join(f"rank {x['rank']} on {x['device']}" for x in ranks)
              + f") in {out['world_s']:.1f} s: every check held; launches on the dp-only "
              f"world's render_progressive by rank " + "; ".join(
                  f"{x['rank']}: {x['launches']}" for x in ranks)
              + f"; the world's sum {ranks[0]['launches_world']}")
        out["ranks"] = ranks
        # 6. the CLI: its PNG is the same world's, byte for byte
        shape = ["--width", str(spec.demo.width), "--height", str(spec.demo.height),
                 "--depth", str(spec.demo.depth), "--tile-rays", str(spec.demo.tile_rays),
                 "--seed", str(spec.seed), "--device", spec.device]
        env = {} if on_card else {"OMP_NUM_THREADS": "1"}
        for devices in ((4, 2) if world >= 4 else (2,)):
            want = "full.png" if devices == world else "pair.png"
            png = os.path.join(tmp, f"cli{devices}.png")
            rc, lines, _, err = _stamped(["--devices", str(devices), *shape, "--epochs",
                                          str(spec.demo.epochs), "--out", png], env)
            text = " | ".join(line for _, line in lines)
            print(f"cli --devices {devices} --epochs {spec.demo.epochs} (rc {rc}): {text[:400]}")
            assert rc == 0, err
            mesh_line = f"mesh: {{'dp': {devices // 2}, 'sp': 2}}"
            assert mesh_line in text, (mesh_line, text)
            with open(png, "rb") as f, open(os.path.join(tmp, want), "rb") as g:
                assert f.read() == g.read(), f"--devices {devices} wrote another PNG than {want}"
        out["cli_wall"] = {}
        for devices in (world, 0):
            rc, lines, end, err = _stamped(
                ["--devices", str(devices), *shape, "--epochs", str(spec.wall_epochs), "--out",
                 os.path.join(tmp, f"wall{devices}.png")], env)
            assert rc == 0, err
            parts = _wall_parts(lines, end)
            assert parts["epoch_lines"] == spec.wall_epochs, parts
            out["cli_wall"][f"--devices {devices}"] = parts
    if on_card:  # phase 6's CLI check, whose --devices 2 runs here
        cli_devices_phase()
    out["phase_s"] = time.time() - t_phase
    report_multicard(out, spec)
    return out


def report_multicard(out, spec):
    """Phase 7's numbers on lines of their own."""
    world, single, ranks = out["world"], out["single"], out["ranks"]
    for label in ranks[0]["times"]:
        rows = [x["times"][label] for x in ranks]
        base = single["mesh" if label.startswith("mesh") else "demo"]
        w, e = rows[0]["whitted_s"], rows[0]["epoch_s"]
        sp = rows[0]["samples_per_pixel"]
        line = (f"{label}: whitted frame {w:.4f} s (one device {base['whitted_s']:.4f} s, "
                f"{base['whitted_s'] / w:.2f}x), mc epoch {e:.4f} s (one device "
                f"{base['epoch_s']:.4f} s, {base['epoch_s'] / e:.2f}x); {sp / e:.1f} samples a "
                f"pixel a second (one device {1 / base['epoch_s']:.1f}); host seconds, the "
                f"slowest rank's, least of {spec.reps}")
        if "whitted_busy_ms" in rows[0]:
            for kind in ("whitted", "epoch"):
                busy = [r[f"{kind}_busy_ms"] for r in rows]
                nccl = [r[f"{kind}_nccl_ms"] for r in rows]
                ops = [r[f"{kind}_ops"] for r in rows]
                line += (f"; {kind} device busy by rank " + ", ".join(f"{b:.2f}" for b in busy)
                         + f" ms (busiest / least {max(busy) / max(min(busy), 1e-9):.2f}; "
                         f"device operations " + ", ".join(map(str, ops)) + "), NCCL "
                         + ", ".join(f"{c:.3f}" for c in nccl) + " ms")
        print(line)
    if "all_reduce" in ranks[0]:
        for label, row in ranks[0]["all_reduce"].items():
            n = row["ranks"]
            bound = 2 * (n - 1) / n * row["bytes"] / NVLINK_BYTES_S * 1e3
            slowest = max(x["all_reduce"][label]["ms"] for x in ranks if label in x["all_reduce"])
            print(f"all_reduce of the {label} ({row['bytes']:,} B) over {n} ranks: device "
                  f"{row['ms']:.4f} ms on rank 0, {slowest:.4f} ms on the slowest (CUDA events "
                  f"over 20 queued behind a sleep); back to back {row['back_to_back_ms']:.4f} ms "
                  f"on rank 0 (the host's pace); NVLink bound {bound:.5f} ms (a ring moves "
                  f"2(N-1)/N of the bytes through each card at 450 GB/s each way, latency not "
                  f"counted: a reckoning from the data sheet)")
    for label, parts in out["cli_wall"].items():
        print(f"cli {label} --epochs {spec.wall_epochs} at {spec.demo.width}x{spec.demo.height}: "
              f"wall {parts['wall_s']:.2f} s = start {parts['start_s']:.2f} s"
              + (f" (of it spawn and group init {parts['spawn_init_s']:.2f} s)"
                 if "spawn_init_s" in parts else "")
              + f" + whitted {parts['whitted_s']:.3f} s + epochs {parts['epochs_s']:.2f} s + "
              f"exit {parts['exit_s']:.2f} s")
    print(f"phase 7 took {out['phase_s']:.1f} s")


def kernel_counts():
    """Every kernel wrapper's count by name: `launches` where it launched
    its kernel, `plain` where it ran the plain version (a CPU tensor)."""
    from raytracer_tpu_torch.ops import (
        intersect_kernel,
        level_kernel,
        march_kernel,
        mc_binned,
        mc_kernel,
    )
    from raytracer_tpu_torch.ops import trace as trace_ops

    return {
        "level": level_kernel.COUNTS, "level_blk": level_kernel.COUNTS_BLK,
        "mc": mc_kernel.COUNTS, "mc_blk": mc_kernel.COUNTS_BLK,
        "binned_primary": mc_binned.COUNTS_PRIMARY,
        "binned_bounce": mc_binned.COUNTS_BOUNCE,
        "binned_terminal": mc_binned.COUNTS_TERMINAL,
        # the per-thread yardsticks of the staged and cooperative walks: no
        # main path launches them
        "level_thread": level_kernel.COUNTS_THREAD, "mc_thread": mc_kernel.COUNTS_THREAD,
        "level_blk_thread": level_kernel.COUNTS_BLK_THREAD,
        "mc_blk_thread": mc_kernel.COUNTS_BLK_THREAD,
        "binned_primary_thread": mc_binned.COUNTS_PRIMARY_THREAD,
        "binned_bounce_thread": mc_binned.COUNTS_BOUNCE_THREAD,
        "binned_terminal_thread": mc_binned.COUNTS_TERMINAL_THREAD,
        "nearest_hit_thread": intersect_kernel.COUNTS_NEAREST_THREAD,
        "any_hit_thread": intersect_kernel.COUNTS_ANY_THREAD,
        "shadow_any_hit_thread": intersect_kernel.COUNTS_SHADOW_THREAD,
        "march_thread": march_kernel.COUNTS_THREAD,
        "nearest_hit": intersect_kernel.COUNTS_NEAREST, "any_hit": intersect_kernel.COUNTS_ANY,
        "shadow_any_hit": intersect_kernel.COUNTS_SHADOW, "march": march_kernel.COUNTS,
        # the Whitted ladder's ordered delivery (a kernel of the port only)
        "deliver": trace_ops.DELIVER_COUNTS,
    }


# ---- phase 8: the full reference schedule, scored and profiled --------------

SCALES = ("raw", "down4", "down8")
# the JAX package's rule (tests/test_reference_golden.py:53-78): a render of
# the schedule scores within this of the two-seed noise floor at every scale
FLOOR_MARGIN_DB = 0.6


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Phase 8's work: the demo at width x height, depth 5, a Whitted pass
    and `epochs` epochs on `device`, seed 0 through the CLI and seed 1
    through render_progressive, scored against `goldens` (the JAX
    package's renders of seeds 0 and 1) and their noise floor in
    `floor_json` (its self_psnr_*); then the epoch loop profiled at each
    group size K in `png_every` over max(profile_epochs, 6 K) epochs, so
    that at least five groups past the first are timed.  The card's spec
    is the reference schedule; tests/test_torch_fidelity.py runs a small
    one on the CPU against the port's own renders."""

    width: int = 1280
    height: int = 960
    epochs: int = 100
    profile_epochs: int = 20
    png_every: tuple = (1, 10)
    device: str = "cuda"
    goldens: tuple = (os.path.join(HERE, "artifacts", "out.png"),
                      os.path.join(HERE, "artifacts", "out_seed1.png"))
    floor_json: str = os.path.join(HERE, "artifacts", "PSNR.json")

    def cli_args(self):
        """The CLI's flags beyond --seed and --out: none for the reference
        schedule, which is the CLI's defaults."""
        if (self.width, self.height, self.epochs, self.device) == (1280, 960, 100, "cuda"):
            return []
        return ["--width", str(self.width), "--height", str(self.height), "--epochs",
                str(self.epochs), "--device", self.device]


def route_counts(counts, device):
    """The kernels' counts since they were set to 0, on the route that a
    tensor on `device` takes: launches on the card, plain calls on the CPU
    (the other route's counts must be 0)."""
    on, off = ("launches", "plain") if device == "cuda" else ("plain", "launches")
    assert not any(getattr(c, off) for c in counts.values()), {
        k: getattr(c, off) for k, c in counts.items()}
    return {k: getattr(c, on) for k, c in counts.items()}


def pixels_sha256(path):
    """The hash of a PNG's decoded u8 pixels (equal pixels, whatever the
    writer that encoded them)."""
    from raytracer_tpu_torch.utils.png import read_png_rgb8

    return hashlib.sha256(read_png_rgb8(path).tobytes()).hexdigest()


def schedule_phase(spec, smi):
    """Phase 8: the reference schedule's image held against the JAX
    package's full-schedule renders, and its epoch loop profiled -> the
    numbers.  Gates: the in-process render's launches are the main path's
    (the level kernel six times a tile, the MC kernel once an epoch, the
    delivery once a tile, nothing else), every port-vs-JAX score >= the
    JAX floor - 0.6 dB at every scale, the port's own two-seed floor
    within 0.6 dB of the JAX floor at every scale, no Whitted ray
    dropped."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import psnr_torch_vs_reference as fidelity

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render import _clips
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene

    t_phase = time.time()
    with open(spec.floor_json) as f:
        recorded = json.load(f)
    jax_floor = {k: recorded[f"self_psnr_{k}_db"] for k in SCALES}
    out = {"smi": smi, "jax_floor": jax_floor}
    env = {} if spec.device == "cuda" else {"OMP_NUM_THREADS": "1"}
    counts = kernel_counts()
    cfg = RenderConfig(width=spec.width, height=spec.height, depth=DEPTH, epochs=spec.epochs)
    tiles = len(_clips(cfg, spec.device)[0])
    with tempfile.TemporaryDirectory() as tmp:
        png0, png1 = os.path.join(tmp, "seed0.png"), os.path.join(tmp, "seed1.png")
        # (a) seed 0 through the user's entry point (a PNG every epoch),
        # seed 1 through render_progressive with one PNG at the end, its
        # launches counted
        rc, lines, end, err = _stamped(["--seed", "0", "--out", png0, *spec.cli_args()], env)
        assert rc == 0, err
        out["cli"] = _wall_parts(lines, end)
        assert out["cli"]["epoch_lines"] == spec.epochs, out["cli"]
        assert not any("dropped" in line for _, line in lines), [x for _, x in lines][:3]
        for c in counts.values():
            c.launches = c.plain = 0
        out["render_seed1"] = fidelity.render(png1, 1, spec.epochs, spec.epochs, spec.device,
                                              spec.width, spec.height)
        out["launches_seed1"] = route_counts(counts, spec.device)
        assert out["render_seed1"]["dropped"] == 0, out["render_seed1"]
        want = {"level": tiles * (DEPTH + 1), "mc": spec.epochs, "deliver": tiles}
        assert out["launches_seed1"] == {k: want.get(k, 0) for k in counts}, (
            out["launches_seed1"], want)
        out["pixels_sha256"] = {"seed0": pixels_sha256(png0), "seed1": pixels_sha256(png1)}
        out["vs_jax_seed0"] = fidelity.score(png0, spec.goldens[0])
        out["vs_jax_seed1"] = fidelity.score(png1, spec.goldens[1])
        out["port_floor"] = fidelity.self_noise(png0, png1)
        report_fidelity(out, spec)
        for k in SCALES:
            for key in ("vs_jax_seed0", "vs_jax_seed1"):
                got = out[key][f"psnr_{k}_db"]
                assert got >= jax_floor[k] - FLOOR_MARGIN_DB, (key, k, got, jax_floor[k])
            own = out["port_floor"][f"self_psnr_{k}_db"]
            assert abs(own - jax_floor[k]) <= FLOOR_MARGIN_DB, ("port floor", k, own,
                                                                jax_floor[k])
        # (b) the epoch loop, read from its own spans
        scene, cam = demo_scene(device=spec.device), demo_camera(device=spec.device)
        out["profile"] = {}
        for k in spec.png_every:
            prof_cfg = dataclasses.replace(cfg, epochs=max(spec.profile_epochs, 6 * k))
            prof = schedule_profile(scene, cam, prof_cfg, k, tmp)
            print(json.dumps({"profile_png_every": k, **prof}))
            out["profile"][k] = prof
        report_profile(out["profile"], smi)
    out["phase_s"] = time.time() - t_phase
    print(f"phase 8 took {out['phase_s']:.1f} s")
    return out


def report_fidelity(out, spec):
    """Phase 8 (a)'s launches, pixel hashes and scores on lines of their
    own."""
    floor = out["jax_floor"]
    cli = out["cli"]
    print(f"phase 8 ({'; '.join(out['smi'])}): demo {spec.width}x{spec.height}, depth {DEPTH}, "
          f"whitted + {spec.epochs} epochs. Seed 0 through the CLI: wall {cli['wall_s']:.2f} s "
          f"= start {cli['start_s']:.2f} + whitted {cli['whitted_s']:.3f} + epochs "
          f"{cli['epochs_s']:.2f} + exit {cli['exit_s']:.2f}; seed 1 through "
          f"render_progressive(png_every={spec.epochs}): {out['render_seed1']['render_s']:.2f} s; "
          f"dropped 0 in both")
    print(f"seed 1's launches ({'launches' if spec.device == 'cuda' else 'plain calls'}): "
          + ", ".join(f"{k} {n}" for k, n in out["launches_seed1"].items() if n)
          + "; every other kernel 0")
    print(f"decoded pixels' sha256: seed 0 {out['pixels_sha256']['seed0']}, seed 1 "
          f"{out['pixels_sha256']['seed1']}")
    rows = (("port seed 0 vs JAX seed 0 (artifacts/out.png)", out["vs_jax_seed0"], "psnr_"),
            ("port seed 1 vs JAX seed 1 (artifacts/out_seed1.png)", out["vs_jax_seed1"], "psnr_"),
            ("port seed 0 vs port seed 1 (the port's floor)", out["port_floor"], "self_psnr_"))
    for label, row, prefix in rows:
        print(f"{label}: " + ", ".join(
            f"{k} {row[f'{prefix}{k}_db']:.2f} dB (JAX floor {floor[k]:.2f})" for k in SCALES))


# schedule_profile's figures a group of epochs, host ms
GROUP_FIGURES = ("wall_ms", "epoch_host_ms", "wait_ms", "encode_u8_ms", "read_ms", "png_job_ms",
                 "png_encode_ms", "png_write_ms")


def schedule_profile(scene, camera, cfg, png_every, out_dir):
    """render_progressive's cfg.epochs epochs, a PNG every png_every, run
    once under torch.profiler (CPU activity, and CUDA on a card) and read
    from the loop's own spans (utils/tracing) -> each group's host ms:
    wall_ms (from its first rt.step.epoch's start to the next group's, the
    last group's to render_progressive's return), epoch_host_ms (its
    rt.step.epoch units less their rt.step.wait spans), wait_ms (those
    waits), encode_u8_ms (its rt.step.encode unit), read_ms (the wall less
    those units: the counters' and the u8 frame's reads and the hand-over
    of the writer's job, which no span covers; the last group's also the
    wait for the writer's last job), png_job_ms (the writer thread's
    rt.png.job unit), png_encode_ms and png_write_ms (its spans); the
    medians of every group but the first, which meets every first-call
    set-up; render_progressive's wall and the writer's route.  Every
    figure carries the profiler's cost per host operation."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.parallel.progressive import render_progressive
    from raytracer_tpu_torch.utils import native, tracing

    device = scene.device
    cuda = device.type == "cuda"
    tracing.take()  # what an earlier window left
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])):
        t0 = time.time_ns()
        render_progressive(scene, camera, cfg, out_path=os.path.join(out_dir, "profile.png"),
                           log=lambda m: None, png_every=png_every)
        t_end = time.time_ns()
    spans = tracing.take().spans
    root = []  # each span's unit: the index of its outermost span
    for i, s in enumerate(spans):
        root.append(i if s.parent is None else root[s.parent])
    unit = {(s.name, s.unit): i for i, s in enumerate(spans) if s.parent is None}
    ns = lambda i: spans[i].end_ns - spans[i].start_ns
    inside = lambda name, units: sum(ns(i) for i, s in enumerate(spans)
                                     if s.name == name and root[i] in units)
    firsts = list(range(0, cfg.epochs, png_every))
    starts = [spans[unit["rt.step.epoch", e]].start_ns for e in firsts] + [t_end]
    groups = []
    for e0, start, end in zip(firsts, starts, starts[1:]):
        e1 = min(e0 + png_every, cfg.epochs)
        epochs = {unit["rt.step.epoch", e] for e in range(e0, e1)}
        encode, job = unit["rt.step.encode", e0], unit["rt.png.job", e1]
        epoch, wait = sum(ns(i) for i in epochs), inside("rt.step.wait", epochs)
        group = {"wall_ms": end - start, "epoch_host_ms": epoch - wait, "wait_ms": wait,
                 "encode_u8_ms": ns(encode), "read_ms": end - start - epoch - ns(encode),
                 "png_job_ms": ns(job), "png_encode_ms": inside("rt.png.encode", {job}),
                 "png_write_ms": inside("rt.png.write", {job})}
        groups.append({"epochs": e1 - e0, **{k: v / 1e6 for k, v in group.items()}})
    timed = groups[1:]
    return {"device": str(device),
            "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
            "width": cfg.width, "height": cfg.height, "epochs": cfg.epochs,
            "png_every": png_every, "writer_route": "native" if native.available() else "python",
            "groups_timed": len(timed), "render_progressive_s": (t_end - t0) / 1e9,
            **{k: float(np.median([g[k] for g in timed])) for k in GROUP_FIGURES},
            "groups": groups}


def report_profile(profiles, smi):
    """Phase 8 (b)'s medians on a line a group size, under the spans'
    names."""
    for k, p in profiles.items():
        print(f"epoch loop, --png-every {k}, {p['epochs']} epochs at {p['width']}x{p['height']} "
              f"({'; '.join(smi)}; writer route {p['writer_route']}; its spans under "
              f"torch.profiler, medians of {p['groups_timed']} groups, host ms a group): wall "
              f"{p['wall_ms']:.2f}; rt.step.epoch less its waits {p['epoch_host_ms']:.2f}, "
              f"rt.step.wait {p['wait_ms']:.2f}, rt.step.encode {p['encode_u8_ms']:.2f}, reads "
              f"and hand-over (no span) {p['read_ms']:.2f}; the writer's rt.png.job "
              f"{p['png_job_ms']:.2f} (rt.png.encode {p['png_encode_ms']:.2f}, rt.png.write "
              f"{p['png_write_ms']:.2f}); render_progressive wall "
              f"{p['render_progressive_s']:.3f} s")


# ---- phase 9: the benchmark harness (raytracer_tpu_torch/bench.py) ----------

# The JAX bench's own counts on the TPU (BENCH_r05.json's "tail"): the demo's
# 1024x1024 depth-5 Whitted frame (16 full tiles: no padding) and one MC epoch.
JAX_BENCH_CASTS = {"whitted": 3_009_477, "mc": 9_793_125}
# the harnesses' runs as a user starts them: (label, argv, extra environment)
BENCH_CLI = (("bench", ["-m", "raytracer_tpu_torch.bench"], {"RAYTPU_BENCH_FAST": "1"}),
             ("bench_torch_mesh", [os.path.join("scripts", "bench_torch_mesh.py"), "--grids",
                                   "75", "--reps", "1"], {}))


def bench_want(spec, section, tiles, sched_tiles, meshes):
    """A harness section's launches (bench.run): a Whitted frame runs the
    level kernel depth + 1 times a tile and the delivery once a tile, an
    MC epoch one MC launch; the dense kernels on the demo, the blocked ones
    on a mesh (`meshes`: the mesh sections' tags in spec.meshes' order);
    the warm-up calls included."""
    levels = spec.depth + 1

    def calls(frames, epochs, t=tiles, blk=""):
        return {"level" + blk: frames * levels * t, "deliver": frames * t, "mc" + blk: epochs}

    if section == "warmup":
        return calls(1, 1)
    if section == "step":
        return calls(spec.reps, spec.reps)
    if section == "batched":
        return calls(0, spec.reps * spec.batched_epochs)
    if section == "steps":
        return calls(spec.reps * spec.steps, spec.reps * spec.steps)
    if section == "schedule":
        return calls(2, 1 + spec.schedule_epochs, sched_tiles)
    if section == "schedule_png10":
        from raytracer_tpu_torch.bench import PNG_GROUP

        return calls(2, min(PNG_GROUP, spec.schedule_epochs) + spec.schedule_epochs, sched_tiles)
    n_reps = spec.meshes[meshes.index(section)][1]
    return calls(1 + n_reps, 1 + n_reps, blk="_blk")


def whitted_level_casts(spec):
    """The demo's Whitted frame at `spec`'s size, traced tile by tile as
    render_whitted does (the level kernel on the card), -> its casts
    level by level, summed over the tiles."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops.trace import process_level, trace_whitted
    from raytracer_tpu_torch.render import _clips
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene

    scene, cam = demo_scene(device=spec.device), demo_camera(device=spec.device)
    cfg = RenderConfig(width=spec.width, height=spec.height, depth=spec.depth,
                       tile_rays=spec.tile_rays)
    calls = []

    def level_fn(*args):
        res = process_level(*args)
        calls.append(res[3])
        return res

    clips, _ = _clips(cfg, spec.device)
    n = cfg.width * cfg.height
    for t, clip in enumerate(clips):
        o, d = camera_ops.shoot(cam, clip[:min(clip.shape[0], n - t * clip.shape[0])])
        trace_whitted(scene, o, d, cfg, level_fn=level_fn)
    levels = cfg.depth + 1
    assert len(calls) == levels * len(clips), len(calls)
    return [int(sum(int(c.sum()) for c in calls[i::levels])) for i in range(levels)]


def bench_line_keys(line):
    """The harness line's numeric keys that neither METRICS nor DESCRIPTORS
    names (by bench.metric_name) -> a list, empty when every one is named."""
    from raytracer_tpu_torch.bench import DESCRIPTORS, METRICS, metric_name

    return [k for k, v in line.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
            and metric_name(k) not in METRICS and metric_name(k) not in DESCRIPTORS]


def bench_phase(spec, smi_name):
    """Phase 9: the harness in process at `spec` with the kernels' counts
    set to 0 before each section and read after, then each run of
    BENCH_CLI as a user starts it -> the numbers.  Gates: each section's
    launches are bench_want's and every other kernel's (yardsticks,
    unfused, binned, plain calls) 0; the demo's Whitted frame drops
    nothing and its levels sum to the harness's count; at the JAX bench's
    sizes its primary level casts JAX_BENCH_CASTS["whitted"] and its MC
    epoch within 1 % of JAX_BENCH_CASTS["mc"]; every numeric key of every
    line is in METRICS or DESCRIPTORS; each line's device.name is
    nvidia-smi's (smi_name)."""
    from raytracer_tpu_torch import bench
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render import _clips

    t_phase = time.time()
    counts = kernel_counts()
    launches = {}

    @contextlib.contextmanager
    def counted(section):
        for c in counts.values():
            c.launches = c.plain = 0
        yield
        launches[section] = route_counts(counts, spec.device)

    result, record = bench.run(spec, counted)
    print(json.dumps(result))
    out = {"line": result, "launches": launches}
    tiles = len(_clips(RenderConfig(width=spec.width, height=spec.height,
                                    tile_rays=spec.tile_rays), spec.device)[0])
    sched_tiles = len(_clips(RenderConfig(width=spec.schedule_width, height=spec.schedule_height,
                                          tile_rays=spec.tile_rays), spec.device)[0])
    meshes = [s for s in launches if s.startswith("mesh")]
    assert list(launches) == ["warmup", "step", "batched", "steps"] + (
        [] if spec.fast else [*meshes, "schedule", "schedule_png10"]), list(launches)
    assert len(meshes) == (0 if spec.fast else len(spec.meshes)), meshes
    for section, got in launches.items():
        want = bench_want(spec, section, tiles, sched_tiles, meshes)
        assert got == {k: want.get(k, 0) for k in counts}, (section, got, want)
        print(f"phase 9, {section}: " + ", ".join(f"{k} {n}" for k, n in got.items() if n)
              + "; every other kernel 0")
    frame, epoch = record["warmup"]
    assert frame["dropped"] == 0, frame
    levels = whitted_level_casts(spec)
    assert sum(levels) == frame["casts"], (levels, frame)
    jax_casts = JAX_BENCH_CASTS if (spec.width, spec.height, spec.depth, spec.tile_rays) == (
        1024, 1024, 5, 1 << 16) else None
    if jax_casts is not None:
        # the JAX bench's Whitted count on the TPU equals the primary
        # level's (the primary rays, their shadow rays and interior
        # marches) to the ray; whether its later levels went uncounted or
        # untraced there is open (PERF.md §6 PR 14, §7)
        assert levels[0] == jax_casts["whitted"], (levels, jax_casts)
        assert casts_close(epoch["casts"], jax_casts["mc"]), (epoch, jax_casts)
    out["casts"] = {"whitted": frame["casts"], "whitted_levels": levels, "mc": epoch["casts"],
                    "jax": jax_casts}
    print(f"phase 9: the demo's {spec.width}x{spec.height} Whitted frame cast {frame['casts']:,} "
          f"rays (by level {', '.join(f'{c:,}' for c in levels)}), dropped {frame['dropped']}; "
          f"an MC epoch {epoch['casts']:,} (the JAX bench: "
          + ("not compared" if jax_casts is None else
             f"Whitted {jax_casts['whitted']:,}, the primary level's here "
             f"{levels[0] - jax_casts['whitted']:+,}; MC {jax_casts['mc']:,}, here "
             f"{(epoch['casts'] / jax_casts['mc'] - 1) * 100:+.3f} %") + ")")
    lines = {"run": result}
    for label, argv, env in BENCH_CLI:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=HERE, capture_output=True, text=True,
                              env=dict(os.environ, **env), timeout=600)
        assert proc.returncode == 0, (label, proc.stderr[-3000:])
        lines[label] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"phase 9, {label} ({time.perf_counter() - t0:.1f} s): {json.dumps(lines[label])}")
    for label, line in lines.items():
        assert not bench_line_keys(line), (label, bench_line_keys(line))
        assert line["device"]["name"] == smi_name, (label, line["device"], smi_name)
    out["cli"] = {k: v for k, v in lines.items() if k != "run"}
    out["phase_s"] = time.time() - t_phase
    print(f"phase 9 took {out['phase_s']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import (
        intersect_kernel,
        level_kernel,
        march_kernel,
        mc_binned,
        mc_kernel,
    )
    from raytracer_tpu_torch.ops import kernel_common
    from raytracer_tpu_torch.ops.intersect import cast_any_hit
    from raytracer_tpu_torch.ops.kernel_common import BIG
    from raytracer_tpu_torch.ops.level_kernel import Pool
    from raytracer_tpu_torch.ops import trace as trace_ops
    from raytracer_tpu_torch.ops.trace import _pack_primary, fused_ok, trace_whitted
    from raytracer_tpu_torch.parallel.progressive import render_progressive
    from raytracer_tpu_torch.render import (
        _clips,
        epoch_frame,
        epoch_tiles,
        frame_draws,
        render_distributed_epoch,
        render_whitted,
        tile_draws,
    )
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene, mesh_scene
    from raytracer_tpu_torch.scene.textures import Texture, host_only
    from raytracer_tpu_torch.scene.types import BVH_FIELDS, Rays
    from raytracer_tpu_torch.utils import kernels
    from raytracer_tpu_torch.utils.png import read_png_rgb8
    from raytracer_tpu_torch.utils.roofline import bound

    dev = torch.device("cuda")
    counts = kernel_counts()
    fused_kernels = ("level", "level_blk", "mc", "mc_blk", "binned_primary", "binned_bounce",
                     "binned_terminal")

    def reset_counts():
        for c in counts.values():
            c.launches = c.plain = 0

    def read_counts():
        launches = {k: c.launches for k, c in counts.items()}
        assert all(c.plain == 0 for c in counts.values()), {k: c.plain for k, c in counts.items()}
        assert not any(launches[k] for k in launches if k.endswith("_thread")), launches
        return launches

    # ---- 1. device and toolchain ----------------------------------------
    smi_lines = nvidia_smi()
    smi = smi_lines[0]
    nvcc_ver = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; nvcc: {nvcc_ver}")
    _, build_s = kernels.build(verbose=True)
    print(f"kernels built in {build_s:.1f} s")
    demo = demo_scene().to(dev)
    # the staged dense walks at the demo's rows
    attrs = {k: kernels.kernel_attrs(k, demo.n_tri) for k in kernels.ATTRS}
    for k, a in attrs.items():
        print(f"{k} kernel: {a['registers']} registers/thread, "
              f"{a['local_bytes']} local (spill+stack) bytes/thread, "
              f"{a['dynamic_shared_bytes']} dynamic shared bytes/block, "
              f"{a['blocks_per_sm']} blocks of 128 threads an SM")

    demo_cam = demo_camera().to(dev)
    meshes = {grid: tuple(x.to(dev) for x in mesh_scene(grid)) for grid in (24, 75, 96, 160)}
    for grid, (scene, _) in meshes.items():
        print(f"mesh_scene({grid}): {scene.n_tri} triangles, "
              f"{scene.blk_tables.n_chunks} chunks of {scene.blk_tables.box.shape[0]}")
    mesh24, mesh24_cam = meshes[24]
    mesh11k, mesh11k_cam = meshes[75]
    # the unfused path's scenes: the demo with its textures' host forms
    # only, and mesh24 with its BVH but no blocked layout
    demo_u = dataclasses.replace(demo, textures=host_only(demo.textures))
    mesh24_bvh = dataclasses.replace(mesh24, blk_perm=None, blk_box=None,
                                     textures=host_only(mesh24.textures))
    assert fused_ok(demo) and fused_ok(mesh24)
    assert not fused_ok(demo_u) and not fused_ok(mesh24_bvh)

    def plain_level(sc, pool, last, direct, thr, md, mr):
        c, r, f, casts = level_kernel.process_level_plain(
            sc.geom, sc.textures, pool, last, direct, thr, md, mr)
        return c, r, f, casts.sum()

    def plain_mc(sc, o, d, unifs):
        return mc_kernel.trace_plain(sc.geom, sc.textures, o, d, unifs, DEPTH, MD, MR)

    def tile_rays(cam, clip, rng, cfg):
        """Numpy-seeded lens normals and draws for one tile -> (o, d, unifs)
        of the MC pass, contiguous on the card."""
        n = clip.shape[0]
        normals = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32), device=dev)
        unifs = rng.uniform(size=(DEPTH, 3, n)).astype(np.float32)
        unifs[:, 2] = unifs[:, 2] * np.float32(2 * np.pi) - np.float32(np.pi)
        o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
        return o.contiguous(), d.contiguous(), torch.as_tensor(unifs, device=dev)

    def check_mc(label, scene, o, d, unifs):
        got, got_casts = mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR)
        ref, ref_casts = plain_mc(scene, o, d, unifs)
        torch.cuda.synchronize()
        a, b = got.cpu().numpy(), ref.cpu().numpy()
        fc = frac_close(a, b)
        print(f"mc {label}: {fc:.5f} of lanes agree, casts {int(got_casts)} vs "
              f"{int(ref_casts)}, max |err| {np.abs(a - b).max():.3g}")
        assert np.isfinite(a).all() and fc >= 0.99, fc
        assert casts_close(got_casts, ref_casts), (int(got_casts), int(ref_casts))
        return got, got_casts

    def check_whitted(label, scene, cam, clip, cfg):
        o, d = camera_ops.shoot(cam, clip)
        rk = trace_whitted(scene, o, d, cfg)
        rp = trace_whitted(scene, o, d, cfg, level_fn=plain_level)
        torch.cuda.synchronize()
        a, b = rk.color.cpu().numpy(), rp.color.cpu().numpy()
        fc = frac_close(a, b)
        print(f"whitted {label}: {fc:.5f} of pixels agree, casts {int(rk.casts)} vs "
              f"{int(rp.casts)}, dropped {int(rk.dropped)}/{int(rp.dropped)}")
        assert np.isfinite(a).all() and fc >= 0.97, fc
        assert casts_close(rk.casts, rp.casts), (int(rk.casts), int(rp.casts))
        assert int(rk.dropped) == 0 and int(rp.dropped) == 0

    def binned_walk(scene, o, d, unifs, order="dealt"):
        """mc_binned.trace step by step -> (photon [n, 3], casts, the inputs
        each kernel got: ("primary", o_t, d_t) / ("bounce", sf, si, u,
        first) / ("terminal", sf, si, first)).  order: "dealt" as
        mc_binned.trace (sorted, then dealt over the warps), "sorted" (the
        sort alone) or "pixel" (the lanes left as they are); any order is
        correct."""
        calls = []
        o_t, d_t = o.t().contiguous(), d.t().contiguous()
        calls.append(("primary", o_t, d_t))
        sf, si, c0 = mc_binned.primary(scene, o_t, d_t)
        casts = c0.sum()
        for step in range(DEPTH):
            if order != "pixel":
                sf, si = mc_binned.sort_state(scene, sf, si, unifs[step])
            if order == "dealt":
                sf, si = mc_binned.deal_lanes(sf, si)
            u = unifs[step][:, si[mc_binned.I_SLOT].long()].contiguous()
            calls.append(("bounce", sf, si, u, step == 0))
            sf, si, dc = mc_binned.bounce(scene, sf, si, u, step == 0, MD, MR)
            casts = casts + dc.sum()
        calls.append(("terminal", sf, si, DEPTH == 0))
        rows, dc = mc_binned.terminal(scene, sf, si, DEPTH == 0)
        casts = casts + dc.sum()
        photon = torch.zeros((o.shape[0], 3), device=dev)
        photon.index_add_(0, si[mc_binned.I_SLOT].long(), rows.t())
        return photon, casts, calls

    def run_binned(scene, call, plain=False, work=None):
        """One binned kernel (or its plain version) on captured inputs ->
        its float outputs, int outputs (or None), casts."""
        kind, *args = call
        geom, tex = scene.geom, scene.textures
        if kind == "primary":
            if plain:
                return mc_binned.primary_plain(geom, *args)
            return mc_binned.primary(scene, *args, work=work)
        if kind == "bounce":
            sf, si, u, first = args
            if plain:
                return mc_binned.bounce_plain(geom, tex, sf, si, u, first, MD, MR)
            return mc_binned.bounce(scene, sf, si, u, first, MD, MR, work=work)
        sf, si, first = args
        if plain:
            out = mc_binned.terminal_plain(geom, tex, sf, si, first)
        else:
            out = mc_binned.terminal(scene, sf, si, first, work=work)
        return out[0], None, out[1]

    def check_binned_kernels(label, scene, calls):
        """Each binned kernel against its plain version on the same inputs:
        >= 99 % of lanes with every output within 1e-3 + 2e-2 |ref| and equal
        int rows; casts within 1 %."""
        errs = {}
        for call in calls:
            fk, ik, ck = run_binned(scene, call)
            fp, ip, cp = run_binned(scene, call, plain=True)
            torch.cuda.synchronize()
            a, b = fk.t().cpu().numpy(), fp.t().cpu().numpy()
            ok = np.abs(a - b) <= 1e-3 + 2e-2 * np.abs(b)
            read = np.ones_like(ok)
            same = np.ones(a.shape[0], bool)
            if ik is not None:
                same = (ik == ip).all(0).cpu().numpy()
                # a dead lane's photon is its accumulation (rows 0-2); its
                # other rows are never read again
                read[(ip[mc_binned.I_ALIVE] == 0).cpu().numpy(), 3:] = False
            close = same & np.all(ok | ~read, axis=-1)
            diff = np.where(read, np.abs(a - b), 0.0)
            err = float(diff[same].max()) if same.any() else 0.0
            name = f"binned_{call[0]}"
            errs[name] = max(errs.get(name, 0.0), err)
            tag = f"{call[0]}{'' if call[0] == 'primary' else ' first' if call[-1] else ''}"
            print(f"binned {tag} {label}: {close.mean():.5f} of lanes agree, casts "
                  f"{int(ck.sum())} vs {int(cp.sum())}, max |err| {err:.3g}")
            assert np.isfinite(a).all() and close.mean() >= 0.99, close.mean()
            assert casts_close(ck.sum(), cp.sum()), (int(ck.sum()), int(cp.sum()))
        return errs

    def new_work(n):
        return work_for(n, dev)

    def same_tests(label, coop, thread):
        """The cooperative walk runs the per-thread walk's tests: the five
        kinds of test and the chunks entered, equal in total to the unit
        (and it staged chunks wherever a ray entered one)."""
        a, b = totals(coop), totals(thread)
        assert b["wchunk"] == 0 and (a["wchunk"] > 0 or a["chunk"] == 0), (label, a, b)
        assert all(a[k] == b[k] for k in a if k != "wchunk"), (label, a, b)
        return a

    def check_coop_mc(label, scene, o, d, unifs, plain_log=False):
        """The MC kernel's main-path walk (the cooperative one on a blocked
        scene, the staged one on a dense scene) against its per-thread
        instantiation: photons and casts equal on every lane, test totals
        equal; with plain_log, its two traversal counters against the plain
        version's chunk log (within 2 %: the kernel contracts multiply-adds,
        and it stages a chunk on a box test that a later, nearer hit may
        undo)."""
        n = o.shape[0]
        wc, wt = new_work(n), new_work(n)
        got, casts = mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR, work=wc)
        ref, ref_casts = mc_kernel.trace_per_thread(scene, o, d, unifs, DEPTH, MD, MR, work=wt)
        torch.cuda.synchronize()
        same = float((got == ref).all(dim=1).float().mean())
        tests = same_tests(label, wc, wt)
        walk = "cooperative" if scene.blocked else "staged"
        print(f"mc {label}, {walk} vs per-thread walk: {same:.6f} of lanes equal, casts "
              f"{int(casts)} vs {int(ref_casts)}, tests {tests}"
              + (f"; warp chunks x 32 / lane chunks {sharing(tests):.3f} (pixel order)"
                 if scene.blocked else ""))
        assert same == 1.0 and int(casts) == int(ref_casts), (same, int(casts), int(ref_casts))
        if plain_log:
            with kernel_common.count_chunks(n, dev) as log:
                plain_mc(scene, o, d, unifs)
            lane, staged = int(log.lane.sum()), int(log.group[32].sum())
            print(f"mc {label}, traversal counters vs the plain chunk log: lane chunks "
                  f"{tests['chunk']} vs {lane}, warp chunks {tests['wchunk']} vs {staged}")
            assert abs(tests["chunk"] - lane) <= 0.02 * lane, (tests["chunk"], lane)
            assert abs(tests["wchunk"] - staged) <= 0.02 * staged, (tests["wchunk"], staged)
        return tests

    def check_coop_bounces(label, scene, calls, plain_log=False):
        """Every bounce of a captured walk: the cooperative kernel against
        its per-thread instantiation (ints, casts and every float row that is
        read again equal on every lane; test totals equal) -> the summed
        tests."""
        total = {}
        for call in (c for c in calls if c[0] == "bounce"):
            _, sf, si, u, first = call
            n = sf.shape[1]
            wc, wt = new_work(n), new_work(n)
            fc, ic, cc = mc_binned.bounce(scene, sf, si, u, first, MD, MR, work=wc)
            ft, it, ct = mc_binned.bounce_per_thread(scene, sf, si, u, first, MD, MR, work=wt)
            torch.cuda.synchronize()
            read = torch.ones_like(fc, dtype=torch.bool)
            read[3:, ic[mc_binned.I_ALIVE] == 0] = False  # a dead lane keeps its photon only
            same = float((((fc == ft) | ~read).all(dim=0) & (ic == it).all(dim=0)
                          & (cc == ct)).float().mean())
            assert same == 1.0, (label, same)
            for k, v in same_tests(label, wc, wt).items():
                total[k] = total.get(k, 0) + v
            if plain_log:
                with kernel_common.count_chunks(n, dev) as log:
                    run_binned(scene, call, plain=True)
                lane, staged = int(log.lane.sum()), int(log.group[32].sum())
                t = totals(wc)
                assert abs(t["chunk"] - lane) <= max(0.02 * lane, 8), (t["chunk"], lane)
                assert abs(t["wchunk"] - staged) <= max(0.02 * staged, 8), (t["wchunk"], staged)
        print(f"binned bounces {label}, cooperative vs per-thread walk: all lanes equal, tests "
              f"{total}; warp chunks x 32 / lane chunks {sharing(total):.3f}"
              + ("; traversal counters within 2 % of the plain chunk log" if plain_log else ""))
        return total

    def level_lanes(entry, scene, pool, last, direct, lv, work):
        """One launch of the level's C entry `entry` (the staged dense, the
        cooperative blocked or a per-thread walk) -> its outputs with the
        casts of each lane."""
        counts = {"rt_level": level_kernel.COUNTS, "rt_level_thread": level_kernel.COUNTS_THREAD,
                  "rt_level_blk": level_kernel.COUNTS_BLK,
                  "rt_level_blk_thread": level_kernel.COUNTS_BLK_THREAD}[entry]
        return level_kernel._launch(entry, not entry.endswith("_thread"), counts, scene, pool,
                                    last, direct, *lv, work)

    def check_coop_levels(label, scene, pools, lv, killed=None):
        """Each (pool, last, direct): the level kernel's main-path walk (the
        cooperative one on a blocked scene, the staged one on a dense scene)
        against its per-thread instantiation (contrib, both children's f and
        i rows and casts equal on every lane, test totals equal); with
        `killed` (a lane mask), the killed lanes' outputs also equal the
        plain version's (a dead lane's contract) -> the summed tests."""
        total = {}
        entry = "rt_level_blk" if scene.blocked else "rt_level"
        for pool, last, direct in pools:
            k = pool.width
            wc, wt = new_work(k), new_work(k)
            got = level_lanes(entry, scene, pool, last, direct, lv, wc)
            ref = level_lanes(entry + "_thread", scene, pool, last, direct, lv, wt)
            torch.cuda.synchronize()
            rows = lambda r: (r[0], r[1].f, r[1].i, r[2].f, r[2].i, r[3][None])
            same = torch.ones(k, dtype=torch.bool, device=dev)
            for a, b in zip(rows(got), rows(ref)):
                same &= (a == b).all(dim=0)
            assert bool(same.all()), (label, k, last, direct, float(same.float().mean()))
            for key, v in same_tests(label, wc, wt).items():
                total[key] = total.get(key, 0) + v
            if killed is not None:
                plain = plain_level(scene, pool, last, direct, *lv)
                for a, b in zip(rows(got)[:5], rows(plain)[:5]):
                    assert bool((a == b)[:, killed].all()), (label, direct)
        walk = "cooperative" if scene.blocked else "staged"
        print(f"level {label}, {walk} vs per-thread walk: {len(pools)} pools "
              f"({', '.join(str(p.width) for p, _, _ in pools)} lanes), all lanes equal, tests "
              f"{total}"
              + (f"; warp chunks x 32 / lane chunks {sharing(total):.3f}" if scene.blocked else "")
              + ("; killed lanes equal the plain version's" if killed is not None else ""))
        return total

    def check_coop_terminals(label, scene, calls):
        """Every terminal call of captured walks, with `first` both ways: the
        cooperative kernel against its per-thread instantiation (photons and
        casts equal on every lane, test totals equal)."""
        total = {}
        for _, sf, si, first in (c for c in calls if c[0] == "terminal"):
            for fst in (first, not first):
                n = sf.shape[1]
                wc, wt = new_work(n), new_work(n)
                pc, cc = mc_binned.terminal(scene, sf, si, fst, work=wc)
                pt, ct = mc_binned.terminal_per_thread(scene, sf, si, fst, work=wt)
                torch.cuda.synchronize()
                assert torch.equal(pc, pt) and torch.equal(cc, ct), (label, fst)
                for key, v in same_tests(label, wc, wt).items():
                    total[key] = total.get(key, 0) + v
        print(f"binned terminals {label}, cooperative vs per-thread walk: all lanes equal, tests "
              f"{total}; warp chunks x 32 / lane chunks {sharing(total):.3f}")
        return total

    def check_coop_primaries(label, scene, calls):
        """Every primary call of captured walks: the cooperative kernel against
        its per-thread instantiation (state and casts equal on every lane,
        test totals equal) and against its plain version (>= 99.9 % of lanes
        with every float row that is read again within 1e-3 + 2e-2 |ref| and
        the int rows equal) -> the summed tests; prints the summed bound of
        the calls (bound: each call's bytes and counted tests)."""
        total, worst, b_ms, by = {}, 1.0, 0.0, set()
        for _, o_t, d_t in (c for c in calls if c[0] == "primary"):
            n = o_t.shape[1]
            wc, wt = new_work(n), new_work(n)
            got = mc_binned.primary(scene, o_t, d_t, work=wc)
            ref = mc_binned.primary_per_thread(scene, o_t, d_t, work=wt)
            fp, ip, cp = mc_binned.primary_plain(scene.geom, o_t, d_t)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), label
            for k, v in same_tests(label, wc, wt).items():
                total[k] = total.get(k, 0) + v
            call_ms, call_by, _ = bound(nbytes(o_t, d_t, *scene_tables(scene))
                                        + (mc_binned.N_F + mc_binned.N_I + 1) * 4 * n, wc)
            b_ms, by = b_ms + call_ms, by | {call_by}
            read = torch.ones_like(fp, dtype=torch.bool)
            read[3:, ip[mc_binned.I_ALIVE] == 0] = False  # a miss keeps its photon only
            ok = ((got[0] - fp).abs() <= 1e-3 + 2e-2 * fp.abs()) | ~read
            frac = float((ok.all(0) & (got[1] == ip).all(0)).float().mean())
            worst = min(worst, frac)
            assert frac >= 0.999 and torch.equal(got[2], cp), (label, n, frac)
        print(f"binned primaries {label}, cooperative vs per-thread walk: all lanes equal, tests "
              f"{total}; warp chunks x 32 / lane chunks {sharing(total):.3f}; plain version: "
              f">= {worst:.5f} of lanes agree; bound {b_ms:.4f} ms ({', '.join(sorted(by))})")
        return total

    # ---- 2. kernels against their plain versions, same inputs -----------
    rng = np.random.default_rng(0)
    full = RenderConfig(depth=5, epochs=3)  # 1280x960, tile_rays 65536
    mesh_cfg = RenderConfig(width=1024, height=1024, depth=5)  # mesh11k
    cases = [(f"{w}x{h}", RenderConfig(width=w, height=h, depth=5, tile_rays=w * h), 0)
             for w, h in ((64, 48), (256, 192))]
    cases.append(("1280x960 tile 9", full, 9))  # a main-path tile, mid-frame
    demo_lv = (full.threshold, full.max_refract_distance, full.max_tir_retries)
    small = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
    for label, cfg, tile in cases:
        clip = _clips(cfg, dev)[0][tile]
        o, d, unifs = tile_rays(demo_cam, clip, rng, cfg)
        check_mc(label, demo, o, d, unifs)
        check_whitted(label, demo, demo_cam, clip, cfg)
        # the staged dense walks against the per-thread ones, lane for lane
        check_coop_mc(label, demo, o, d, unifs)
        check_coop_levels(label + ", every level", demo, level_pools(demo, demo_cam, clip, cfg),
                          demo_lv)
    # a ragged tile, and pools with 30 % of lanes killed but owing radiance
    o, d, unifs = tile_rays(demo_cam, _clips(full, dev)[0][9][:3821], rng, full)
    check_coop_mc("1280x960 tile 9, first 3821 lanes", demo, o, d, unifs)
    tile9 = level_pools(demo, demo_cam, _clips(full, dev)[0][9], full)
    wide = tile9[1][0]
    check_coop_levels("1280x960 tile 9, level 1's first 3821 lanes", demo,
                      [(Pool(wide.f[:, :3821].contiguous(), wide.i[:, :3821].contiguous()),
                        False, True)], demo_lv)
    for j in (0, 2):
        pool = tile9[j][0]
        kill = torch.as_tensor(rng.uniform(size=pool.width) < 0.3, device=dev)
        f, i = pool.f.clone(), pool.i.clone()
        i[level_kernel.I_ALIVE, kill] = 0
        f[level_kernel.F_PEND:, kill] = torch.as_tensor(
            rng.uniform(size=(3, int(kill.sum()))).astype(np.float32), device=dev)
        check_coop_levels(f"1280x960 tile 9, level {j} with 30 % of lanes killed owing radiance",
                          demo, [(Pool(f, i), False, True), (Pool(f, i), False, False)], demo_lv,
                          killed=kill)
    # a dense table too large to stage in shared memory (mesh_scene(30)
    # without its blocked layout: 1,812 triangles), which the dense entries
    # walk per thread: against the plain versions
    big, big_cam = (x.to(dev) for x in mesh_scene(30))
    big = dataclasses.replace(big, blk_perm=None, blk_box=None)
    assert not big.blocked and big.n_tri * 64 > 96 * 1024, big.n_tri
    clip = _clips(small, dev)[0][0]
    label = f"mesh_scene(30) dense ({big.n_tri} triangles, walked per thread) 64x48"
    check_mc(label, big, *tile_rays(big_cam, clip, rng, small))
    for pool, last, direct in level_pools(big, big_cam, clip, small):
        c, _, _, casts = level_kernel.process_level(big, pool, last, direct, *demo_lv)
        cp, _, _, casts_p = plain_level(big, pool, last, direct, *demo_lv)
        fc = frac_close(c.t().cpu().numpy(), cp.t().cpu().numpy())
        print(f"level {label}, {pool.width} lanes: {fc:.5f} of lanes agree, casts "
              f"{int(casts)} vs {int(casts_p)}")
        assert fc >= 0.99 and casts_close(casts, casts_p), (fc, int(casts), int(casts_p))
    # the whole 1280x960 frame's padded rays (19 tiles) in one launch, as
    # an epoch on the main path makes it
    frame_clips = _clips(full, dev)[0]
    o, d, unifs = tile_rays(demo_cam, frame_clips.reshape(-1, 2), rng, full)
    assert o.shape[0] == 19 * 65536
    check_coop_mc(f"1280x960, the frame's {o.shape[0]} rays in one launch", demo, o, d, unifs)
    # the epoch in one launch against the epoch tile by tile: every lane
    tile_in = [tile_draws(full, 3, 5, t, 65536, dev) for t in range(len(frame_clips))]
    one = epoch_frame(demo, demo_cam, full, frame_clips, tile_in)
    per_tile = epoch_tiles(demo, demo_cam, full, frame_clips, tile_in)
    torch.cuda.synchronize()
    print(f"mc epoch 1280x960 in one launch vs tile by tile: "
          f"{float((one[0] == per_tile[0]).all(dim=1).float().mean()):.6f} of lanes equal, casts "
          f"{int(one[1])} vs {int(per_tile[1])}, filtered {int(one[2])} vs {int(per_tile[2])}")
    assert torch.equal(one[0], per_tile[0]) and int(one[1]) == int(per_tile[1])
    assert int(one[2]) == int(per_tile[2])

    binned_err = {}
    for label, scene, cam, cfg, tile in (
            ("mesh24 64x48", mesh24, mesh24_cam, small, 0),
            ("mesh11k 1024x1024 tile 6", mesh11k, mesh11k_cam, mesh_cfg, 6)):
        clip = _clips(cfg, dev)[0][tile]
        o, d, unifs = tile_rays(cam, clip, rng, cfg)
        mega, mega_casts = check_mc(label + " (blocked)", scene, o, d, unifs)
        check_whitted(label + " (blocked)", scene, cam, clip, cfg)
        photon, casts, calls = binned_walk(scene, o, d, unifs)
        for k, v in check_binned_kernels(label, scene, calls).items():
            binned_err[k] = max(binned_err.get(k, 0.0), v)
        a, b = photon.cpu().numpy(), mega.cpu().numpy()
        close = float(np.all(np.isclose(a, b, rtol=1e-4, atol=1e-5), axis=-1).mean())
        print(f"binned path vs blocked mc kernel {label}: {close:.5f} of lanes agree, "
              f"casts {int(casts)} vs {int(mega_casts)}")
        assert close >= 0.995 and int(casts) == int(mega_casts), (close, int(casts))
        # the cooperative walks against the per-thread ones and the plain log
        lv = (cfg.threshold, cfg.max_refract_distance, cfg.max_tir_retries)
        pools = level_pools(scene, cam, clip, cfg)
        assert len(pools) == DEPTH + 1
        check_coop_levels(label + ", every level", scene, pools, lv)
        wide = pools[1][0]  # the level-1 pool: its first lanes, and lanes killed
        cut = wide.width * 5 // 8 - 19
        check_coop_levels(f"{label}, level 1's first {cut} lanes", scene,
                          [(Pool(wide.f[:, :cut].contiguous(), wide.i[:, :cut].contiguous()),
                            False, True)], lv)
        for j in (0, 2):
            pool = pools[j][0]
            kill = torch.as_tensor(rng.uniform(size=pool.width) < 0.3, device=dev)
            f, i = pool.f.clone(), pool.i.clone()
            i[level_kernel.I_ALIVE, kill] = 0
            f[level_kernel.F_PEND:, kill] = torch.as_tensor(
                rng.uniform(size=(3, int(kill.sum()))).astype(np.float32), device=dev)
            check_coop_levels(f"{label}, level {j} with 30 % of lanes killed owing radiance",
                              scene, [(Pool(f, i), False, True), (Pool(f, i), False, False)], lv,
                              killed=kill)
        check_coop_mc(label, scene, o, d, unifs, plain_log=True)
        check_coop_primaries(label, scene, calls)
        check_coop_bounces(label + " (sorted and dealt)", scene, calls, plain_log=True)
        terminals = [c for c in calls if c[0] == "terminal"]
        # a tile whose lane count is no multiple of 32
        cut = o.shape[0] * 5 // 8 - 19
        oc, dc, uc = o[:cut].contiguous(), d[:cut].contiguous(), unifs[:, :, :cut].contiguous()
        check_mc(f"{label} (blocked), first {cut} lanes", scene, oc, dc, uc)
        check_coop_mc(f"{label}, first {cut} lanes", scene, oc, dc, uc)
        _, _, ragged = binned_walk(scene, oc, dc, uc)
        check_binned_kernels(f"{label}, first {cut} lanes", scene,
                             [c for c in ragged if c[0] != "primary"])
        check_coop_primaries(f"{label}, first {cut} lanes", scene, ragged)
        check_coop_bounces(f"{label}, first {cut} lanes", scene, ragged)
        terminals += [c for c in ragged if c[0] == "terminal"]
        # the lanes sorted but not dealt, and left in pixel order
        for order in ("sorted", "pixel"):
            _, _, other = binned_walk(scene, o, d, unifs, order=order)
            check_coop_bounces(f"{label} ({order} order)", scene, other)
            terminals += [c for c in other if c[0] == "terminal"]
        # dead lanes scattered through a bounce's state
        holed = []
        for kind, sf, si, u, first in [c for c in calls if c[0] == "bounce"][:3]:
            si = si.clone()
            si[mc_binned.I_ALIVE, torch.as_tensor(rng.uniform(size=si.shape[1]) < 0.3,
                                                  device=dev)] = 0
            holed.append((kind, sf, si, u, first))
        # and through the terminal's state (after the bounce before it)
        _, sf, si, first = [c for c in calls if c[0] == "terminal"][0]
        si = si.clone()
        si[mc_binned.I_ALIVE, torch.as_tensor(rng.uniform(size=si.shape[1]) < 0.3,
                                              device=dev)] = 0
        holed.append(("terminal", sf, si, first))
        terminals.append(holed[-1])
        check_binned_kernels(label + ", 30 % of lanes killed", scene, holed)
        check_coop_bounces(label + ", 30 % of lanes killed", scene, holed)
        check_coop_terminals(label + " (dealt, ragged, sorted, pixel order, holed)", scene,
                             terminals)
    # the primary casts of all 16 tiles of a mesh11k 1024x1024 epoch, as the
    # binned route makes them
    epoch_primaries = []
    for t, clip in enumerate(_clips(mesh_cfg, dev)[0]):
        normals, _ = tile_draws(mesh_cfg, 0, 0, t, clip.shape[0], dev)
        o, d = camera_ops.shoot_focus(mesh11k_cam, clip, normals * mesh_cfg.blur,
                                      mesh_cfg.focus)
        epoch_primaries.append(("primary", o.t().contiguous(), d.t().contiguous()))
    check_coop_primaries(f"mesh11k 1024x1024, the epoch's {len(epoch_primaries)} tiles", mesh11k,
                         epoch_primaries)

    # the unfused path's four kernels: the demo's primary hits, their
    # shadow rays and marches, and random rays
    unfused_err = {}

    def keep(name, err):
        unfused_err[name] = max(unfused_err.get(name, 0.0), err)

    for label, cfg, tile in cases[:1] + cases[2:]:
        o, d = camera_ops.shoot(demo_cam, _clips(cfg, dev)[0][tile])
        u = Unfused(demo_u, o, d)
        keep("nearest_hit", u.check_nearest(label))
        keep("shadow_any_hit", u.check_shadow(label))
        for li, rays in enumerate(u.shadow):
            keep("any_hit", u.check_any(f"{label} light {li}", rays, u.considers[li],
                                        u.limits[li]))
        keep("march", u.check_march(label))
        rays, active, limit = random_rays(demo.n_prim, u.n, rng, dev)
        keep("nearest_hit", u.check_nearest(f"{u.n} random rays", rays, active, atol=1e-5))
        keep("any_hit", u.check_any(f"{u.n} random rays", rays, active, limit))
        keep("any_hit", u.check_any(f"{u.n} random rays, no limit", rays, active, None))
    tile_u = u  # the 65536-ray tile of the main path, for phase 5
    # a dense table too large to stage (mesh_scene(30) without its BVH and
    # blocked layout: 1,812 triangles), which the listed kernels walk per
    # thread out of global memory (DenseGeom)
    big_u = dataclasses.replace(big, textures=host_only(big.textures),
                                **{f: None for f in BVH_FIELDS})
    assert not fused_ok(big_u) and big_u.bvh_node_min is None
    ub = Unfused(big_u, *camera_ops.shoot(big_cam, _clips(small, dev)[0][0]))
    big_label = f"mesh_scene(30) dense ({big_u.n_tri} triangles) 64x48"
    # a fine grid: 0.3 % of these primary rays, and up to 0.2 % of their
    # shadow rays, cross an edge two triangles share within an ulp, where
    # a contracted multiply-add and PyTorch's rounding disagree about which
    # side they hit; the triangle tests round as written (common.cuh
    # dot3_sep, edge_in), so they are held at the usual share
    keep("nearest_hit", hold_nearest(big_label, big_u, ub.rays, ub.active))
    for li, rays in enumerate(ub.shadow):
        keep("any_hit", ub.check_any(f"{big_label} light {li}", rays, ub.considers[li],
                                     ub.limits[li]))
    keep("shadow_any_hit", ub.check_shadow(big_label))
    keep("march", hold_march(f"mesh_scene(30) dense ({big_u.n_tri} triangles) 64x48", big_u,
                             ub.march_in))
    # the calls that the unfused MC epoch makes of the nearest-hit, shadow
    # and march kernels, on tile 9 through the tile loop and frame-wide (the
    # main path's shape: the frame's 1,245,184 lanes in one call): the shadow
    # and march kernels against their yardsticks and plain versions, also on
    # ragged cuts; then the epoch frame-wide against the tile loop
    u_draws = [tile_draws(full, 2, 3, t, 65536, dev) for t in range(len(frame_clips))]
    hooks = [(intersect_kernel, "nearest_hit"), (intersect_kernel, "shadow_any_hit"),
             (march_kernel, "march")]
    epoch_calls = {
        "tile 9": capture(hooks, lambda: epoch_tiles(demo_u, demo_cam, full, frame_clips[9:10],
                                                     u_draws[9:10])),
        "frame": capture(hooks, lambda: epoch_frame(demo_u, demo_cam, full, frame_clips,
                                                    u_draws))}
    for where, calls in epoch_calls.items():
        assert [len(calls[name]) for _, name in hooks] == [DEPTH + 1, DEPTH + 1, DEPTH], where
        for i, (args, _) in enumerate(calls["nearest_hit"]):
            keep("nearest_hit", hold_nearest(f"unfused mc epoch, {where}, cast {i}", demo_u,
                                             *args[1:3]))
        for i, (args, _) in enumerate(calls["shadow_any_hit"]):
            keep("shadow_any_hit", hold_shadow(f"unfused mc epoch, {where}, shade {i}", demo_u,
                                               args[1:6]))
        for i, (args, _) in enumerate(calls["march"]):
            keep("march", hold_march(f"unfused mc epoch, {where}, bounce {i}", demo_u, args[1:7],
                                     share=0.999 if where == "frame" else None))
    def cut(x, at, m):  # lanes at:at+m of a [..., N, 3] or [..., N] operand
        return (x[..., at:at + m, :] if x.dim() > 1 and x.shape[-1] == 3
                else x[..., at:at + m]).contiguous()

    marching = epoch_calls["frame"]["march"][0][0][6]  # bounce 0's want
    at = int(torch.nonzero(marching[9 * 65536:])[0]) + 9 * 65536  # tile 9's first
    def cut_rays(r, at, m):
        return Rays(**{f.name: cut(getattr(r, f.name), at, m) for f in dataclasses.fields(r)})

    for m in (3821, 65536 * 5 // 8 - 19):
        for i in (1, 3):  # two advance casts
            r, act = epoch_calls["frame"]["nearest_hit"][i][0][1:3]
            keep("nearest_hit", hold_nearest(f"unfused mc epoch, frame, cast {i}, lanes {at} + {m}",
                                             demo_u, cut_rays(r, at, m), cut(act, at, m)))
        sh = tile_u.shadow[1]  # tile 9's rays to the spot light
        keep("any_hit", hold_any(f"1280x960 tile 9 light 1, lanes 1001 + {m}", demo_u,
                                 cut_rays(sh, 1001, m), cut(tile_u.considers[1], 1001, m),
                                 cut(tile_u.limits[1], 1001, m)))
        args = epoch_calls["frame"]["shadow_any_hit"][1][0][1:6]
        hold_shadow(f"unfused mc epoch, frame, shade 1, lanes {at} + {m}", demo_u,
                    tuple(cut(x, at, m) for x in args))
        args = epoch_calls["frame"]["march"][0][0][1:7]
        hold_march(f"unfused mc epoch, frame, bounce 0, lanes {at} + {m}", demo_u,
                   tuple(cut(x, at, m) for x in args))
    frame_calls = epoch_calls["frame"]  # for the per-launch times of phase 5
    del epoch_calls
    one = epoch_frame(demo_u, demo_cam, full, frame_clips, u_draws)
    per_tile = epoch_tiles(demo_u, demo_cam, full, frame_clips, u_draws)
    torch.cuda.synchronize()
    print(f"unfused mc epoch 1280x960 in one call vs tile by tile: "
          f"{float((one[0] == per_tile[0]).all(dim=1).float().mean()):.6f} of lanes equal, casts "
          f"{int(one[1])} vs {int(per_tile[1])}, filtered {int(one[2])} vs {int(per_tile[2])}")
    assert torch.equal(one[0], per_tile[0]) and int(one[1]) == int(per_tile[1])
    assert int(one[2]) == int(per_tile[2])

    # ---- 3. goldens (scripts/tpu_check.py gates) ------------------------
    z = np.load(os.path.join(GOLDEN, "mc_demo_64x48_draws.npz"))
    draws = [(torch.as_tensor(z["normals"], device=dev), torch.as_tensor(z["unifs"], device=dev))]
    img, stats = render_whitted(demo, demo_cam, small)
    p, bad, ok = golden_gate(img, "whitted_demo_64x48.npy", 38.0, 0.02)
    print(f"golden whitted 64x48: psnr {p:.1f} dB, bad {bad:.4f}, dropped {stats['dropped']}")
    assert ok and stats["dropped"] == 0
    img, stats = render_distributed_epoch(demo, demo_cam, small, draws=draws)
    p, bad, ok = golden_gate(img, "mc_demo_64x48.npy", 25.0, 0.01)
    print(f"golden mc 64x48: psnr {p:.1f} dB, bad {bad:.4f}")
    assert ok
    for grid in (24, 96, 160):
        scene, cam = meshes[grid]
        img, stats = render_whitted(scene, cam, small)
        p, bad, ok = golden_gate(img, f"whitted_mesh{grid}_64x48.npy", 30.0, 0.01)
        print(f"golden whitted mesh{grid} ({scene.n_tri} triangles) 64x48: psnr {p:.1f} dB, "
              f"bad {bad:.4f}, dropped {stats['dropped']}")
        assert ok and stats["dropped"] == 0
    # the draws of PRNGKey(7), tile 0, do not depend on the scene
    img, stats = render_distributed_epoch(mesh24, mesh24_cam, small, draws=draws)
    p, bad, ok = golden_gate(img, "mc_mesh24_64x48.npy", 25.0, 0.01)
    print(f"golden mc mesh24 64x48: psnr {p:.1f} dB, bad {bad:.4f}")
    assert ok

    # the same goldens through the unfused path
    reset_counts()
    img, stats = render_whitted(demo_u, demo_cam, small)
    p, bad, ok = golden_gate(img, "whitted_demo_64x48.npy", 38.0, 0.02)
    ref_default = img.cpu()
    print(f"golden whitted 64x48, unfused path: psnr {p:.1f} dB, bad {bad:.4f}, "
          f"dropped {stats['dropped']}")
    assert ok and stats["dropped"] == 0
    img, stats = render_distributed_epoch(demo_u, demo_cam, small, draws=draws)
    p, bad, ok = golden_gate(img, "mc_demo_64x48.npy", 25.0, 0.01)
    print(f"golden mc 64x48, unfused path: psnr {p:.1f} dB, bad {bad:.4f}")
    assert ok
    got = read_counts()
    assert got["nearest_hit"] > 0 and got["shadow_any_hit"] > 0 and got["march"] > 0, got
    assert not any(got[k] for k in fused_kernels), got
    # a user texture that shares a default's name and paints the wall
    # green: the fused kernels' built-in switch would paint stripes, so it
    # must take the unfused path, here and on the CPU (plain versions)
    green = Texture("stripes", normal=demo.textures[2].normal,
                    diffuse=lambda uv: torch.tensor([0.0, 1.0, 0.0], device=uv.device)
                    .expand(uv.shape[0], 3))
    user = dataclasses.replace(demo, textures=(demo.textures[0], green, demo.textures[2]))
    assert not fused_ok(user)
    reset_counts()
    img, stats = render_whitted(user, demo_cam, small)
    got = read_counts()
    ref, _ = render_whitted(user.to("cpu"), demo_cam.to("cpu"), small)
    fc = frac_close(img.reshape(-1, 3).cpu().numpy(), ref.reshape(-1, 3).numpy())
    moved = float(((img.cpu() - ref_default).abs().amax(dim=-1) > 0.05).float().mean())
    print(f"user texture named 'stripes' 64x48: {fc:.5f} of pixels agree with the CPU's "
          f"plain path, {moved:.3f} of pixels differ from the demo's; launches {got}")
    assert fc >= 0.97 and 0.02 < moved < 0.5 and stats["dropped"] == 0
    assert got["nearest_hit"] > 0 and not any(got[k] for k in fused_kernels), got
    reset_counts()
    img, stats = render_whitted(mesh24_bvh, mesh24_cam, small)
    p, bad, ok = golden_gate(img, "whitted_mesh24_64x48.npy", 30.0, 0.01)
    print(f"golden whitted mesh24 64x48, BVH-only route: psnr {p:.1f} dB, bad {bad:.4f}, "
          f"dropped {stats['dropped']}")
    assert ok and stats["dropped"] == 0
    # tensor operations only: no tracing kernel, no plain sweep
    assert not any(v for k, v in read_counts().items() if k != "deliver")

    # ---- 4. presets, scene files, render_* and the CLI -------------------
    preset_times = presets_phase(dev, reset_counts, read_counts, fused_kernels)
    cli_phase()

    # ---- 5. the main paths -----------------------------------------------
    lines = []

    def log(msg):
        lines.append(msg)
        print(msg, flush=True)

    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.png")
        state, wall = timed(lambda: render_progressive(demo, demo_cam, full, out_path=out,
                                                       log=log))
        demo_launches = read_counts()
        demo_png = read_png_rgb8(out)
    print(f"main path (demo): whitted + {full.epochs} epochs at 1280x960 in {wall:.2f} s wall; "
          f"launches {demo_launches}")
    assert state.epoch == full.epochs
    assert demo_png.shape == (960, 1280, 3) and demo_png.max() > 0, demo_png.shape
    assert torch.isfinite(state.img).all()
    assert not any("dropped" in m for m in lines), lines
    # the Whitted frame: six levels a tile; each epoch: ONE launch of the
    # staged MC walk for the whole frame (read_counts: no per-thread
    # yardstick ran)
    demo_tiles = len(_clips(full, dev)[0])
    assert demo_launches["level"] == demo_tiles * (DEPTH + 1), demo_launches
    assert demo_launches["mc"] == full.epochs, demo_launches
    # and one ordered delivery a tile, of the last level's lanes
    assert demo_launches["deliver"] == demo_tiles, demo_launches

    # the demo epoch's host seconds here, early in phase 5, for comparison
    # with the same epoch profiled after the mesh paths below
    demo_epoch_early_s = min(timed(lambda: render_distributed_epoch(demo, demo_cam, full,
                                                                     epoch=7))[1]
                             for _ in range(3))
    print(f"demo mc epoch 1280x960, early in phase 5: {demo_epoch_early_s:.4f} s host "
          f"(least of three)")

    reset_counts()
    (wimg, wst), mw_s = timed(lambda: render_whitted(mesh11k, mesh11k_cam, mesh_cfg))
    (eimg, est), me_s = timed(lambda: render_distributed_epoch(mesh11k, mesh11k_cam, mesh_cfg))
    mesh_launches = read_counts()
    print(f"main path (mesh11k, {mesh11k.n_tri} triangles): whitted frame 1024x1024 "
          f"{mw_s:.3f} s ({wst['casts'] / mw_s:,.0f} casts/s, dropped {wst['dropped']}), "
          f"mc epoch {me_s:.3f} s ({est['casts'] / me_s:,.0f} casts/s); "
          f"launches {mesh_launches}")
    for img in (wimg, eimg):
        assert tuple(img.shape) == (1024, 1024, 3) and torch.isfinite(img).all()
        assert float(img.max()) > 0
    assert wst["dropped"] == 0
    tiles = len(_clips(mesh_cfg, dev)[0])
    # every level of every tile through the cooperative blocked level kernel
    # (read_counts: no per-thread yardstick ran); the epoch's 16 tiles in
    # ONE launch of the cooperative MC walk, no binned kernel
    assert mesh_launches["level_blk"] == tiles * (DEPTH + 1), mesh_launches
    assert mesh_launches["deliver"] == tiles, mesh_launches
    assert mesh_launches["mc_blk"] == 1, mesh_launches
    assert not any(mesh_launches[k] for k in ("binned_primary", "binned_bounce",
                                              "binned_terminal")), mesh_launches
    # the same epoch through the binned route
    reset_counts()
    (bimg, bst), mb_s = timed(lambda: binned_route(
        lambda: render_distributed_epoch(mesh11k, mesh11k_cam, mesh_cfg)))
    binned_launches = read_counts()
    print(f"mesh11k mc epoch through the binned route (BINNED_MIN_TRIS lowered): {mb_s:.3f} s; "
          f"launches {binned_launches}")
    assert all(binned_launches[k] == tiles for k in ("binned_primary", "binned_terminal"))
    assert binned_launches["binned_bounce"] == tiles * DEPTH and binned_launches["mc_blk"] == 0
    assert bst["casts"] == est["casts"] and torch.isfinite(bimg).all()

    reset_counts()
    (m24img, m24st), m24_s = timed(lambda: render_distributed_epoch(mesh24, mesh24_cam,
                                                                    mesh_cfg))
    m24_launches = read_counts()
    print(f"main path (mesh24 mc epoch 1024x1024): {m24_s:.3f} s; launches {m24_launches}")
    assert torch.isfinite(m24img).all() and float(m24img.max()) > 0
    assert m24_launches["mc_blk"] == 1, m24_launches

    mesh51k, mesh51k_cam = meshes[160]
    render_whitted(mesh51k, mesh51k_cam, mesh_cfg)  # first-call set-up
    reset_counts()
    (_, w51), w51_s = timed(lambda: render_whitted(mesh51k, mesh51k_cam, mesh_cfg))
    w51_launches = read_counts()
    print(f"mesh51k ({mesh51k.n_tri} triangles) whitted frame 1024x1024: {w51_s:.3f} s "
          f"({w51['casts'] / w51_s:,.0f} casts/s, dropped {w51['dropped']}); "
          f"launches {w51_launches}")
    assert w51["dropped"] == 0 and w51_launches["level_blk"] == tiles * (DEPTH + 1), w51_launches

    # the MC route on this card: each mesh's 1024x1024 epoch through the
    # default route (the blocked MC kernel, one launch) and the binned
    # route, the least host seconds of three, casts equal
    routes = {}
    for grid in (24, 75, 160, 320):
        scene, cam = meshes[grid] if grid in meshes else (x.to(dev) for x in mesh_scene(grid))
        epoch = lambda: render_distributed_epoch(scene, cam, mesh_cfg, epoch=7)
        row = {"n_tri": scene.n_tri}
        for route, run in (("mega", epoch), ("binned", lambda: binned_route(epoch))):
            _, st = run()  # first-call set-up
            reset_counts()
            row[f"{route}_s"] = min(timed(run)[1] for _ in range(3))
            got = read_counts()
            assert (got["mc_blk"] == 3) == (route == "mega"), (grid, route, got)
            row[f"{route}_casts"] = st["casts"]
        assert row["mega_casts"] == row["binned_casts"], (grid, row)
        routes[f"mesh_scene({grid})"] = row
        print(f"mc epoch mesh_scene({grid}) ({scene.n_tri} triangles) 1024x1024: blocked mc "
              f"kernel {row['mega_s']:.4f} s, binned {row['binned_s']:.4f} s "
              f"({row['binned_s'] / row['mega_s']:.1f}x); BINNED_MIN_TRIS "
              f"{mc_binned.BINNED_MIN_TRIS}")
    del scene, cam

    # the unfused path at the reference schedule's full width: the demo
    # scene with row-less textures, Whitted + 2 epochs; its peak device
    # memory (an epoch takes the frame's 1,245,184 lanes at once)
    ucfg = dataclasses.replace(full, epochs=2)
    render_whitted(demo_u, demo_cam, ucfg)  # first-call set-up
    ulines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.png")
        ustate, uwall = timed(lambda: render_progressive(
            demo_u, demo_cam, ucfg, out_path=out, log=lambda m: (ulines.append(m), print(m))))
        unfused_launches = read_counts()
        unfused_peak = torch.cuda.max_memory_allocated()
        png = read_png_rgb8(out)
    print(f"main path (demo, unfused): whitted + {ucfg.epochs} epochs at 1280x960 in "
          f"{uwall:.2f} s wall; launches {unfused_launches}; peak device memory "
          f"{unfused_peak / 2**30:.2f} GiB")
    assert ustate.epoch == ucfg.epochs and torch.isfinite(ustate.img).all()
    assert png.shape == (960, 1280, 3) and png.max() > 0, png.shape
    assert not any("dropped" in m for m in ulines), ulines
    # the Whitted ladder tile by tile: a cast and a shade a level, a march
    # but at the last; an epoch in ONE call: a primary and five advance
    # casts, five shades and the terminal shade, five marches
    whitted_tiles = len(_clips(ucfg, dev)[0])
    assert unfused_launches["nearest_hit"] == (whitted_tiles + ucfg.epochs) * (DEPTH + 1)
    assert unfused_launches["shadow_any_hit"] == (whitted_tiles + ucfg.epochs) * (DEPTH + 1)
    assert unfused_launches["march"] == (whitted_tiles + ucfg.epochs) * DEPTH, unfused_launches
    assert not any(unfused_launches[k] for k in fused_kernels), unfused_launches

    # the per-light shadow test of the main path's tile through the public
    # cast_any_hit: the any-hit kernel's route (get_shade takes the shadow
    # kernel wherever the any-hit kernel would be eligible, shade.py:67)
    reset_counts()
    per_light = torch.stack([cast_any_hit(demo_u, tile_u.shadow[li], active=tile_u.considers[li],
                                          limit=tile_u.limits[li])
                             for li in range(demo_u.n_light)])
    torch.cuda.synchronize()
    any_launches = read_counts()
    print(f"cast_any_hit path (tile 9, {demo_u.n_light} lights): {int(per_light.sum())} of "
          f"{int(tile_u.considers.sum())} shadow rays blocked; launches {any_launches}")
    assert any_launches["any_hit"] == demo_u.n_light and int(per_light.sum()) > 0
    assert not bool(per_light[~tile_u.considers].any())

    # unfused against fused on this card: the Whitted frame, and one MC
    # epoch on the same draws
    (uimg, ust), uw_s = timed(lambda: render_whitted(demo_u, demo_cam, full))
    (fimg, fst), fw_s = timed(lambda: render_whitted(demo, demo_cam, full))
    fc = frac_close(uimg.reshape(-1, 3).cpu().numpy(), fimg.reshape(-1, 3).cpu().numpy())
    print(f"whitted frame 1280x960, unfused vs fused: {fc:.5f} of pixels agree, casts "
          f"{ust['casts']} vs {fst['casts']}, dropped {ust['dropped']}/{fst['dropped']}; "
          f"{uw_s:.3f} s vs {fw_s:.3f} s")
    assert fc >= 0.97 and casts_close(ust["casts"], fst["casts"])
    assert ust["dropped"] == 0 and fst["dropped"] == 0
    (uep, uest), ue_s = timed(lambda: render_distributed_epoch(demo_u, demo_cam, full, epoch=7))
    (fep, fest), fe_s = timed(lambda: render_distributed_epoch(demo, demo_cam, full, epoch=7))
    fc = frac_close(uep.reshape(-1, 3).cpu().numpy(), fep.reshape(-1, 3).cpu().numpy())
    print(f"mc epoch 1280x960 on the same draws, unfused vs fused: {fc:.5f} of lanes agree, "
          f"casts {uest['casts']} vs {fest['casts']}; {ue_s:.3f} s vs {fe_s:.3f} s")
    assert fc >= 0.99 and casts_close(uest["casts"], fest["casts"])
    assert torch.isfinite(uep).all() and float(uep.max()) > 0

    # ---- 5b. the Whitted ladder as CUDA graphs ------------------------------
    graph_times = ladder_graph_phase(dev, [("demo 1280x960", demo, demo_cam, full),
                                           ("mesh11k 1024x1024", mesh11k, mesh11k_cam,
                                            mesh_cfg)])

    # ---- 5c. the SPD sphereflake's gated MC walk ---------------------------
    spd = spd_phase(dev)

    # ---- 6. multi-card rendering ------------------------------------------
    mesh_times, world1_launches = mesh_phase(dev, reset_counts, read_counts, demo, demo_cam,
                                             full, mesh11k, mesh11k_cam, mesh_cfg, state,
                                             demo_png, smi)
    # ---- 7. a real world on the host's cards -------------------------------
    if torch.cuda.device_count() >= 2:
        multicard = multicard_phase(card_spec(), smi_lines)
    else:
        multicard = None
        print(f"phase 7: not run: {torch.cuda.device_count()} CUDA device (run chip_smoke.py "
              f"--phase multicard on a host with 2 or more)")
    launches = {k: demo_launches[k] + mesh_launches[k] + binned_launches[k] + m24_launches[k]
                + w51_launches[k] + unfused_launches[k] + any_launches[k] + world1_launches[k]
                for k in counts}

    # frames and epochs, kernel vs plain, host clock around a sync
    def whitted_plain_frame(scene, cam, cfg):
        for clip in _clips(cfg, dev)[0]:
            o, d = camera_ops.shoot(cam, clip)
            trace_whitted(scene, o, d, cfg, level_fn=plain_level)

    def mc_plain_epoch(scene, cam, cfg):
        for t, clip in enumerate(_clips(cfg, dev)[0]):
            normals, unifs = tile_draws(cfg, 0, 0, t, clip.shape[0], dev)
            o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
            plain_mc(scene, o.contiguous(), d.contiguous(), unifs)

    frames = {}
    for name, scene, cam, cfg in (("demo 1280x960", demo, demo_cam, full),
                                  ("mesh11k 1024x1024", mesh11k, mesh11k_cam, mesh_cfg)):
        (_, wst), w_s = timed(lambda: render_whitted(scene, cam, cfg))
        _, wp_s = timed(lambda: whitted_plain_frame(scene, cam, cfg))
        (_, est), e_s = timed(lambda: render_distributed_epoch(scene, cam, cfg, epoch=7))
        _, ep_s = timed(lambda: mc_plain_epoch(scene, cam, cfg))
        frames[name] = {"whitted_frame_s": w_s, "whitted_frame_plain_s": wp_s,
                        "mc_epoch_s": e_s, "mc_epoch_plain_s": ep_s}
        if scene.blocked:  # the same epoch on the binned route
            (_, est2), e2_s = timed(lambda: binned_route(
                lambda: render_distributed_epoch(scene, cam, cfg, epoch=7)))
            assert est2["casts"] == est["casts"], (est2["casts"], est["casts"])
            frames[name]["mc_epoch_binned_s"] = e2_s
            print(f"mc epoch {name} through the binned route instead: {e2_s:.3f} s")
        print(f"whitted frame {name}: kernel {w_s:.3f} s ({wst['casts'] / w_s:,.0f} casts/s), "
              f"plain {wp_s:.3f} s")
        print(f"mc epoch {name}: kernel {e_s:.3f} s ({est['casts'] / e_s:,.0f} casts/s), "
              f"plain {ep_s:.3f} s")
    frames["mesh51k 1024x1024"] = {"whitted_frame_s": w51_s}
    frames["demo 1280x960"]["mc_epoch_early_s"] = demo_epoch_early_s
    frames["demo unfused 1280x960"] = {"whitted_frame_s": uw_s, "mc_epoch_s": ue_s,
                                       "fused_whitted_frame_s": fw_s, "fused_mc_epoch_s": fe_s,
                                       "peak_bytes": unfused_peak}

    # where the mesh11k frame and epoch spend device time (both MC routes)
    profiles = {
        "mesh11k whitted": profile_breakdown(
            "mesh11k whitted frame", lambda: render_whitted(mesh11k, mesh11k_cam, mesh_cfg)),
        "mesh11k mc binned": binned_route(lambda: profile_breakdown(
            "mesh11k mc epoch (binned)",
            lambda: render_distributed_epoch(mesh11k, mesh11k_cam, mesh_cfg, epoch=7)))}
    for name, scene in (("demo unfused", demo_u), ("demo fused", demo)):
        profiles[f"{name} whitted"] = profile_breakdown(
            f"{name} whitted frame", lambda: render_whitted(scene, demo_cam, full))
        profiles[f"{name} mc"] = profile_breakdown(
            f"{name} mc epoch",
            lambda: render_distributed_epoch(scene, demo_cam, full, epoch=7))
    profiles["mesh11k mc mega"] = profile_breakdown(
        "mesh11k mc epoch (blocked mc kernel)",
        lambda: render_distributed_epoch(mesh11k, mesh11k_cam, mesh_cfg, epoch=7))

    # per-launch times at the main paths' shapes: the dense MC walk on the
    # whole 1280x960 frame (19 tiles in one launch), the blocked one on one
    # 65536-ray tile
    def time_mc(scene, cam, cfg):
        clips = _clips(cfg, dev)[0]
        if scene.blocked:
            clips = clips[:1]
        tile_in = [tile_draws(cfg, 0, 0, t, clip.shape[0], dev) for t, clip in enumerate(clips)]
        normals, unifs = frame_draws(tile_in)
        o, d = camera_ops.shoot_focus(cam, clips.reshape(-1, 2), normals * cfg.blur, cfg.focus)
        o, d = o.contiguous(), d.contiguous()
        n = o.shape[0]
        work = torch.zeros((len(kernels.WORK_ROWS), n), dtype=torch.int32, device=dev)
        mk, casts = mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR)
        mw, _ = mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR, work=work)
        assert torch.equal(mk, mw)  # counting changes no result
        mp, casts_p = plain_mc(scene, o, d, unifs)
        # the kernel against the plain version at this shape, as check_mc
        a, b = mk.cpu().numpy(), mp.cpu().numpy()
        fc = frac_close(a, b)
        print(f"mc {n} rays in one launch: {fc:.5f} of lanes agree with the plain version, "
              f"casts {int(casts)} vs {int(casts_p)}")
        assert np.isfinite(a).all() and fc >= 0.99, fc
        assert casts_close(casts, casts_p), (int(casts), int(casts_p))
        io = nbytes(o, d, unifs, *scene_tables(scene)) + 16 * n  # photon + casts
        b_ms, b_by, ops = bound(io, work)
        run = lambda: mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR)
        out = dict(rays=n, max_abs_err=float((mk - mp).abs().max()),
                   phases=phase_shares(work) if scene.blocked else walk_phases(work),
                   ms=device_ms(run, 5, "mc_kernel"), events_ms=cuda_ms(run, 5),
                   per_thread_ms=cuda_ms(lambda: mc_kernel.trace_per_thread(
                       scene, o, d, unifs, DEPTH, MD, MR), 3),
                   plain_ms=cuda_ms(lambda: plain_mc(scene, o, d, unifs), 1),
                   bound_ms=b_ms, bound_by=b_by, bytes=io, ops=ops,
                   tests=totals(work))
        if scene.blocked:  # and the whole frame in one launch, as the epoch takes it
            fclips = _clips(cfg, dev)[0]
            f_in = [tile_draws(cfg, 0, 0, t, c.shape[0], dev) for t, c in enumerate(fclips)]
            fnorm, fu = frame_draws(f_in)
            fo, fd = camera_ops.shoot_focus(cam, fclips.reshape(-1, 2), fnorm * cfg.blur,
                                            cfg.focus)
            fo, fd = fo.contiguous(), fd.contiguous()
            fw = torch.zeros((len(kernels.WORK_ROWS), fo.shape[0]), dtype=torch.int32,
                             device=dev)
            mc_kernel.trace(scene, fo, fd, fu, DEPTH, MD, MR, work=fw)
            f_io = nbytes(fo, fd, fu, *scene_tables(scene)) + 16 * fo.shape[0]
            f_ms, f_by, f_ops = bound(f_io, fw)
            out.update(rays_frame=fo.shape[0], bound_ms_frame=f_ms, bound_by_frame=f_by,
                       ops_frame=f_ops, bytes_frame=f_io, ms_frame=device_ms(
                           lambda: mc_kernel.trace(scene, fo, fd, fu, DEPTH, MD, MR), 3,
                           "mc_kernel"))
            del fw
        if not scene.blocked:  # and the first tile alone, as one launch took it before
            t0 = slice(0, clips.shape[1])
            o0, d0, u0 = o[t0].contiguous(), d[t0].contiguous(), unifs[:, :, t0].contiguous()
            out.update(block_us=block_spread(work), ms_per_65536=out["ms"] * 65536 / n,
                       ms_tile=device_ms(lambda: mc_kernel.trace(scene, o0, d0, u0, DEPTH, MD,
                                                                 MR), 5, "mc_kernel"),
                       per_thread_ms_tile=device_ms(lambda: mc_kernel.trace_per_thread(
                           scene, o0, d0, u0, DEPTH, MD, MR), 5, "mc_kernel"))
        return out

    def time_level(scene, cam, cfg):
        """The level kernel on the pools of the first tile's Whitted ladder:
        the primary level on the dense demo; on a blocked mesh each of the
        six levels, through both walks.  Per level: ms (torch.profiler) and
        events_ms (CUDA events around 5 back-to-back launches: below ~0.2 ms
        they read the host's launch pace), the per-thread walk's ms, the
        plain version's, the bound, the tests, a warp's cycles by phase and
        the block durations.  The blocked fields are the means over the six
        levels (each level launches once a tile); max_abs_err is the primary
        level's contrib against the plain version's."""
        clip = _clips(cfg, dev)[0][0]
        args = (cfg.threshold, cfg.max_refract_distance, cfg.max_tir_retries)
        pools = level_pools(scene, cam, clip, cfg)
        levels = []
        for pool, last, direct in (pools if scene.blocked else pools[:1]):
            run = lambda fn=level_kernel.process_level, **kw: fn(scene, pool, last, direct, *args,
                                                                 **kw)
            work = new_work(pool.width)
            lk, lw = run(), run(work=work)
            assert torch.equal(lk[0], lw[0])  # counting changes no result
            lp = plain_level(scene, pool, last, direct, *args)
            io = level_bytes(scene, pool)
            b_ms, b_by, ops = bound(io, work)
            lv = dict(k=pool.width, max_abs_err=float((lk[0] - lp[0]).abs().max()),
                      ms=device_ms(run, 10, "level_kernel"), events_ms=cuda_ms(run, 5),
                      plain_ms=cuda_ms(lambda: plain_level(scene, pool, last, direct, *args), 1),
                      bound_ms=b_ms, bound_by=b_by, bytes=io, ops=ops, tests=totals(work))
            thread = lambda: run(level_kernel.process_level_per_thread)
            lv.update(per_thread_ms=device_ms(thread, 3, "level_kernel"),
                      per_thread_events_ms=cuda_ms(thread, 3),
                      phases=phase_shares(work) if scene.blocked else walk_phases(work),
                      block_us=block_spread(work))
            levels.append(lv)
        mean = lambda key: sum(lv[key] for lv in levels) / len(levels)
        out = dict(levels[0], levels=levels)
        if not scene.blocked:  # the mean over a whole frame's launches
            ms, seen = profiled_ms(lambda: render_whitted(scene, cam, cfg), "level_kernel")
            out.update(frame_mean_ms=ms, frame_launches=seen)
        if scene.blocked:
            out.update({key: mean(key) for key in ("ms", "events_ms", "plain_ms", "bound_ms",
                                                   "per_thread_ms", "per_thread_events_ms")},
                       ms_primary=levels[0]["ms"],
                       bound_by="operations" if any(lv["bound_by"] == "operations"
                                                    for lv in levels) else "bytes")
        return out

    def time_binned(scene, cam, cfg):
        """Each binned kernel on the inputs it got in one 65536-ray tile's
        walk: ms and bound per launch (bounces: the mean over the walk's
        five), plain_ms likewise.  ms is the kernel's own device time
        (torch.profiler over 5 launches, device_ms; CUDA events around
        back-to-back calls of the wrapper read the host's pace once the
        kernel is shorter than the wrapper's host work, as the terminal
        kernel is).  The bounces in other lane orders and the per-thread
        bounce are timed with CUDA events."""
        clip = _clips(cfg, dev)[0][0]
        normals, unifs = tile_draws(cfg, 0, 0, 0, clip.shape[0], dev)
        o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
        o, d = o.contiguous(), d.contiguous()
        _, _, calls = binned_walk(scene, o, d, unifs)
        out = {}
        # the bounces of the same walk in the other lane orders, and the
        # per-thread instantiation
        bounces = lambda cs: [c for c in cs if c[0] == "bounce"]
        mean_ms = lambda cs, fn: sum(cuda_ms(lambda: fn(c), 5) for c in bounces(cs)) / DEPTH
        coop = lambda c: run_binned(scene, c)
        thread = lambda c: mc_binned.bounce_per_thread(scene, *c[1:], MD, MR)
        out["bounce_orders"] = {"dealt_ms": mean_ms(calls, coop),
                                "per_thread_dealt_ms": mean_ms(calls, thread)}
        for order in ("sorted", "pixel"):
            _, _, other = binned_walk(scene, o, d, unifs, order=order)
            out["bounce_orders"][f"{order}_ms"] = mean_ms(other, coop)
            out["bounce_orders"][f"per_thread_{order}_ms"] = mean_ms(other, thread)
            work = new_work(o.shape[0])
            tests, spread = {}, []
            for c in bounces(other):
                run_binned(scene, c, work=work)
                tests = {k: tests.get(k, 0) + v for k, v in totals(work).items()}
                spread.append(block_spread(work))
            out["bounce_orders"][f"{order}_sharing"] = sharing(tests)
            out["bounce_orders"][f"{order}_block_us_median_longest"] = spread
        spreads, phases = [], []
        for kind in ("primary", "bounce", "terminal"):
            mine = [c for c in calls if c[0] == kind]
            ms = plain_ms = b_ms = io = ops = 0.0
            by = set()
            tests = {}
            for call in mine:
                n = call[1].shape[1]
                work = torch.zeros((len(kernels.WORK_ROWS), n), dtype=torch.int32, device=dev)
                got = run_binned(scene, call)
                counted = run_binned(scene, call, work=work)
                assert all(a is None or torch.equal(a, b) for a, b in zip(got, counted))
                ins = [t for t in call[1:] if isinstance(t, torch.Tensor)]
                outs = {"primary": (21 + 5 + 1) * 4, "bounce": (21 + 5 + 1) * 4,
                        "terminal": 4 * 4}[kind] * n
                call_io = nbytes(*ins, *scene_tables(scene)) + outs
                b, b_by, call_ops = bound(call_io, work)
                b_ms, io, ops = b_ms + b, io + call_io, ops + call_ops
                by.add(b_by)
                for k, v in totals(work).items():
                    tests[k] = tests.get(k, 0) + v
                if kind == "bounce":
                    spreads.append(block_spread(work))
                    phases.append(phase_shares(work))
                ms += device_ms(lambda: run_binned(scene, call), 5, f"binned_{kind}")
                plain_ms += cuda_ms(lambda: run_binned(scene, call, plain=True), 1)
            k = len(mine)
            out[f"binned_{kind}"] = dict(ms=ms / k, plain_ms=plain_ms / k, bound_ms=b_ms / k,
                                         bound_by="operations" if "operations" in by else "bytes",
                                         bytes=io / k, ops=ops / k,
                                         tests={t: v / k for t, v in tests.items()})
        out["bounce_orders"]["dealt_block_us_median_longest"] = spreads
        out["bounce_orders"]["dealt_phases"] = phases
        _, sf, si, first = [c for c in calls if c[0] == "terminal"][0]
        term = out["binned_terminal"]
        term["per_thread_ms"] = device_ms(
            lambda: mc_binned.terminal_per_thread(scene, sf, si, first), 5, "binned_terminal")
        work = new_work(sf.shape[1])
        mc_binned.terminal(scene, sf, si, first, work=work)
        term["phases"], term["block_us"] = phase_shares(work), block_spread(work)
        _, o_t, d_t = calls[0]
        prim = out["binned_primary"]
        prim["per_thread_ms"] = device_ms(lambda: mc_binned.primary_per_thread(scene, o_t, d_t),
                                          5, "binned_primary")
        n = o_t.shape[1]
        work = new_work(n)
        mc_binned.primary(scene, o_t, d_t, work=work)
        work = work[:, mc_binned.primary_lanes(n, dev).clamp(max=n - 1)]  # threads' order
        prim["phases"], prim["block_us"] = phase_shares(work), block_spread(work)
        return out

    def time_unfused(u, frame_calls):
        """The four standalone kernels at the main path's shapes: the
        nearest-hit, shadow and march kernels on the calls that the unfused
        MC epoch makes frame-wide (frame_calls: 6, 6 and 5 calls of the
        frame's 1,245,184 lanes), each figure the mean per launch over
        them; the any-hit kernel on the shadow rays of tile 9's primary
        hits, a launch per light (cast_any_hit's route), the mean of the
        three.  The first three also on tile 9's primary hits (Unfused:
        the inputs of the earlier rows), as `*_tile`.  Per kernel: ms, its
        kernels' own device time (torch.profiler, with the list_lanes
        launch that each listed kernel makes first), queued_ms (the
        wrapper's calls queued behind a device sleep), plain_ms (CUDA
        events), the bound (the bytes each call must move as far as a lane
        needs them: sweep_bytes, shadow_bytes, march_bytes; the tests it
        counted), and the per-thread yardsticks' ms."""
        ik = intersect_kernel

        def nearest(sc, rays, active=None):
            act = torch.ones_like(rays.face, dtype=torch.bool) if active is None else active
            return (lambda work=None: ik.nearest_hit(sc, rays, act, work=work),
                    lambda: ik.nearest_hit_plain(sc.tables, rays, act),
                    lambda: ik.nearest_hit_per_thread(sc, rays, act),
                    sweep_bytes(sc, act, 10), rays.o.shape[0])

        def any_hit(sc, rays, active, limit):
            return (lambda work=None: ik.any_hit(sc, rays, active, limit, work=work),
                    lambda: ik.any_hit_plain(sc.tables, rays, active, limit.clamp(max=BIG)),
                    lambda: ik.any_hit_per_thread(sc, rays, active, limit),
                    sweep_bytes(sc, active, 1, limited=True), rays.o.shape[0])

        def shadow(sc, *args):
            return (lambda work=None: ik.shadow_any_hit(sc, *args, work=work),
                    lambda: ik.shadow_any_hit_plain(sc.tables, *args),
                    lambda: ik.shadow_any_hit_per_thread(sc, *args),
                    shadow_bytes(sc, args[4]), args[0].shape[0])

        def march(sc, pos, normal, ray_d, prim, k, want, *_):
            args = (sc, pos, normal, ray_d, prim, k, want, MD, MR)
            return (lambda work=None: march_kernel.march(*args, work=work),
                    lambda: march_kernel.march_plain(sc.tables, pos, normal, ray_d, k, want,
                                                     MD, MR),
                    lambda: march_kernel.march_per_thread(*args),
                    march_bytes(sc, want), pos.shape[0])

        names = {"nearest_hit": ("nearest_kernel", "nearest_thread_kernel"),
                 "any_hit": ("any_kernel", "any_thread_kernel"),
                 "shadow_any_hit": ("shadow_kernel", "shadow_thread_kernel"),
                 "march": ("march_kernel", "march_thread_kernel")}

        def measure(name, specs):
            kname, tname = names[name]
            row = dict(launches_timed=len(specs), ms=0.0, queued_ms=0.0, plain_ms=0.0,
                       bound_ms=0.0, bytes=0, ops=0, tests={}, per_thread_ms=0.0)
            by = set()
            for kernel, plain, yard, io, n in specs:
                row["rays"] = n
                work = work_for(n, dev)
                got, counted = kernel(), kernel(work=work)
                pairs = zip(got, counted) if isinstance(got, tuple) else [(got, counted)]
                assert all(torch.equal(a, b) for a, b in pairs), name  # counting changes nothing
                b_ms, b_by, ops = bound(io, work)
                by.add(b_by)
                # and the lane list each listed kernel launches first
                row["ms"] += device_ms(kernel, 5, kname) + device_ms(kernel, 5, "list_lanes")
                row["per_thread_ms"] += device_ms(yard, 5, tname)
                row["queued_ms"] += queued_ms(kernel, 5)
                row["plain_ms"] += cuda_ms(plain, 1)
                row["bound_ms"] += b_ms
                row["bytes"] += io
                row["ops"] += ops
                for key, v in totals(work).items():
                    row["tests"][key] = row["tests"].get(key, 0) + v
            k = len(specs)
            for key in ("ms", "queued_ms", "plain_ms", "bound_ms", "bytes", "ops",
                        "per_thread_ms"):
                row[key] /= k
            row["tests"] = {key: v / k for key, v in row["tests"].items()}
            row["bound_by"] = "operations" if "operations" in by else "bytes"
            return row

        sc, h = u.scene, u.hits
        tile = {"nearest_hit": [nearest(sc, u.rays, u.active)],
                "shadow_any_hit": [shadow(sc, h.pos, u.to_light, h.prim, u.limits, u.considers)],
                "march": [march(sc, *u.march_in)]}
        frame = {"nearest_hit": [nearest(*a, **kw) for a, kw in frame_calls["nearest_hit"]],
                 "shadow_any_hit": [shadow(*a) for a, _ in frame_calls["shadow_any_hit"]],
                 "march": [march(*a) for a, _ in frame_calls["march"]]}
        out = {}
        for name in ("nearest_hit", "shadow_any_hit", "march"):
            row = measure(name, frame[name])
            row.update({f"{key}_tile": v for key, v in measure(name, tile[name]).items()
                        if key in ("ms", "queued_ms", "plain_ms", "bound_ms", "per_thread_ms")})
            out[name] = row
        out["any_hit"] = measure("any_hit", [any_hit(sc, u.shadow[li], u.considers[li],
                                                     u.limits[li]) for li in range(sc.n_light)])
        for name, row in out.items():
            row["max_abs_err"] = unfused_err[name]
        return out

    def time_deliver(scene, cam, cfg):
        """The ordered delivery at the main path's shapes: the demo Whitted
        frame's calls (one a tile, its last level's pool), each figure the
        mean per call: ms the kernel's own device time (torch.profiler),
        call_ms all that the wrapper enqueues (the stable sort, the copies
        and the kernel; queued_ms), plain_ms the plain version
        (index_add, whose sums on the card take no fixed order),
        library_ms one in-place index_add_ on a prepared index (queued),
        max_abs_err against the CPU's index_add, and the bound of the
        kernel's own work on this data (what ms times): every lane's sorted
        slot read once; for each lane that carries radiance its position
        (int64) and its three floats read and three adds; each pixel such a
        lane touches read and written once.  The wrapper's clone and sort
        are call_ms's, not the kernel's."""
        from raytracer_tpu_torch.utils.roofline import PEAK_BYTES, PEAK_FP32

        with eager_ladder():
            calls = capture([(trace_ops, "deliver")], lambda: render_whitted(scene, cam, cfg))
        calls = [args for args, _ in calls["deliver"]]
        assert len(calls) == len(_clips(cfg, dev)[0]), len(calls)
        row = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0,
                   ops=0, lanes=0, max_abs_err=0.0, tests={}, calls=len(calls))
        for img, slot, contrib in calls:
            run = lambda: trace_ops.deliver(img, slot, contrib)
            want = img.cpu().index_add(0, slot.cpu().long(), contrib.cpu())
            row["max_abs_err"] = max(row["max_abs_err"], float((run().cpu() - want).abs().max()))
            idx, out = slot.long(), img.clone()
            owes = (contrib != 0.0).any(dim=1)  # the lanes the kernel walks
            lanes, pixels = int(owes.sum()), int(torch.unique(slot[owes]).numel())
            io = slot.numel() * 4 + lanes * (8 + 3 * 4) + pixels * 2 * 3 * 4
            ops = 3 * lanes
            row["ms"] += device_ms(run, 10, "deliver_kernel")
            row["call_ms"] += queued_ms(run, 10)
            row["plain_ms"] += queued_ms(lambda: img.index_add(0, slot.long(), contrib), 10)
            row["library_ms"] += queued_ms(lambda: out.index_add_(0, idx, contrib), 10)
            row["bound_ms"] += max(io / PEAK_BYTES, ops / PEAK_FP32) * 1e3
            row["bytes"] += io
            row["ops"] += ops
            row["lanes"] += slot.numel()
        for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bytes", "ops",
                    "lanes"):
            row[key] /= len(calls)
        row["bound_by"] = "bytes" if row["bytes"] / PEAK_BYTES >= row["ops"] / PEAK_FP32 \
            else "operations"
        row["rays"] = round(row["lanes"])
        print(f"deliver, the demo Whitted frame's {len(calls)} calls of {row['rays']} lanes on "
              f"average, per call: kernel {row['ms']:.4f} ms, the whole call (sort, copies, "
              f"kernel) {row['call_ms']:.4f} ms, index_add {row['plain_ms']:.4f} ms, index_add_ "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms; max |err| against "
              f"the CPU's index_add {row['max_abs_err']}")
        assert row["max_abs_err"] == 0.0
        return row

    per = {"mc": time_mc(demo, demo_cam, full), "level": time_level(demo, demo_cam, full),
           "mc_blk": time_mc(mesh11k, mesh11k_cam, mesh_cfg),
           "level_blk": time_level(mesh11k, mesh11k_cam, mesh_cfg)}
    binned_times = time_binned(mesh11k, mesh11k_cam, mesh_cfg)
    orders = binned_times.pop("bounce_orders")
    per.update(binned_times)
    per.update(time_unfused(tile_u, frame_calls))
    per["deliver"] = time_deliver(demo, demo_cam, full)
    for order in ("dealt", "sorted", "pixel"):
        print(f"binned_bounce on one mesh11k tile's walk, lanes in {order} order, mean of its "
              f"five launches (CUDA events): cooperative {orders[order + '_ms']:.3f} ms, "
              f"per-thread {orders['per_thread_' + order + '_ms']:.3f} ms; block durations "
              f"(median/longest us) per bounce: "
              + ", ".join(f"{m:.0f}/{x:.0f}"
                          for m, x in orders[order + "_block_us_median_longest"])
              + (f"; warp chunks x 32 / lane chunks {orders[order + '_sharing']:.3f}"
                 if order != "dealt" else ""))
    share = lambda ph: (f"box tests {ph['box']:.2f}, staging {ph['stage']:.2f}, row tests "
                        f"{ph['rows']:.2f}, the rest {ph['rest']:.2f} of "
                        f"{ph['warp_cycles']:,.0f} cycles a warp")
    print(f"where a warp's cycles go, mesh11k tile: mc_kernel (blocked) "
          f"{share(per['mc_blk']['phases'])}; binned_bounce per launch: "
          + "; ".join(share(ph) for ph in orders["dealt_phases"]))
    for kind in ("primary", "bounce", "terminal"):
        b = per[f"binned_{kind}"]
        print(f"binned_{kind} per launch on tile 0's states: torch.profiler {b['ms']:.4f} ms")
    print(f"mc_kernel (blocked), the mesh11k frame's {per['mc_blk']['rays_frame']} rays in one "
          f"launch: {per['mc_blk']['ms_frame']:.3f} ms, bound {per['mc_blk']['bound_ms_frame']:.4f} "
          f"ms ({per['mc_blk']['bound_by_frame']}: {per['mc_blk']['ops_frame']:,} FP32 operations, "
          f"{per['mc_blk']['bytes_frame']:,} B)")
    print(f"mc_kernel (blocked) on one mesh11k tile: torch.profiler {per['mc_blk']['ms']:.3f} ms, "
          f"CUDA events {per['mc_blk']['events_ms']:.3f} ms; warp chunks x 32 / lane chunks "
          f"{sharing(per['mc_blk']['tests']):.3f} (pixel order), binned bounces "
          f"{sharing(per['binned_bounce']['tests']):.3f} (sorted and dealt)")
    for j, lv in enumerate(per["level_blk"]["levels"]):
        print(f"level_kernel (blocked), mesh11k tile 0, level {j} ({lv['k']} lanes): cooperative "
              f"{lv['ms']:.4f} ms (events {lv['events_ms']:.4f}), per-thread "
              f"{lv['per_thread_ms']:.4f} ms; bound {lv['bound_ms']:.4f} ms; {share(lv['phases'])}; "
              f"block durations (median/longest us) {lv['block_us'][0]:.0f}/{lv['block_us'][1]:.0f}; "
              f"warp chunks x 32 / lane chunks {sharing(lv['tests']):.3f}")
    dense_share = lambda ph: (f"nearest sweeps {ph['near']:.2f}, shadow tests "
                              f"{ph['shadow']:.2f}, marches {ph['march']:.2f}, the rest "
                              f"{ph['rest']:.2f} of {ph['thread_cycles']:,.0f} cycles a thread")
    mc, lvl = per["mc"], per["level"]
    print(f"mc_kernel (dense), the 1280x960 frame's {mc['rays']} rays in one launch: staged "
          f"{mc['ms']:.3f} ms ({mc['ms_per_65536']:.4f} ms per 65536 rays; events "
          f"{mc['events_ms']:.3f}), per-thread {mc['per_thread_ms']:.3f} ms (events); tile 0 "
          f"alone: staged {mc['ms_tile']:.4f} ms, per-thread {mc['per_thread_ms_tile']:.4f} ms; "
          f"{dense_share(mc['phases'])}; block durations (median/longest us) "
          f"{mc['block_us'][0]:.0f}/{mc['block_us'][1]:.0f}")
    print(f"level_kernel (dense), demo tile 0's primary level: staged {lvl['ms']:.4f} ms, "
          f"per-thread {lvl['per_thread_ms']:.4f} ms; over a Whitted frame's "
          f"{lvl['frame_launches']} launches {lvl['frame_mean_ms']:.4f} ms each; "
          f"{dense_share(lvl['phases'])}; block durations (median/longest us) "
          f"{lvl['block_us'][0]:.0f}/{lvl['block_us'][1]:.0f}")
    prim = per["binned_primary"]
    print(f"binned_primary on tile 0's camera rays: cooperative {prim['ms']:.4f} ms, per-thread "
          f"{prim['per_thread_ms']:.4f} ms (torch.profiler); {share(prim['phases'])}; block "
          f"durations (median/longest us) {prim['block_us'][0]:.0f}/{prim['block_us'][1]:.0f}")
    term = per["binned_terminal"]
    print(f"binned_terminal on tile 0's dealt states: cooperative {term['ms']:.4f} ms, per-thread "
          f"{term['per_thread_ms']:.4f} ms (torch.profiler); {share(term['phases'])}; block durations "
          f"(median/longest us) {term['block_us'][0]:.0f}/{term['block_us'][1]:.0f}")
    for name in ("nearest_hit", "shadow_any_hit", "march"):
        v = per[name]
        print(f"{name}, the unfused epoch's {v['launches_timed']} frame-wide calls of {v['rays']} "
              f"lanes, per launch: listed {v['ms']:.4f} ms (queued {v['queued_ms']:.4f}), "
              f"per-thread {v['per_thread_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms; tile 9's "
              f"primary hits: listed {v['ms_tile']:.4f} ms, per-thread {v['per_thread_ms_tile']:.4f} ms")
    v = per["any_hit"]
    print(f"any_hit, tile 9's shadow rays, a launch per light, per launch: listed {v['ms']:.4f} ms "
          f"(queued {v['queued_ms']:.4f}), per-thread {v['per_thread_ms']:.4f} ms, bound "
          f"{v['bound_ms']:.4f} ms")
    for k, v in per.items():
        print(f"per launch, {v.get('rays', 65536)} rays, {k}: kernel {v['ms']:.3f} ms vs plain "
              f"{v['plain_ms']:.3f} ms; bound {v['bound_ms']:.4f} ms ({v['bound_by']}: "
              f"{v['bytes']:,.0f} B, {v['ops']:,.0f} FP32 operations; tests {v['tests']})")

    # ---- 8. the full reference schedule, scored and profiled ---------------
    # (after the kernels' timing above, which it would otherwise precede by
    # two 100-epoch renders)
    schedule = schedule_phase(ScheduleSpec(), smi_lines[:1])
    # ---- 9. the benchmark harness -------------------------------------------
    from raytracer_tpu_torch.bench import BenchSpec

    bench_out = bench_phase(BenchSpec(), smi.rsplit(",", 1)[0].strip())
    bench_launches = {k: sum(sec[k] for sec in bench_out["launches"].values()) for k in counts}

    print(json.dumps({"frames": frames, "presets": preset_times, "routes": routes,
                      "attrs": attrs, "per_launch": per, "ladder_graph": graph_times, "spd": spd,
                      "mesh": mesh_times,
                      "multicard": multicard, "schedule": schedule, "bench": bench_out,
                      "profiles": profiles, "bounce_orders": orders}))

    def entry(name, source, replaces, key, blk_key=None, thread_ms=None):
        """The kernel's line: with `blk_key`, the blocked instantiation's own
        fields; with `thread_ms`, the per-thread yardstick's launches on the
        main paths and its ms beside the cooperative walk's."""
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[key] + (launches[blk_key] if blk_key else 0),
             # phase 9's, the harness's sections summed
             "launches_bench": bench_launches[key] + (bench_launches[blk_key] if blk_key else 0),
             "max_abs_err": per[key].get("max_abs_err", binned_err.get(key)),
             "ms": per[key]["ms"], "plain_ms": per[key]["plain_ms"],
             "bound_ms": per[key]["bound_ms"], "bound_by": per[key]["bound_by"],
             "library_ms": None}
        if blk_key:  # the blocked instantiation's own fields
            e.update({"launches_blocked": launches[blk_key],
                      "max_abs_err_blocked": per[blk_key]["max_abs_err"],
                      "ms_blocked": per[blk_key]["ms"],
                      "plain_ms_blocked": per[blk_key]["plain_ms"],
                      "bound_ms_blocked": per[blk_key]["bound_ms"],
                      "bound_by_blocked": per[blk_key]["bound_by"]})
        if thread_ms is not None:
            e.update({"launches_per_thread": launches[(blk_key or key) + "_thread"],
                      "ms_per_thread": thread_ms})
        if blk_key:  # the dense instantiation's per-thread yardstick
            e.update({"launches_dense_per_thread": launches[key + "_thread"],
                      "ms_dense_per_thread": per[key]["per_thread_ms"]})
        return e

    csrc = "raytracer_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        dict(entry("mc_kernel", csrc + "mc_kernel.cu", "raytracer_tpu/ops/mc_pallas.py:474",
                   "mc", "mc_blk", per["mc_blk"]["per_thread_ms"]),
             rays=per["mc"]["rays"], ms_per_65536=per["mc"]["ms_per_65536"],
             ms_tile=per["mc"]["ms_tile"], ms_blocked_frame=per["mc_blk"]["ms_frame"],
             bound_ms_blocked_frame=per["mc_blk"]["bound_ms_frame"],
             bound_by_blocked_frame=per["mc_blk"]["bound_by_frame"]),
        dict(entry("level_kernel", csrc + "level_kernel.cu",
                   "raytracer_tpu/ops/level_pallas.py:73", "level", "level_blk",
                   per["level_blk"]["per_thread_ms"]),
             ms_blocked_primary=per["level_blk"]["ms_primary"],
             ms_frame_mean=per["level"]["frame_mean_ms"]),
        entry("binned_primary", csrc + "mc_binned.cu", "raytracer_tpu/ops/mc_binned.py:131",
              "binned_primary", thread_ms=per["binned_primary"]["per_thread_ms"]),
        entry("binned_bounce", csrc + "mc_binned.cu", "raytracer_tpu/ops/mc_binned.py:157",
              "binned_bounce", thread_ms=orders["per_thread_dealt_ms"]),
        entry("binned_terminal", csrc + "mc_binned.cu", "raytracer_tpu/ops/mc_binned.py:190",
              "binned_terminal", thread_ms=per["binned_terminal"]["per_thread_ms"]),
        dict(entry("nearest_hit", csrc + "intersect_kernels.cu",
                   "raytracer_tpu/ops/intersect_pallas.py:172", "nearest_hit",
                   thread_ms=per["nearest_hit"]["per_thread_ms"]),
             rays=per["nearest_hit"]["rays"], ms_tile=per["nearest_hit"]["ms_tile"],
             ms_tile_per_thread=per["nearest_hit"]["per_thread_ms_tile"]),
        entry("any_hit", csrc + "intersect_kernels.cu",
              "raytracer_tpu/ops/intersect_pallas.py:212", "any_hit",
              thread_ms=per["any_hit"]["per_thread_ms"]),
        dict(entry("shadow_any_hit", csrc + "intersect_kernels.cu",
                   "raytracer_tpu/ops/intersect_pallas.py:335", "shadow_any_hit",
                   thread_ms=per["shadow_any_hit"]["per_thread_ms"]),
             rays=per["shadow_any_hit"]["rays"], ms_tile=per["shadow_any_hit"]["ms_tile"],
             ms_tile_per_thread=per["shadow_any_hit"]["per_thread_ms_tile"]),
        dict(entry("march", csrc + "march_kernel.cu", "raytracer_tpu/ops/march_pallas.py:164",
                   "march", thread_ms=per["march"]["per_thread_ms"]),
             rays=per["march"]["rays"], ms_tile=per["march"]["ms_tile"],
             ms_tile_per_thread=per["march"]["per_thread_ms_tile"]),
        # a kernel of the port only: the JAX ladder delivers with XLA's
        # scatter-add at this line, through no Pallas kernel
        dict(entry("deliver", csrc + "deliver.cu", "raytracer_tpu/ops/trace.py:541", "deliver"),
             port_only=True, library_ms=per["deliver"]["library_ms"],
             call_ms=per["deliver"]["call_ms"], lanes=per["deliver"]["rays"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def schedule_main() -> int:
    """`--phase schedule`: build the kernels and run phase 8 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from raytracer_tpu_torch.utils import kernels

    smi = nvidia_smi()
    _, build_s = kernels.build()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; kernels built in {build_s:.1f} s")
    out = schedule_phase(ScheduleSpec(), smi[:1])
    print(json.dumps({"schedule": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bench_main() -> int:
    """`--phase bench`: build the kernels and run phase 9 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from raytracer_tpu_torch.bench import BenchSpec
    from raytracer_tpu_torch.utils import kernels

    smi = nvidia_smi()
    _, build_s = kernels.build()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; kernels built in {build_s:.1f} s")
    out = bench_phase(BenchSpec(), smi[0].rsplit(",", 1)[0].strip())
    print(json.dumps({"bench": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def spd_main() -> int:
    """`--phase spd`: build the kernels and run phase 5c alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from raytracer_tpu_torch.utils import kernels

    smi = nvidia_smi()
    _, build_s = kernels.build()
    print(f"{smi[0]}; torch {torch.__version__} cuda {torch.version.cuda}; kernels built in "
          f"{build_s:.1f} s")
    out = spd_phase(torch.device("cuda"))
    print(json.dumps({"spd": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def graph_main() -> int:
    """`--phase graph`: build the kernels and run phase 5b alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene, mesh_scene
    from raytracer_tpu_torch.utils import kernels

    smi = nvidia_smi()
    _, build_s = kernels.build()
    print(f"{smi[0]}; torch {torch.__version__} cuda {torch.version.cuda}; kernels built in "
          f"{build_s:.1f} s")
    dev = torch.device("cuda")
    mesh11k, mesh11k_cam = mesh_scene(75, device=dev)
    out = ladder_graph_phase(dev, [
        ("demo 1280x960", demo_scene(device=dev), demo_camera(device=dev),
         RenderConfig(depth=DEPTH)),
        ("mesh11k 1024x1024", mesh11k, mesh11k_cam,
         RenderConfig(width=1024, height=1024, depth=DEPTH))])
    print(json.dumps({"ladder_graph": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def multicard_main() -> int:
    """`--phase multicard`: build the kernels and run phase 7 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from raytracer_tpu_torch.utils import kernels

    smi = nvidia_smi()
    if torch.cuda.device_count() < 2:
        print(f"chip_smoke --phase multicard: {torch.cuda.device_count()} CUDA device; phase 7 "
              f"needs 2 or more", file=sys.stderr)
        return 1
    _, build_s = kernels.build()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; kernels built in {build_s:.1f} s")
    out = multicard_phase(card_spec(), smi)
    print(json.dumps({"multicard": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="Build and check the port on the host's GPUs.")
    parser.add_argument("--phase", choices=["graph", "spd", "multicard", "schedule", "bench"],
                        help="run phase 5b alone, 5c, phase 7 (a host with 2 or more cards), "
                             "phase 8 or phase 9")
    phase = parser.parse_args().phase
    sys.exit({"graph": graph_main, "spd": spd_main, "multicard": multicard_main,
              "schedule": schedule_main, "bench": bench_main}.get(phase, main)())
