#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port on one NVIDIA GPU, then drive its
main paths once.

    python3 chip_smoke.py

Phases (each asserts; none catches a failure):
  1. device and toolchain: nvidia-smi name and power limit, CUDA and nvcc
     versions; build the kernels (raytracer_tpu_torch/csrc, nvcc, sm_90a)
     and print each instantiation's registers and local (spill) bytes;
  2. each kernel against its plain PyTorch version on the card, same
     inputs: the demo scene (dense kernels) at 64x48, 256x192 and one
     65536-ray tile of 1280x960; mesh_scene(24) at 64x48 and one
     65536-ray tile of the 1024x1024 mesh11k frame (blocked level kernel,
     blocked MC kernel, the three binned kernels), and the binned path
     against the blocked MC kernel; the four standalone kernels of the
     unfused path (nearest hit, any hit, multi-light shadow, interior
     march) on the demo's primary hits at 64x48 and on that 65536-ray tile
     (their shadow rays to all three lights, the glass lanes' marches) and
     on random rays with random face, exclusion and limit, and the shadow
     kernel against one any-hit launch per light through cast_any_hit;
  3. the committed goldens (tests/golden) at 64x48, depth 5, with the
     gates of scripts/tpu_check.py: the demo's and the meshes'
     (whitted_mesh{24,96,160}, mc_mesh24); then the demo's goldens through
     the unfused path (the demo's textures without row forms) and
     whitted_mesh24 through its BVH-only route (no blocked layout);
  4. the main paths, each with the kernels' launch counts set to 0 just
     before it and read just after: the reference schedule
     (render_progressive on the demo scene, 1280x960, depth 5, Whitted +
     3 epochs); the mesh11k path (render_whitted and
     render_distributed_epoch on mesh_scene(75), 1024x1024, depth 5,
     tile_rays 65536: blocked level and binned kernels); an MC epoch of
     mesh_scene(24) at 1024x1024 (the blocked MC kernel); a Whitted frame
     of mesh_scene(160); the unfused path (render_progressive on the demo
     scene with row-less textures, 1280x960, depth 5, Whitted + 2 epochs:
     nearest-hit, shadow and march kernels, no fused kernel), its frame
     and one epoch held against the fused path's on the same draws; the
     per-light shadow test of a tile through cast_any_hit (the any-hit
     kernel); then frame / epoch and per-launch times of
     kernels (device time, torch.profiler) and plain versions (CUDA
     events) at the main paths' shapes, the mesh11k epoch also through the
     blocked MC kernel, and each kernel's bound (the least time the card
     could take for its work).
The line before the last is a JSON object with each kernel's launches,
error, times and bound; the last line is {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")

# The bound: the larger of bytes over HBM bandwidth and FP32 operations
# over the FP32 (non-tensor) peak, from the H100 SXM data sheet.
PEAK_BYTES = 3.35e12  # B/s
PEAK_FP32 = 67e12  # FLOP/s
# FP32 operations charged to each kind of test that the kernels' counting
# instantiations count per lane (kernels.WORK_ROWS, common.cuh `Work`),
# an FMA as 2 and a division, square root, compare or min/max as 1: a
# triangle test begun is a dot product and a compare (6); going on to the
# plane's t adds a dot product, a subtraction, a division and three
# compares (10); an edge test is two dot products, an add, an FMA and a
# compare (14); a sphere test a difference, a cross product, two dot
# products, a square root and compares (30); a slab test 6 subtractions,
# 6 multiplies, 6 NaN tests, 11 min/max and 2 compares (31).  Shading,
# sampling and the march's refractions are not counted, so the operation
# bound is low.
OPS = {"tri": 6, "plane": 10, "edge": 14, "sph": 30, "box": 31}
DEPTH, MD, MR = 5, 100.0, 10


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


def device_ms(fn, reps, name):
    """Mean device milliseconds per fn() call of the kernels whose name
    holds `name`, from torch.profiler over reps calls after a warm-up
    (CUDA events around a short kernel measure the host's launch pace)."""
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


def bound(in_out_bytes, work):
    """(bound_ms, bound_by, FP32 operations) from the bytes a call must
    move and the tests its lanes ran (work: [len(WORK_ROWS), n] counts)."""
    from raytracer_tpu_torch.utils.kernels import WORK_ROWS

    ops = sum(int(work[i].sum()) * OPS[k] for i, k in enumerate(WORK_ROWS))
    t_bytes = in_out_bytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), ops


def golden_gate(img, name, min_psnr, max_bad):
    g = np.load(os.path.join(GOLDEN, name))
    a = img.cpu().numpy()
    p, bad = psnr(a, g), float((np.abs(a - g).max(axis=-1) > 0.1).mean())
    return p, bad, p >= min_psnr and bad <= max_bad


def agree(a, b):
    """Fraction of equal elements of two tensors."""
    return float((a == b).float().mean())


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
    operation, so a razor-edge lane may fall the other way.)"""

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
        from raytracer_tpu_torch.ops import intersect_kernel as ik

        rays = self.rays if rays is None else rays
        active = self.active if active is None else active
        t, idx, bf, valid = ik.nearest_hit(self.scene, rays, active)
        tp, ip, bp, vp = ik.nearest_hit_plain(self.scene.tables, rays, active)
        torch.cuda.synchronize()
        same = (valid == vp) & (idx == ip) & (bf == bp)
        both = valid & vp
        rel = ((t - tp).abs() / tp.abs())[both]
        err = float((t - tp).abs()[both].max()) if bool(both.any()) else 0.0
        print(f"nearest_hit {label}: {float(same.float().mean()):.5f} of lanes equal "
              f"(valid, index, backface), {int(both.sum())} hits, max rel t err "
              f"{float(rel.max()) if rel.numel() else 0.0:.3g}")
        assert float(same.float().mean()) >= 0.999
        assert bool(((t - tp).abs() <= 1e-5 * tp.abs() + atol)[both].all())
        assert bool(torch.isinf(t[~valid]).all()) and bool((idx[~valid] == -1).all())
        return err

    def check_any(self, label, rays, active, limit):
        from raytracer_tpu_torch.ops import intersect_kernel as ik
        from raytracer_tpu_torch.ops.kernel_common import BIG

        got = ik.any_hit(self.scene, rays, active, limit)
        lim = torch.full_like(rays.o[:, 0], BIG) if limit is None else limit.clamp(max=BIG)
        ref = ik.any_hit_plain(self.scene.tables, rays, active, lim)
        torch.cuda.synchronize()
        print(f"any_hit {label}: {agree(got, ref):.5f} of lanes equal, "
              f"{int(got.sum())} blocked of {int(active.sum())}")
        assert agree(got, ref) >= 0.999
        return float((got != ref).float().max())

    def check_shadow(self, label):
        """The shadow kernel against its plain version, and against one
        any-hit launch per light through cast_any_hit (other arithmetic:
        direct t against the factored target)."""
        from raytracer_tpu_torch.ops import intersect_kernel as ik
        from raytracer_tpu_torch.ops.intersect import cast_any_hit

        h = self.hits
        args = (h.pos, self.to_light, h.prim, self.limits, self.considers)
        got = ik.shadow_any_hit(self.scene, *args)
        ref = ik.shadow_any_hit_plain(self.scene.tables, *args)
        per_light = torch.stack([
            cast_any_hit(self.scene, self.shadow[li], active=self.considers[li],
                         limit=self.limits[li]) for li in range(self.scene.n_light)])
        torch.cuda.synchronize()
        print(f"shadow_any_hit {label}: {agree(got, ref):.5f} of (light, lane) pairs equal "
              f"the plain version, {agree(got, per_light):.5f} the per-light any-hit kernel; "
              f"{int(got.sum())} blocked of {int(self.considers.sum())} shadow rays")
        assert agree(got, ref) >= 0.999 and agree(got, per_light) >= 0.999
        assert not bool(got[~self.considers].any())
        return float((got != ref).float().max())

    def check_march(self, label):
        from raytracer_tpu_torch.ops import march_kernel as mk

        pos, normal, ray_d, prim, k, want = self.march_in
        esc, travel, eo, ed, eprim, casts = mk.march(self.scene, *self.march_in, MD, MR)
        esc_p, travel_p, eo_p, ed_p, eprim_p, iters_p = mk.march_plain(
            self.scene.tables, pos, normal, ray_d, k, want, MD, MR)
        torch.cuda.synchronize()
        n_want = int(want.sum())
        flips = int((esc != esc_p).sum())
        both = esc & esc_p
        err = max(float((travel - travel_p).abs()[both].max()),
                  float((eo - eo_p).abs()[both].max()),
                  float((ed - ed_p).abs()[both].max())) if bool(both.any()) else 0.0
        print(f"march {label}: {n_want} lanes march, {flips} escape flags differ, "
              f"{int(both.sum())} escape in both, max |err| {err:.3g}, casts "
              f"{int(casts)} vs {int(iters_p.sum())}")
        assert n_want > 0 and flips < 0.01 * n_want, (flips, n_want)
        assert err <= 1e-4 and bool((eprim == eprim_p)[both].all())
        assert abs(int(casts) - int(iters_p.sum())) <= 0.01 * int(iters_p.sum())
        assert not bool(esc[~want].any())
        return err


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
    from raytracer_tpu_torch.ops.intersect import cast_any_hit
    from raytracer_tpu_torch.ops.kernel_common import BIG
    from raytracer_tpu_torch.ops.trace import _pack_primary, fused_ok, trace_whitted
    from raytracer_tpu_torch.parallel.progressive import render_progressive
    from raytracer_tpu_torch.render import (
        _clips,
        render_distributed_epoch,
        render_whitted,
        tile_draws,
    )
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene, mesh_scene
    from raytracer_tpu_torch.scene.textures import Texture, host_only
    from raytracer_tpu_torch.utils import kernels
    from raytracer_tpu_torch.utils.png import read_png_rgb8

    dev = torch.device("cuda")
    counts = {
        "level": level_kernel.COUNTS, "level_blk": level_kernel.COUNTS_BLK,
        "mc": mc_kernel.COUNTS, "mc_blk": mc_kernel.COUNTS_BLK,
        "binned_primary": mc_binned.COUNTS_PRIMARY,
        "binned_bounce": mc_binned.COUNTS_BOUNCE,
        "binned_terminal": mc_binned.COUNTS_TERMINAL,
        "nearest_hit": intersect_kernel.COUNTS_NEAREST, "any_hit": intersect_kernel.COUNTS_ANY,
        "shadow_any_hit": intersect_kernel.COUNTS_SHADOW, "march": march_kernel.COUNTS,
    }
    fused_kernels = ("level", "level_blk", "mc", "mc_blk", "binned_primary", "binned_bounce",
                     "binned_terminal")

    def reset_counts():
        for c in counts.values():
            c.launches = c.plain = 0

    def read_counts():
        launches = {k: c.launches for k, c in counts.items()}
        assert all(c.plain == 0 for c in counts.values()), {k: c.plain for k, c in counts.items()}
        return launches

    # ---- 1. device and toolchain ----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    nvcc_ver = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; nvcc: {nvcc_ver}")
    _, build_s = kernels.build(verbose=True)
    print(f"kernels built in {build_s:.1f} s")
    attrs = {k: kernels.kernel_attrs(k) for k in kernels.ATTRS}
    for k, a in attrs.items():
        print(f"{k} kernel: {a['registers']} registers/thread, "
              f"{a['local_bytes']} local (spill+stack) bytes/thread")

    demo = demo_scene().to(dev)
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

    def binned_walk(scene, o, d, unifs):
        """mc_binned.trace step by step -> (photon [n, 3], casts, the inputs
        each kernel got: ("primary", o_t, d_t) / ("bounce", sf, si, u,
        first) / ("terminal", sf, si, first))."""
        calls = []
        o_t, d_t = o.t().contiguous(), d.t().contiguous()
        calls.append(("primary", o_t, d_t))
        sf, si, c0 = mc_binned.primary(scene, o_t, d_t)
        casts = c0.sum()
        for step in range(DEPTH):
            sf, si = mc_binned.sort_state(scene, sf, si, unifs[step])
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

    # ---- 2. kernels against their plain versions, same inputs -----------
    rng = np.random.default_rng(0)
    full = RenderConfig(depth=5, epochs=3)  # 1280x960, tile_rays 65536
    mesh_cfg = RenderConfig(width=1024, height=1024, depth=5)  # mesh11k
    cases = [(f"{w}x{h}", RenderConfig(width=w, height=h, depth=5, tile_rays=w * h), 0)
             for w, h in ((64, 48), (256, 192))]
    cases.append(("1280x960 tile 9", full, 9))  # a main-path tile, mid-frame
    for label, cfg, tile in cases:
        clip = _clips(cfg, dev)[0][tile]
        check_mc(label, demo, *tile_rays(demo_cam, clip, rng, cfg))
        check_whitted(label, demo, demo_cam, clip, cfg)

    binned_err = {}
    small = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
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
    tile_u = u  # the 65536-ray tile of the main path, for phase 4

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
    assert not any(read_counts().values())  # tensor operations only: no kernel, no plain sweep

    # ---- 4. the main paths -----------------------------------------------
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
        png = read_png_rgb8(out)
    print(f"main path (demo): whitted + {full.epochs} epochs at 1280x960 in {wall:.2f} s wall; "
          f"launches {demo_launches}")
    assert state.epoch == full.epochs
    assert png.shape == (960, 1280, 3) and png.max() > 0, png.shape
    assert torch.isfinite(state.img).all()
    assert not any("dropped" in m for m in lines), lines
    assert demo_launches["level"] > 0 and demo_launches["mc"] > 0, demo_launches

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
    assert mesh_launches["level_blk"] > 0, mesh_launches
    assert all(mesh_launches[k] > 0 for k in ("binned_primary", "binned_bounce",
                                               "binned_terminal")), mesh_launches

    reset_counts()
    (m24img, m24st), m24_s = timed(lambda: render_distributed_epoch(mesh24, mesh24_cam,
                                                                    mesh_cfg))
    m24_launches = read_counts()
    print(f"main path (mesh24 mc epoch 1024x1024): {m24_s:.3f} s; launches {m24_launches}")
    assert torch.isfinite(m24img).all() and float(m24img.max()) > 0
    assert m24_launches["mc_blk"] > 0, m24_launches

    mesh51k, mesh51k_cam = meshes[160]
    render_whitted(mesh51k, mesh51k_cam, mesh_cfg)  # first-call set-up
    reset_counts()
    (_, w51), w51_s = timed(lambda: render_whitted(mesh51k, mesh51k_cam, mesh_cfg))
    w51_launches = read_counts()
    print(f"mesh51k ({mesh51k.n_tri} triangles) whitted frame 1024x1024: {w51_s:.3f} s "
          f"({w51['casts'] / w51_s:,.0f} casts/s, dropped {w51['dropped']}); "
          f"launches {w51_launches}")
    assert w51["dropped"] == 0 and w51_launches["level_blk"] > 0

    # the unfused path at the reference schedule's full width: the demo
    # scene with row-less textures, Whitted + 2 epochs
    ucfg = dataclasses.replace(full, epochs=2)
    render_whitted(demo_u, demo_cam, ucfg)  # first-call set-up
    ulines = []
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.png")
        ustate, uwall = timed(lambda: render_progressive(
            demo_u, demo_cam, ucfg, out_path=out, log=lambda m: (ulines.append(m), print(m))))
        unfused_launches = read_counts()
        png = read_png_rgb8(out)
    print(f"main path (demo, unfused): whitted + {ucfg.epochs} epochs at 1280x960 in "
          f"{uwall:.2f} s wall; launches {unfused_launches}")
    assert ustate.epoch == ucfg.epochs and torch.isfinite(ustate.img).all()
    assert png.shape == (960, 1280, 3) and png.max() > 0, png.shape
    assert not any("dropped" in m for m in ulines), ulines
    assert all(unfused_launches[k] > 0 for k in ("nearest_hit", "shadow_any_hit", "march"))
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

    launches = {k: demo_launches[k] + mesh_launches[k] + m24_launches[k] + w51_launches[k]
                + unfused_launches[k] + any_launches[k] for k in counts}

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
        if scene.n_tri >= mc_binned.BINNED_MIN_TRIS:  # the same epoch on the other route
            threshold, mc_binned.BINNED_MIN_TRIS = mc_binned.BINNED_MIN_TRIS, scene.n_tri + 1
            (_, est2), e2_s = timed(lambda: render_distributed_epoch(scene, cam, cfg, epoch=7))
            mc_binned.BINNED_MIN_TRIS = threshold
            assert est2["casts"] == est["casts"], (est2["casts"], est["casts"])
            frames[name]["mc_epoch_mega_kernel_s"] = e2_s
            print(f"mc epoch {name} through the blocked mc kernel instead: {e2_s:.3f} s")
        print(f"whitted frame {name}: kernel {w_s:.3f} s ({wst['casts'] / w_s:,.0f} casts/s), "
              f"plain {wp_s:.3f} s")
        print(f"mc epoch {name}: kernel {e_s:.3f} s ({est['casts'] / e_s:,.0f} casts/s), "
              f"plain {ep_s:.3f} s")
    frames["mesh51k 1024x1024"] = {"whitted_frame_s": w51_s}
    frames["demo unfused 1280x960"] = {"whitted_frame_s": uw_s, "mc_epoch_s": ue_s,
                                       "fused_whitted_frame_s": fw_s, "fused_mc_epoch_s": fe_s}

    # where the mesh11k frame and epoch spend device time (both MC routes)
    profiles = {
        "mesh11k whitted": profile_breakdown(
            "mesh11k whitted frame", lambda: render_whitted(mesh11k, mesh11k_cam, mesh_cfg)),
        "mesh11k mc binned": profile_breakdown(
            "mesh11k mc epoch (binned)",
            lambda: render_distributed_epoch(mesh11k, mesh11k_cam, mesh_cfg, epoch=7))}
    for name, scene in (("demo unfused", demo_u), ("demo fused", demo)):
        profiles[f"{name} whitted"] = profile_breakdown(
            f"{name} whitted frame", lambda: render_whitted(scene, demo_cam, full))
        profiles[f"{name} mc"] = profile_breakdown(
            f"{name} mc epoch",
            lambda: render_distributed_epoch(scene, demo_cam, full, epoch=7))
    threshold, mc_binned.BINNED_MIN_TRIS = mc_binned.BINNED_MIN_TRIS, mesh11k.n_tri + 1
    profiles["mesh11k mc mega"] = profile_breakdown(
        "mesh11k mc epoch (blocked mc kernel)",
        lambda: render_distributed_epoch(mesh11k, mesh11k_cam, mesh_cfg, epoch=7))
    mc_binned.BINNED_MIN_TRIS = threshold

    # per-launch times at the main paths' shapes: one 65536-ray tile each
    def time_mc(scene, cam, cfg):
        clip = _clips(cfg, dev)[0][0]
        normals, unifs = tile_draws(cfg, 0, 0, 0, clip.shape[0], dev)
        o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
        o, d = o.contiguous(), d.contiguous()
        n = o.shape[0]
        work = torch.zeros((len(kernels.WORK_ROWS), n), dtype=torch.int32, device=dev)
        mk, _ = mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR)
        mw, _ = mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR, work=work)
        assert torch.equal(mk, mw)  # counting changes no result
        mp, _ = plain_mc(scene, o, d, unifs)
        io = nbytes(o, d, unifs, *scene_tables(scene)) + 16 * n  # photon + casts
        b_ms, b_by, ops = bound(io, work)
        return dict(max_abs_err=float((mk - mp).abs().max()),
                    ms=device_ms(lambda: mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR), 5,
                                 "mc_kernel"),
                    plain_ms=cuda_ms(lambda: plain_mc(scene, o, d, unifs), 1),
                    bound_ms=b_ms, bound_by=b_by, bytes=io, ops=ops,
                    tests=dict(zip(kernels.WORK_ROWS, work.sum(1).tolist())))

    def time_level(scene, cam, cfg):
        clip = _clips(cfg, dev)[0][0]
        o, d = camera_ops.shoot(cam, clip)
        pool = _pack_primary(o, d)
        args = (cfg.threshold, cfg.max_refract_distance, cfg.max_tir_retries)
        work = torch.zeros((len(kernels.WORK_ROWS), pool.width), dtype=torch.int32, device=dev)
        lk = level_kernel.process_level(scene, pool, False, True, *args)
        lw = level_kernel.process_level(scene, pool, False, True, *args, work=work)
        assert torch.equal(lk[0], lw[0])  # counting changes no result
        lp = plain_level(scene, pool, False, True, *args)
        io = nbytes(pool.f, pool.i, *scene_tables(scene)) + (3 + 2 * 16 + 1) * 4 * pool.width
        b_ms, b_by, ops = bound(io, work)
        return dict(max_abs_err=float((lk[0] - lp[0]).abs().max()),
                    ms=device_ms(lambda: level_kernel.process_level(scene, pool, False, True,
                                                                    *args), 10, "level_kernel"),
                    plain_ms=cuda_ms(lambda: plain_level(scene, pool, False, True, *args), 1),
                    bound_ms=b_ms, bound_by=b_by, bytes=io, ops=ops,
                    tests=dict(zip(kernels.WORK_ROWS, work.sum(1).tolist())))

    def scene_tables(scene):
        tb = scene.tables
        out = [tb.tri, tb.sph, tb.mat, tb.lights]
        if scene.blocked:
            bt = scene.blk_tables
            out = [bt.tri, bt.box, bt.sup, tb.sph, tb.mat, tb.lights]
        return out

    def time_binned(scene, cam, cfg):
        """Each binned kernel on the inputs it got in one 65536-ray tile's
        walk: ms and bound per launch (bounces: the mean over the walk's
        five), plain_ms likewise."""
        clip = _clips(cfg, dev)[0][0]
        normals, unifs = tile_draws(cfg, 0, 0, 0, clip.shape[0], dev)
        o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
        _, _, calls = binned_walk(scene, o.contiguous(), d.contiguous(), unifs)
        out = {}
        for kind in ("primary", "bounce", "terminal"):
            mine = [c for c in calls if c[0] == kind]
            ms = plain_ms = b_ms = io = ops = 0.0
            by = set()
            tests = dict.fromkeys(kernels.WORK_ROWS, 0)
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
                for k, v in zip(kernels.WORK_ROWS, work.sum(1).tolist()):
                    tests[k] += v
                ms += device_ms(lambda: run_binned(scene, call), 5, f"binned_{kind}")
                plain_ms += cuda_ms(lambda: run_binned(scene, call, plain=True), 1)
            k = len(mine)
            out[f"binned_{kind}"] = dict(ms=ms / k, plain_ms=plain_ms / k, bound_ms=b_ms / k,
                                         bound_by="operations" if "operations" in by else "bytes",
                                         bytes=io / k, ops=ops / k,
                                         tests={t: v / k for t, v in tests.items()})
        return out

    def time_unfused(u):
        """The four standalone kernels on the inputs the unfused path
        gives them for one 65536-ray tile (Unfused): the primary cast, the
        shadow rays of its hits to all lights, the any-hit sweep of one
        light's shadow rays, the glass lanes' marches."""
        sc, h, n = u.scene, u.hits, u.n
        geo = [sc.tables.tri, sc.tables.sph]
        r = u.rays
        ray_in = [r.o, r.d, r.face, r.excl_prim, r.excl_face, u.active]
        sh = u.shadow[1]  # the spot light: a limit and a cone
        pos, normal, ray_d, prim, k, want = u.march_in
        shadow_args = (h.pos, u.to_light, h.prim, u.limits, u.considers)
        specs = {
            "nearest_hit": (
                lambda work=None: intersect_kernel.nearest_hit(sc, r, u.active, work=work),
                lambda: intersect_kernel.nearest_hit_plain(sc.tables, r, u.active),
                nbytes(*ray_in, *geo) + 10 * n, "nearest_kernel"),
            "any_hit": (
                lambda work=None: intersect_kernel.any_hit(sc, sh, u.considers[1], u.limits[1],
                                                           work=work),
                lambda: intersect_kernel.any_hit_plain(sc.tables, sh, u.considers[1],
                                                       u.limits[1].clamp(max=BIG)),
                nbytes(sh.o, sh.d, sh.face, sh.excl_prim, sh.excl_face, u.considers[1],
                       u.limits[1], *geo) + n, "any_kernel"),
            "shadow_any_hit": (
                lambda work=None: intersect_kernel.shadow_any_hit(sc, *shadow_args, work=work),
                lambda: intersect_kernel.shadow_any_hit_plain(sc.tables, *shadow_args),
                nbytes(*shadow_args, *geo, sc.tables.lights) + sc.n_light * n, "shadow_kernel"),
            "march": (
                lambda work=None: march_kernel.march(sc, *u.march_in, MD, MR, work=work),
                lambda: march_kernel.march_plain(sc.tables, pos, normal, ray_d, k, want, MD, MR),
                nbytes(pos, normal, ray_d, k, want, *geo) + 37 * n, "march_kernel"),
        }
        out = {}
        for name, (kernel, plain, io, kname) in specs.items():
            work = torch.zeros((len(kernels.WORK_ROWS), n), dtype=torch.int32, device=dev)
            got, counted = kernel(), kernel(work=work)
            same = lambda a, b: torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            pairs = zip(got, counted) if isinstance(got, tuple) else [(got, counted)]
            assert all(same(a, b) for a, b in pairs), name  # counting changes no result
            b_ms, b_by, ops = bound(io, work)
            out[name] = dict(max_abs_err=unfused_err[name], ms=device_ms(kernel, 10, kname),
                             plain_ms=cuda_ms(plain, 1), bound_ms=b_ms, bound_by=b_by,
                             bytes=io, ops=ops,
                             tests=dict(zip(kernels.WORK_ROWS, work.sum(1).tolist())))
        return out

    per = {"mc": time_mc(demo, demo_cam, full), "level": time_level(demo, demo_cam, full),
           "mc_blk": time_mc(mesh11k, mesh11k_cam, mesh_cfg),
           "level_blk": time_level(mesh11k, mesh11k_cam, mesh_cfg)}
    per.update(time_binned(mesh11k, mesh11k_cam, mesh_cfg))
    per.update(time_unfused(tile_u))
    for k, v in per.items():
        print(f"per launch, 65536 rays, {k}: kernel {v['ms']:.3f} ms vs plain "
              f"{v['plain_ms']:.3f} ms; bound {v['bound_ms']:.4f} ms ({v['bound_by']}: "
              f"{v['bytes']:,.0f} B, {v['ops']:,.0f} FP32 operations; tests {v['tests']})")

    print(json.dumps({"frames": frames, "attrs": attrs, "per_launch": per,
                      "profiles": profiles}))

    def entry(name, source, replaces, key, blk_key=None):
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[key] + (launches[blk_key] if blk_key else 0),
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
        return e

    csrc = "raytracer_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        entry("mc_kernel", csrc + "mc_kernel.cu", "raytracer_tpu/ops/mc_pallas.py:474",
              "mc", "mc_blk"),
        entry("level_kernel", csrc + "level_kernel.cu", "raytracer_tpu/ops/level_pallas.py:73",
              "level", "level_blk"),
        entry("binned_primary", csrc + "mc_binned.cu", "raytracer_tpu/ops/mc_binned.py:131",
              "binned_primary"),
        entry("binned_bounce", csrc + "mc_binned.cu", "raytracer_tpu/ops/mc_binned.py:157",
              "binned_bounce"),
        entry("binned_terminal", csrc + "mc_binned.cu", "raytracer_tpu/ops/mc_binned.py:190",
              "binned_terminal"),
        entry("nearest_hit", csrc + "intersect_kernels.cu",
              "raytracer_tpu/ops/intersect_pallas.py:172", "nearest_hit"),
        entry("any_hit", csrc + "intersect_kernels.cu",
              "raytracer_tpu/ops/intersect_pallas.py:212", "any_hit"),
        entry("shadow_any_hit", csrc + "intersect_kernels.cu",
              "raytracer_tpu/ops/intersect_pallas.py:335", "shadow_any_hit"),
        entry("march", csrc + "march_kernel.cu", "raytracer_tpu/ops/march_pallas.py:164",
              "march"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
