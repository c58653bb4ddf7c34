#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port on one NVIDIA GPU, then drive its
main path once.

    python3 chip_smoke.py

Phases (each asserts; none catches a failure):
  1. device and toolchain: nvidia-smi name and power limit, CUDA and nvcc
     versions; build the kernels (raytracer_tpu_torch/csrc, nvcc, sm_90a)
     and print their registers and local (spill) bytes;
  2. each kernel against its plain PyTorch version on the card, same
     inputs: 64x48 and 256x192 frames, and one 65536-ray tile of the
     1280x960 frame (the main path's shapes);
  3. the committed goldens (tests/golden) at 64x48, depth 5, with the
     gates of scripts/tpu_check.py;
  4. the main path: render_progressive (the CLI's function) at 1280x960,
     depth 5, Whitted frame + 3 epochs, with the kernels' launch counts
     taken over exactly that run; then kernel and plain times at the
     main path's shapes.
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, when CUDA is not available.
"""

from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import level_kernel, mc_kernel
    from raytracer_tpu_torch.ops.trace import _pack_primary, trace_whitted
    from raytracer_tpu_torch.parallel.progressive import render_progressive
    from raytracer_tpu_torch.render import (
        _clips,
        render_distributed_epoch,
        render_whitted,
        tile_draws,
    )
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene
    from raytracer_tpu_torch.utils import kernels
    from raytracer_tpu_torch.utils.png import read_png_rgb8

    dev = torch.device("cuda")

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
    attrs = {k: kernels.kernel_attrs(k) for k in ("level", "mc")}
    for k, a in attrs.items():
        print(f"{k} kernel: {a['registers']} registers/thread, "
              f"{a['local_bytes']} local (spill+stack) bytes/thread")

    scene = demo_scene().to(dev)
    camera = demo_camera().to(dev)
    tb, tex = scene.tables, scene.textures

    def plain_level(sc, pool, last, direct, thr, md, mr):
        c, r, f, casts = level_kernel.process_level_plain(
            sc.tables, sc.textures, pool, last, direct, thr, md, mr)
        return c, r, f, casts.sum()

    # ---- 2. kernels against their plain versions, same inputs -----------
    rng = np.random.default_rng(0)
    full = RenderConfig(depth=5, epochs=3)  # 1280x960, tile_rays 65536
    cases = [(f"{w}x{h}", RenderConfig(width=w, height=h, depth=5, tile_rays=w * h), 0)
             for w, h in ((64, 48), (256, 192))]
    cases.append(("1280x960 tile 9", full, 9))  # a main-path tile, mid-frame
    for label, cfg, tile in cases:
        clip = _clips(cfg, dev)[0][tile]
        n = clip.shape[0]
        # MC: numpy-seeded lens normals and draws
        normals = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32), device=dev)
        unifs = rng.uniform(size=(5, 3, n)).astype(np.float32)
        unifs[:, 2] = unifs[:, 2] * np.float32(2 * np.pi) - np.float32(np.pi)
        unifs = torch.as_tensor(unifs, device=dev)
        o, d = camera_ops.shoot_focus(camera, clip, normals * cfg.blur, cfg.focus)
        o, d = o.contiguous(), d.contiguous()
        got, got_casts = mc_kernel.trace(scene, o, d, unifs, 5, 100.0, 10)
        ref, ref_casts = mc_kernel.trace_plain(tb, tex, o, d, unifs, 5, 100.0, 10)
        torch.cuda.synchronize()
        a, b = got.cpu().numpy(), ref.cpu().numpy()
        fc = frac_close(a, b)
        print(f"mc {label}: {fc:.5f} of lanes agree, casts {int(got_casts)} vs "
              f"{int(ref_casts)}, max |err| {np.abs(a - b).max():.3g}")
        assert np.isfinite(a).all() and fc >= 0.99, fc
        assert casts_close(got_casts, ref_casts), (int(got_casts), int(ref_casts))
        # Whitted: the whole frame through the level kernel vs plain levels
        o, d = camera_ops.shoot(camera, clip)
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

    # ---- 3. goldens (scripts/tpu_check.py gates) ------------------------
    cfg = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
    img, stats = render_whitted(scene, camera, cfg)
    g = np.load(os.path.join(GOLDEN, "whitted_demo_64x48.npy"))
    a = img.cpu().numpy()
    p, bad = psnr(a, g), float((np.abs(a - g).max(axis=-1) > 0.1).mean())
    print(f"golden whitted 64x48: psnr {p:.1f} dB, bad {bad:.4f}, dropped {stats['dropped']}")
    assert p >= 38.0 and bad <= 0.02 and stats["dropped"] == 0
    z = np.load(os.path.join(GOLDEN, "mc_demo_64x48_draws.npz"))
    draws = [(torch.as_tensor(z["normals"], device=dev), torch.as_tensor(z["unifs"], device=dev))]
    img, stats = render_distributed_epoch(scene, camera, cfg, draws=draws)
    g = np.load(os.path.join(GOLDEN, "mc_demo_64x48.npy"))
    a = img.cpu().numpy()
    p, bad = psnr(a, g), float((np.abs(a - g).max(axis=-1) > 0.1).mean())
    print(f"golden mc 64x48: psnr {p:.1f} dB, bad {bad:.4f}")
    assert p >= 25.0 and bad <= 0.01

    # ---- 4. the main path at full size -----------------------------------
    lines = []

    def log(msg):
        lines.append(msg)
        print(msg, flush=True)

    for c in (mc_kernel.COUNTS, level_kernel.COUNTS):
        c.launches = c.plain = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.png")
        t0 = time.time()
        state = render_progressive(scene, camera, full, out_path=out, log=log)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {"level": level_kernel.COUNTS.launches, "mc": mc_kernel.COUNTS.launches}
        png = read_png_rgb8(out)
    print(f"main path: whitted + {full.epochs} epochs at 1280x960 in {wall:.2f} s wall; "
          f"launches {launches}")
    assert state.epoch == full.epochs
    assert png.shape == (960, 1280, 3) and png.max() > 0, png.shape
    assert torch.isfinite(state.img).all()
    assert not any("dropped" in m for m in lines), lines
    assert launches["level"] > 0 and launches["mc"] > 0, launches
    assert level_kernel.COUNTS.plain == 0 and mc_kernel.COUNTS.plain == 0

    # Whitted frame and one epoch, kernel vs plain, host clock around a sync
    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        r = fn()
        torch.cuda.synchronize()
        return r, time.time() - t

    clips, _ = _clips(full, dev)

    def whitted_plain_frame():
        for clip in clips:
            o, d = camera_ops.shoot(camera, clip)
            trace_whitted(scene, o, d, full, level_fn=plain_level)

    def mc_plain_epoch():
        for t, clip in enumerate(clips):
            normals, unifs = tile_draws(full, 0, 0, t, clip.shape[0], dev)
            o, d = camera_ops.shoot_focus(camera, clip, normals * full.blur, full.focus)
            mc_kernel.trace_plain(tb, tex, o.contiguous(), d.contiguous(), unifs, 5, 100.0, 10)

    (_, wst), w_s = timed(lambda: render_whitted(scene, camera, full))
    _, wp_s = timed(whitted_plain_frame)
    (_, est), e_s = timed(lambda: render_distributed_epoch(scene, camera, full, epoch=7))
    _, ep_s = timed(mc_plain_epoch)
    print(f"whitted frame 1280x960: kernel {w_s:.3f} s ({wst['casts'] / w_s:,.0f} casts/s), "
          f"plain {wp_s:.3f} s")
    print(f"mc epoch 1280x960: kernel {e_s:.3f} s ({est['casts'] / e_s:,.0f} casts/s), "
          f"plain {ep_s:.3f} s")

    # per-launch times at the main path's shapes: one 65536-ray tile
    clip = clips[0]
    normals, unifs = tile_draws(full, 0, 0, 0, clip.shape[0], dev)
    o, d = camera_ops.shoot_focus(camera, clip, normals * full.blur, full.focus)
    o, d = o.contiguous(), d.contiguous()
    mk, _ = mc_kernel.trace(scene, o, d, unifs, 5, 100.0, 10)
    mp, _ = mc_kernel.trace_plain(tb, tex, o, d, unifs, 5, 100.0, 10)
    mc_err = float((mk - mp).abs().max())
    mc_ms = cuda_ms(lambda: mc_kernel.trace(scene, o, d, unifs, 5, 100.0, 10), 5)
    mc_plain_ms = cuda_ms(lambda: mc_kernel.trace_plain(tb, tex, o, d, unifs, 5, 100.0, 10), 2)
    o, d = camera_ops.shoot(camera, clip)
    pool = _pack_primary(o, d)
    args = (full.threshold, full.max_refract_distance, full.max_tir_retries)
    lk = level_kernel.process_level(scene, pool, False, True, *args)
    lp = plain_level(scene, pool, False, True, *args)
    lv_err = float((lk[0] - lp[0]).abs().max())
    lv_ms = cuda_ms(lambda: level_kernel.process_level(scene, pool, False, True, *args), 10)
    lv_plain_ms = cuda_ms(lambda: plain_level(scene, pool, False, True, *args), 3)
    print(f"per launch, 65536 rays: mc kernel {mc_ms:.3f} ms vs plain {mc_plain_ms:.3f} ms; "
          f"level (primary) kernel {lv_ms:.3f} ms vs plain {lv_plain_ms:.3f} ms")

    print(json.dumps({"whitted_frame_s": w_s, "whitted_frame_plain_s": wp_s,
                      "mc_epoch_s": e_s, "mc_epoch_plain_s": ep_s, "attrs": attrs}))
    print(json.dumps({"kernels": [
        {"name": "mc_kernel", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/mc_kernel.cu",
         "replaces": "raytracer_tpu/ops/mc_pallas.py:474", "launches": launches["mc"],
         "max_abs_err": mc_err, "ms": mc_ms, "plain_ms": mc_plain_ms},
        {"name": "level_kernel", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/level_kernel.cu",
         "replaces": "raytracer_tpu/ops/level_pallas.py:73", "launches": launches["level"],
         "max_abs_err": lv_err, "ms": lv_ms, "plain_ms": lv_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
