#!/usr/bin/env python3
"""The warp-cooperative blocked MC walks against their per-thread
instantiations on one NVIDIA GPU: results, test totals and times.

    python3 scripts/exp_torch_coop_walk.py

Builds the kernels (printing ptxas' report and each instantiation's
attributes), then, on mesh_scene(24) at 64x48 (whole and cut to 1000 lanes)
and on tile 6 of the 1024x1024 frames of mesh_scene(75) (whole and cut to
40013 lanes) and mesh_scene(160): mc_kernel.trace against
mc_kernel.trace_per_thread (share of lanes with equal photons, casts, the
totals of the `work` rows, milliseconds of each by CUDA events around 5
launches), then every bounce of the binned walk the same way, with the
median and the longest block duration of the counted launch.  Prints as it
goes; an experiment's record, not a check.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from raytracer_tpu_torch.utils import kernels
from raytracer_tpu_torch.ops import kernel_common as kc, mc_kernel, mc_binned
from raytracer_tpu_torch.ops import camera as camera_ops
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import _clips
from raytracer_tpu_torch.scene.presets import mesh_scene
os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
_, s = kernels.build(verbose=True)
print("built in", s, flush=True)
for k in kernels.ATTRS:
    print(k, kernels.kernel_attrs(k), flush=True)
dev = torch.device("cuda")
DEPTH, MD, MR = 5, 100.0, 10
NW = len(kernels.WORK_ROWS)
rng = np.random.default_rng(0)
def ms(fn, reps=5):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps): fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
def frac_close(a, b):
    return float(np.all(np.abs(a - b) <= 1e-3 + 2e-2 * np.abs(b), axis=-1).mean())
for grid, size, tile, n_take, plain in ((24, 64, 0, 3072, True), (24, 64, 0, 1000, True), (75, 1024, 6, 65536, True), (75, 1024, 6, 40013, False), (160, 1024, 6, 65536, False)):
    scene, cam = (x.to(dev) for x in mesh_scene(grid))
    cfg = RenderConfig(width=size, height=size * 3 // 4 if size == 64 else size, depth=5, tile_rays=min(size * size, 65536))
    clip = _clips(cfg, dev)[0][tile][:n_take]
    n = clip.shape[0]
    normals = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32), device=dev)
    unifs = rng.uniform(size=(DEPTH, 3, n)).astype(np.float32)
    unifs[:, 2] = unifs[:, 2] * np.float32(2 * np.pi) - np.float32(np.pi)
    unifs = torch.as_tensor(unifs, device=dev)
    o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
    o, d = o.contiguous(), d.contiguous()
    wc = torch.zeros((NW, n), dtype=torch.int32, device=dev); wt = torch.zeros_like(wc)
    pc, cc = mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR, work=wc)
    torch.cuda.synchronize(); print("coop ran", flush=True)
    pt, ct = mc_kernel.trace_per_thread(scene, o, d, unifs, DEPTH, MD, MR, work=wt)
    torch.cuda.synchronize()
    pn, cn = mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR)
    print(f"mesh{grid} n={n}: coop==thread photons {float((pc == pt).all(1).float().mean()):.6f} casts {int(cc)} {int(ct)} "
          f"work {wc[:7].sum(1).tolist()} vs {wt[:7].sum(1).tolist()}; counting==main {torch.equal(pc, pn)}", flush=True)
    if plain:
        pp, cp = mc_kernel.trace_plain(scene.geom, scene.textures, o, d, unifs, DEPTH, MD, MR)
        print(f"   vs plain {frac_close(pc.cpu().numpy(), pp.cpu().numpy()):.5f} casts {int(cp)}", flush=True)
    print(f"   ms: coop {ms(lambda: mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR)):.3f} thread "
          f"{ms(lambda: mc_kernel.trace_per_thread(scene, o, d, unifs, DEPTH, MD, MR)):.3f}", flush=True)
    # binned walk
    sf, si, _ = mc_binned.primary(scene, o.t().contiguous(), d.t().contiguous())
    for step in range(DEPTH):
        sf, si = mc_binned.deal_lanes(*mc_binned.sort_state(scene, sf, si, unifs[step]))
        u = unifs[step][:, si[mc_binned.I_SLOT].long()].contiguous()
        wc.zero_(); wt.zero_()
        fc, ic, c1 = mc_binned.bounce(scene, sf, si, u, step == 0, MD, MR, work=wc)
        ft, it, c2 = mc_binned.bounce_per_thread(scene, sf, si, u, step == 0, MD, MR, work=wt)
        torch.cuda.synchronize()
        alive = (ic[0] != 0)
        samef = float(((fc == ft) | ~alive | (torch.arange(21, device=dev)[:, None] >= 3)).all(0).float().mean())
        t1 = ms(lambda: mc_binned.bounce(scene, sf, si, u, step == 0, MD, MR))
        t2 = ms(lambda: mc_binned.bounce_per_thread(scene, sf, si, u, step == 0, MD, MR))
        dur = (wc[8].long() - wc[7].long()) & 0xffffffff
        bd = dur.view(-1, 128).max(1).values.float() if n % 128 == 0 else dur.float()
        print(f"   bounce {step}: f {samef:.6f} exact {float((fc == ft).all(0).float().mean()):.6f} i {torch.equal(ic, it)} casts {int(c1.sum())} {int(c2.sum())} work {wc[:7].sum(1).tolist()} "
              f"vs {wt[:7].sum(1).tolist()}; ms coop {t1:.3f} thread {t2:.3f}; block us p50 {float(bd.median())/1e3:.0f} max {float(bd.max())/1e3:.0f}", flush=True)
        sf, si = fc, ic
print("done")
