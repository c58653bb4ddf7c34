#!/usr/bin/env python3
"""Lane orders of the binned MC walk and of the blocked MC kernel on one
NVIDIA GPU: what the sort between bounces is worth to the warp-cooperative
bounce kernel.

    python3 scripts/exp_torch_lane_orders.py

On tile 0 of the 1024x1024 frames of mesh_scene(75) and mesh_scene(160),
depth 5, CUDA events around 5 launches: mc_kernel.trace with the rays dealt
round-robin over the warps in groups of 1, 4, 8 and 32 lanes (32: pixel
order), with the block durations of a counted launch; then the five
bounces of the binned walk with the lanes in sorted order, sorted and dealt
in groups of 1 to 16 lanes (deal1, as mc_binned.trace, to deal16), in pixel
order, in pixel order dealt at the first bounce (pdeal1, pdeal4) and live
lanes first (alive-first), then dealt (afdeal1), with the three
slowest warps of bounces 1 and 4 of the dealt walk (their casts, ray-chunks,
staged chunks and tests); last sort_state's and the terminal kernel's own
time.  Prints as it goes; an experiment's record, not a check.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from raytracer_tpu_torch.utils import kernels
from raytracer_tpu_torch.ops import mc_kernel, mc_binned
from raytracer_tpu_torch.ops import camera as camera_ops
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import _clips, tile_draws
from raytracer_tpu_torch.scene.presets import mesh_scene
os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
kernels.build()
dev = torch.device("cuda")
DEPTH, MD, MR = 5, 100.0, 10
NW = len(kernels.WORK_ROWS)
def ms(fn, reps=5):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps): fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
def deal(n, g):
    W = n // 32
    i = torch.arange(n, device=dev)
    q, r = i // g, i % g
    pos = (q % W) * 32 + (q // W) * g + r
    inv = torch.empty_like(pos); inv[pos] = i
    return inv  # new[pos] = old[i]  -> new = old[inv]
for grid in (75, 160):
    scene, cam = (x.to(dev) for x in mesh_scene(grid))
    cfg = RenderConfig(width=1024, height=1024, depth=5)
    clip = _clips(cfg, dev)[0][0]
    n = clip.shape[0]
    normals, unifs = tile_draws(cfg, 0, 0, 0, n, dev)
    o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
    o, d = o.contiguous(), d.contiguous()
    print(f"mesh{grid}: mc_blk {ms(lambda: mc_kernel.trace(scene, o, d, unifs, DEPTH, MD, MR)):.3f} ms", flush=True)
    for g in (1, 4, 8, 32):
        inv = deal(n, g)
        oo, dd, uu = o[inv].contiguous(), d[inv].contiguous(), unifs[:, :, inv].contiguous()
        w = torch.zeros((NW, n), dtype=torch.int32, device=dev)
        mc_kernel.trace(scene, oo, dd, uu, DEPTH, MD, MR, work=w); torch.cuda.synchronize()
        dur = ((w[8].long() - w[7].long()) & 0xffffffff).view(-1, 128).max(1).values.float() / 1e3
        t0 = (w[7].long() & 0xffffffff); span = float(((w[8].long() & 0xffffffff).max() - t0.min())) / 1e3
        print(f"  mc_blk rays dealt g={g}: {ms(lambda: mc_kernel.trace(scene, oo, dd, uu, DEPTH, MD, MR)):.3f} ms; counted launch: block us p10 {float(dur.quantile(0.1)):.0f} p50 {float(dur.median()):.0f} p90 {float(dur.quantile(0.9)):.0f} max {float(dur.max()):.0f}, span {span:.0f}; staged {int(w[6].sum())} ray-chunks {int(w[5].sum())}", flush=True)
    for order in ("sorted", "pixel", "alive-first", "deal1", "deal2", "deal4", "deal8", "deal16",
                  "pdeal1", "pdeal4", "afdeal1"):
        sf, si, _ = mc_binned.primary(scene, o.t().contiguous(), d.t().contiguous())
        times = []
        for step in range(DEPTH):
            if order in ("alive-first", "afdeal1"):
                perm = torch.argsort((si[0] == 0).long(), stable=True)
                sf, si = sf[:, perm].contiguous(), si[:, perm].contiguous()
                if order == "afdeal1":
                    inv = deal(n, 1)
                    sf, si = sf[:, inv].contiguous(), si[:, inv].contiguous()
            elif order.startswith("pdeal"):
                if step == 0:
                    inv = deal(n, int(order[5:]))
                    sf, si = sf[:, inv].contiguous(), si[:, inv].contiguous()
            elif order != "pixel":
                sf, si = mc_binned.sort_state(scene, sf, si, unifs[step])
                if order.startswith("deal"):
                    inv = deal(n, int(order[4:]))
                    sf, si = sf[:, inv].contiguous(), si[:, inv].contiguous()
            u = unifs[step][:, si[mc_binned.I_SLOT].long()].contiguous()
            times.append(ms(lambda: mc_binned.bounce(scene, sf, si, u, step == 0, MD, MR)))
            if order in ("deal1",) and step in (1, 4):
                w = torch.zeros((NW, n), dtype=torch.int32, device=dev)
                _, _, casts = mc_binned.bounce(scene, sf, si, u, step == 0, MD, MR, work=w)
                torch.cuda.synchronize()
                dur = ((w[8].long() - w[7].long()) & 0xffffffff).view(-1, 32).max(1).values
                top = torch.argsort(dur, descending=True)[:3]
                for t in top.tolist():
                    sl = slice(t * 32, t * 32 + 32)
                    print(f"    {order} bounce {step} warp {t}: {int(dur[t])/1e3:.0f} us, alive {int((si[0, sl] != 0).sum())}, casts {int(casts[sl].sum())}, "
                          f"ray-chunks {int(w[5, sl].sum())}, staged {int(w[6, sl].sum())}, box {int(w[4, sl].sum())}, tri {int(w[0, sl].sum())}")
            sf, si, _ = mc_binned.bounce(scene, sf, si, u, step == 0, MD, MR)
        print(f"  {order:12s} bounces {' '.join(f'{t:.3f}' for t in times)}  sum {sum(times):.3f}", flush=True)
    t_sort = ms(lambda: mc_binned.sort_state(scene, sf, si, unifs[0]))
    t_term = ms(lambda: mc_binned.terminal(scene, sf, si, False))
    print(f"  sort_state {t_sort:.3f} ms, terminal {t_term:.3f} ms")
