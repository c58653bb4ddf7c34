#!/usr/bin/env python3
"""How far the lanes of a warp share the chunks of a blocked mesh, counted
by the plain PyTorch versions (any device; the CPU will do at a few thousand
lanes).

    python3 scripts/blocked_chunk_sharing.py [--grid 75] [--size 1024]
        [--tile 6] [--lanes 4096] [--device cpu]

Takes the first `lanes` lanes of tile `tile` of a size x size frame of
mesh_scene(grid), depth 5, and walks them twice under
kernel_common.count_chunks: through mc_kernel.trace_plain (lanes in pixel
order, 32x16 blocks) and through the binned path's plain kernels (lanes
sorted before every bounce).  Prints, for each, the chunks that single rays
entered (`lane`), the chunks that groups of 32 and of 128 consecutive lanes
entered together in one pass (what a warp, or a block of four warps, of the
cooperative kernels would stage), and the ratios: staged x group / lane is
1 when all lanes of a group enter the same chunks and the group size when
no two do.  These are counts, not times.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEPTH, MD, MR = 5, 100.0, 10


def report(label, lane, group):
    out = {"walk": label, "lane_chunks": int(lane)}
    for g, staged in group.items():
        out[f"staged_per_{g}"] = int(staged)
        out[f"ratio_{g}"] = int(staged) * g / max(int(lane), 1)
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=75)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--tile", type=int, default=6)
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.ops import camera as camera_ops
    from raytracer_tpu_torch.ops import kernel_common as kc
    from raytracer_tpu_torch.ops import mc_binned, mc_kernel
    from raytracer_tpu_torch.render import _clips
    from raytracer_tpu_torch.scene.presets import mesh_scene

    dev = torch.device(args.device)
    scene, cam = (x.to(dev) for x in mesh_scene(args.grid))
    cfg = RenderConfig(width=args.size, height=args.size, depth=DEPTH)
    clip = _clips(cfg, dev)[0][args.tile][:args.lanes]
    n = clip.shape[0]
    rng = np.random.default_rng(0)
    normals = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32), device=dev)
    unifs = rng.uniform(size=(DEPTH, 3, n)).astype(np.float32)
    unifs[:, 2] = unifs[:, 2] * np.float32(2 * np.pi) - np.float32(np.pi)
    unifs = torch.as_tensor(unifs, device=dev)
    o, d = camera_ops.shoot_focus(cam, clip, normals * cfg.blur, cfg.focus)
    o, d = o.contiguous(), d.contiguous()
    groups = (32, 128)
    print(f"mesh_scene({args.grid}): {scene.n_tri} triangles, {scene.blk_tables.n_chunks} "
          f"chunks; {n} lanes of tile {args.tile} of {args.size}x{args.size}")

    geom, tex = scene.geom, scene.textures
    with kc.count_chunks(n, dev, groups) as log:
        mc_kernel.trace_plain(geom, tex, o, d, unifs, DEPTH, MD, MR)
    report("whole walk, pixel order", log.lane.sum(), {g: a.sum() for g, a in log.group.items()})

    # the binned walk: every kernel call has its own lane order
    lane, group = 0, dict.fromkeys(groups, 0)

    def counted(fn, *a):
        nonlocal lane
        with kc.count_chunks(n, dev, groups) as log:
            out = fn(*a)
        lane += int(log.lane.sum())
        for g, acc in log.group.items():
            group[g] += int(acc.sum())
        return out

    sf, si, _ = counted(mc_binned.primary_plain, geom, o.t().contiguous(), d.t().contiguous())
    report("binned primary", lane, group)
    for step in range(DEPTH):
        lane, group = 0, dict.fromkeys(groups, 0)
        sf, si = mc_binned.sort_state(scene, sf, si, unifs[step])  # the sort alone, not dealt
        u = unifs[step][:, si[mc_binned.I_SLOT].long()].contiguous()
        sf, si, _ = counted(mc_binned.bounce_plain, geom, tex, sf, si, u, step == 0, MD, MR)
        report(f"binned bounce {step}, sorted", lane, group)
    lane, group = 0, dict.fromkeys(groups, 0)
    counted(mc_binned.terminal_plain, geom, tex, sf, si, DEPTH == 0)
    report("binned terminal", lane, group)
    return 0


if __name__ == "__main__":
    sys.exit(main())
