"""Command-line entry point (counterpart of raytracer_tpu/cli.py:22-273).

The reference has no CLI — everything is hardcoded in main()
(src/main.rs:809-1174).  This runs the same schedule (Whitted pass, then
progressive stochastic epochs, PNG after every epoch) with the reference's
defaults:

    python -m raytracer_tpu_torch --scene demo --epochs 100 --out out.png

It renders on --device (default cuda) and fails if that device is absent.
"""

from __future__ import annotations

import argparse
import sys

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.scene.presets import PRESETS, demo_camera


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch", description=__doc__)
    p.add_argument("--scene", default="demo", choices=sorted(PRESETS.keys()))
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=960)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--epochs", type=int, default=100,
                   help="stochastic epochs after the Whitted pass (0 = Whitted only)")
    p.add_argument("--focus", type=float, default=3.0)
    p.add_argument("--blur", type=float, default=0.04)
    p.add_argument("--out", default="out.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="npz path for epoch-granular resume")
    p.add_argument("--tile-rays", type=int, default=1 << 16)
    p.add_argument("--png-every", type=int, default=1, metavar="K",
                   help="write the PNG/checkpoint once per K epochs (same image)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:1, cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from raytracer_tpu_torch.parallel.progressive import render_progressive

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available (use --device cpu for the plain "
              "PyTorch path)", file=sys.stderr)
        return 2
    cfg = RenderConfig(
        width=args.width, height=args.height, depth=args.depth,
        epochs=args.epochs, focus=args.focus, blur=args.blur,
        tile_rays=args.tile_rays,
    )
    scene = PRESETS[args.scene]().to(device)
    camera = demo_camera().to(device)
    render_progressive(
        scene, camera, cfg, out_path=args.out, seed=args.seed,
        checkpoint_path=args.checkpoint, png_every=args.png_every,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
