"""Fidelity of the port's full schedule against the JAX package's renders.

Counterpart of scripts/psnr_vs_reference.py for raytracer_tpu_torch.  The
schedule is the reference program's (src/main.rs:1084-1173): the demo
scene at 1280x960, depth 5, a Whitted pass and 100 stochastic epochs,
percentile-renormalised every epoch.  artifacts/out.png (seed 0) and
artifacts/out_seed1.png (seed 1) are the JAX package's renders of it;
artifacts/PSNR.json records their two-seed Monte-Carlo noise floor
(self_psnr_*).  The port draws with its own generator, so its render is
another noise realisation of the same estimator: against a JAX render it
should score at that floor, and a structural bias shows as a score under
it.

Scores, as the JAX tool's:
  * raw PSNR in 8-bit sRGB, bounded by the per-pixel MC noise;
  * PSNR of k x k box averages (k = 4, 8), which average that noise away,
    so the number measures structural agreement.

Usage:
  python scripts/psnr_torch_vs_reference.py                 # render on the card + score
  python scripts/psnr_torch_vs_reference.py --png-every 100 # same image, one PNG
  python scripts/psnr_torch_vs_reference.py --use out.png   # score only
  python scripts/psnr_torch_vs_reference.py --device cpu --width 64 --height 48 \\
      --epochs 2 --golden a.png --self-b b.png              # a small rehearsal

Prints one JSON object; --json PATH also writes it there.  The feature
crops of the JAX tool (score_features) need the reference's report/*.png,
which the repository does not hold, and are not scored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GOLDEN = os.path.join(REPO, "artifacts", "out.png")
SEED_B = os.path.join(REPO, "artifacts", "out_seed1.png")


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR between two u8 RGB images (dB)."""
    assert a.shape == b.shape, (a.shape, b.shape)
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def box_down(img: np.ndarray, k: int) -> np.ndarray:
    """k x k box average (float64), the rows and columns past a multiple
    of k cropped."""
    h, w = img.shape[0] // k * k, img.shape[1] // k * k
    x = img[:h, :w].astype(np.float64)
    return x.reshape(h // k, k, w // k, k, 3).mean(axis=(1, 3))


def psnr_down(a: np.ndarray, b: np.ndarray, k: int) -> float:
    """PSNR of the two images' k x k box averages (dB)."""
    da, db = box_down(a, k), box_down(b, k)
    mse = np.mean((da - db) ** 2)
    return float(20.0 * np.log10(255.0 / np.sqrt(mse))) if mse else float("inf")


def _scores(a: np.ndarray, b: np.ndarray, prefix: str) -> dict:
    return {f"{prefix}raw_db": round(psnr_u8(a, b), 2),
            f"{prefix}down4_db": round(psnr_down(a, b, 4), 2),
            f"{prefix}down8_db": round(psnr_down(a, b, 8), 2)}


def score(render_path: str, golden_path: str = GOLDEN) -> dict:
    """A render's PSNR against a golden, raw and box-averaged."""
    from raytracer_tpu_torch.utils.png import read_png_rgb8

    got = read_png_rgb8(render_path)
    return {"render": render_path, "golden": golden_path, "shape": list(got.shape),
            **_scores(got, read_png_rgb8(golden_path), "psnr_")}


def self_noise(render_a: str, render_b: str) -> dict:
    """The noise floor: PSNR between two renders of the same schedule with
    different seeds."""
    from raytracer_tpu_torch.utils.png import read_png_rgb8

    return {"self_render_a": render_a, "self_render_b": render_b,
            **_scores(read_png_rgb8(render_a), read_png_rgb8(render_b), "self_psnr_")}


def render(out: str, seed: int, epochs: int, png_every: int, device: str = "cuda",
           width: int = 1280, height: int = 960) -> dict:
    """The full schedule through render_progressive on the demo scene ->
    {render_s, dropped, device_name}: the render's wall, and the rays its
    Whitted pass dropped (from render_progressive's own warning line)."""
    import torch

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.parallel.progressive import render_progressive
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene

    cfg = RenderConfig(width=width, height=height, depth=5, epochs=epochs)
    scene, camera = demo_scene(device=device), demo_camera(device=device)
    lines: list = []
    t0 = time.time()
    render_progressive(scene, camera, cfg, out_path=out, seed=seed, log=lines.append,
                       png_every=png_every)  # returns once the last PNG is written
    dropped = sum(int(m.split()[1]) for m in lines if "dropped by pool overflow" in m)
    name = torch.cuda.get_device_name(scene.device) if scene.device.type == "cuda" else "cpu"
    return {"render_s": time.time() - t0, "dropped": dropped, "device_name": name}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--use", default=None, metavar="PNG",
                   help="score an existing render instead of rendering")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="out.png", help="where the render is written")
    p.add_argument("--png-every", type=int, default=1, metavar="K",
                   help="write the PNG once per K epochs (the same image; 100 is fastest)")
    p.add_argument("--golden", default=GOLDEN)
    p.add_argument("--self-b", default=SEED_B, metavar="PNG",
                   help="a second render of the schedule with another seed")
    p.add_argument("--json", default=None, metavar="PATH", help="also write the result here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=960)
    args = p.parse_args(argv)

    result = {}
    if args.use is None:
        result.update(render(args.out, args.seed, args.epochs, args.png_every, args.device,
                             args.width, args.height))
        result.update(epochs=args.epochs, seed=args.seed, png_every=args.png_every,
                      device=args.device)
        render_path = args.out
    else:
        render_path = args.use
    result.update(score(render_path, args.golden))
    result.update(self_noise(render_path, args.self_b))
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
