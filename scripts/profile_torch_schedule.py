"""Per-phase profile of the port's progressive epoch loop.

Counterpart of scripts/profile_schedule.py for raytracer_tpu_torch.  It
runs the loop of parallel/progressive.render_progressive by hand on the
demo scene (default 1280x960, depth 5, 20 epochs), with render_progressive's
own calls: the Whitted frame through render_whitted_sharded, then each group
of --png-every epochs through train_steps_sharded on the mesh of one, the
u8 frame's copy to the host and utils/png.write_png_atomic's writer.  Per
group it times:

  dispatch    the host's time until train_steps_sharded returns;
  device      torch.cuda.synchronize() after it, and the counters' read;
  fetch       u8.cpu(): the frame's copy to the host;
  encode      the PNG encoder (encode_png_rgb8, zlib level 6), Python route;
  write       the temp file's write and fsync (Python route), or the whole
              C++ writer of native/ as one call (native route: taken when
              utils/native.available(), as render_progressive does);
  rename      the atomic rename (Python route);
  checkpoint  with --checkpoint: the accumulator's copy and save_checkpoint.

The writer's phases run on the main thread here so they can be timed;
render_progressive runs them on its writer thread, overlapped with the
next group's device work.  On the native route the Python route is also
timed once on the last frame.  Then the same epochs run through render_progressive,
timed around the call (the pipelined wall) and between its groups'
on_epoch callbacks.  The first group, which meets every first-call set-up,
is left out of the medians.  Prints one JSON line.

    python scripts/profile_torch_schedule.py [--epochs 20] [--png-every 1]
    python scripts/profile_torch_schedule.py --device cpu --width 64 --height 48 --epochs 3
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PHASES = ("dispatch_s", "device_s", "fetch_s", "encode_s", "write_s", "rename_s",
          "checkpoint_s")


def _python_writer(path, rgb, lap) -> dict:
    """utils/png.write_png_atomic's Python route, phase by phase."""
    from raytracer_tpu_torch.utils import png

    data = png.encode_png_rgb8(rgb)
    out = {"encode_s": lap()}
    tmp = png.write_tmp(path, data)
    out["write_s"] = lap()
    os.replace(tmp, path)
    out["rename_s"] = lap()
    return out


def _stopwatch():
    """lap() -> seconds since the previous lap (or since the stopwatch
    was made)."""
    last = [time.perf_counter()]

    def lap():
        now = time.perf_counter()
        dt, last[0] = now - last[0], now
        return dt
    return lap


def profile(scene, camera, cfg, png_every: int, out_dir: str, seed: int = 0,
            checkpoint: bool = False) -> dict:
    """Run cfg.epochs epochs of the schedule by hand, then through
    render_progressive -> the result printed by main (medians, and each
    group's phases under "groups")."""
    import torch

    from raytracer_tpu_torch.ops.tonemap import post_process
    from raytracer_tpu_torch.parallel.mesh import (
        RenderMesh,
        render_whitted_sharded,
        train_steps_sharded,
    )
    from raytracer_tpu_torch.parallel.progressive import render_progressive, save_checkpoint
    from raytracer_tpu_torch.utils import native

    device = scene.device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    mesh = RenderMesh(dp=1, sp=1)
    out_png = os.path.join(out_dir, "profile.png")
    ckpt = os.path.join(out_dir, "profile.ckpt.npz") if checkpoint else None
    route = "native" if native.available() else "python"

    t0 = time.perf_counter()
    img, _ = render_whitted_sharded(scene, camera, cfg, mesh)
    img = post_process(img, cfg.percentile)
    sync()
    whitted_s = time.perf_counter() - t0

    groups, epoch, host = [], 0, None
    while epoch < cfg.epochs:
        k = max(1, min(png_every, cfg.epochs - epoch))
        start = time.perf_counter()
        lap = _stopwatch()
        g = dict.fromkeys(PHASES)
        img, u8, counters = train_steps_sharded(scene, camera, cfg, mesh, img, seed, k, epoch)
        g["dispatch_s"] = lap()
        sync()
        counters.tolist()
        g["device_s"] = lap()
        host = u8.cpu().numpy()
        g["fetch_s"] = lap()
        if route == "native":
            native.write_png_atomic(out_png, host)
            g["write_s"] = lap()
        else:
            g.update(_python_writer(out_png, host, lap))
        epoch += k
        if ckpt:
            save_checkpoint(ckpt, img.cpu().numpy(), epoch, seed)
            g["checkpoint_s"] = lap()
        g["serial_s"] = time.perf_counter() - start
        g["epochs"] = k
        groups.append(g)
    python_once = None
    if route == "native":
        python_once = _python_writer(out_png, host, _stopwatch())

    # a checkpoint of its own: the loop's would resume it at the end
    stamps = []
    own_ckpt = os.path.join(out_dir, "pipelined.ckpt.npz") if ckpt else None
    t0 = time.perf_counter()
    render_progressive(scene, camera, cfg, out_path=os.path.join(out_dir, "pipelined.png"),
                       seed=seed, log=lambda m: None, png_every=png_every,
                       checkpoint_path=own_ckpt,
                       on_epoch=lambda e, s: stamps.append(time.perf_counter()))
    wall = time.perf_counter() - t0

    def med(xs):
        xs = [x for x in xs if x is not None]
        return statistics.median(xs) if xs else None

    timed = groups[1:]  # the first group meets every first-call set-up
    out = {
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "width": cfg.width, "height": cfg.height, "epochs": cfg.epochs, "png_every": png_every,
        "writer_route": route, "groups_timed": len(timed), "whitted_s": whitted_s,
        **{p: med(g[p] for g in timed) for p in PHASES},
        "serial_group_s": med(g["serial_s"] for g in timed),
        "python_route_once": python_once,
        "pipelined_wall_s": wall,
        "pipelined_group_s": med(b - a for a, b in zip(stamps, stamps[1:])),
        "groups": groups,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--png-every", type=int, default=1, metavar="K")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", action="store_true",
                    help="also write the checkpoint each group, as --checkpoint does")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene

    cfg = RenderConfig(width=args.width, height=args.height, depth=5, epochs=args.epochs)
    scene, camera = demo_scene(device=args.device), demo_camera(device=args.device)
    with tempfile.TemporaryDirectory() as tmp:
        out = profile(scene, camera, cfg, args.png_every, tmp, args.seed, args.checkpoint)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
