"""Command-line entry point (counterpart of raytracer_tpu/cli.py:22-273).

The reference has no CLI — everything is hardcoded in main()
(src/main.rs:809-1174).  This runs the same schedule (Whitted pass, then
progressive stochastic epochs, PNG after every epoch) with the reference's
defaults:

    python -m raytracer_tpu_torch --scene demo --epochs 100 --out out.png

It renders on --device (default cuda) and fails if that device is absent.
With --devices N it starts N processes on this host, one a card (cuda:r
for rank r; gloo processes with --device cpu), which render as one (dp,
sp) mesh (parallel/mesh.py); rank 0 writes the PNG and the checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import os
import subprocess
import sys
import tempfile
import time

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.scene.presets import PRESETS, demo_camera


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch", description=__doc__)
    p.add_argument("--scene", default="demo", choices=sorted(PRESETS.keys()))
    p.add_argument("--scene-file", default=None, metavar="JSON",
                   help="load a JSON scene (scene/serialize.py format) instead of a "
                        "preset; its camera is used if present")
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
    p.add_argument("--obj", default=None,
                   help="OBJ mesh in place of the demo's dodecahedron (presets "
                        "that take one; a missing file keeps the built-in mesh)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the render with torch.profiler into DIR (Chrome "
                        "trace and an operation summary) and print the top "
                        "operations afterwards")
    p.add_argument("--debug-nans", action="store_true",
                   help="stop at the first non-finite value in a Whitted frame's "
                        "colours or an epoch's photons (each check waits for "
                        "the device)")
    p.add_argument("--warm-cache", action="store_true",
                   help="build the kernel library and run this config's schedule "
                        "once at each group size --png-every dispatches, into a "
                        "temp file, then exit without writing --out")
    p.add_argument("--png-every", type=int, default=1, metavar="K",
                   help="write the PNG/checkpoint once per K epochs (same image)")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="supervise the render: relaunch it up to N times in a fresh "
                        "process if it fails, resuming from --checkpoint "
                        "(derived from --out if not given): a CUDA context "
                        "that took a sticky error cannot be used again")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:1, cpu)")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="render on N processes of this host as a (dp, sp) mesh, rank r on "
                        "cuda:r (with --device cpu: N CPU processes on gloo); 0 = one "
                        "process on --device")
    return p


def _supervise(argv: list[str], retries: int, checkpoint: str | None, out: str) -> int:
    """Relaunch the render in a fresh process on failure, resuming from the
    checkpoint (raytracer_tpu/cli.py:73-141).

    The progressive driver checkpoints with each PNG write, so a crash at
    any point loses at most one output group; the draws of an epoch depend
    only on (seed, epoch, tile), so a resumed render draws what the dead
    one would have.  rc 2 (a usage error, or no CUDA) is not retried. Two
    failures in a row with no checkpoint progress abort: a failure that
    reproduces from the same state is deterministic, not transient."""
    import numpy as np

    child = [a for i, a in enumerate(argv)
             if a != "--retries" and not a.startswith("--retries=")
             and not (i > 0 and argv[i - 1] == "--retries")]
    auto_ckpt = checkpoint is None
    if auto_ckpt:
        checkpoint = out + ".ckpt.npz"
        child += ["--checkpoint", checkpoint]
        print(f"supervisor: checkpointing to {checkpoint}")
        if os.path.exists(checkpoint):
            print(f"supervisor: resuming from leftover {checkpoint}")

    def ckpt_epoch() -> int:
        try:
            with np.load(checkpoint) as data:
                return int(data["epoch"])
        except (OSError, KeyError, ValueError):
            return -1

    env = dict(os.environ, RAYTPU_SUPERVISED="1")
    delay = float(os.environ.get("RAYTPU_RETRY_DELAY", "30"))
    rc, no_progress = 1, 0
    for attempt in range(retries + 1):
        if attempt:
            print(f"supervisor: attempt {attempt} failed (rc={rc}); "
                  f"relaunching in {delay:.0f}s", flush=True)
            time.sleep(delay)
        before = ckpt_epoch()
        sys.stdout.flush()
        rc = subprocess.call([sys.executable, "-m", "raytracer_tpu_torch", *child], env=env)
        if rc == 0:
            if auto_ckpt:
                # it existed only to make retries resumable: a rerun of the
                # same command must render afresh, not resume at the end
                try:
                    os.remove(checkpoint)
                except FileNotFoundError:
                    pass
            return 0
        if rc == 2:  # usage error or no CUDA: retrying cannot help
            return rc
        no_progress = no_progress + 1 if ckpt_epoch() <= before else 0
        if no_progress >= 2:
            print("supervisor: two failures with no checkpoint progress — "
                  "deterministic error, giving up")
            return rc
    print(f"supervisor: giving up after {retries + 1} attempts (rc={rc})")
    return rc


def _log():
    """The log function, with the failure injections of the supervisor's
    tests (raytracer_tpu/cli.py:186-216): RAYTPU_TEST_FAIL_ALWAYS dies on
    every process's first throughput line, before anything is
    checkpointed; RAYTPU_TEST_FAIL_TOKEN dies on the second (after the
    Whitted pass checkpointed), once per token file."""
    if os.environ.get("RAYTPU_TEST_FAIL_ALWAYS"):
        def log(msg):
            print(msg, flush=True)
            if "rays in" in msg:
                raise RuntimeError("injected deterministic failure (RAYTPU_TEST_FAIL_ALWAYS)")
        return log
    tok = os.environ.get("RAYTPU_TEST_FAIL_TOKEN")
    if tok:
        seen = [0]

        def log(msg):
            print(msg, flush=True)
            if "rays in" in msg:
                seen[0] += 1
                if seen[0] >= 2 and not os.path.exists(tok):
                    open(tok, "w").close()
                    raise RuntimeError("injected transient failure (RAYTPU_TEST_FAIL_TOKEN)")
        return log
    return print


def _scene(args, device):
    """(scene, camera) on `device` from --scene-file or --scene / --obj."""
    if args.scene_file:
        from raytracer_tpu_torch.scene.serialize import load_scene_file

        scene, camera = load_scene_file(args.scene_file, device=device)
        return scene, camera or demo_camera(device)
    preset = PRESETS[args.scene]
    takes_obj = "obj_path" in inspect.signature(preset).parameters
    made = preset(obj_path=args.obj, device=device) if takes_obj else preset(device=device)
    if isinstance(made, tuple):  # a preset with a view of its own (spd-balls, spd-rings)
        return made
    return made, demo_camera(device)


def _warm_cache(scene, camera, cfg, args, device, mesh=None) -> None:
    """Build the kernel library, then run the schedule once for each group
    size the real run dispatches (raytracer_tpu/cli.py:222-251): the main
    group of --png-every epochs and the tail group, into a temp file."""
    from raytracer_tpu_torch.parallel.progressive import render_progressive

    t0 = time.time()
    built = "nothing to build on the CPU"
    if device.type == "cuda":
        from raytracer_tpu_torch.utils import kernels

        path, build_s = kernels.build()
        built = f"{os.path.basename(path)} ({build_s:.1f} s to build)"
    ks = {max(1, min(args.png_every, cfg.epochs or 1))}
    if 1 < args.png_every < cfg.epochs and cfg.epochs % args.png_every:
        ks.add(cfg.epochs % args.png_every)
    with tempfile.TemporaryDirectory() as tmp:
        for k in sorted(ks):
            render_progressive(scene, camera, dataclasses.replace(cfg, epochs=k),
                               out_path=os.path.join(tmp, "warm.png"), seed=args.seed,
                               log=lambda m: None, png_every=k, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print(f"warm-cache: kernel library {built}; schedule run at group sizes "
              f"{sorted(ks)} in {time.time() - t0:.1f} s")


def _render(args, device, mesh=None) -> None:
    """Build the scene on `device` and run the schedule (with `mesh`: this
    rank's part of it; rank 0 alone profiles)."""
    from raytracer_tpu_torch.parallel.progressive import render_progressive

    cfg = RenderConfig(
        width=args.width, height=args.height, depth=args.depth,
        epochs=args.epochs, focus=args.focus, blur=args.blur,
        tile_rays=args.tile_rays,
    )
    scene, camera = _scene(args, device)
    if args.warm_cache:
        _warm_cache(scene, camera, cfg, args, device, mesh)
        return

    def render():
        render_progressive(
            scene, camera, cfg, out_path=args.out, seed=args.seed,
            checkpoint_path=args.checkpoint, log=_log(), png_every=args.png_every,
            debug_nans=args.debug_nans, mesh=mesh,
        )

    if args.profile and (mesh is None or mesh.rank == 0):
        from raytracer_tpu_torch.utils.profiling import print_profile, profile_trace

        with profile_trace(args.profile, cuda=device.type == "cuda"):
            render()
        print_profile(args.profile)
    else:
        render()


def _rank_main(rank: int, args, port: int) -> None:
    """Rank `rank` of a --devices group: join the group on this host's
    `port`, take the rank's device, render its part."""
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.mesh import init_multihost, make_render_mesh

    device = init_multihost(f"127.0.0.1:{port}", args.devices, rank, device=args.device)
    try:
        mesh = make_render_mesh(args.devices)
        if rank == 0:
            print(f"mesh: {mesh.shape}", flush=True)
        _render(args, device, mesh)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.retries > 0 and not os.environ.get("RAYTPU_SUPERVISED"):
        raw = list(sys.argv[1:] if argv is None else argv)
        return _supervise(raw, args.retries, args.checkpoint, args.out)
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available (use --device cpu for the plain "
              "PyTorch path)", file=sys.stderr)
        return 2
    if args.devices < 0:
        print(f"error: --devices {args.devices} is negative", file=sys.stderr)
        return 2
    if not args.devices:
        _render(args, device)
        return 0
    if device.index is not None:
        print(f"error: --devices {args.devices} takes cuda:0 .. cuda:{args.devices - 1}, "
              f"one a rank; --device {args.device} names one card (give --device cuda)",
              file=sys.stderr)
        return 2
    if device.type == "cuda" and args.devices > torch.cuda.device_count():
        print(f"error: --devices {args.devices}, but this host has "
              f"{torch.cuda.device_count()} CUDA device(s)", file=sys.stderr)
        return 2
    if device.type == "cuda":
        # once here, not by each rank at once on a fresh checkout; a
        # failed build raises with nvcc's message
        from raytracer_tpu_torch.utils import kernels

        kernels.build()
    import torch.multiprocessing as mp

    try:
        mp.start_processes(_rank_main, args=(args, _free_port()), nprocs=args.devices,
                           start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:  # a rank failed
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
