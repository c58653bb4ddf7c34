"""raytracer_tpu_torch's CLI in subprocesses on the CPU (--device cpu, tiny
frames): the flags added beside tests/test_cli.py's — --scene-file,
--retries, --warm-cache, --profile, --debug-nans — and the parser's flag
set against the JAX package's."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu.cli import build_parser as jax_parser
from raytracer_tpu_torch.cli import build_parser
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.utils.png import read_png_rgb8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--width", "12", "--height", "8", "--depth", "1", "--tile-rays", "96",
         "--device", "cpu"]


def _run(args, **env):
    return subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", *SMALL, *args], cwd=REPO,
        env=dict(os.environ, RAYTPU_RETRY_DELAY="0", OMP_NUM_THREADS="1", **env),
        capture_output=True, text=True, timeout=300)


def _flags(parser):
    return {o for a in parser._actions for o in a.option_strings if o.startswith("--")}


def test_parser_has_the_jax_flags_but_devices():
    """Every flag of the JAX CLI, --devices too; --device is the port's own."""
    assert _flags(jax_parser()) - _flags(build_parser()) == set()
    assert _flags(build_parser()) - _flags(jax_parser()) == {"--device"}


def test_scene_file(tmp_path):
    out = str(tmp_path / "file.png")
    r = _run(["--scene-file", os.path.join(REPO, "assets", "scene_spheres.json"),
              "--epochs", "1", "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    img = read_png_rgb8(out)
    assert img.shape == (8, 12, 3) and img.sum() > 0


def test_retries_resume_after_a_transient_failure(tmp_path):
    out = str(tmp_path / "sup.png")
    tok = str(tmp_path / "fail.token")
    r = _run(["--epochs", "2", "--out", out, "--retries", "2"], RAYTPU_TEST_FAIL_TOKEN=tok)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert os.path.exists(tok)  # the injected failure fired
    assert "supervisor: attempt 1 failed" in r.stdout
    assert "resumed at epoch 0" in r.stdout
    assert not os.path.exists(out + ".ckpt.npz")  # the auto checkpoint is removed
    img = read_png_rgb8(out)
    assert img.shape == (8, 12, 3) and img.sum() > 0


def test_retries_give_up_after_two_failures_without_progress(tmp_path):
    out = str(tmp_path / "det.png")
    r = _run(["--epochs", "2", "--out", out, "--retries", "5"], RAYTPU_TEST_FAIL_ALWAYS="1")
    assert r.returncode not in (0, 2), r.stdout[-2000:]
    assert "deterministic error, giving up" in r.stdout
    assert "supervisor: attempt 1 failed" in r.stdout
    assert "supervisor: attempt 2 failed" not in r.stdout


def test_retries_do_not_retry_rc_2(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the child's rc 2 here is 'CUDA is not available'")
    r = _run(["--epochs", "1", "--out", str(tmp_path / "x.png"), "--retries", "3",
              "--device", "cuda"])
    assert r.returncode == 2 and "CUDA is not available" in r.stderr, r.stderr[-2000:]
    assert "relaunching" not in r.stdout


def test_warm_cache_writes_no_output(tmp_path):
    out = str(tmp_path / "never.png")
    r = _run(["--epochs", "5", "--png-every", "2", "--out", out, "--warm-cache"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "warm-cache: kernel library nothing to build on the CPU" in r.stdout
    assert "group sizes [1, 2]" in r.stdout
    assert not os.path.exists(out)


def test_profile_writes_a_trace_and_prints_the_top_operations(tmp_path):
    prof = tmp_path / "prof"
    r = _run(["--epochs", "1", "--depth", "3", "--out", str(tmp_path / "p.png"),
              "--profile", str(prof)])
    assert r.returncode == 0, r.stderr[-2000:]
    with open(prof / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert "top 20 operations by self cpu time" in r.stdout
    assert "aten::" in r.stdout
    # the program's spans and counters (utils/tracing), after the operations
    spans = r.stdout.split("program spans by self host time")[1]
    for name in ("rt.whitted.frame", "rt.ladder.level", "rt.step.epoch", "rt.epoch.walk",
                 "rt.step.wait", "counter ladder.lanes", "counter ladder.live",
                 "counter tracing.sums", "counter tracing.reads"):
        assert name in spans, name
    with open(prof / "ops.json") as f:
        ops = {op["name"]: op for op in json.load(f)["ops"]}
    assert ops["rt.step.encode"]["device_us"] == 0 and ops["rt.step.encode"]["cpu_us"] > 0


def test_debug_nans(tmp_path):
    scene = {"objects": [{"material": {"diffuse_color": [float("nan"), 0.5, 0.5]},
                          "spheres": [{"center": [0, 0.5, 0], "radius": 1.0}]}],
             "lights": [{"type": "directional", "direction": [0, -1, 0],
                         "color": [1, 1, 1]}]}
    path = tmp_path / "nan.json"
    path.write_text(json.dumps(scene))  # json writes NaN, and reads it back
    out = str(tmp_path / "nan.png")
    r = _run(["--scene-file", str(path), "--epochs", "1", "--out", out])
    assert r.returncode == 0, r.stderr[-2000:]  # without the flag the NaN passes
    r = _run(["--scene-file", str(path), "--epochs", "1", "--out", out, "--debug-nans"])
    assert r.returncode == 1 and "FloatingPointError: non-finite value in the whitted " \
        "frame (epoch 0)" in r.stderr, r.stderr[-2000:]
    r = _run(["--epochs", "2", "--out", str(tmp_path / "demo.png"), "--debug-nans"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert np.asarray(read_png_rgb8(str(tmp_path / "demo.png"))).sum() > 0


def test_devices_2_on_the_cpu_writes_the_emulated_png(tmp_path):
    """Two gloo ranks render a (1, 2) mesh; rank 0 prints the mesh and writes
    the PNG, which equals byte for byte the PNG of the mesh's rank bodies
    run one after another here: the Whitted frame's tile on rank 0, then
    each epoch's samples 0 and 1 summed and renormalised."""
    out = str(tmp_path / "mesh.png")
    r = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "--device", "cpu", "--devices", "2",
         "--width", "64", "--height", "48", "--epochs", "2", "--png-every", "2",
         "--tile-rays", "768", "--out", out],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert r.stdout.count("mesh: {'dp': 1, 'sp': 2}") == 1
    assert r.stdout.count("rays in") == 2  # rank 0's Whitted line and one group's

    from raytracer_tpu_torch.ops.tonemap import post_process
    from raytracer_tpu_torch.parallel.mesh import RenderMesh, epoch_body, whitted_body
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene
    from raytracer_tpu_torch.utils.color import linear_to_u8
    from raytracer_tpu_torch.utils.png import write_png_atomic

    torch.set_num_threads(1)
    scene, cam = demo_scene(device="cpu"), demo_camera(device="cpu")
    cfg = RenderConfig(width=64, height=48, depth=5, epochs=2, tile_rays=768)
    ranks = [RenderMesh(dp=1, sp=2, rank=i) for i in range(2)]
    img = whitted_body(scene, cam, cfg, ranks[0])[0] + whitted_body(scene, cam, cfg, ranks[1])[0]
    accum = post_process(img)
    for epoch in range(2):
        a, b = (epoch_body(scene, cam, cfg, m, 0, epoch)[0] for m in ranks)
        accum = post_process(accum + (a + b))
    emulated = str(tmp_path / "emulated.png")
    write_png_atomic(emulated, linear_to_u8(accum).numpy())
    with open(out, "rb") as f, open(emulated, "rb") as g:
        assert f.read() == g.read()


def test_devices_beyond_the_hosts_cards_fail_before_any_spawn(monkeypatch, capsys):
    """--devices N with fewer than N cards, or N < 0: rc 2 and no process
    started."""
    from raytracer_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        lambda *a, **k: pytest.fail("spawned"))
    assert cli.main(["--devices", "2"]) == 2
    assert "--devices 2, but this host has 1 CUDA device(s)" in capsys.readouterr().err
    assert cli.main(["--devices", "-1", "--device", "cpu"]) == 2


def test_devices_with_a_card_index_fail_before_any_spawn(monkeypatch, capsys):
    """--devices N deals cuda:0 .. cuda:N-1 to its ranks, so a --device
    that names one card is refused (rc 2) rather than ignored."""
    from raytracer_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        lambda *a, **k: pytest.fail("spawned"))
    assert cli.main(["--devices", "1", "--device", "cuda:1"]) == 2
    assert "--device cuda:1 names one card" in capsys.readouterr().err


@pytest.mark.parametrize("device, nvcc, events", [
    ("cuda", None, ["build", ("spawn", 4)]),
    ("cpu", None, [("spawn", 4)]),
    ("cuda", "nvcc failed: level_kernel.cu (1)", ["build"])])
def test_devices_builds_the_kernels_once_before_the_spawn(monkeypatch, device, nvcc, events):
    """--devices N on cards builds the kernel library once, in the parent,
    before any rank starts (not once a rank); on the CPU nothing is built;
    a failed build raises nvcc's message and starts no rank."""
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.utils import kernels

    seen = []

    def build(verbose=False):
        seen.append("build")
        if nvcc:
            raise RuntimeError(nvcc)
        return "libraytracer_kernels.so", 0.0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(torch.multiprocessing, "start_processes",
                        lambda *a, **k: seen.append(("spawn", k["nprocs"])))
    if nvcc:
        with pytest.raises(RuntimeError, match=re.escape(nvcc)):
            cli.main(["--devices", "4", "--device", device])
    else:
        assert cli.main(["--devices", "4", "--device", device]) == 0
    assert seen == events
