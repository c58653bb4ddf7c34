"""raytracer_tpu_torch's CLI in subprocesses on the CPU (--device cpu, tiny
frames): the flags added beside tests/test_cli.py's — --scene-file,
--retries, --warm-cache, --profile, --debug-nans — and the parser's flag
set against the JAX package's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu.cli import build_parser as jax_parser
from raytracer_tpu_torch.cli import build_parser
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
    assert _flags(jax_parser()) - _flags(build_parser()) == {"--devices"}
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
    r = _run(["--epochs", "1", "--out", str(tmp_path / "p.png"), "--profile", str(prof)])
    assert r.returncode == 0, r.stderr[-2000:]
    with open(prof / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert "top 20 operations by self cpu time" in r.stdout
    assert "aten::" in r.stdout


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
