"""raytracer_tpu_torch/bench.py and scripts/bench_torch_mesh.py, the port's
benchmark harness, on the CPU at a small spec: the regression gate
(tests/test_bench_gate.py's cases, by the METRICS table), the refusal of a
prior from another device, the line's keys against the JAX bench's, the
casts it times against render_step / render_epochs / render_steps at the
same seeds, and the exits without CUDA.  No JAX program is compiled."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess

import pytest
import torch

from raytracer_tpu_torch import bench
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import (
    render_distributed_epoch,
    render_epochs,
    render_step,
    render_steps,
    render_whitted,
)
from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene, mesh_scene

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = bench.BenchSpec(width=32, height=24, depth=3, tile_rays=256, reps=2, batched_epochs=2,
                        steps=2, meshes=((4, 1),), schedule_width=32, schedule_height=24,
                        schedule_epochs=3, device="cpu")
CPU = {"platform": "cpu", "name": "cpu", "power_limit": None, "count": 1}
# the JAX bench's last round on a TPU, its line under "parsed"
JAX_LINE = os.path.join(ROOT, "BENCH_r05.json")


def _mesh_script():
    spec = importlib.util.spec_from_file_location(
        "bench_torch_mesh", os.path.join(ROOT, "scripts", "bench_torch_mesh.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.fixture(scope="module")
def small_run():
    return bench.run(SMALL)


def _numeric(line):
    return [k for k, v in line.items() if isinstance(v, (int, float)) and not isinstance(v, bool)]


@pytest.mark.parametrize("case", [
    # (metric, prev, now, flagged)
    ("mesh51k_mc_epoch_seconds", 1.0, 1.2, True),         # 20 % slower
    ("roofline_frac", 0.10, 0.085, True),                  # 15 % lower
    ("value", 100.0, 120.0, False),                        # faster
    ("whitted_mc_step_mrays_per_sec", 90.0, 89.0, False),  # 1 % lower
    ("full_schedule_seconds", 10.0, 10.9, False),          # 9 % slower
    ("mesh11k_tris", 11262, 20000, False),                 # a descriptor
    (None, None, None, False),                             # no prior
], ids=["seconds_up_20", "rate_down_15", "rate_up", "rate_down_1", "seconds_up_9",
        "descriptor", "no_prior"])
def test_gate_flags_by_the_direction_table(tmp_path, case):
    """Seconds flag when they grow, rates when they fall, by more than 10 %
    (tests/test_bench_gate.py:21-51, by METRICS in place of key substrings);
    no prior gives {}."""
    key, old, now, flagged = case
    if key is None:
        assert bench.prior_round_deltas({"value": 1.0, "device": CPU}, None) == {}
        return
    f = tmp_path / "prev.json"
    f.write_text(json.dumps({"device": CPU, key: old}))
    out = bench.prior_round_deltas({"device": CPU, key: now}, str(f))
    assert out["prev_round_file"] == "prev.json" and "prev_round_error" not in out
    assert set(out["regressions"]) == ({key} if flagged else set())
    if flagged:
        assert out["regressions"][key]["worse_pct"] == pytest.approx(
            abs(now - old) / old * 100.0, abs=0.05)


def _jax_bench():
    """The JAX package's bench.py, loaded as tests/test_bench_gate.py does."""
    spec = importlib.util.spec_from_file_location("bench", os.path.join(ROOT, "bench.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


# A line of scripts/bench_mesh.py's keys for both of its grids.
JAX_MESH_LINE = {"mesh11k_whitted_seconds": 0.05, "mesh11k_whitted_mrays": 120.0,
                 "mesh11k_mc_epoch_seconds": 0.035, "mesh11k_mc_mrays": 280.0,
                 "mesh11k_tris": 11262, "mesh51k_whitted_seconds": 0.07,
                 "mesh51k_whitted_mrays": 85.0, "mesh51k_mc_epoch_seconds": 0.047,
                 "mesh51k_mc_mrays": 210.0, "mesh51k_tris": 51212}
# Keys the JAX gate's substring rule compares and METRICS does not:
# vs_baseline (dropped from the line) and the roofline's bound (a descriptor).
NOT_COMPARED = {"vs_baseline", "roofline_attainable_mrays"}


@pytest.mark.parametrize("factor", [1.2, 0.8], ids=["up_20", "down_20"])
@pytest.mark.parametrize("line", ["bench", "bench_mesh"])
def test_gate_flags_what_the_jax_gate_flags(tmp_path, monkeypatch, line, factor):
    """Every numeric key of the JAX bench's last line (BENCH_r05.json) and of
    a scripts/bench_mesh.py line, moved 20 % up or down with the same device
    on both sides: the port's gate flags exactly what the JAX gate
    (bench.py _prior_round_deltas) flags, less NOT_COMPARED, with the same
    numbers; the two lines between them name every METRICS entry."""
    card = {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
            "count": 1}
    if line == "bench":
        with open(JAX_LINE) as f:
            prior = json.load(f)["parsed"]
        prior = {k: v for k, v in prior.items() if k not in ("prev_round_file", "regressions")}
    else:
        prior = JAX_MESH_LINE
    prev = dict(prior, device=card)
    now = {k: v * factor if k in _numeric(prev) else v for k, v in prev.items()}
    (tmp_path / "BENCH_r99.json").write_text(json.dumps({"parsed": prev}))
    jax_bench = _jax_bench()
    with monkeypatch.context() as mp:
        mp.setattr(jax_bench.os.path, "dirname", lambda p: str(tmp_path))
        want = jax_bench._prior_round_deltas(now)
    assert want["prev_round_file"] == "BENCH_r99.json"
    got = bench.prior_round_deltas(now, str(tmp_path / "BENCH_r99.json"))
    assert "prev_round_error" not in got and got["regressions"]
    assert got["regressions"] == {k: v for k, v in want["regressions"].items()
                                  if k not in NOT_COMPARED}
    better = "lower" if factor > 1 else "higher"
    assert set(got["regressions"]) == {k for k in _numeric(now)
                                       if getattr(bench.METRICS.get(bench.metric_name(k)),
                                                  "better", None) == better}
    with open(JAX_LINE) as f:
        named = {bench.metric_name(k) for k in [*json.load(f)["parsed"], *JAX_MESH_LINE]}
    assert set(bench.METRICS) <= named


def test_device_info_asks_nvidia_smi_for_the_card_by_uuid(monkeypatch):
    """nvidia-smi numbers cards in its own order: the query names the card
    CUDA runs on by its UUID."""
    calls = []

    class Props:
        uuid = "6b5a1f0e-0000-4000-8000-000000000001"

    def smi(argv, **kw):
        calls.append(argv)
        return subprocess.CompletedProcess(argv, 0, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(bench.subprocess, "run", smi)
    info = bench.device_info("cuda:2")
    assert calls == [["nvidia-smi", "--id=GPU-6b5a1f0e-0000-4000-8000-000000000001",
                      "--query-gpu=name,power.limit", "--format=csv,noheader"]]
    assert info == {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3",
                    "power_limit": "700.00 W", "count": 4}


@pytest.mark.parametrize("prior", ["tpu_bench", "other_card", "same_card"])
def test_gate_compares_only_a_prior_of_the_same_card(tmp_path, prior):
    """The JAX bench's BENCH_r05.json (a TPU's) and a line of another card
    (its power limit) give prev_round_error and flag nothing; a line of the
    same card is compared."""
    card = {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
            "count": 1}
    now = {"device": card, "value": 50.0, "frame_seconds": 0.5}
    if prior == "tpu_bench":
        path = JAX_LINE
    else:
        line = {"device": dict(card, power_limit="500.00 W") if prior == "other_card" else card,
                "value": 100.0, "frame_seconds": 0.1}
        path = str(tmp_path / "prev.json")
        with open(path, "w") as f:
            json.dump(line, f)
    out = bench.prior_round_deltas(now, path)
    assert out["prev_round_file"] == os.path.basename(path)
    if prior == "same_card":
        assert "prev_round_error" not in out
        assert set(out["regressions"]) == {"value", "frame_seconds"}
    else:
        assert "not compared" in out["prev_round_error"] and out["regressions"] == {}


def test_line_has_the_jax_keys_and_every_number_a_direction(small_run):
    result, _ = small_run
    with open(JAX_LINE) as f:
        jax_line = json.load(f)["parsed"]
    # less vs_baseline (against a TPU target) and the gate's keys, plus two
    want = set(jax_line) - {"vs_baseline", "prev_round_file", "regressions"} | {"device",
                                                                              "png_writer"}
    assert {bench.metric_name(k) for k in result} == {bench.metric_name(k) for k in want}
    assert "vs_baseline" not in result and result["device"] == CPU
    assert result["png_writer"] in ("native", "python")
    named = [k for k in _numeric(result)
             if bench.metric_name(k) in bench.METRICS or bench.metric_name(k) in bench.DESCRIPTORS]
    assert named == _numeric(result)
    assert not set(bench.METRICS) & set(bench.DESCRIPTORS)
    assert {m.better for m in bench.METRICS.values()} == {"higher", "lower"}
    # every numeric key of the JAX bench's line, less vs_baseline, is named too
    assert all(bench.metric_name(k) in bench.METRICS or bench.metric_name(k) in bench.DESCRIPTORS
               for k in _numeric(jax_line) if k != "vs_baseline")


def test_small_run_times_the_casts_of_the_render_calls(small_run):
    """What the harness divides by its seconds is what render_step /
    render_epochs / render_steps / render_whitted count at the same seeds."""
    result, record = small_run
    scene, cam = demo_scene(device="cpu"), demo_camera(device="cpu")
    cfg = RenderConfig(width=32, height=24, depth=3, tile_rays=256)
    _, w = render_whitted(scene, cam, cfg)
    _, e = render_distributed_epoch(scene, cam, cfg, 0)
    assert record["warmup"][0]["casts"] == w["casts"] and w["dropped"] == 0
    assert record["warmup"][1]["casts"] == e["casts"]
    for r, rep in enumerate(record["step"]):
        assert rep["seed"] == r and rep["casts"] == render_step(scene, cam, cfg, r)[2]["casts"]
    for r, rep in enumerate(record["batched"]):
        assert rep["seed"] == 100 + r
        assert rep["casts"] == render_epochs(scene, cam, cfg, 100 + r, 2)[1]["casts"]
    for r, rep in enumerate(record["steps"]):
        assert rep["seed"] == 200 + r
        assert rep["casts"] == render_steps(scene, cam, cfg, 200 + r, 2)[2]["casts"]
    best_step = min(record["step"], key=lambda x: x["seconds"])
    assert result["rays_per_frame"] == best_step["casts"]
    assert result["frame_seconds"] == best_step["seconds"]
    best = max(record["batched"], key=lambda x: x["mrays_per_sec"])
    assert best["mrays_per_sec"] == best["casts"] / best["seconds"] / 1e6
    assert result["value"] == best["mrays_per_sec"]
    assert result["batched_seconds_per_epoch"] == best["seconds"] / 2
    m_scene, m_cam = mesh_scene(4, device="cpu")
    tag = bench.mesh_tag(m_scene)
    _, mw = render_whitted(m_scene, m_cam, cfg)
    assert [f["casts"] for f in record[tag]["frames"]] == [mw["casts"]]
    assert record[tag]["epochs"][0]["casts"] == render_distributed_epoch(
        m_scene, m_cam, cfg, 200)[1]["casts"]
    assert result[f"{tag}_tris"] == m_scene.n_tri and result["full_schedule_epochs"] == 3


def test_mesh_script_on_mesh24():
    m = _mesh_script()
    out, record = m.run([24], 1, 2, 24, False, "cpu")
    scene, cam = mesh_scene(24, device="cpu")
    cfg = RenderConfig(width=24, height=24, depth=2)
    assert set(out) == {"device", "mesh1k_whitted_seconds", "mesh1k_whitted_mrays",
                        "mesh1k_mc_epoch_seconds", "mesh1k_mc_mrays", "mesh1k_tris"}
    assert out["device"] == CPU and out["mesh1k_tris"] == 1164
    frame, epoch = record["mesh1k"]["frames"][0], record["mesh1k"]["epochs"][0]
    assert frame["casts"] == render_whitted(scene, cam, cfg)[1]["casts"]
    assert epoch["casts"] == render_distributed_epoch(scene, cam, cfg, m.SEED)[1]["casts"]
    assert out["mesh1k_mc_mrays"] == epoch["casts"] / epoch["seconds"] / 1e6
    assert all(bench.metric_name(k) in bench.METRICS or bench.metric_name(k) in bench.DESCRIPTORS
               for k in _numeric(out))
    mc_only, _ = m.run([24], 1, 2, 24, True, "cpu")
    assert set(mc_only) == {"device", "mesh1k_mc_epoch_seconds", "mesh1k_mc_mrays", "mesh1k_tris"}


@pytest.mark.parametrize("entry", ["bench", "bench_torch_mesh"])
def test_main_without_cuda_exits_nonzero_and_prints_no_line(entry, monkeypatch):
    """Without a card and without --device cpu neither harness runs on the
    CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = bench.main if entry == "bench" else _mesh_script().main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([])
    assert rc != 0 and "{" not in out.getvalue()
    assert "CUDA is not available" in err.getvalue()


def test_main_on_the_cpu_prints_the_line_with_the_gate(tmp_path, monkeypatch, capsys):
    """--device cpu with a small spec, RAYTPU_BENCH_FAST set (no meshes, no
    schedule) and --prev a prior of the same device: the last line is the
    result with the gate's keys."""
    monkeypatch.setenv("RAYTPU_BENCH_FAST", "1")
    prev = tmp_path / "prev.json"
    prev.write_text(json.dumps({"device": CPU, "frame_seconds": 1e-9, "value": 1e9}))
    spec = dataclasses.replace(SMALL, device="cuda", reps=1)
    assert bench.main(["--device", "cpu", "--prev", str(prev)], spec) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == CPU and line["prev_round_file"] == "prev.json"
    assert set(line["regressions"]) == {"frame_seconds", "value"}
    assert not any(k.startswith("mesh") or k.startswith("full_schedule") for k in line)
