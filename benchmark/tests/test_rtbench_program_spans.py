"""The readers of the port's own spans and counters (rtbench/program_spans.py
and benchmark/metrics/{ladder_*,epoch_*}.py) on small traced windows on the
CPU (the port's plain path, torch.profiler recording the host alone): each
reads a positive finite number in its own cells and nothing in the others,
and nothing from a port without utils/tracing."""

import math
import sys
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtbench import core, program_spans, result, runner, scenes

READERS = ("ladder_host_ms", "ladder_live_pct", "epoch_host_ms", "epoch_draws_ms")


def read_all(bench, rec, record, monkeypatch):
    """result.per_layer over the run with every per-layer reader asked, the
    port's record being `record`."""
    from raytracer_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "take", lambda: record)
    monkeypatch.setattr(core, "cell_metrics", lambda b, c, kind: b[kind])
    return result.per_layer(bench, rec)


def traced_run(cell):
    """One --trace 1 run of the cell at 32x24 on the CPU -> (bench, the
    run's record, the port's record of the window)."""
    from raytracer_tpu_torch.utils import tracing

    bench = core.benchmark_json()
    cfg = core.config(core.cell(bench, cell)["config"])
    cfg["render"].update(width=32, height=24)
    spec = runner.Spec(workload=cell, seed=2**31 + 4099, seconds=0.2, trace=True,
                       t0=time.time(), device="cpu", config=cfg)
    rec = runner.run_cell(spec)
    assert rec["correct"], rec["checks"]
    return bench, rec, tracing.take()


def check_cell(cell, got):
    for m in core.benchmark_json()["per_layer"]:
        if m["name"] not in READERS:
            continue
        if cell in m["workloads"]:
            value = got[m["name"]]["value"]
            assert math.isfinite(value) and value > 0, (m["name"], value)
        else:
            assert m["name"] not in got, (m["name"], got[m["name"]])


def test_preview_reads_the_ladders_spans_and_counters(monkeypatch):
    bench, rec, record = traced_run("demo.preview")
    got = read_all(bench, rec, record, monkeypatch)
    check_cell("demo.preview", got)
    assert got["ladder_live_pct"]["value"] <= 100.0
    # each frame's span lies inside the harness's mark of the frame, and
    # fills it but for the harness's own few lines
    units = rec["trace"]["units"]
    unit_ms = 1e3 * sum(u[0] for u in units) / len(units)
    ctx = {program_spans.KEY: record}
    frame_ms = program_spans.per_unit_ms(ctx, "rt.whitted.frame", "rt.whitted.frame")
    assert len([s for s in record.spans if s.name == "rt.whitted.frame"]) == len(units)
    assert 0.95 * unit_ms <= frame_ms <= unit_ms


def test_progressive_reads_the_epochs_spans(monkeypatch):
    bench, rec, record = traced_run("demo.progressive")
    got = read_all(bench, rec, record, monkeypatch)
    check_cell("demo.progressive", got)
    assert got["epoch_draws_ms"]["value"] < got["epoch_host_ms"]["value"]
    epochs = [s.unit for s in record.spans if s.name == "rt.step.epoch"]
    assert len(epochs) == rec["win"]["units"]
    # the epoch's span less the renormalise's read of its index, an epoch
    ctx = {program_spans.KEY: record}
    whole = program_spans.per_unit_ms(ctx, "rt.step.epoch", "rt.step.epoch")
    wait = program_spans.per_unit_ms(ctx, "rt.step.wait", "rt.step.epoch")
    assert 0 < wait < whole
    assert got["epoch_host_ms"]["value"] == pytest.approx(whole - wait)


def test_terrain_reads_the_epochs_spans():
    """The terrain's window at 8x8 (a whole harness run of it takes minutes
    on the CPU): two epochs of the step under the profiler."""
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.parallel.mesh import RenderMesh, train_steps_sharded
    from raytracer_tpu_torch.utils import tracing

    config = core.config("terrain11k")
    scene, camera = scenes.program_scene(scenes.load(config["scene"]), "cpu", use_bvh=True)
    cfg = RenderConfig(**dict(config["render"], width=8, height=8))
    accum = torch.zeros((8, 8, 3))
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        train_steps_sharded(scene, camera, cfg, RenderMesh(dp=1, sp=1), accum, 2**31 + 7, 2, 0)
    ctx = {"entry": "progressive", program_spans.KEY: tracing.take()}
    got = {}
    for name in READERS:
        value = core.metric_reader(name).read(ctx)
        if value is not None:
            got[name] = {"value": value}
    check_cell("terrain11k.progressive", got)


def test_a_port_without_tracing_reads_nothing(monkeypatch):
    from raytracer_tpu_torch import utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "raytracer_tpu_torch.utils.tracing", None)
    for entry in ("whitted", "progressive"):
        ctx = {"entry": entry}
        assert all(core.metric_reader(name).read(ctx) is None for name in READERS)
        assert ctx[program_spans.KEY] is None
