"""The `cli` entry (rtbench/entries/cli.py) for the queued cell `demo.cli`,
and the reader of the sphereflake cell, on the CPU.  `demo.cli` is not in
BENCHMARK.json (its spread was too wide to admit it, PERF.md §7); the tests
hand the harness the cell as it was measured.  At 32x24 with 12 epochs a
schedule: a sound run is correct and records its PNG writer's spans; a PNG
that is not the frame, a walk that alters its photons, and the control come
out not correct."""

import time

import pytest

from rtbench import core, program_spans, runner

SMALL = {"width": 32, "height": 24, "epochs": 12}
CELL = {"name": "demo.cli", "config": "demo", "traffic": "cli", "chips": 1,
        "why": "the CLI's default schedule, a PNG every epoch"}


@pytest.fixture(autouse=True)
def with_the_cell(monkeypatch):
    bench = core.benchmark_json()
    bench["workloads"].append(CELL)
    monkeypatch.setattr(core, "benchmark_json", lambda: bench)


def _config():
    cfg = core.config("demo")
    cfg["render"].update(SMALL)
    return cfg


def _run(seed=5, trace=False, fault=None):
    spec = runner.Spec(workload="demo.cli", seed=seed, seconds=0.2, trace=trace,
                       t0=time.time(), device="cpu", config=_config(), fault=fault)
    return runner.run_cell(spec)


def test_a_sound_run_is_correct_and_counts_whole_schedules():
    rec = _run()
    assert rec["correct"], rec["checks"]
    assert set(rec["checks"]) == {"photon_bad_share", "accum_rel_err", "u8_bad_share",
                                  "png_bad_share"}
    assert rec["win"]["units"] % SMALL["epochs"] == 0 and rec["win"]["units"] >= 12
    assert rec["e2e"]["epoch_ms"] > 0


def test_a_traced_run_records_the_writers_spans():
    rec = _run(seed=7, trace=True)
    assert rec["correct"], rec["checks"]
    assert rec["win"]["units"] == SMALL["epochs"]  # trace_units: one schedule
    ctx = {}
    assert program_spans.per_unit_ms(ctx, "rt.png.write", "rt.step.epoch") > 0
    jobs = [s for s in program_spans.record(ctx).spans if s.name == "rt.png.job"]
    assert [s.unit for s in jobs] == list(range(1, SMALL["epochs"] + 1))


def test_a_png_that_is_not_the_frame_fails(monkeypatch):
    from raytracer_tpu_torch.parallel import progressive

    real = progressive.write_png_atomic

    def flipped(path, rgb):
        real(path, 255 - rgb)

    monkeypatch.setattr(progressive, "write_png_atomic", flipped)
    rec = _run()
    assert not rec["correct"]
    assert rec["checks"]["png_bad_share"]["value"] > 0.5


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_a_planted_fault_fails(fault):
    assert not _run(fault=fault)["correct"]


def test_the_control_fails():
    import calibrate

    got = {r["kind"]: r for r in calibrate.readings("demo.cli", [3], 1, device="cpu",
                                                     config=_config(), frames=1)}
    for kind, want in (("program", True), ("control", False)):
        numbers = {k: v for k, v in got[kind].items() if k not in ("seed", "kind")}
        assert core.judge(numbers, core.limits("demo.cli"))[0] is want, (kind, numbers)
    assert got["control"]["png_bad_share"] > 0


def test_sph_tests_per_cast_reads_the_counter_over_the_casts(monkeypatch):
    rec = {"spans": [], "counters": {"mc.sph_tests": 7000}}
    monkeypatch.setattr(program_spans, "record", lambda ctx: type("R", (), rec)())
    read = core.metric_reader("mc_sph_tests_per_cast").read
    assert read({"entry": "progressive", "casts": 2}) == 3500
    assert read({"entry": "progressive", "casts": 0}) is None
    assert read({"entry": "whitted", "casts": 2}) is None
    rec["counters"] = {}
    assert read({"entry": "progressive", "casts": 2}) is None  # a port that does not count
