"""A cell on several cards (rtbench/ranks.py) driven end to end on the CPU:
four gloo ranks spawned as run.py spawns them, each through the port's
init_multihost / make_render_mesh / train_steps_sharded, at 32x24 on the
demo scene (the terrain's plain path takes minutes a run on the CPU) with
tiles of 192 rays, so that each rank walks one of the four.  A sound run
comes out correct with every rank's accumulator equal; each planted fault
comes out not correct; the run ends within its deadline when a rank fails;
run.py exits 2 without the cards; and the multi-card readers read made-up
per-rank summaries."""

import json
import time

import pytest

from rtbench import core, ranks, spawn

CELL = "terrain11k-dp4.progressive"
CHIPS = 4


def small_config():
    cfg = core.config(core.cell(core.benchmark_json(), CELL)["config"])
    cfg.update(scene="demo", bvh="auto")
    cfg["render"].update(width=32, height=24, tile_rays=192)
    return cfg


def run_ranks(seed=2**31 + 17, fault=None, trace=False, deadline_s=600):
    spec = dict(workload=CELL, seed=seed, seconds=0.2, trace=trace, t0=time.time(),
                device="cpu", config=small_config(), fault=fault)
    return spawn.run_cell(spec, CHIPS, deadline_s)


def test_the_cell_is_dp4_over_terrain11k():
    mesh = core.config("terrain11k-dp4")
    one = core.config("terrain11k")
    assert mesh["mesh"] == {"dp": 4, "sp": 1}
    assert all(mesh[k] == one[k] for k in ("scene", "bvh", "render", "dtype"))
    lim, lim_one = core.limits(CELL), core.limits("terrain11k.progressive")
    assert lim == dict(lim_one, rank_accum_diff={"limit": 0.0})


def test_sound_run_on_four_ranks_is_correct():
    line = run_ranks()
    assert line["correct"], line["checks"]
    assert line["checks"]["rank_accum_diff"]["value"] == 0.0
    assert line["device"]["count"] == CHIPS
    assert set(line["metrics"]) == {"setup_s", "epoch_ms"}
    assert line["attempted"] >= 10 and line["metrics"]["setup_s"]["value"] > 0
    assert list(line)[-1] == "checks"


def test_traced_run_on_four_ranks_reads_rank_0():
    line = run_ranks(seed=2**31 + 4099, trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] == core.traffic("progressive")["trace_units"]
    for name in ("epoch_host_ms", "epoch_draws_ms", "scene_build_s"):
        assert line["metrics"][name]["value"] > 0, name
    # the CPU's profiler records no device activity: nothing for the
    # multi-card readers, whose numbers come from the card's timeline
    assert "allreduce_ms" not in line["metrics"] and "rank_busy_ratio" not in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "no_exchange"])
def test_planted_fault_on_four_ranks_is_not_correct(fault):
    line = run_ranks(fault=fault)
    assert not line["correct"], line["checks"]


def test_a_drifting_rank_fails_rank_accum_diff_alone():
    line = run_ranks(fault="accum_drift")
    over = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert over == ["rank_accum_diff"], line["checks"]


def test_no_exchange_leaves_rank_0_its_own_tiles():
    checks = run_ranks(fault="no_exchange")["checks"]
    assert checks["photon_bad_share"]["value"] > 0.5  # three quarters of the frame unwalked
    assert checks["rank_accum_diff"]["value"] > 0


def raise_on_rank_2(rank, ready, out):
    if rank == 0:
        ready.set()
    ready.wait()
    if rank == 2:
        raise RuntimeError("rank 2 fails")
    time.sleep(600)


def hang(rank, ready, out):
    time.sleep(600)


def hand_back(rank, ready, out):
    if rank == 0:
        ready.set()
    ready.wait()
    out.put(f"rank {rank}")


def _ended(group, deadline_s):
    try:
        return group.wait(deadline_s)
    finally:
        group.stop()
        assert not any(p.is_alive() for p in group.procs)


def test_a_failing_rank_ends_the_run():
    group = spawn.Ranks("test_rtbench_ranks:raise_on_rank_2", (), CHIPS)
    with pytest.raises(spawn.Failed, match="rank 2 exited with code 1"):
        _ended(group, 120)


def test_the_deadline_ends_hanging_ranks():
    t = time.monotonic()
    with pytest.raises(spawn.Failed, match="did not end within 15 s"):
        _ended(spawn.Ranks("test_rtbench_ranks:hang", (), 2), 15)
    assert time.monotonic() - t < 45


def test_ranks_hand_back_what_they_put():
    got = sorted(_ended(spawn.Ranks("test_rtbench_ranks:hand_back", (), CHIPS), 60))
    assert got == [f"rank {r}" for r in range(CHIPS)]


def test_run_exits_2_without_the_cards(capfd):
    """Here, with no card, the four-card cell's rank 0 exits 2 before any
    rank joins the group, and so does the run; so does a one-card cell."""
    import run as runmod

    for cell in (CELL, "terrain11k.progressive"):
        assert runmod.main(["--workload", cell, "--seed", "7", "--seconds", "1"]) == 2
    out, err = capfd.readouterr()
    assert out == "" and "needs 4 CUDA card(s); found 0" in err


def test_rank_0_counts_the_cards(monkeypatch):
    import multiprocessing

    import torch

    from rtbench import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: CHIPS - 1)
    spec = runner.Spec(workload=CELL, seed=7, seconds=1, trace=False, t0=time.time())
    ready = multiprocessing.get_context("spawn").Event()
    with pytest.raises(SystemExit) as e:
        ranks.start(0, ready, spec, CHIPS, spawn.free_port())
    assert e.value.code == 2 and not ready.is_set()


def test_calibrate_on_four_ranks(capfd):
    import calibrate

    calibrate.on_ranks(CELL, [2**31 + 3], 1, CHIPS, device="cpu", config=small_config())
    got = [json.loads(x) for x in capfd.readouterr().out.splitlines() if x.startswith("{")]
    assert [g["kind"] for g in got] == ["program", "control"]
    lim = core.limits(CELL)
    program, control = got
    assert all(program[k] <= lim[k]["limit"] for k in lim), program
    assert any(control[k] > lim[k]["limit"] for k in lim if k in control), control


def _summary(mc_us=240_000.0, nccl_us=10_500.0, busy_s=0.4):
    return {"window_s": 0.5, "busy_s": busy_s, "device_ops": 900,
            "op_us": {"void rt::mc_kernel<rt::CoopGeom, rt::NoWork>(...)": mc_us,
                      "ncclDevKernel_AllReduce_Sum_f32_RING_LL(...)": nccl_us * 6 / 7,
                      "ncclDevKernel_AllReduce_Sum_i64_RING_LL(...)": nccl_us / 7,
                      "Memcpy DtoH": 3_000.0}}


def _ctx(ranks_=None, summary=None):
    return {"entry": "progressive", "units": 30, "trace": summary or _summary(),
            "ranks": ranks_}


def _rank(rank, mc_ms, nccl_ms, busy_s):
    return {"rank": rank, "peak": 1, "found": [], "device": {},
            "trace": _summary(mc_ms * 1e3, nccl_ms * 1e3, busy_s)}


def test_multi_card_readers_on_made_up_ranks():
    read = lambda name, c: core.metric_reader(name).read(c)
    # rank 0 (the run's own trace) the least loaded, waiting longest in NCCL;
    # rank 2 the slowest, its NCCL kernels the collective's own time
    four = [_rank(0, 240.0, 90.0, 0.34), _rank(1, 290.0, 40.0, 0.36),
            _rank(2, 330.0, 6.0, 0.37), _rank(3, 250.0, 80.0, 0.35)]
    ctx = _ctx(four, four[0]["trace"])
    assert read("allreduce_ms", ctx) == pytest.approx(6.0 / 30)  # both NCCL kernels
    assert read("rank_busy_ratio", ctx) == pytest.approx(333.0 / 243.0)
    # the progressive readers read the rank that paces the epoch, rank 2
    assert read("mc_kernel_ms", ctx) == pytest.approx(330.0 / 30)
    assert read("step_other_ms", ctx) == pytest.approx(9.0 / 30)
    assert read("idle_pct.epoch", ctx) == pytest.approx(100 * (1 - 0.37 / 0.5))
    # one card: no ranks; the progressive readers read the run's own trace
    assert read("allreduce_ms", _ctx()) is None and read("rank_busy_ratio", _ctx()) is None
    assert read("mc_kernel_ms", _ctx()) == pytest.approx(8.0)
    assert read("idle_pct.epoch", _ctx()) == pytest.approx(20.0)
    # untraced ranks, a window with no NCCL kernel, or a rank without device time
    assert read("rank_busy_ratio", _ctx([dict(r, trace=None) for r in four])) is None
    assert read("allreduce_ms", _ctx([_rank(r, 240.0, 0.0, 0.3) for r in range(4)])) is None
    assert read("rank_busy_ratio", _ctx(four[:1])) is None
    idle = dict(_rank(1, 0.0, 0.0, 0.0), trace=dict(_summary(), op_us={}))
    assert read("rank_busy_ratio", _ctx([four[0], idle])) is None
    assert read("allreduce_ms", dict(ctx, entry="whitted")) is None


def test_gather_carries_each_ranks_trace():
    """World.gather, on one gloo rank: the trace's busy time, window and
    operations, which readings.own_ms splits from NCCL's."""
    import torch
    import torch.distributed as dist

    from rtbench import readings

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spawn.free_port()}",
                            world_size=1, rank=0)
    try:
        world = ranks.World(0, 1, torch.device("cpu"), None)
        got = world.gather(123, dict(_summary(), top_ops=[], idle_gaps=[], units=[]))
    finally:
        dist.destroy_process_group()
    assert got[0]["trace"] == {k: _summary()[k] for k in ("busy_s", "window_s", "op_us")}
    assert readings.device_ms(got[0]["trace"], readings.NCCL_KERNELS) == pytest.approx(10.5)
    assert readings.own_ms(got[0]["trace"]) == pytest.approx(243.0)
    assert got[0]["peak"] == 123


def load_jax_in_the_readers(spec, world, out):
    """ranks.cell with a per-layer reader that loads a module named jax on
    rank 0, after the window (rtbench/result.per_layer)."""
    import sys
    import types

    from rtbench import result

    line = result.result_line

    def loading(*a, **kw):
        sys.modules["jax"] = types.ModuleType("jax")
        return line(*a, **kw)
    result.result_line = loading
    ranks.cell(spec, world, out)


def test_a_module_loaded_by_the_readers_exits_3(capfd):
    spec = dict(workload=CELL, seed=2**31 + 29, seconds=0.2, trace=True, t0=time.time(),
                device="cpu", config=small_config())
    with pytest.raises(spawn.Failed) as e:
        spawn.on_ranks(spec, CHIPS, 600, "test_rtbench_ranks:load_jax_in_the_readers")
    assert e.value.code == 3
    assert "forbidden modules loaded: ['jax']" in capfd.readouterr().err
