"""raytracer_tpu_torch.utils.tracing: the port's spans and counters, on the
CPU's plain path (the demo at 64x48, depth 5, three tiles of 1024 rays).

Off without a recording profiler (nothing recorded, no clock read, no span
made); under torch.profiler every span of the Whitted frame and of the
progressive step, with its parent and unit, inside its parent and beside a
Kineto twin on the same clock; the ladder's counters against a recount
from the pools' own masks; and every output bit for bit the same either
way."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu_torch import render
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import trace as ttrace
from raytracer_tpu_torch.ops.level_kernel import F_PEND, I_ALIVE, process_level
from raytracer_tpu_torch.parallel.mesh import RenderMesh, train_steps_sharded
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.utils import tracing

torch.set_num_threads(1)

CFG = RenderConfig(width=64, height=48, depth=5, tile_rays=1024)
N_TILES = 3
SEED, EPOCHS, START = 11, 2, 4

# span -> its parent's name (None: a unit)
PARENT = {
    "rt.whitted.frame": None,
    "rt.whitted.tile": "rt.whitted.frame",
    "rt.whitted.shoot": "rt.whitted.tile",
    "rt.ladder.level": "rt.whitted.tile",
    "rt.ladder.compact": "rt.whitted.tile",
    "rt.ladder.deliver": "rt.whitted.tile",
    "rt.whitted.assemble": "rt.whitted.frame",
    "rt.whitted.read": "rt.whitted.frame",
    "rt.step.epoch": None,
    "rt.epoch.draws": "rt.step.epoch",
    "rt.epoch.walk": "rt.step.epoch",
    "rt.epoch.assemble": "rt.step.epoch",
    "rt.step.renormalise": "rt.step.epoch",
    "rt.step.wait": "rt.step.renormalise",
    "rt.step.encode": None,
}


@pytest.fixture(scope="module")
def demo():
    return presets.demo_scene(device="cpu"), presets.demo_camera(device="cpu")


def _render(scene, camera):
    """A Whitted frame and a group of EPOCHS progressive epochs -> every
    output, the photons of each epoch included."""
    img, stats = render.render_whitted(scene, camera, CFG)
    photons = []
    accum = torch.zeros((CFG.height, CFG.width, 3))
    accum, u8, counters = train_steps_sharded(scene, camera, CFG, RenderMesh(dp=1, sp=1), accum,
                                              SEED, EPOCHS, START,
                                              lambda p, epoch: photons.append(p.clone()))
    return {"img": img, "stats": stats, "photons": photons, "accum": accum, "u8": u8,
            "counters": counters}


@pytest.fixture(scope="module")
def traced(demo):
    """(outputs, record, Kineto's host events) of one render under the profiler."""
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _render(*demo)
    rec = tracing.take()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("rt.")]
    return out, rec, events


def test_off_without_a_profiler(demo, monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("called with the profiler off")

    tracing.take()
    monkeypatch.setattr(tracing.time, "time_ns", forbidden)
    monkeypatch.setattr(tracing, "_Open", forbidden)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", forbidden)
    _render(*demo)
    assert not tracing.active()
    rec = tracing.take()
    assert rec.spans == [] and rec.counters == {}


def test_outputs_are_the_same_with_tracing_on(demo, traced):
    out, rec, _ = traced
    want = _render(*demo)
    assert rec.spans
    assert out["stats"] == want["stats"]
    for key in ("img", "accum", "u8", "counters"):
        assert torch.equal(out[key], want[key]), key
    assert len(out["photons"]) == EPOCHS
    assert all(torch.equal(a, b) for a, b in zip(out["photons"], want["photons"]))


def test_every_span_with_its_parent_and_unit(traced):
    _, rec, _ = traced
    spans = rec.spans
    by_name = collections.Counter(s.name for s in spans)
    levels = N_TILES * (CFG.depth + 1)
    assert by_name == {
        "rt.whitted.frame": 1, "rt.whitted.tile": N_TILES, "rt.whitted.shoot": N_TILES,
        "rt.ladder.level": levels, "rt.ladder.compact": N_TILES * (CFG.depth - 1),
        "rt.ladder.deliver": N_TILES, "rt.whitted.assemble": 1, "rt.whitted.read": 1,
        "rt.step.epoch": EPOCHS, "rt.epoch.draws": EPOCHS, "rt.epoch.walk": EPOCHS,
        "rt.epoch.assemble": EPOCHS, "rt.step.renormalise": EPOCHS, "rt.step.wait": 2 * EPOCHS,
        "rt.step.encode": 1,
    }
    for s in spans:
        assert s.name.startswith(tracing.PREFIX) and s.start_ns <= s.end_ns
        want = PARENT[s.name]
        if want is None:
            assert s.parent is None, s
            continue
        parent = spans[s.parent]
        assert parent.name == want, (s, parent)
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, (s, parent)
        assert s.unit == parent.unit
    units = {s.name: [] for s in spans if s.parent is None}
    for s in spans:
        if s.parent is None:
            units[s.name].append(s.unit)
    assert units["rt.step.epoch"] == list(range(START, START + EPOCHS))
    assert units["rt.step.encode"] == [START]
    assert len(units["rt.whitted.frame"]) == 1
    tiles = [s.attrs["tile"] for s in spans if s.name == "rt.whitted.tile"]
    assert tiles == list(range(N_TILES))
    got = [s.attrs["level"] for s in spans if s.name == "rt.ladder.level"]
    assert got == list(range(CFG.depth + 1)) * N_TILES


def test_frame_numbers_go_on(demo):
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            render.render_whitted(*demo, CFG)
    frames = [s.unit for s in tracing.take().spans if s.name == "rt.whitted.frame"]
    assert len(frames) == 2 and frames[1] == frames[0] + 1


def test_ladder_counters_against_the_pools(demo, monkeypatch):
    """ladder.lanes: the widths of the pools entering levels 1 .. depth-1;
    ladder.live: their lanes alive or owing pending radiance, recounted
    from each pool handed to a level."""
    pools = []

    def recording(scene, pool, *args):
        pools[-1].append(pool)
        return process_level(scene, pool, *args)

    def trace_whitted(scene, o, d, cfg):
        pools.append([])
        return ttrace.trace_whitted(scene, o, d, cfg, level_fn=recording)

    monkeypatch.setattr(render, "trace_whitted", trace_whitted)
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        _, stats = render.render_whitted(*demo, CFG)
    counters = tracing.take().counters
    assert stats["dropped"] == 0
    assert len(pools) == N_TILES and all(len(p) == CFG.depth + 1 for p in pools)
    entering = [p for tile in pools for p in tile[1:CFG.depth]]
    live = sum(int(((p.i[I_ALIVE] != 0) | (p.f[F_PEND:F_PEND + 3] != 0).any(dim=0)).sum())
               for p in entering)
    # one reduction a pool; one read of the int64 buffer (the compactions'
    # group counts) and, where a level-1 pool is the uncompacted peel (twice
    # its tile's width), one of the int32 buffer (its alive lanes)
    peeled = any(tile[1].width >= 2 * tile[0].width for tile in pools)
    assert counters == {"ladder.lanes": sum(p.width for p in entering), "ladder.live": live,
                        "ladder.tiles": N_TILES, "tracing.sums": len(entering),
                        "tracing.reads": 1 + peeled}
    assert 0 < live < counters["ladder.lanes"]


def test_spans_share_the_profilers_clock(traced):
    _, rec, events = traced
    by_name = collections.defaultdict(list)
    for name, start, end in events:
        by_name[name].append((start, end))
    tol = 200_000  # ns
    for s in rec.spans:
        twins = [(a, b) for a, b in by_name[s.name]
                 if abs(a - s.start_ns) <= tol and abs(b - s.end_ns) <= tol]
        assert twins, s


def test_counters_add_host_ints_and_device_tensors():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.unit("rt.test", uid="u"):
            assert tracing.active()
            tracing.count("n", 3)
            tracing.count("n", torch.tensor(4))
            tracing.count("m", torch.tensor([True, False, True]))
            tracing.count("m", torch.arange(3, dtype=torch.int32))
            with tracing.span("rt.test.child", k=1):
                pass
        tracing.count("n", 100)  # outside the unit: not counted
    assert not tracing.active()
    rec = tracing.take()
    # three tensors summed into two buffers (int64, int32), each read once
    assert rec.counters == {"n": 7, "m": 5, "tracing.sums": 3, "tracing.reads": 2}
    assert [(s.name, s.parent, s.unit, s.attrs) for s in rec.spans] == [
        ("rt.test", None, "u", {}), ("rt.test.child", 0, "u", {"k": 1})]
    assert tracing.take() == tracing.Record([], {})


def test_a_full_record_stops_recording_units(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            with tracing.unit("rt.test", uid=i):
                with tracing.span("rt.test.child"):
                    pass
    assert [(s.name, s.unit) for s in tracing.take().spans] == [
        ("rt.test", 0), ("rt.test.child", 0), ("rt.test", 1), ("rt.test.child", 1)]


def test_a_full_device_buffer_is_read_at_once(monkeypatch):
    monkeypatch.setattr(tracing, "SLOTS", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.unit("rt.test"):
            for i in range(5):
                tracing.count("n", torch.full((4,), i))
    # read as the third and the fifth count find the buffer full, then by take()
    assert tracing.take().counters == {"n": 4 * (0 + 1 + 2 + 3 + 4), "tracing.sums": 5,
                                       "tracing.reads": 3}


def test_units_on_several_threads_keep_their_own_spans():
    """Each thread keeps its own open unit and spans: a span's parent is the
    unit its own thread opened, however the threads interleave."""
    import sys
    import threading

    n_threads, n_units = 8, 40
    tracing.take()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(n_units):
                with tracing.unit("rt.test", uid=(t, i), recorded=True):
                    with tracing.span("rt.test.child", t=t):
                        with tracing.span("rt.test.leaf"):
                            pass

        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = tracing.take().spans
    assert len(spans) == 3 * n_threads * n_units
    for s in spans:
        if s.name == "rt.test":
            assert s.parent is None
            continue
        parent = spans[s.parent]
        assert parent.unit == s.unit, (s, parent)
        assert parent.name == ("rt.test" if s.name == "rt.test.child" else "rt.test.child")
    assert not tracing.active()


def test_the_png_writers_spans_are_units_of_its_thread(demo, tmp_path):
    """render_progressive's writer thread records a unit `rt.png.job` an
    epoch (id: the epoch it ends) holding the PNG's phases, as the thread
    that started the profiler asks; the epochs' own units are untouched."""
    from raytracer_tpu_torch.parallel.progressive import render_progressive

    cfg = RenderConfig(width=64, height=48, depth=2, tile_rays=1024, epochs=2)
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        render_progressive(*demo, cfg, out_path=str(tmp_path / "out.png"), log=lambda m: None)
    spans = tracing.take().spans
    jobs = [s for s in spans if s.name == "rt.png.job"]
    assert [s.unit for s in jobs] == [1, 2] and all(s.parent is None for s in jobs)
    phases = [s for s in spans if s.name.startswith("rt.png.") and s.name != "rt.png.job"]
    assert {s.name for s in phases} in ({"rt.png.write"}, {"rt.png.encode", "rt.png.write"})
    assert all(spans[s.parent].name == "rt.png.job" for s in phases)
    assert [s.unit for s in spans if s.name == "rt.step.epoch"] == [0, 1]
