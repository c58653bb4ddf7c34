"""benchmark/metrics/ladder_replay_pct.py: the share of the Whitted ladder's
traced tiles that ran as a replay of a captured CUDA graph.  On the CPU the
port's ladder runs eagerly, so a traced frame there reads 0 %; the card's
readings are read here from records made up for them."""

from torch.profiler import ProfilerActivity, profile

from rtbench import core, program_spans


def read(entry, counters):
    from raytracer_tpu_torch.utils import tracing

    ctx = {"entry": entry, program_spans.KEY: tracing.Record([], counters)}
    return core.metric_reader("ladder_replay_pct").read(ctx)


def test_reads_the_replays_over_the_tiles():
    assert read("whitted", {"ladder.tiles": 38, "ladder.replays": 38}) == 100.0
    assert read("whitted", {"ladder.tiles": 38, "ladder.replays": 19}) == 50.0
    assert read("whitted", {"ladder.tiles": 19}) == 0.0


def test_reads_nothing_without_tiles_or_outside_the_preview():
    # a port that counts no tiles (before ops/ladder_graph.py)
    assert read("whitted", {"ladder.live": 5, "ladder.lanes": 9}) is None
    assert read("progressive", {"ladder.tiles": 19, "ladder.replays": 19}) is None


def test_a_traced_frame_on_the_cpu_reads_0():
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render import render_whitted
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene
    from raytracer_tpu_torch.utils import tracing

    cfg = RenderConfig(width=32, height=24, tile_rays=256)
    scene, camera = demo_scene(device="cpu"), demo_camera(device="cpu")
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        render_whitted(scene, camera, cfg)
    record = tracing.take()
    assert record.counters["ladder.tiles"] == 3 and "ladder.replays" not in record.counters
    ctx = {"entry": "whitted", program_spans.KEY: record}
    assert core.metric_reader("ladder_replay_pct").read(ctx) == 0.0
