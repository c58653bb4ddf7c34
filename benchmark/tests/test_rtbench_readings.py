"""The trace's arithmetic and the per-layer readers on made-up readings."""

import pytest

from rtbench import core, scenes, trace


def test_merged_clips_and_unions():
    spans = [(5, 9, "a"), (0, 3, "b"), (2, 4, "c"), (8, 12, "d"), (20, 30, "e")]
    assert trace.merged(spans, 1, 25) == [[1, 4], [5, 12], [20, 25]]


def test_innermost_host_operation():
    at = trace._HostIndex([(0, 10_000_000, "outer"), (2_000_000, 3_000_000, "inner")])
    assert at.innermost(2_500_000) == "inner"
    assert at.innermost(5_000_000) == "outer"
    assert at.innermost(20_000_000) == "(no host operation)"


def _ctx(entry, blocked=False):
    from raytracer_tpu_torch.config import RenderConfig

    summary = {"window_s": 1.0, "busy_s": 0.6, "device_ops": 300,
               "op_us": {"void rt::mc_kernel_staged<rt::NoWork>(...)": 50_000.0,
                         "Memcpy DtoH": 10_000.0}}
    return {"entry": entry, "units": 10, "wall_s": 0.1, "casts": 110_000_000,
            "trace": summary, "spans": {"scene_build_s": 0.02},
            "cfg": RenderConfig(), "raw": scenes.load("demo"), "blocked": blocked}


def test_readers_read_their_cells_and_nothing_else():
    ctx = _ctx("progressive")
    read = lambda name, c: core.metric_reader(name).read(c)
    assert read("mc_kernel_ms", ctx) == pytest.approx(5.0)
    assert read("step_other_ms", ctx) == pytest.approx(1.0)
    assert read("idle_pct.epoch", ctx) == pytest.approx(40.0)
    assert read("scene_build_s", ctx) == 0.02
    assert read("idle_pct.frame", ctx) is None and read("level_kernel_ms", ctx) is None
    assert read("mc_roofline_pct", _ctx("progressive", blocked=True)) is None
    share = read("mc_roofline_pct", ctx)
    # 11 M casts x (64 x 6 + 4 x 30) FLOP over 67 TFLOP/s: 0.0827 ms of 5 ms
    assert share == pytest.approx(100 * 11e6 * 504 / 67e12 * 1e3 / 5.0, rel=1e-6)
    assert read("frame_device_ops", _ctx("whitted")) == 30


class _Event:
    def __init__(self, name, start, dur, cuda):
        self.args = (name, start, dur, cuda)

    def name(self):
        return self.args[0]

    def start_ns(self):
        return self.args[1]

    def duration_ns(self):
        return self.args[2]

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self.args[3] else torch.autograd.DeviceType.CPU


def test_annotations_copied_onto_the_device_are_left_out():
    """Kineto draws a record_function range (the harness's marks, c10d's
    "nccl:all_reduce") on the device's timeline too: not device activity."""
    from types import SimpleNamespace

    evs = [_Event(trace.MARK + "window", 0, 100, False), _Event(trace.MARK + "window", 0, 100, True),
           _Event("nccl:all_reduce", 10, 30, False), _Event("nccl:all_reduce", 12, 30, True),
           _Event("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 14, 20, True),
           _Event("cudaLaunchKernel", 15, 2, False), _Event("void rt::mc_kernel", 40, 50, True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    dev, host = trace.events(prof)
    assert [d[2] for d in dev] == ["ncclDevKernel_AllReduce_Sum_f32_RING_LL", "void rt::mc_kernel"]
    assert len(host) == 3
    s = trace.summary(prof, "group")
    assert s["busy_s"] == pytest.approx(70e-9) and s["device_ops"] == 2
