"""raytracer_tpu_torch.ops.ladder_graph: a tile's Whitted ladder replayed as
a CUDA graph.

On the CPU: which ladders run as a graph (a fused scene on a CUDA device,
with the default levels, and nothing else), what a captured ladder is kept
under, and how many are kept.  On a card (the `card` tests, which skip
without one): the graphed frame against the eager one, bit for bit, with
its counters, launches and recorded counts.  This file imports no JAX, so
that a card host can run it:
`python -m pytest --noconftest -p no:xdist -o addopts='' tests/test_torch_ladder_graph.py`.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import ladder_graph, level_kernel
from raytracer_tpu_torch.ops import trace as trace_ops
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.textures import host_only
from raytracer_tpu_torch.scene.types import Camera

CUDA = torch.device("cuda", 0)


@pytest.fixture(scope="module")
def demo_cpu():
    return presets.demo_scene(device="cpu")


@pytest.fixture(scope="module")
def mesh_cpu():
    return presets.mesh_scene(24, device="cpu")[0]


@pytest.mark.parametrize("case, want", [
    ("fused on a card", True),
    ("fused on the CPU", False),
    ("unfused textures on a card", False),
    ("a level function of its own", False),
    ("blocked on a card", True),
    ("BVH-only on a card", False),
])
def test_the_route(case, want, demo_cpu, mesh_cpu):
    scene, device, level_fn = demo_cpu, CUDA, None
    if case == "fused on the CPU":
        device = torch.device("cpu")
    elif case == "unfused textures on a card":
        scene = dataclasses.replace(demo_cpu, textures=host_only(demo_cpu.textures))
    elif case == "a level function of its own":
        level_fn = level_kernel.process_level_plain
    elif case == "blocked on a card":
        scene = mesh_cpu
    elif case == "BVH-only on a card":
        scene = dataclasses.replace(mesh_cpu, blk_perm=None, blk_box=None)
    assert ladder_graph.engages(scene, device, level_fn) is want


@pytest.mark.parametrize("change", ladder_graph.LADDER_FIELDS + ("width",))
def test_the_key_follows_every_baked_value(change, demo_cpu):
    cfg = RenderConfig(compact_group=8)
    base = ladder_graph.key(trace_ops.trace_whitted, demo_cpu, cfg, 65536, CUDA)
    if change == "width":
        other = ladder_graph.key(trace_ops.trace_whitted, demo_cpu, cfg, 49152, CUDA)
    else:
        value = getattr(cfg, change)
        moved = value + 1 if isinstance(value, int) else value * 1.5
        other = ladder_graph.key(trace_ops.trace_whitted, demo_cpu,
                                 dataclasses.replace(cfg, **{change: moved}), 65536, CUDA)
    assert other != base


def test_the_key_ignores_what_the_ladder_does_not_bake(demo_cpu):
    """The frame's size, the MC pass's fields and the tile size (the
    tile's width is its own part) leave a tile's ladder as it was."""
    cfg = RenderConfig()
    other = dataclasses.replace(cfg, width=320, height=240, epochs=3, focus=2.0, blur=0.1,
                                percentile=0.5, tile_rays=1 << 12)
    assert (ladder_graph.key(trace_ops.trace_whitted, demo_cpu, cfg, 4096, CUDA)
            == ladder_graph.key(trace_ops.trace_whitted, demo_cpu, other, 4096, CUDA))
    assert (ladder_graph.key(trace_ops.trace_whitted, demo_cpu, cfg, 4096, CUDA)
            != ladder_graph.key(trace_ops.trace_whitted, presets.demo_scene(device="cpu"), cfg,
                                4096, CUDA))


def test_ladders_are_bounded_and_die_with_their_scene(monkeypatch):
    monkeypatch.setattr(ladder_graph, "_LADDERS", type(ladder_graph._LADDERS)())
    monkeypatch.setattr(ladder_graph, "_WATCHED", set())
    kept, gone = presets.demo_scene(device="cpu"), presets.demo_scene(device="cpu")
    cfg = RenderConfig()
    for width in range(ladder_graph.MAX_GRAPHS + 2):
        ladder_graph._keep(ladder_graph.key(None, kept, cfg, width, CUDA), kept, width)
    assert list(ladder_graph._LADDERS.values()) == list(range(2, ladder_graph.MAX_GRAPHS + 2))
    ladder_graph._keep(ladder_graph.key(None, gone, cfg, 0, CUDA), gone, "gone")
    assert len(ladder_graph._LADDERS) == ladder_graph.MAX_GRAPHS
    del gone
    gc.collect()
    assert "gone" not in ladder_graph._LADDERS.values()
    assert all(k[0] == id(kept) for k in ladder_graph._LADDERS)


# ---- on a card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(CUDA)
    return CUDA


def _counts():
    return tuple(c.launches for c in ladder_graph.COUNTERS)


def _frame(scene, cam, cfg, graphed, monkeypatch):
    """render_whitted through the graph or the eager ladder -> (image,
    stats, each counter's launches)."""
    from raytracer_tpu_torch.render import render_whitted

    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(ladder_graph, "engages", lambda *a, **k: False)
        before = _counts()
        img, stats = render_whitted(scene, cam, cfg)
        torch.cuda.synchronize()
        return img, stats, tuple(a - b for a, b in zip(_counts(), before))


def _hold(scene, cam, cfg, monkeypatch, calls=2):
    """The eager frame, then `calls` graphed ones (the first captures), each
    equal to it bit for bit, its stats and its launches too."""
    want = _frame(scene, cam, cfg, False, monkeypatch)
    assert want[1]["dropped"] == 0
    for _ in range(calls):
        got = _frame(scene, cam, cfg, True, monkeypatch)
        assert torch.equal(got[0], want[0])
        assert got[1:] == want[1:], (got[1:], want[1:])
    return want


@pytest.mark.card
def test_a_ragged_demo_frame_is_the_eager_one(card, monkeypatch):
    cfg = RenderConfig(width=320, height=240, tile_rays=20000)  # tiles of 20000, last 16800
    scene, cam = presets.demo_scene(device=card), presets.demo_camera(device=card)
    img, _, launches = _hold(scene, cam, cfg, monkeypatch)
    assert launches == (4 * (cfg.depth + 1), 0, 4)
    widths = {k[3] for k in ladder_graph._LADDERS if k[0] == id(scene)}
    assert widths == {20000, 16800}


@pytest.mark.card
def test_a_blocked_mesh_frame_is_the_eager_one(card, monkeypatch):
    scene, cam = presets.mesh_scene(24, device=card)
    assert scene.blocked
    cfg = RenderConfig(width=128, height=96, tile_rays=4096)
    _, _, launches = _hold(scene, cam, cfg, monkeypatch)
    assert launches == (0, 3 * (cfg.depth + 1), 3)


@pytest.mark.card
def test_another_depth_and_another_camera_are_their_eager_frames(card, monkeypatch):
    cfg = RenderConfig(width=160, height=120, tile_rays=8192)
    scene, cam = presets.demo_scene(device=card), presets.demo_camera(device=card)
    first = _hold(scene, cam, cfg, monkeypatch)
    for depth in (3, 1):
        other = _hold(scene, cam, dataclasses.replace(cfg, depth=depth), monkeypatch)
        assert not torch.equal(other[0], first[0])
    moved = Camera.create(fovy_deg=45.0, center=(2.5, 2.0, 2.5),
                          toward=np.asarray([-1.0, -0.8, -1.0]) / np.sqrt(2.64),
                          up=(0.0, 1.0, 0.0), near=-0.1, device=card)
    other = _hold(scene, moved, cfg, monkeypatch, calls=1)
    assert not torch.equal(other[0], first[0])


@pytest.mark.card
def test_a_recorded_frame_counts_what_the_eager_one_counts(card, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from raytracer_tpu_torch.utils import tracing

    cfg = RenderConfig(width=320, height=240, tile_rays=20000)
    scene, cam = presets.demo_scene(device=card), presets.demo_camera(device=card)
    counters, frames = {}, []
    for graphed in (False, True, True):  # eager; the captures; the counted replays
        tracing.take()
        with profile(activities=[ProfilerActivity.CPU]):
            frames.append(_frame(scene, cam, cfg, graphed, monkeypatch))
        counters.setdefault(graphed, []).append(tracing.take().counters)
    frames.append(_frame(scene, cam, cfg, True, monkeypatch))  # the plain replays
    for got in frames[1:]:
        assert torch.equal(got[0], frames[0][0]) and got[1:] == frames[0][1:]
    eager, (capture, replay) = counters[False][0], counters[True]
    for name in ("ladder.lanes", "ladder.live", "ladder.tiles"):
        assert capture[name] == eager[name] == replay[name], name
    # the first frame captures tiles 0 (20000 rays) and 3 (16800) and
    # replays tiles 1 and 2; the next replays every tile
    assert "ladder.replays" not in eager and capture["ladder.replays"] == 2
    assert replay["ladder.replays"] == replay["ladder.tiles"] == 4
    assert 0 < eager["ladder.live"] < eager["ladder.lanes"]
