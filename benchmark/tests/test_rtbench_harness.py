"""The harness driven end to end on the CPU at 32x24 (the port's plain
path): sound runs come out correct, the lower-precision control and every
planted fault come out not correct; the scenes are the port's presets."""

import dataclasses
import time

import pytest
import torch

from rtbench import core, runner, scenes

SMALL = {"width": 32, "height": 24}


def small_config(cell, **render):
    cfg = core.config(core.cell(core.benchmark_json(), cell)["config"])
    cfg["render"].update(SMALL, **render)
    return cfg


def run_small(cell, seed=5, fault=None, config=None):
    spec = runner.Spec(workload=cell, seed=seed, seconds=0.2, trace=False, t0=time.time(),
                       device="cpu", config=config or small_config(cell), fault=fault)
    return runner.run_cell(spec)


def _same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.shape == y.shape and torch.equal(x, y), f.name
        elif f.name != "textures":
            assert x == y, f.name


def test_demo_scene_is_the_preset():
    from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene

    scene, camera = scenes.program_scene(scenes.load("demo"), "cpu")
    _same(scene, demo_scene(device="cpu"))
    _same(camera, demo_camera(device="cpu"))


def test_terrain_scene_is_mesh_scene_75():
    from raytracer_tpu_torch.scene.presets import mesh_scene

    raw = scenes.load("terrain")
    assert raw.n_tri == 11262
    scene, camera = scenes.program_scene(raw, "cpu", use_bvh=True)
    want, want_cam = mesh_scene(75, device="cpu")
    _same(scene, want)
    _same(camera, want_cam)


@pytest.mark.parametrize("cell", ["demo.progressive", "demo.preview"])
def test_sound_run_is_correct(cell):
    rec = run_small(cell)
    assert rec["correct"], rec["checks"]
    assert rec["win"]["units"] >= 1 and rec["setup_s"] > 0


@pytest.mark.parametrize("cell", ["demo.progressive", "demo.preview"])
def test_control_in_bfloat16_fails(cell):
    import calibrate

    lim = core.limits(cell)
    got = list(calibrate.readings(cell, [7], 1, device="cpu", config=small_config(cell)))
    program, control = got
    assert all(program[k] <= lim[k]["limit"] for k in lim), program
    assert any(control[k] > lim[k]["limit"] for k in lim), control


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", ["demo.progressive", "demo.preview"])
def test_planted_fault_is_not_correct(cell, fault):
    rec = run_small(cell, fault=fault)
    assert not rec["correct"], rec["checks"]


@pytest.mark.parametrize("late", ["stale_accumulator", "photons_altered"])
def test_fault_after_the_first_group_is_not_correct(late, monkeypatch):
    """Set-up's checked group (epochs 0-9) is sound; from epoch 10 on, the
    window's groups and the one checked after it go wrong."""
    from raytracer_tpu_torch.parallel import mesh

    steps, epoch_fn = mesh.train_steps_sharded, mesh._mc_epoch
    if late == "stale_accumulator":
        def late_steps(scene, camera, cfg, rmesh, accum, seed, k, start_epoch=0, check=None):
            got = steps(scene, camera, cfg, rmesh, accum, seed, k, start_epoch, check)
            return got if start_epoch < 10 else (accum, got[1], got[2])
        monkeypatch.setattr(mesh, "train_steps_sharded", late_steps)
    else:
        def late_epoch(scene, camera, cfg, rmesh, seed, epoch):
            photons, counters = epoch_fn(scene, camera, cfg, rmesh, seed, epoch)
            if epoch >= 10:
                photons = photons + torch.tensor([0.01, 0.0, 0.0])
            return photons, counters
        monkeypatch.setattr(mesh, "_mc_epoch", late_epoch)
    rec = run_small("demo.progressive")
    assert not rec["correct"], rec["checks"]


@pytest.mark.card
def test_control_fails_at_the_cells_size_on_the_card(card):
    import calibrate

    for cell in ("demo.progressive", "demo.preview"):
        lim = core.limits(cell)
        got = list(calibrate.readings(cell, [11, 12, 13], 3))
        for r in got:
            over = [k for k in lim if r[k] > lim[k]["limit"]]
            assert bool(over) == (r["kind"] == "control"), r
