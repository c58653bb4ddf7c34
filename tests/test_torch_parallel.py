"""raytracer_tpu_torch.parallel.mesh on the CPU.

The mesh's rank bodies run one after another in this process (no
collective), and one gloo world of four processes, spawned once for the
module, runs the collective functions and render_progressive and hands
its results back through files; the same world then runs chip_smoke.py's
phase 7 rank body (multicard_body: the checks each card's rank makes on a
host with several cards) at 64x48, against references made here.  The port deals whole tiles of the
single-card layout to the ranks and keys its draws per (seed, epoch,
tile), so the dp-only frames, epochs and train steps are held to the
single card bit for bit, and the sharded frames to the JAX-made goldens.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import chip_smoke
from raytracer_tpu.parallel.mesh import make_render_mesh as jax_make_render_mesh
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops.tonemap import post_process
from raytracer_tpu_torch.parallel import mesh as tmesh
from raytracer_tpu_torch.parallel.mesh import RenderMesh
from raytracer_tpu_torch.parallel.progressive import render_progressive
from raytracer_tpu_torch.render import (
    _clips,
    _epoch,
    _seed,
    render_distributed_epoch,
    render_whitted,
    tile_draws,
)
from raytracer_tpu_torch.scene.presets import demo_camera, demo_scene, mesh_scene
from raytracer_tpu_torch.utils.color import linear_to_u8, luma
from raytracer_tpu_torch.utils.png import read_png_rgb8

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
MESHES = [(2, 1), (4, 1), (2, 2), (1, 4)]
# five tiles of 128 rays: dealt unevenly over two and four ranks
DEMO_CFG = RenderConfig(width=32, height=20, depth=3, tile_rays=128)
MESH24_CFG = RenderConfig(width=32, height=20, depth=1, tile_rays=128)
# the goldens' frame in four tiles of 768: the gloo world deals one to a rank
WORLD_CFG = RenderConfig(width=64, height=48, depth=5, tile_rays=768)
WORLD = 4
# phase 7 in the gloo world: the demo at WORLD_CFG, 2 epochs of seed 3
# (the second is world_refs'), mesh_scene(24) in four tiles
MC_SPEC = chip_smoke.MulticardSpec(
    demo=dataclasses.replace(WORLD_CFG, epochs=2), grid=24,
    mesh=RenderConfig(width=32, height=16, depth=1, tile_rays=128), seed=3, reps=1,
    device="cpu")


def _meshes(dp, sp):
    return [RenderMesh(dp=dp, sp=sp, rank=r) for r in range(dp * sp)]


def _sum(parts):
    """The ranks' buffers summed in rank order, as the emulation of the
    all_reduce."""
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(max(float(b.max()), 1e-6) ** 2 / mse) if mse else float("inf")


def _gate(img, name, min_psnr, max_bad):
    golden = np.load(os.path.join(GOLDEN, name))
    a = img.numpy()
    bad = (np.abs(a - golden).max(axis=-1) > 0.1).mean()
    assert psnr(a, golden) >= min_psnr and bad <= max_bad, (name, psnr(a, golden), bad)


@pytest.fixture(scope="module")
def demo():
    return demo_scene(device="cpu"), demo_camera(device="cpu")


@pytest.fixture(scope="module")
def mesh24():
    return mesh_scene(24, device="cpu")


@pytest.fixture(scope="module")
def single_whitted(demo, mesh24):
    """The single-card Whitted frames and stats the rank bodies sum to."""
    return {"demo": render_whitted(*demo, DEMO_CFG), "mesh24": render_whitted(*mesh24, MESH24_CFG)}


# ---- factoring and dealing ------------------------------------------------

@pytest.mark.parametrize("n, sp", [(8, None), (8, 1), (1, None), (4, None), (6, None),
                                   (5, None), (3, None)])
def test_make_render_mesh_factors_as_jax(n, sp):
    """The conftest's 8 virtual devices: the same (dp, sp) as the JAX
    mesh, and rank r at the JAX mesh's position of device r."""
    jm = jax_make_render_mesh(n, sp)
    tm = tmesh.make_render_mesh(n, sp)
    assert tm.shape == dict(jm.shape)
    assert (tm.world, tm.rank, tm.group) == (n, 0, None)
    for r, dev in enumerate(jm.devices.flat):
        pos = tuple(int(i) for i in np.argwhere(jm.devices == dev)[0])
        assert RenderMesh(dp=tm.dp, sp=tm.sp, rank=r).index == pos


@pytest.mark.parametrize("n_tiles", [1, 5, 12, 19])
@pytest.mark.parametrize("dp, sp", MESHES + [(3, 1), (4, 2)])
def test_rank_tiles_deal_every_tile_once(n_tiles, dp, sp):
    """Whitted deals over the flattened world, MC over dp: every tile once,
    in tile order, each part within one tile of the others."""
    for parts in (dp * sp, dp):
        dealt = [tmesh.rank_tiles(n_tiles, parts, i) for i in range(parts)]
        assert [t for r in dealt for t in r] == list(range(n_tiles))
        sizes = [len(r) for r in dealt]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


# ---- the rank bodies in this process --------------------------------------

@pytest.mark.parametrize("which", ["demo", "mesh24"])
@pytest.mark.parametrize("dp, sp", MESHES)
def test_whitted_rank_bodies_sum_to_the_single_card_frame(which, dp, sp, demo, mesh24,
                                                          single_whitted):
    """The flattened world's tiles, summed, give the single card's frame
    bit for bit (mesh24: the blocked level path); the casts are the single
    card's for every sp, and nothing is dropped."""
    scene, cam = demo if which == "demo" else mesh24
    cfg = DEMO_CFG if which == "demo" else MESH24_CFG
    assert len(_clips(cfg, "cpu")[0]) == 5
    if which == "mesh24":
        assert scene.blocked
    parts = [tmesh.whitted_body(scene, cam, cfg, m) for m in _meshes(dp, sp)]
    img = _sum([p[0] for p in parts])
    casts, dropped = _sum([p[1] for p in parts]).tolist()
    ref, stats = single_whitted[which]
    assert torch.equal(img, ref)
    assert casts == stats["casts"] and dropped == 0 == stats["dropped"]
    assert all(p[0].shape == (cfg.height, cfg.width, 3) for p in parts)


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_dp_only_epoch_equals_the_single_card_epoch(dp, demo):
    """dp = 8 over five tiles: three ranks trace nothing and add zeros."""
    photons, st = render_distributed_epoch(*demo, DEMO_CFG, seed=3, epoch=2)
    parts = [tmesh.epoch_body(*demo, DEMO_CFG, m, 3, 2) for m in _meshes(dp, 1)]
    assert torch.equal(_sum([p[0] for p in parts]), photons)
    assert _sum([p[1] for p in parts]).tolist() == [st["casts"], st["filtered"]]


def test_sample_zero_is_the_single_card_seed_chain_and_samples_differ():
    """Sample 0 keeps the seed chain of the single-card draws (pinned at
    three points); samples 1..3 draw other numbers."""
    assert [_seed(0, 0, 0), _seed(5, 2, 1), _seed(7, 100, 18)] == [
        0x238275bc38fcbe91, 0x55c3db6560a3c772, 0x230d6303b19fe2b1]
    assert _seed(5, 2, 1, 0) == _seed(5, 2, 1)
    cfg = RenderConfig(depth=3)
    draws = [tile_draws(cfg, 5, 2, 1, 500, "cpu", sample=s) for s in range(4)]
    ref = tile_draws(cfg, 5, 2, 1, 500, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(draws[0], ref))
    for i in range(4):
        for j in range(i):
            assert not torch.equal(draws[i][1], draws[j][1])
            assert not torch.equal(draws[i][0], draws[j][0])


def test_sample_parallel_epoch_is_the_two_samples_summed_and_repeats(demo):
    """(2, 2): each pixel sums samples 0 and 1 (bit for bit: two operands
    add alike in either order); a second run repeats it."""
    runs = [_sum([tmesh.epoch_body(*demo, DEMO_CFG, m, 1, 4)[0] for m in _meshes(2, 2)])
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    two = [_epoch(*demo, DEMO_CFG, 1, 4, None, sample=s)[0] for s in (0, 1)]
    assert torch.equal(runs[0], two[0] + two[1])
    assert not torch.equal(two[0], two[1])


def test_mc_golden_with_jax_draws_dealt_over_dp4(demo):
    """The golden's draws (PRNGKey(7), tests/golden/mc_demo_64x48_draws.npz)
    cut into the frame's four tiles of 768 and dealt over dp = 4: the
    scripts/tpu_check.py gate (>= 25 dB, <= 1 % bad), and the single-card
    one-tile epoch of the same draws bit for bit."""
    z = np.load(os.path.join(GOLDEN, "mc_demo_64x48_draws.npz"))
    normals, unifs = torch.as_tensor(z["normals"]), torch.as_tensor(z["unifs"])
    t = WORLD_CFG.tile_rays
    draws = [(normals[i * t:(i + 1) * t], unifs[:, :, i * t:(i + 1) * t].contiguous())
             for i in range(4)]
    parts = [tmesh.epoch_body(*demo, WORLD_CFG, m, 0, 0, draws=draws) for m in _meshes(4, 1)]
    img = _sum([p[0] for p in parts])
    _gate(img, "mc_demo_64x48.npy", 25.0, 0.01)
    one = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
    ref, st = render_distributed_epoch(*demo, one, draws=[(normals, unifs)])
    assert torch.equal(img, ref)
    assert _sum([p[1] for p in parts]).tolist() == [st["casts"], st["filtered"]]
    with pytest.raises(ValueError):
        tmesh.epoch_body(*demo, WORLD_CFG, RenderMesh(dp=2, sp=2, rank=1), 0, 0, draws=draws)


def test_train_steps_on_a_world_of_one(demo):
    """A mesh of one rank: a train step is the single card's
    post_process(accum + photons) bit for bit, its u8 the accumulator's,
    its 99th-percentile luma 1 (tests/test_parallel.py:78); k = 3 steps in
    one call equal three steps, and its counters are their sums."""
    one = RenderMesh(dp=1, sp=1)
    accum = post_process(render_whitted(*demo, DEMO_CFG)[0])
    a1, u1, c1 = tmesh.train_step_sharded(*demo, DEMO_CFG, one, accum, 9, 0)
    photons, st = render_distributed_epoch(*demo, DEMO_CFG, seed=9, epoch=0)
    assert torch.equal(a1, post_process(accum + photons))
    assert torch.equal(u1, linear_to_u8(a1))
    assert c1.tolist() == [st["casts"], st["filtered"]] and c1.dtype == torch.int64
    lum = luma(a1.reshape(-1, 3)).numpy()
    valid = lum[np.abs(lum) >= np.finfo(np.float32).tiny]
    assert abs(np.sort(valid)[int(len(valid) * 0.99)] - 1.0) < 1e-3
    a, counters = accum, torch.zeros(2, dtype=torch.int64)
    for e in range(3):
        a, u, c = tmesh.train_step_sharded(*demo, DEMO_CFG, one, a, 9, e)
        counters += c
    a3, u3, c3 = tmesh.train_steps_sharded(*demo, DEMO_CFG, one, accum, 9, 3, 0)
    assert torch.equal(a3, a) and torch.equal(u3, u) and torch.equal(c3, counters)


def test_collectives_of_several_ranks_need_the_group(demo):
    with pytest.raises(ValueError):
        tmesh.render_whitted_sharded(*demo, DEMO_CFG, RenderMesh(dp=2, sp=1))
    with pytest.raises(ValueError):
        tmesh.make_render_mesh()  # no process group and no count


def test_init_multihost_wiring(monkeypatch):
    """Explicit coordinator arguments go to init_process_group as tcp://,
    world_size and rank; none give the env:// form (torchrun's).  On cards
    the backend is NCCL and the rank takes cuda:<LOCAL_RANK>, else its
    process id modulo the host's cards (tests/test_parallel.py:307)."""
    calls, devices = [], []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda **kw: calls.append(kw))
    assert tmesh.init_multihost("10.0.0.1:1234", 4, 2, device="cpu") == torch.device("cpu")
    assert calls[-1] == dict(backend="gloo", init_method="tcp://10.0.0.1:1234", world_size=4,
                             rank=2)
    tmesh.init_multihost(device="cpu")
    assert calls[-1] == dict(backend="gloo", init_method="env://")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", devices.append)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert tmesh.init_multihost("h:1", 8, 5) == torch.device("cuda", 1)
    assert calls[-1]["backend"] == "nccl" and devices[-1] == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tmesh.init_multihost() == torch.device("cuda", 3)
    assert calls[-1] == dict(backend="nccl", init_method="env://")


# ---- a gloo world of four processes ----------------------------------------

def _world_worker(rank, tmp, port, mc_dir):
    """Rank `rank` of the gloo world: the collective functions and
    render_progressive on the demo at WORLD_CFG, then phase 7's rank body
    with the references in mc_dir; results into tmp/rank<r>.pt."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = tmesh.init_multihost(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    try:
        scene, cam = demo_scene(device=dev), demo_camera(device=dev)
        dp4, dp2sp2 = tmesh.make_render_mesh(sp=1), tmesh.make_render_mesh()
        out = {"shapes": (dp4.shape, dp2sp2.shape, dp4.rank, dp2sp2.index)}
        out["whitted"] = tmesh.render_whitted_sharded(scene, cam, WORLD_CFG, dp2sp2)
        out["epoch_dp4"] = tmesh.render_mc_epoch_sharded(scene, cam, WORLD_CFG, dp4, 3, 1)
        out["epoch_dp2sp2"] = tmesh.render_mc_epoch_sharded(scene, cam, WORLD_CFG, dp2sp2, 3, 1)
        accum = post_process(out["whitted"][0])
        out["step"] = tmesh.train_step_sharded(scene, cam, WORLD_CFG, dp4, accum, 3, 1)
        a, counters = accum, torch.zeros(2, dtype=torch.int64)
        for e in (1, 2, 3):
            a, u, c = tmesh.train_step_sharded(scene, cam, WORLD_CFG, dp4, a, 3, e)
            counters += c
        out["three_steps"] = (a, u, counters)
        out["steps"] = tmesh.train_steps_sharded(scene, cam, WORLD_CFG, dp4, accum, 3, 3, 1)
        # progressive: uninterrupted, then one epoch and a resume to three;
        # each rank names its own files, so only rank 0's may exist
        logs = {"full": [], "part": [], "resume": []}
        cfg3 = RenderConfig(width=64, height=48, depth=5, tile_rays=768, epochs=3)
        cfg1 = RenderConfig(width=64, height=48, depth=5, tile_rays=768, epochs=1)
        run = lambda cfg, name, ckpt, log: render_progressive(
            scene, cam, cfg, out_path=os.path.join(tmp, f"{name}{rank}.png"), seed=11,
            checkpoint_path=ckpt and os.path.join(tmp, f"ck{rank}.npz"), log=log.append,
            mesh=dp2sp2)
        out["full"] = run(cfg3, "full", False, logs["full"]).img
        run(cfg1, "part", True, logs["part"])
        out["resumed"] = run(cfg3, "part", True, logs["resume"]).img
        out["logs"] = logs
        # phase 7's rank body; each of its checks raises
        refs = torch.load(os.path.join(mc_dir, "refs.pt"), weights_only=False)
        out["multicard"] = chip_smoke.multicard_body(dev, dp2sp2, MC_SPEC, refs, mc_dir)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multicard_refs():
    """Phase 7's references (chip_smoke.multicard_refs) on the CPU."""
    return chip_smoke.multicard_refs(torch.device("cpu"), MC_SPEC, WORLD)


@pytest.fixture(scope="module")
def multicard_dir(tmp_path_factory, multicard_refs):
    """Phase 7's references for the world, and where its rank 0 writes."""
    mc_dir = str(tmp_path_factory.mktemp("multicard"))
    torch.save(multicard_refs, os.path.join(mc_dir, "refs.pt"))
    return mc_dir


@pytest.fixture(scope="module")
def world(tmp_path_factory, multicard_dir):
    tmp = str(tmp_path_factory.mktemp("gloo_world"))
    mp.start_processes(_world_worker, args=(tmp, _free_port(), multicard_dir), nprocs=WORLD,
                       start_method="spawn")
    return tmp, [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(WORLD)]


@pytest.fixture(scope="module")
def world_refs(multicard_refs):
    """The single card's frame and epoch (seed 3, epoch 1) at WORLD_CFG, and
    the (2, 2) epoch emulated in this process: multicard_refs'
    render_whitted, render_distributed_epoch and summed rank bodies."""
    r = multicard_refs
    return ((r["whitted"], r["whitted_stats"]), (r["epochs"][1], r["epoch_stats"][1]),
            r["emulated_epochs"][1])


def test_world_whitted_frame_is_the_single_cards_and_passes_the_golden(world, world_refs):
    _, outs = world
    ref, stats = world_refs[0]
    for out in outs:
        img, st = out["whitted"]
        assert torch.equal(img, ref)
        assert st == stats
    _gate(outs[0]["whitted"][0], "whitted_demo_64x48.npy", 38.0, 0.02)


def test_world_mc_epochs(world, world_refs):
    """(4, 1): the single card's epoch bit for bit; (2, 2): the in-process
    emulation bit for bit (sp = 2), two samples a pixel."""
    _, outs = world
    (photons, st), emulated = world_refs[1], world_refs[2]
    for out in outs:
        img, s = out["epoch_dp4"]
        assert torch.equal(img, photons)
        assert s == dict(st, samples_per_pixel=1)
        img, s = out["epoch_dp2sp2"]
        assert torch.equal(img, emulated)
        assert s["samples_per_pixel"] == 2 and s["primary_rays"] == 2 * 64 * 48
    assert outs[0]["shapes"][:2] == ({"dp": 4, "sp": 1}, {"dp": 2, "sp": 2})
    assert [o["shapes"][3] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_world_train_steps(world, world_refs):
    """dp = 4: a step is the single card's post_process(accum + photons) bit
    for bit on every rank; train_steps_sharded(k=3) equals three steps and
    sums their counters."""
    _, outs = world
    accum = post_process(world_refs[0][0])
    photons, st = world_refs[1]
    want = post_process(accum + photons)
    for out in outs:
        a1, u1, c1 = out["step"]
        assert torch.equal(a1, want) and torch.equal(u1, linear_to_u8(want))
        assert c1.tolist() == [st["casts"], st["filtered"]]
        for x, y in zip(out["steps"], out["three_steps"]):
            assert torch.equal(x, y)


def test_world_progressive_writes_on_rank_0_and_resumes_exactly(world):
    tmp, outs = world
    written = sorted(f for f in os.listdir(tmp) if not f.startswith("rank"))
    assert written == ["ck0.npz", "full0.png", "part0.png"]
    for out in outs:
        assert torch.equal(out["resumed"], outs[0]["full"])
        assert torch.equal(out["full"], outs[0]["full"])
    np.testing.assert_array_equal(read_png_rgb8(os.path.join(tmp, "part0.png")),
                                  read_png_rgb8(os.path.join(tmp, "full0.png")))
    logs = outs[0]["logs"]
    assert len(logs["full"]) == 4 and "resumed at epoch 1" in logs["resume"]
    assert not any(o["logs"][k] for o in outs[1:] for k in logs)


def test_world_runs_phase_7s_rank_body(world, multicard_refs, multicard_dir):
    """chip_smoke.multicard_body ran on every rank (it raises on a check
    that fails): each rank's launches are its tiles' (the plain versions
    here: a level kernel call six times a Whitted tile, a delivery a tile,
    an MC call an epoch), rank 0 wrote the dp-only world's PNG as the single
    device's, and the resumed, uninterrupted and (1, 2) renders' PNGs are
    one and the same."""
    runs = [o["multicard"] for o in world[1]]
    assert [(r["rank"], r["world"], r["device"]) for r in runs] == [
        (k, WORLD, "cpu") for k in range(WORLD)]
    for r in runs:
        assert r["launches"] == {"level": 6, "mc": 2, "deliver": 1, "level_thread": 0,
                                 "mc_thread": 0}
        assert set(r["times"]) == {"demo (4, 1)", "demo (2, 2)", "mesh (4, 1)"}
    assert runs[0]["launches_world"] == {"level": 24, "mc": 8, "deliver": 4}
    assert sorted(os.listdir(multicard_dir)) == ["ck.npz", "dp.png", "full.png", "pair.png",
                                          "part.png", "refs.pt"]
    png = lambda name: open(os.path.join(multicard_dir, name), "rb").read()
    assert png("dp.png") == multicard_refs["png"]
    assert png("part.png") == png("full.png") == png("pair.png") != png("dp.png")
