"""The port's MC walk (plain version) against raytracer_tpu.

JAX's own draws are handed to the port, so both walk the same random
decisions; they may differ only where f32 op order flips a branch
(roulette / TIR boundaries, near-tie winners), which can decorrelate an
isolated lane.  Gates as tests/test_mc_pallas.py: >= 99 % of lanes within
1e-3 + 2e-2 |ref|, casts within 1 %, filtered within 2 % of N.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.ops.camera import shoot_focus
from raytracer_tpu.ops.distributed import trace_distributed as jax_trace_distributed
from raytracer_tpu.render import clip_coords
from raytracer_tpu.scene.presets import demo_camera, demo_scene
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import intersect_kernel, mc_kernel
from raytracer_tpu_torch.ops.distributed import trace_distributed
from raytracer_tpu_torch.render import render_distributed_epoch, tile_draws
from raytracer_tpu_torch.scene import presets as tpresets
from raytracer_tpu_torch.scene.textures import host_only

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def jax_unifs(key, n, depth):
    """The [depth, 3, n] uniforms ops/distributed.py:96-107 draws from key."""
    draws = []
    for step in range(depth):
        k_sel, k_phi, k_theta = jax.random.split(jax.random.fold_in(key, step), 3)
        draws.append(jnp.stack([
            jax.random.uniform(k_sel, (n,), jnp.float32),
            jax.random.uniform(k_phi, (n,), jnp.float32),
            jax.random.uniform(k_theta, (n,), jnp.float32, minval=-np.pi, maxval=np.pi),
        ]))
    return np.asarray(jnp.stack(draws))


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(max(float(b.max()), 1e-6) ** 2 / mse) if mse else float("inf")


def test_mc_walk_matches_jax_trace_distributed():
    scene, textures = demo_scene()
    cfg = JaxConfig(depth=5)
    clips = jnp.asarray(clip_coords(24, 24))
    offsets = jax.random.normal(jax.random.PRNGKey(2), (clips.shape[0], 2)) * 0.04
    o, d = shoot_focus(demo_camera(), clips, offsets, 3.0)
    key = jax.random.PRNGKey(7)
    run = jax.jit(jax_trace_distributed, static_argnums=(1, 5))
    ref = run(scene, textures, o, d, key, cfg)

    n = o.shape[0]
    unifs = torch.tensor(jax_unifs(key, n, cfg.depth))
    got = trace_distributed(tpresets.demo_scene(device="cpu"), torch.tensor(np.asarray(o)),
                            torch.tensor(np.asarray(d)), unifs, RenderConfig(depth=5))
    a, b = got.photon.numpy(), np.asarray(ref.photon)
    close = np.all(np.abs(a - b) <= 1e-3 + 2e-2 * np.abs(b), axis=-1)
    assert close.mean() >= 0.99, f"only {close.mean():.4f} of lanes agree"
    assert abs(int(got.casts) - int(ref.casts)) <= 0.01 * int(ref.casts)
    assert abs(int(got.filtered) - int(ref.filtered)) <= 0.02 * n


def test_mc_epoch_with_jax_draws_matches_golden():
    """The committed fixture holds the draws PRNGKey(7) gave the golden's
    one-tile epoch (scripts/gen_torch_fixtures.py); gates of
    scripts/tpu_check.py: >= 25 dB and <= 1 % of pixels off by > 0.1."""
    z = np.load(os.path.join(GOLDEN, "mc_demo_64x48_draws.npz"))
    cfg = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
    img, stats = render_distributed_epoch(
        tpresets.demo_scene(device="cpu"), tpresets.demo_camera(device="cpu"), cfg,
        draws=[(torch.as_tensor(z["normals"]), torch.as_tensor(z["unifs"]))])
    golden = np.load(os.path.join(GOLDEN, "mc_demo_64x48.npy"))
    a = img.numpy()
    bad = (np.abs(a - golden).max(axis=-1) > 0.1).mean()
    assert psnr(a, golden) >= 25.0 and bad <= 0.01, (psnr(a, golden), bad)
    assert stats["casts"] > 3 * 64 * 48 and 0 < stats["filtered"] < 64 * 48


def test_generator_draws_are_deterministic_and_in_range():
    cfg = RenderConfig(depth=3)
    n1, u1 = tile_draws(cfg, 5, 2, 1, 1000, "cpu")
    n2, u2 = tile_draws(cfg, 5, 2, 1, 1000, "cpu")
    n3, _ = tile_draws(cfg, 5, 3, 1, 1000, "cpu")
    assert torch.equal(n1, n2) and torch.equal(u1, u2) and not torch.equal(n1, n3)
    assert tuple(u1.shape) == (3, 3, 1000)
    assert 0.0 <= float(u1[:, :2].min()) and float(u1[:, :2].max()) < 1.0
    assert -np.pi <= float(u1[:, 2].min()) and float(u1[:, 2].max()) < np.pi


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    scene = tpresets.demo_scene(device="cpu")
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(4, 1)
    unifs = torch.full((2, 3, 4), 0.5)
    before = mc_kernel.COUNTS.plain
    photon, casts = mc_kernel.trace(scene, o, d, unifs, 2, 100.0, 10)
    assert mc_kernel.COUNTS.plain == before + 1 and tuple(photon.shape) == (4, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        mc_kernel.trace(scene, o.to("meta"), d.to("meta"), unifs.to("meta"), 2, 100.0, 10)


# 64x48 in tiles of 1088 rays: three tiles, the last one 896 rays and 192
# centre rays of padding.  A tile is a multiple of 64 lanes, so PyTorch's CPU
# kernels take the same vector path on a lane in a tile and in the frame
# (a lane in a scalar loop tail may round acos, sin or pow an ulp apart).
_RAGGED = RenderConfig(width=64, height=48, depth=5, tile_rays=1088)


def _numpy_draws(cfg, n_tiles, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_tiles):
        u = rng.uniform(size=(cfg.depth, 3, cfg.tile_rays)).astype(np.float32)
        u[:, 2] = u[:, 2] * np.float32(2 * np.pi) - np.float32(np.pi)
        out.append((torch.as_tensor(rng.normal(size=(cfg.tile_rays, 2)).astype(np.float32)),
                    torch.as_tensor(u)))
    return out


def _unfused_demo():
    scene = tpresets.demo_scene(device="cpu")
    return dataclasses.replace(scene, textures=host_only(scene.textures))


# (source of the draws, route): the mega-kernel's walk, and the unfused
# walk of a dense scene (the demo with its textures' host forms only: the
# nearest-hit, shadow and march kernels), whose epoch also goes frame-wide
@pytest.mark.parametrize("source,route", [
    ("generator", "mega"), ("draws", "mega"), ("generator", "unfused"), ("draws", "unfused")],
    ids=["generator", "draws", "generator-unfused", "draws-unfused"])
def test_frame_wide_epoch_equals_the_tile_loop(source, route):
    """An epoch on a route that takes its lanes one by one, in one
    trace_distributed call, gives the per-tile loop's photons on every lane
    (padding too), casts and filtered, with the generator's draws and with
    a draws= list; render_distributed_epoch takes that one call."""
    from raytracer_tpu_torch import render
    from raytracer_tpu_torch.ops.distributed import frame_wide_route, mega_kernel_route

    cfg = _RAGGED
    if route == "mega":
        scene = tpresets.demo_scene(device="cpu")
        assert mega_kernel_route(scene)
        counts, per_walk = mc_kernel.COUNTS, 1
    else:
        scene = _unfused_demo()
        assert not mega_kernel_route(scene)
        # a walk casts its primary rays and one advance ray per bounce
        counts, per_walk = intersect_kernel.COUNTS_NEAREST, cfg.depth + 1
    assert frame_wide_route(scene)
    cam = tpresets.demo_camera(device="cpu")
    clips, _ = render._clips(cfg, "cpu")
    assert tuple(clips.shape) == (3, 1088, 2)
    if source == "draws":
        draws = _numpy_draws(cfg, 3)
        tile_in = draws
    else:
        draws = None
        tile_in = [tile_draws(cfg, 4, 2, t, 1088, "cpu") for t in range(3)]
    before = counts.plain
    frame = render.epoch_frame(scene, cam, cfg, clips, tile_in)
    assert counts.plain == before + per_walk  # one walk for the whole frame
    tiles = render.epoch_tiles(scene, cam, cfg, clips, tile_in)
    assert counts.plain == before + 4 * per_walk
    assert torch.equal(frame[0], tiles[0]) and tuple(frame[0].shape) == (3264, 3)
    assert int(frame[1]) == int(tiles[1]) and int(frame[2]) == int(tiles[2])
    img, stats = render_distributed_epoch(scene, cam, cfg, seed=4, epoch=2, draws=draws)
    assert counts.plain == before + 5 * per_walk
    ref = frame[0][: 64 * 48][render._clips(cfg, "cpu")[1]].reshape(48, 64, 3)
    assert torch.equal(img, ref)
    assert stats["casts"] == int(tiles[1]) and stats["filtered"] == int(tiles[2])


def test_frame_wide_route_keeps_the_binned_and_bvh_walks_tile_by_tile(monkeypatch):
    """The binned walk (its state is sorted and dealt per tile) and the
    unfused walk of a BVH scene (its traversal syncs the host per step) go
    tile by tile; lowering BINNED_MIN_TRIS takes a blocked mesh there."""
    from raytracer_tpu_torch.ops import mc_binned
    from raytracer_tpu_torch.ops.distributed import frame_wide_route

    mesh, _ = tpresets.mesh_scene(8, device="cpu")
    assert frame_wide_route(mesh)
    monkeypatch.setattr(mc_binned, "BINNED_MIN_TRIS", 64)
    assert not frame_wide_route(mesh)
    bvh = dataclasses.replace(mesh, blk_perm=None, blk_box=None)
    assert bvh.bvh_node_min is not None and not frame_wide_route(bvh)


def test_frame_draws_lay_the_tiles_side_by_side():
    from raytracer_tpu_torch.render import frame_draws

    cfg = _RAGGED
    tile_in = [tile_draws(cfg, 4, 2, t, 1088, "cpu") for t in range(3)]
    normals, unifs = frame_draws(tile_in)
    assert tuple(normals.shape) == (3264, 2) and tuple(unifs.shape) == (5, 3, 3264)
    assert unifs.is_contiguous()
    for t, (nm, u) in enumerate(tile_in):
        assert torch.equal(normals[t * 1088:(t + 1) * 1088], nm)
        assert torch.equal(unifs[:, :, t * 1088:(t + 1) * 1088], u)
    with pytest.raises(ValueError, match="draws for 2 tiles"):
        render_distributed_epoch(tpresets.demo_scene(device="cpu"), tpresets.demo_camera(device="cpu"), cfg,
                                 draws=tile_in[:2])
