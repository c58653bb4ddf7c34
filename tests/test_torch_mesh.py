"""The large-mesh path of the port against raytracer_tpu and the goldens.

mesh_scene takes the BVH / blocked build, so the port's Whitted levels and
MC walk run their blocked branch (BlockedGeom), while the JAX package on
the CPU runs its jnp path with the BVH traversal (ops/intersect_bvh.py).
Gates: Whitted pixels and MC lanes as tests/test_torch_whitted.py and
tests/test_torch_mc.py (within 1e-3 + 2e-2 |ref|: >= 97 % of pixels,
>= 99 % of lanes; casts within 1 %), dropped == 0; the binned path against
the mega-kernel path as tests/test_mc_binned.py (>= 99.5 % of lanes within
rtol 1e-4 / atol 1e-5, casts equal); the mesh goldens with the gates of
scripts/tpu_check.py (Whitted >= 30 dB and <= 1 % bad pixels, MC >= 25 dB
and <= 1 %).
"""

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
from raytracer_tpu.render import render_whitted as jax_render_whitted
from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import camera as camera_ops
from raytracer_tpu_torch.ops import mc_binned, mc_kernel
from raytracer_tpu_torch.ops.distributed import trace_distributed
from raytracer_tpu_torch.render import render_distributed_epoch, render_whitted
from raytracer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def frac_close(a, b):
    return np.all(np.abs(a - b) <= 1e-3 + 2e-2 * np.abs(b), axis=-1).mean()


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(max(float(b.max()), 1e-6) ** 2 / mse) if mse else float("inf")


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


def test_mesh_scene_builds_blocked_and_routes_by_size():
    """A blocked scene below BINNED_MIN_TRIS walks through the blocked MC
    kernel by default; the threshold, set from the card, lies above every
    mesh measured (mesh_scene(320): 204,812 triangles)."""
    from raytracer_tpu_torch.ops.distributed import mega_kernel_route

    scene, cam = tpresets.mesh_scene(4)
    assert scene.blocked and scene.n_tri == 2 * 4 * 4 + 12
    assert float(cam.near) == pytest.approx(-0.1)
    assert scene.n_tri < mc_binned.BINNED_MIN_TRIS and mc_binned.BINNED_MIN_TRIS > 204812
    assert mega_kernel_route(scene)


def test_mesh_whitted_frame_matches_jax():
    """mesh_scene(24) at 31x23.  Coarser meshes and an even width are
    avoided on purpose: reflections about the interpolated normal of a
    large facet dip below its plane and re-hit it at t ~ 1e-7, a coin toss
    of the last ulp (at grid=4 the JAX package's own blocked and dense
    paths disagree on 9 % of pixels), and at clip_x == 0 the camera rays
    run exactly along the terrain's diagonal edges."""
    jscene, jtex, jcam = jpresets.mesh_scene(24)
    jcfg = JaxConfig(width=31, height=23, depth=5, tile_rays=31 * 23)
    ref, jstats = jax_render_whitted(jscene, jtex, jcam, jcfg)
    scene, cam = tpresets.mesh_scene(24)
    cfg = RenderConfig(width=31, height=23, depth=5, tile_rays=31 * 23)
    img, stats = render_whitted(scene, cam, cfg)
    a, b = img.numpy(), np.asarray(ref)
    assert frac_close(a, b) >= 0.97, frac_close(a, b)
    assert abs(stats["casts"] - int(jstats["casts"])) <= 0.01 * int(jstats["casts"])
    assert stats["dropped"] == 0 and int(jstats["dropped"]) == 0


def test_blocked_mc_walk_matches_jax_trace_distributed():
    """The blocked plain walk (mesh_scene(24) is under BINNED_MIN_TRIS: the
    mega-kernel's path) with JAX's own draws, lane for lane."""
    jscene, jtex, jcam = jpresets.mesh_scene(24)
    cfg = JaxConfig(depth=5)
    clips = jnp.asarray(clip_coords(24, 24))
    offsets = jax.random.normal(jax.random.PRNGKey(2), (clips.shape[0], 2)) * 0.04
    o, d = shoot_focus(jcam, clips, offsets, 3.0)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(jax_trace_distributed, static_argnums=(1, 5))(jscene, jtex, o, d, key, cfg)

    n = o.shape[0]
    before = mc_kernel.COUNTS_BLK.plain
    got = trace_distributed(tpresets.mesh_scene(24)[0], torch.tensor(np.asarray(o)),
                            torch.tensor(np.asarray(d)), torch.tensor(jax_unifs(key, n, 5)),
                            RenderConfig(depth=5))
    assert mc_kernel.COUNTS_BLK.plain == before + 1
    a, b = got.photon.numpy(), np.asarray(ref.photon)
    assert frac_close(a, b) >= 0.99, frac_close(a, b)
    assert abs(int(got.casts) - int(ref.casts)) <= 0.01 * int(ref.casts)
    assert abs(int(got.filtered) - int(ref.filtered)) <= 0.02 * n


@pytest.mark.parametrize("depth", [0, 1, 5])
def test_binned_path_matches_mega_path(depth, monkeypatch):
    """Route mesh_scene(8) (140 triangles) through the binned path by
    lowering BINNED_MIN_TRIS, as tests/test_mc_binned.py:95-96 does."""
    scene, cam = tpresets.mesh_scene(8)
    n = 48 * 32
    rng = np.random.default_rng(depth)
    clips = torch.as_tensor(rng.uniform(-0.6, 0.6, size=(n, 2)).astype(np.float32))
    normals = torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32)) * 0.04
    unifs = rng.uniform(size=(depth, 3, n)).astype(np.float32)
    unifs[:, 2] = unifs[:, 2] * np.float32(2 * np.pi) - np.float32(np.pi)
    o, d = camera_ops.shoot_focus(cam, clips, normals, 3.0)
    cfg = RenderConfig(depth=depth)
    mega = trace_distributed(scene, o, d, torch.as_tensor(unifs), cfg)
    monkeypatch.setattr(mc_binned, "BINNED_MIN_TRIS", 64)
    before = (mc_binned.COUNTS_PRIMARY.plain, mc_binned.COUNTS_BOUNCE.plain,
              mc_binned.COUNTS_TERMINAL.plain)
    binned = trace_distributed(scene, o, d, torch.as_tensor(unifs), cfg)
    assert (mc_binned.COUNTS_PRIMARY.plain, mc_binned.COUNTS_BOUNCE.plain,
            mc_binned.COUNTS_TERMINAL.plain) == (before[0] + 1, before[1] + depth, before[2] + 1)
    a, b = binned.photon.numpy(), mega.photon.numpy()
    close = np.all(np.isclose(a, b, rtol=1e-4, atol=1e-5), axis=-1)
    assert close.mean() >= 0.995, close.mean()
    assert int(binned.casts) == int(mega.casts)
    assert (a != 0).any()


def test_binned_state_sort_keeps_slots_and_sends_dead_lanes_last():
    scene, cam = tpresets.mesh_scene(8)
    rng = np.random.default_rng(4)
    clips = torch.as_tensor(rng.uniform(-0.7, 0.7, size=(500, 2)).astype(np.float32))
    o, d = camera_ops.shoot(cam, clips)
    sf, si, casts = mc_binned.primary(scene, o.t().contiguous(), d.t().contiguous())
    assert torch.equal(si[mc_binned.I_SLOT], torch.arange(500, dtype=torch.int32))
    assert int(casts.sum()) == 500
    u = torch.as_tensor(rng.uniform(size=(3, 500)).astype(np.float32))
    sf2, si2 = mc_binned.sort_state(scene, sf, si, u)
    slot = si2[mc_binned.I_SLOT].long()
    assert sorted(slot.tolist()) == list(range(500))
    assert torch.equal(sf2, sf[:, slot]) and torch.equal(si2, si[:, slot])
    alive = si2[mc_binned.I_ALIVE] != 0
    assert 0 < int(alive.sum()) < 500
    assert not bool(alive[int(alive.sum()):].any())  # dead lanes form the tail


@pytest.mark.parametrize("n", [500, 512])
def test_deal_lanes_spreads_sorted_neighbours_over_the_warps(n):
    """deal_lanes is a permutation of the lanes that puts consecutive lanes
    into different warps of 32 and gives every warp its share of a run."""
    sf = torch.arange(n, dtype=torch.float32).repeat(mc_binned.N_F, 1)
    si = torch.arange(n, dtype=torch.int32).repeat(mc_binned.N_I, 1)
    f2, i2 = mc_binned.deal_lanes(sf, si)
    lane = i2[mc_binned.I_SLOT].long()
    assert sorted(lane.tolist()) == list(range(n))
    assert torch.equal(f2, sf[:, lane]) and torch.equal(i2, si[:, lane])
    warp_of = torch.empty(n, dtype=torch.long)
    warp_of[lane] = torch.arange(n) // 32
    warps = -(-n // 32)
    if n % 32 == 0:  # whole warps: neighbours part
        assert bool((warp_of[1:warps] != warp_of[:warps - 1]).all())
    # a run of 100 sorted lanes: 6 or 7 to each of 16 warps (where the last
    # warp is ragged, the shares straddle warps)
    share = torch.bincount(warp_of[:100], minlength=warps)
    assert int(share.max()) <= -(-100 // warps) + (n % 32 != 0)
    assert n % 32 != 0 or int(share.min()) >= 100 // warps


def test_mesh24_goldens():
    """whitted_mesh24_64x48.npy and mc_mesh24_64x48.npy (scripts/tpu_check.py
    :41-91) through the port's plain path.  The MC golden's draws are
    those of PRNGKey(7), tile 0, 3072 rays, depth 5 — the scene does not
    enter them, so tests/golden/mc_demo_64x48_draws.npz holds them too."""
    scene, cam = tpresets.mesh_scene(24)
    cfg = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
    img, stats = render_whitted(scene, cam, cfg)
    golden = np.load(os.path.join(GOLDEN, "whitted_mesh24_64x48.npy"))
    a = img.numpy()
    bad = (np.abs(a - golden).max(axis=-1) > 0.1).mean()
    assert psnr(a, golden) >= 30.0 and bad <= 0.01, (psnr(a, golden), bad)
    assert stats["dropped"] == 0

    z = np.load(os.path.join(GOLDEN, "mc_demo_64x48_draws.npz"))
    img, stats = render_distributed_epoch(
        scene, cam, cfg, draws=[(torch.as_tensor(z["normals"]), torch.as_tensor(z["unifs"]))])
    golden = np.load(os.path.join(GOLDEN, "mc_mesh24_64x48.npy"))
    a = img.numpy()
    bad = (np.abs(a - golden).max(axis=-1) > 0.1).mean()
    assert psnr(a, golden) >= 25.0 and bad <= 0.01, (psnr(a, golden), bad)
