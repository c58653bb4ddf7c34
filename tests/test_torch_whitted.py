"""The port's Whitted ladder and level kernel (plain version) against
raytracer_tpu and the committed golden.

Differences come only from f32 op order (near-tie winners, razor-edge
grazing shadows on the floor's coplanar triangles, TIR boundaries), so the
frame gates are those of tests/test_level_pallas.py and
scripts/tpu_check.py: >= 97 % of pixels within 1e-3 + 2e-2 |ref|, casts
within 1 %, and no ray dropped by pool overflow.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.ops.camera import shoot
from raytracer_tpu.ops.trace import trace_whitted as jax_trace_whitted
from raytracer_tpu.render import clip_coords
from raytracer_tpu.scene.presets import demo_camera, demo_scene
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import level_kernel
from raytracer_tpu_torch.ops.level_kernel import Pool
from raytracer_tpu_torch.ops.camera import shoot as tshoot
from raytracer_tpu_torch.ops.trace import _compact, _pack_primary, trace_whitted
from raytracer_tpu_torch.render import render_whitted
from raytracer_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def test_whitted_matches_jax_trace_whitted():
    scene, textures = demo_scene()
    o, d = shoot(demo_camera(), jnp.asarray(clip_coords(16, 12)))
    run = jax.jit(jax_trace_whitted, static_argnums=(1, 4))
    ref = run(scene, textures, o, d, JaxConfig(width=16, height=12, depth=3))

    got = trace_whitted(tpresets.demo_scene(), torch.tensor(np.asarray(o)),
                        torch.tensor(np.asarray(d)), RenderConfig(width=16, height=12, depth=3))
    a, b = got.color.numpy(), np.asarray(ref.color)
    close = np.all(np.abs(a - b) <= 1e-3 + 2e-2 * np.abs(b), axis=-1)
    assert close.mean() >= 0.97, f"only {close.mean():.4f} of pixels agree"
    assert abs(int(got.casts) - int(ref.casts)) <= max(0.01 * int(ref.casts), 16)
    assert int(got.dropped) == 0 and int(ref.dropped) == 0


def test_render_whitted_matches_golden():
    cfg = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
    img, stats = render_whitted(tpresets.demo_scene(), tpresets.demo_camera(), cfg)
    golden = np.load(os.path.join(GOLDEN, "whitted_demo_64x48.npy"))
    a = img.numpy()
    mse = float(np.mean((a.astype(np.float64) - golden) ** 2))
    psnr = 10 * np.log10(float(golden.max()) ** 2 / max(mse, 1e-30))
    bad = (np.abs(a - golden).max(axis=-1) > 0.1).mean()
    assert psnr >= 38.0 and bad <= 0.02, (psnr, bad)
    assert stats["dropped"] == 0 and stats["casts"] > 64 * 48


def _pool(alive, pend, slot):
    k = len(alive)
    f = torch.zeros((11, k))
    f[3:6] = torch.tensor([0.0, -1.0, 0.0])[:, None]  # straight down
    f[0:3] = torch.tensor([0.0, 3.0, 0.0])[:, None]
    f[6:8] = 1.0
    f[8:11] = torch.as_tensor(pend, dtype=torch.float32).t()
    i = torch.zeros((5, k), dtype=torch.int32)
    i[1] = -1
    i[3] = torch.as_tensor(slot, dtype=torch.int32)
    i[4] = torch.as_tensor(alive, dtype=torch.int32)
    return Pool(f, i)


@pytest.mark.parametrize("scene_name", ["demo", "mesh24"])
def test_level_dead_lanes_pass_pending_through(scene_name):
    """A lane that is not alive does no work and gives what a dead TPU tile
    gives (level_pallas.py:98-113), on the dense and on the blocked
    geometry (whose CUDA kernel keeps that contract by flags, not by an
    early return)."""
    scene = tpresets.demo_scene() if scene_name == "demo" else tpresets.mesh_scene(24)[0]
    assert scene.blocked == (scene_name == "mesh24")
    pend = [[0.0, 0.0, 0.0], [0.25, 0.5, 0.75], [1.0, 2.0, 3.0]]
    pool = _pool([1, 0, 0], pend, [5, 6, 7])
    args = (0.001, 100.0, 10)
    for direct in (False, True):
        contrib, rch, fch, casts = level_kernel.process_level_plain(
            scene.geom, scene.textures, pool, False, direct, *args)
        assert int(casts[1]) == 0 and int(casts[2]) == 0 and int(casts[0]) >= 1
        for lane in (1, 2):
            assert torch.all(fch.f[:, lane] == 0) and torch.all(fch.i[:, lane] == 0)
            assert int(rch.i[4, lane]) == 0  # dead
            if direct:
                assert torch.equal(contrib[:, lane], torch.tensor(pend[lane]))
                assert torch.all(rch.f[:, lane] == 0) and int(rch.i[3, lane]) == 0
            else:
                assert torch.all(contrib[:, lane] == 0)
                assert torch.equal(rch.f[8:11, lane], torch.tensor(pend[lane]))
                assert int(rch.i[3, lane]) == 5 + lane
    # the live lane hits the floor below and carries its slot
    assert int(rch.i[3, 0]) == 5 and float(rch.f[1, 0]) < 3.0


def test_blocked_level_of_a_ragged_pool_equals_the_same_lanes_in_a_wider_pool():
    """A pool whose width is no multiple of the kernels' 128-lane blocks (or
    of a warp) gives, lane for lane, what its lanes give inside a wider
    pool: a lane's outputs do not depend on its neighbours, live or dead."""
    scene, cam = tpresets.mesh_scene(24)
    o, d = tshoot(cam, torch.as_tensor(clip_coords(16, 12)))
    pool = _pack_primary(o, d)
    rng = np.random.default_rng(3)
    dead = torch.as_tensor(rng.uniform(size=pool.width) < 0.3)
    pool.i[4, dead] = 0
    pool.f[8:11, dead] = torch.as_tensor(rng.uniform(size=(3, int(dead.sum()))), dtype=torch.float32)
    cut = pool.width - 45  # 147 lanes
    ragged = Pool(pool.f[:, :cut].contiguous(), pool.i[:, :cut].contiguous())
    args = (0.001, 100.0, 10)
    for direct in (True, False):
        wide = level_kernel.process_level_plain(scene.geom, scene.textures, pool, False, direct,
                                                *args)
        part = level_kernel.process_level_plain(scene.geom, scene.textures, ragged, False,
                                                direct, *args)
        assert torch.equal(part[0], wide[0][:, :cut])
        for a, b in ((part[1], wide[1]), (part[2], wide[2])):
            assert torch.equal(a.f, b.f[:, :cut]) and torch.equal(a.i, b.i[:, :cut])
        assert torch.equal(part[3], wide[3][:cut]) and int(wide[3][cut:].sum()) > 0


def test_compaction_keeps_live_and_pending_groups_and_counts_drops():
    k = 64
    alive = np.zeros(k, np.int32)
    pend = np.zeros((k, 3), np.float32)
    alive[[3, 20, 50]] = 1  # groups 0, 2, 6 of 8 lanes
    pend[41, 1] = 0.5  # group 5 only owes radiance
    pool = _pool(alive, pend, np.arange(k))
    out, dropped = _compact(pool, 32, 8)
    assert int(dropped) == 0
    assert out.f.is_contiguous() and out.i.is_contiguous()  # the kernel's layout
    np.testing.assert_array_equal(out.i[3].numpy(), np.r_[0:8, 16:24, 40:48, 48:56])
    out, dropped = _compact(pool, 16, 8)  # room for two groups only
    assert int(dropped) == 2  # the later groups' live / owing lanes
    np.testing.assert_array_equal(out.i[3].numpy(), np.r_[0:8, 16:24])
