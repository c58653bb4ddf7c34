"""The port's MC walk (plain version) against raytracer_tpu.

JAX's own draws are handed to the port, so both walk the same random
decisions; they may differ only where f32 op order flips a branch
(roulette / TIR boundaries, near-tie winners), which can decorrelate an
isolated lane.  Gates as tests/test_mc_pallas.py: >= 99 % of lanes within
1e-3 + 2e-2 |ref|, casts within 1 %, filtered within 2 % of N.
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
from raytracer_tpu.scene.presets import demo_camera, demo_scene
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import mc_kernel
from raytracer_tpu_torch.ops.distributed import trace_distributed
from raytracer_tpu_torch.render import render_distributed_epoch, tile_draws
from raytracer_tpu_torch.scene import presets as tpresets

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
    got = trace_distributed(tpresets.demo_scene(), torch.tensor(np.asarray(o)),
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
        tpresets.demo_scene(), tpresets.demo_camera(), cfg,
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
    scene = tpresets.demo_scene()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(4, 1)
    unifs = torch.full((2, 3, 4), 0.5)
    before = mc_kernel.COUNTS.plain
    photon, casts = mc_kernel.trace(scene, o, d, unifs, 2, 100.0, 10)
    assert mc_kernel.COUNTS.plain == before + 1 and tuple(photon.shape) == (4, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        mc_kernel.trace(scene, o.to("meta"), d.to("meta"), unifs.to("meta"), 2, 100.0, 10)
