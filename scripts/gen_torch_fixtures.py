#!/usr/bin/env python
"""Write the MC draws fixture for the PyTorch/CUDA port's golden checks.

tests/golden/mc_demo_64x48.npy is one stochastic epoch of the demo scene at
64x48, depth 5, tile_rays 3072 (one tile), key PRNGKey(7)
(scripts/tpu_check.py render_mc).  This script draws exactly the random
numbers that epoch consumed — the lens normals and the per-bounce uniforms,
as raytracer_tpu/render.py:82-88 and ops/distributed.py:96-107 draw them
for tile 0, in the tile's (32x16 block-major) lane order — and saves them
to tests/golden/mc_demo_64x48_draws.npz.  raytracer_tpu_torch can then be
held against the JAX golden lane for lane with no JAX at hand.

Before writing, it re-renders the JAX epoch at that key on the CPU and
checks that it still equals the committed golden.

    python scripts/gen_torch_fixtures.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GOLDEN = os.path.join(ROOT, "tests", "golden", "mc_demo_64x48.npy")
OUT = os.path.join(ROOT, "tests", "golden", "mc_demo_64x48_draws.npz")
W, H, DEPTH, KEY = 64, 48, 5, 7


def jax_draws():
    """(lens normals [3072, 2], unifs [depth, 3, 3072]) for tile 0."""
    import jax
    import jax.numpy as jnp

    n = W * H
    tkey = jax.random.fold_in(jax.random.PRNGKey(KEY), jnp.int32(0))
    k_lens, k_path = jax.random.split(tkey)
    normals = jax.random.normal(k_lens, (n, 2), jnp.float32)
    draws = []
    for step in range(DEPTH):
        k_sel, k_phi, k_theta = jax.random.split(jax.random.fold_in(k_path, step), 3)
        draws.append(jnp.stack([
            jax.random.uniform(k_sel, (n,), jnp.float32),
            jax.random.uniform(k_phi, (n,), jnp.float32),
            jax.random.uniform(k_theta, (n,), jnp.float32,
                               minval=-np.pi, maxval=np.pi),
        ]))
    return np.asarray(normals), np.asarray(jnp.stack(draws))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from raytracer_tpu.config import RenderConfig
    from raytracer_tpu.render import render_distributed_epoch
    from raytracer_tpu.scene.presets import demo_camera, demo_scene

    scene, textures = demo_scene()
    cfg = RenderConfig(width=W, height=H, depth=DEPTH, tile_rays=W * H)
    img, _ = render_distributed_epoch(scene, textures, demo_camera(), cfg,
                                      jax.random.PRNGKey(KEY))
    golden = np.load(GOLDEN)
    if not np.array_equal(np.asarray(img), golden):
        raise SystemExit(f"JAX epoch at PRNGKey({KEY}) no longer equals {GOLDEN}")
    normals, unifs = jax_draws()
    np.savez(OUT, normals=normals, unifs=unifs)
    print(f"wrote {OUT}: normals {normals.shape}, unifs {unifs.shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
