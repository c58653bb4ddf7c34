"""The unfused path as a whole: scenes whose textures the fused kernels do
not hold, and scenes with a BVH and no blocked layout.

The slice's vehicle is the demo scene with the same two textures WITHOUT
row forms (textures.host_only): it must route to the unfused path and give
the fused path's image.  Gates: the Whitted frame against the JAX frame as
tests/test_torch_whitted.py (>= 97 % of pixels within 1e-3 + 2e-2 |ref|,
casts within 1 %) and against whitted_demo_64x48.npy (>= 38 dB, <= 2 % of
pixels off by > 0.1); the MC epoch fed the golden's own draws against
mc_demo_64x48.npy, which IS the JAX package's photons pixel for pixel
(>= 99 % of lanes within 1e-3 + 2e-2 |ref|), and against the port's own
fused plain path (same gate, casts within 1 %); the BVH-only route against
whitted_mesh24_64x48.npy (>= 30 dB, <= 1 %); dropped == 0 everywhere.
"""

import dataclasses
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
from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu.scene import textures as jtextures
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import (
    intersect_kernel,
    level_kernel,
    march_kernel,
    materials,
    mc_binned,
    mc_kernel,
)
from raytracer_tpu_torch.ops.distributed import trace_distributed
from raytracer_tpu_torch.ops.trace import fused_ok, trace_whitted
from raytracer_tpu_torch.render import render_distributed_epoch, render_whitted
from raytracer_tpu_torch.scene import presets as tpresets
from raytracer_tpu_torch.scene.convert import from_jax_scene
from raytracer_tpu_torch.scene.textures import (
    DEFAULT_TEXTURES,
    Texture,
    _const_normal,
    host_only,
    kernel_textures_ok,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SMALL = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)

FUSED = {"level": level_kernel.COUNTS, "level_blk": level_kernel.COUNTS_BLK,
         "mc": mc_kernel.COUNTS, "mc_blk": mc_kernel.COUNTS_BLK,
         "binned_primary": mc_binned.COUNTS_PRIMARY}
UNFUSED = {"nearest": intersect_kernel.COUNTS_NEAREST, "any": intersect_kernel.COUNTS_ANY,
           "shadow": intersect_kernel.COUNTS_SHADOW, "march": march_kernel.COUNTS}


def plain_calls():
    """Plain-version calls so far, by wrapper (CPU tensors take them)."""
    return {k: c.plain for k, c in {**FUSED, **UNFUSED}.items()}


def since(before):
    return {k: v - before[k] for k, v in plain_calls().items() if v != before[k]}


def frac_close(a, b):
    return np.all(np.abs(a - b) <= 1e-3 + 2e-2 * np.abs(b), axis=-1).mean()


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(max(float(b.max()), 1e-6) ** 2 / mse) if mse else float("inf")


def gate(img, name):
    g = np.load(os.path.join(GOLDEN, name))
    return psnr(img, g), float((np.abs(img - g).max(axis=-1) > 0.1).mean())


def unfused_demo():
    scene = tpresets.demo_scene(device="cpu")
    return dataclasses.replace(scene, textures=host_only(scene.textures))


def bvh_only_mesh(grid=24):
    scene, cam = tpresets.mesh_scene(grid, device="cpu")
    return dataclasses.replace(scene, blk_perm=None, blk_box=None,
                               textures=host_only(scene.textures)), cam


def golden_draws():
    z = np.load(os.path.join(GOLDEN, "mc_demo_64x48_draws.npz"))
    return [(torch.as_tensor(z["normals"]), torch.as_tensor(z["unifs"]))]


def test_kernel_textures_ok_is_identity_of_the_row_functions():
    assert kernel_textures_ok(DEFAULT_TEXTURES)
    assert kernel_textures_ok(tuple(dataclasses.replace(t, name="x") for t in DEFAULT_TEXTURES))
    assert not kernel_textures_ok(host_only(DEFAULT_TEXTURES))
    assert not kernel_textures_ok(DEFAULT_TEXTURES[:2])
    same_name = Texture("stripes", diffuse=DEFAULT_TEXTURES[1].diffuse, normal=_const_normal,
                        diffuse_rows=lambda u, v: (u, u, u),
                        normal_rows=DEFAULT_TEXTURES[1].normal_rows)
    assert not kernel_textures_ok((DEFAULT_TEXTURES[0], same_name, DEFAULT_TEXTURES[2]))


def test_routing():
    """Fused iff dense or blocked, with a primitive, and the kernels' own
    textures (trace.py:383-394, distributed.py:112-114)."""
    demo = tpresets.demo_scene(device="cpu")
    mesh, _ = tpresets.mesh_scene(8, device="cpu")
    assert fused_ok(demo) and fused_ok(mesh) and mesh.blocked
    assert not fused_ok(unfused_demo())
    bvh, _ = bvh_only_mesh(8)
    assert not bvh.blocked and bvh.bvh_node_min is not None and not fused_ok(bvh)
    assert not fused_ok(dataclasses.replace(mesh, blk_perm=None, blk_box=None))

    cfg = RenderConfig(width=16, height=12, depth=2, tile_rays=16 * 12)
    cam = tpresets.demo_camera(device="cpu")
    before = plain_calls()
    render_whitted(demo, cam, cfg)
    assert since(before) == {"level": 3}
    before = plain_calls()
    render_whitted(unfused_demo(), cam, cfg)
    # per level a cast, a shade and (but for the last level) a march
    assert since(before) == {"nearest": 3, "shadow": 3, "march": 2}
    before = plain_calls()
    render_whitted(mesh, tpresets.mesh_scene(8, device="cpu")[1], cfg)
    assert since(before) == {"level_blk": 3}
    before = plain_calls()
    stats = render_whitted(bvh, tpresets.mesh_scene(8, device="cpu")[1], cfg)[1]
    assert since(before) == {} and stats["casts"] > 16 * 12  # the BVH route, no dense sweep

    unifs = torch.rand((2, 3, 16 * 12), generator=torch.Generator().manual_seed(0))
    unifs[:, 2] = unifs[:, 2] * (2 * np.pi) - np.pi
    o = torch.zeros((16 * 12, 3)) + torch.tensor([0.5, 3.0, 0.5])
    d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(16 * 12, 1)
    before = plain_calls()
    trace_distributed(demo, o, d, unifs, cfg)
    assert since(before) == {"mc": 1}
    before = plain_calls()
    trace_distributed(unfused_demo(), o, d, unifs, cfg)
    # primary + per bounce an advance cast, a march and a merged shade +
    # the terminal shade
    assert since(before) == {"nearest": 3, "march": 2, "shadow": 3}


def test_unfused_whitted_matches_jax_trace_whitted():
    jscene, jtex = jpresets.demo_scene()
    jtex = tuple(dataclasses.replace(t, diffuse_rows=None, normal_rows=None) for t in jtex)
    o, d = shoot(jpresets.demo_camera(), jnp.asarray(clip_coords(16, 12)))
    run = jax.jit(jax_trace_whitted, static_argnums=(1, 4))
    ref = run(jscene, jtex, o, d, JaxConfig(width=16, height=12, depth=3))

    before = plain_calls()
    got = trace_whitted(unfused_demo(), torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
                        RenderConfig(width=16, height=12, depth=3))
    assert since(before) == {"nearest": 4, "shadow": 4, "march": 3}
    a, b = got.color.numpy(), np.asarray(ref.color)
    assert frac_close(a, b) >= 0.97, frac_close(a, b)
    assert abs(int(got.casts) - int(ref.casts)) <= max(0.01 * int(ref.casts), 16)
    assert int(got.dropped) == 0 and int(ref.dropped) == 0


def test_unfused_whitted_golden_and_fused_frame():
    cam = tpresets.demo_camera(device="cpu")
    img, stats = render_whitted(unfused_demo(), cam, SMALL)
    p, bad = gate(img.numpy(), "whitted_demo_64x48.npy")
    assert p >= 38.0 and bad <= 0.02, (p, bad)
    assert stats["dropped"] == 0
    fused, fstats = render_whitted(tpresets.demo_scene(device="cpu"), cam, SMALL)
    assert frac_close(img.numpy(), fused.numpy()) >= 0.97
    # both routes count the same rays; here both run their plain versions
    assert abs(stats["casts"] - fstats["casts"]) <= 0.01 * fstats["casts"]


def test_unfused_mc_epoch_matches_jax_photons_and_fused_path():
    cam = tpresets.demo_camera(device="cpu")
    img, stats = render_distributed_epoch(unfused_demo(), cam, SMALL, draws=golden_draws())
    golden = np.load(os.path.join(GOLDEN, "mc_demo_64x48.npy"))
    a = img.numpy().reshape(-1, 3)
    assert frac_close(a, golden.reshape(-1, 3)) >= 0.99
    p, bad = gate(img.numpy(), "mc_demo_64x48.npy")
    assert p >= 25.0 and bad <= 0.01, (p, bad)
    fused, fstats = render_distributed_epoch(tpresets.demo_scene(device="cpu"), cam, SMALL,
                                             draws=golden_draws())
    assert frac_close(a, fused.numpy().reshape(-1, 3)) >= 0.99
    assert abs(stats["casts"] - fstats["casts"]) <= 0.01 * fstats["casts"]
    assert abs(stats["filtered"] - fstats["filtered"]) <= 0.02 * 64 * 48


def test_bvh_only_route_matches_golden_and_blocked_frame():
    scene, cam = bvh_only_mesh(24)
    before = plain_calls()
    img, stats = render_whitted(scene, cam, SMALL)
    assert since(before) == {}  # neither a fused level nor a dense sweep
    p, bad = gate(img.numpy(), "whitted_mesh24_64x48.npy")
    assert p >= 30.0 and bad <= 0.01, (p, bad)
    assert stats["dropped"] == 0
    cfg = RenderConfig(width=31, height=23, depth=5, tile_rays=31 * 23)
    img, stats = render_whitted(scene, cam, cfg)
    blocked, bstats = render_whitted(tpresets.mesh_scene(24, device="cpu")[0], cam, cfg)
    assert frac_close(img.numpy(), blocked.numpy()) >= 0.97
    assert stats["dropped"] == 0
    assert abs(stats["casts"] - bstats["casts"]) <= 0.01 * bstats["casts"]


def test_bvh_only_mc_epoch_matches_blocked_path():
    scene, cam = bvh_only_mesh(24)
    cfg = RenderConfig(width=32, height=24, depth=3, tile_rays=32 * 24)
    draws = [(n[:768], u[:3, :, :768].contiguous()) for n, u in golden_draws()]
    img, stats = render_distributed_epoch(scene, cam, cfg, draws=draws)
    ref, rstats = render_distributed_epoch(tpresets.mesh_scene(24, device="cpu")[0], cam, cfg, draws=draws)
    assert frac_close(img.numpy().reshape(-1, 3), ref.numpy().reshape(-1, 3)) >= 0.99
    assert abs(stats["casts"] - rstats["casts"]) <= 0.01 * rstats["casts"]
    assert float(img.max()) > 0


def test_texture_that_shares_a_defaults_name_renders_its_own_function():
    """A user texture named "stripes" with another function: the fused
    kernels' built-in switch would paint the demo's stripes, so the scene
    takes the unfused path and the wall shows the user's colour."""
    green = lambda uv: torch.tensor([0.0, 1.0, 0.0]).expand(uv.shape[0], 3)
    mine = Texture("stripes", diffuse=green, normal=_const_normal,
                   diffuse_rows=lambda u, v: (torch.zeros_like(u), torch.ones_like(u),
                                              torch.zeros_like(u)),
                   normal_rows=DEFAULT_TEXTURES[2].normal_rows)
    demo = tpresets.demo_scene(device="cpu")
    scene = dataclasses.replace(demo, textures=(demo.textures[0], mine, demo.textures[2]))
    assert [t.name for t in scene.textures] == [t.name for t in demo.textures]
    assert not fused_ok(scene)

    wall = int(torch.nonzero(demo.mat_tex == 1)[0])
    mat = materials.eval_material(scene, scene.textures, torch.tensor([wall], dtype=torch.int32),
                                  torch.tensor([[0.3, 0.26]]))
    assert mat.diffuse.tolist() == [[0.0, 1.0, 0.0]] and mat.normal.tolist() == [[0.0, 0.0, 1.0]]

    cfg = RenderConfig(width=32, height=24, depth=1, tile_rays=32 * 24)
    cam = tpresets.demo_camera(device="cpu")
    before = plain_calls()
    img, _ = render_whitted(scene, cam, cfg)
    assert since(before) == {"nearest": 2, "shadow": 2, "march": 1}
    ref, _ = render_whitted(demo, cam, cfg)
    changed = (img - ref).abs().amax(dim=-1) > 0.05
    assert 0.02 < float(changed.float().mean()) < 0.5  # the wall, not the whole frame
    # where it changed, the wall lost its red and blue
    assert float(img[changed][:, 1].mean()) > 2 * float(img[changed][:, 0].mean())


def test_from_jax_scene_carries_host_textures_and_checks_ids():
    jscene, _ = jpresets.demo_scene()
    fields = {f.name: np.asarray(getattr(jscene, f.name)) for f in dataclasses.fields(jscene)
              if isinstance(getattr(jscene, f.name), jnp.ndarray)}
    scene = from_jax_scene(fields, textures=host_only(DEFAULT_TEXTURES))
    assert not fused_ok(scene) and fused_ok(from_jax_scene(fields))
    assert [t.name for t in scene.textures] == [t.name for t in jtextures.DEFAULT_TEXTURES]
    assert scene.mat_tex.tolist() == np.asarray(jscene.mat_tex).tolist()
    with pytest.raises(ValueError, match="mat_tex names texture 2"):
        from_jax_scene(fields, textures=DEFAULT_TEXTURES[:2])
