"""raytracer_tpu_torch scene, camera and pixel layout against raytracer_tpu.

The port builds the demo scene without JAX; here it is held field by field
against the JAX package's build carried across with from_jax_scene, and
the camera / clip / block-order helpers against their JAX counterparts on
numpy-seeded inputs.
"""

import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu import render as jrender
from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.ops import camera as jcamera
from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu.scene.geometry import write_dodecahedron_obj as jax_write_dodecahedron_obj
from raytracer_tpu.utils import vec as jax_vec
from raytracer_tpu.utils.obj import load_obj_triangles as jax_load_obj
from raytracer_tpu_torch import render as trender
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import camera as tcamera
from raytracer_tpu_torch.scene import presets as tpresets
from raytracer_tpu_torch.scene.builder import MaterialSpec, SceneBuilder, square
from raytracer_tpu_torch.scene.convert import from_jax_camera, from_jax_scene
from raytracer_tpu_torch.scene.types import BVH_FIELDS, SCENE_FIELDS
from raytracer_tpu_torch.scene.geometry import write_dodecahedron_obj
from raytracer_tpu_torch.utils import vec as tvec
from raytracer_tpu_torch.utils.obj import load_obj_triangles

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "raytracer_tpu_torch")


def jax_scene_fields(scene):
    return {f.name: np.asarray(getattr(scene, f.name))
            for f in dataclasses.fields(scene)
            if isinstance(getattr(scene, f.name), jnp.ndarray)}


def test_demo_scene_matches_jax_field_by_field():
    jscene, _ = jpresets.demo_scene()
    ref = from_jax_scene(jax_scene_fields(jscene))
    got = tpresets.demo_scene(device="cpu")
    assert [t.name for t in got.textures] == ["const", "stripes", "checker"]
    for name in SCENE_FIELDS:
        a, b = getattr(got, name).numpy(), getattr(ref, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=name)
    assert (got.n_tri, got.n_sph, got.n_obj, got.n_light) == (64, 4, 9, 3)


def test_obj_loader_matches_jax():
    path = os.path.join(ROOT, "assets", "dodecahedron.obj")
    got = load_obj_triangles(path)
    ref = jax_load_obj(path)
    assert len(got) == len(ref) > 0
    for tg, tr in zip(got, ref):
        for vg, vr in zip(tg, tr):
            np.testing.assert_array_equal(vg.position, vr.position)
            np.testing.assert_allclose(vg.normal, vr.normal, atol=1e-7)


def test_builder_builds_bvh_and_blocked_layout_from_512_triangles():
    quad = square([((0, 0, 0), (0, 0)), ((1, 0, 0), (0, 1)),
                   ((1, 0, 1), (1, 0)), ((0, 0, 1), (0, 1))])
    for copies, blocked in ((255, False), (256, True)):  # 510 / 512 triangles
        b = SceneBuilder()
        b.push_object(MaterialSpec()).push_triangles(quad * copies)
        scene = b.build(device="cpu")
        assert scene.blocked is blocked
        assert all((getattr(scene, f) is not None) is blocked for f in BVH_FIELDS)
    assert scene.blk_perm.shape[0] == scene.blk_box.shape[0] * 128 == 8 * 128
    assert not b.build(use_bvh=False, device="cpu").blocked
    moved = scene.to("meta")
    assert all(getattr(moved, f).device.type == "meta" for f in BVH_FIELDS)


def test_config_defaults_match_jax():
    got, ref = RenderConfig(), JaxConfig()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


def test_camera_shoot_matches_jax():
    jcam = jpresets.demo_camera()
    cam = from_jax_camera(*(np.asarray(getattr(jcam, k))
                            for k in ("fovy", "center", "toward", "up", "near")))
    own = tpresets.demo_camera(device="cpu")
    for k in ("fovy", "center", "toward", "up", "near"):
        np.testing.assert_allclose(getattr(own, k).numpy(), getattr(cam, k).numpy(),
                                   atol=1e-7)
    rng = np.random.default_rng(0)
    clip = rng.uniform(-0.7, 0.7, size=(500, 2)).astype(np.float32)
    offs = (rng.normal(size=(500, 2)) * 0.04).astype(np.float32)
    o_ref, d_ref = jcamera.shoot(jcam, jnp.asarray(clip))
    o, d = tcamera.shoot(own, torch.as_tensor(clip))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-6)
    o_ref, d_ref = jcamera.shoot_focus(jcam, jnp.asarray(clip), jnp.asarray(offs), 3.0)
    o, d = tcamera.shoot_focus(own, torch.as_tensor(clip), torch.as_tensor(offs), 3.0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-6)


@pytest.mark.parametrize("which,bits", [("demo", 0x3F13CD3B), ("mesh", 0x3F0543E2)])
def test_camera_scale_is_pinned_to_the_goldens_tan(which, bits):
    """Camera.scale is tan(fovy / 2) as the committed goldens were rendered:
    0.57735032 at the demo's 60 degrees, one ulp above the correctly
    rounded tan that torch gives.  It comes from the host C library's tanf
    (utils/vec.tanf), so a C library that rounds otherwise fails here by
    name.  It is derived from fovy, never passed, and moves with the
    camera."""
    if which == "demo":
        own, jcam = tpresets.demo_camera(device="cpu"), jpresets.demo_camera()
    else:
        own, jcam = tpresets.mesh_scene(2, device="cpu")[1], jpresets.mesh_scene(2)[2]
    assert int(own.scale.numpy().view(np.uint32)) == bits
    ref = np.asarray(jnp.tan(jcam.fovy / 2.0), np.float32)
    assert own.scale.numpy().view(np.uint32) == ref.view(np.uint32)
    assert "scale" not in {f.name for f in dataclasses.fields(own) if f.init}
    assert torch.equal(own.to("cpu").scale, own.scale)


def test_camera_scale_matches_jax_at_every_whole_degree():
    """utils/vec.tanf against the JAX package's jnp.tan at every whole-degree
    fovy, where torch's tan differs at some."""
    degrees = np.arange(1, 180, dtype=np.float64)
    fovy = np.deg2rad(degrees).astype(np.float32)  # as both Camera.create round it
    ref = np.asarray(jnp.tan(jnp.asarray(fovy) / 2.0), np.float32)
    got = np.array([tpresets.Camera.create(deg, (0, 0, 0), (0, 0, -1), (0, 1, 0), 0.0,
                                           device="cpu").scale for deg in degrees],
                   np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("wh", [(64, 48), (37, 29), (1280, 960)])
def test_clip_coords_and_block_order_match_jax(wh):
    w, h = wh
    np.testing.assert_array_equal(trender.clip_coords(w, h), jrender.clip_coords(w, h))
    np.testing.assert_array_equal(trender._block_perm(w, h), jrender._block_perm(w, h))


def test_tiled_clips_are_block_major_with_centre_padding():
    cfg = RenderConfig(width=40, height=20, tile_rays=256)
    clips, inv = trender._clips(cfg, "cpu")
    assert tuple(clips.shape) == (4, 256, 2)  # 800 pixels -> 4 tiles
    flat = clips.reshape(-1, 2)
    np.testing.assert_array_equal(flat[800:].numpy(), 0.0)
    np.testing.assert_array_equal(flat[:800][inv].numpy(), trender.clip_coords(40, 20))


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_write_dodecahedron_obj_writes_the_jax_bytes(tmp_path):
    ours, theirs = tmp_path / "t.obj", tmp_path / "j.obj"
    write_dodecahedron_obj(str(ours))
    jax_write_dodecahedron_obj(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(load_obj_triangles(str(ours))) == 36


def test_cross_and_normalize_safe_match_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=(257, 3)).astype(np.float32) for _ in range(2))
    a[0] = 0.0  # a zero vector: 0 / eps, not a NaN
    np.testing.assert_array_equal(tvec.cross(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                                  np.asarray(jax_vec.cross(jnp.asarray(a), jnp.asarray(b))))
    # XLA's norm and division round an ulp apart from torch's on some rows
    for eps in (0.0, 1e-3):
        got = tvec.normalize_safe(torch.as_tensor(a[1:] if eps == 0.0 else a), eps).numpy()
        want = np.asarray(jax_vec.normalize_safe(jnp.asarray(a[1:] if eps == 0.0 else a), eps))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert not np.isnan(tvec.normalize_safe(torch.as_tensor(a), 1e-3).numpy()).any()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Static scan: the card has no JAX, and importing any raytracer_tpu
    module imports jax (raytracer_tpu/__init__.py)."""
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    files += [os.path.join(ROOT, "chip_smoke.py"),
              os.path.join(ROOT, "scripts", "psnr_torch_vs_reference.py"),
              os.path.join(ROOT, "scripts", "bench_torch_mesh.py")]
    assert len(files) > 15 and os.path.join(PKG, "parallel", "mesh.py") in files
    assert os.path.join(PKG, "bench.py") in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "raytracer_tpu"), (path, mod)
