"""raytracer_tpu_torch's JSON scene format (scene/serialize.py): the cases of
tests/test_serialize.py, the `bvh` key, and the degenerate scenes of
tests/test_degenerate_scenes.py built from JSON and rendered on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from raytracer_tpu.scene import serialize as jserialize
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import render_distributed_epoch, render_whitted
from raytracer_tpu_torch.scene import builder as tbuilder
from raytracer_tpu_torch.scene.builder import MaterialSpec, SceneBuilder, square
from raytracer_tpu_torch.scene.presets import demo_builder, demo_camera, spheres_scene
from raytracer_tpu_torch.scene.serialize import dump_builder, load_scene_dict, load_scene_file
from raytracer_tpu_torch.scene.types import BVH_FIELDS, SCENE_FIELDS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "assets", "scene_spheres.json")


def test_json_scene_matches_builder_preset():
    scene_j, cam_j = load_scene_file(ASSET, device="cpu")
    scene_b = spheres_scene(device="cpu")
    assert cam_j is not None
    np.testing.assert_allclose(cam_j.center.numpy(), demo_camera(device="cpu").center.numpy())
    assert (scene_j.n_tri, scene_j.n_sph, scene_j.n_light) == (
        scene_b.n_tri, scene_b.n_sph, scene_b.n_light)
    for field in ("sph_c", "tri_v", "mat_diffuse"):
        np.testing.assert_allclose(getattr(scene_j, field).numpy(),
                                   getattr(scene_b, field).numpy(), err_msg=field)
    np.testing.assert_allclose(scene_j.light_color.numpy(), scene_b.light_color.numpy(),
                               atol=1e-6)

    cfg = RenderConfig(width=12, height=8, depth=1, tile_rays=96)
    img_j, _ = render_whitted(scene_j, cam_j, cfg)
    img_b, _ = render_whitted(scene_b, demo_camera(device="cpu"), cfg)
    np.testing.assert_allclose(img_j.numpy(), img_b.numpy(), atol=1e-5, rtol=1e-4)


def test_json_scene_matches_the_jax_loader():
    scene_j, cam_j = load_scene_file(ASSET, device="cpu")
    ref, _, ref_cam = jserialize.load_scene_file(ASSET)
    for field in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(scene_j, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    for k in ("fovy", "center", "toward", "up", "near"):
        np.testing.assert_array_equal(getattr(cam_j, k).numpy(), np.asarray(getattr(ref_cam, k)))


def test_json_scene_obj_and_textures():
    data = {
        "objects": [
            {"material": {"texture": "checker", "shiness": 0.3},
             "spheres": [{"center": [0, 0.5, 0], "radius": 0.5}]},
            {"material": {"diffuse_color": [1, 1, 1], "shiness": 0.1},
             "obj": {"path": os.path.join(REPO, "assets", "dodecahedron.obj"),
                     "scale": 0.5, "offset": [0, 1, 0]}},
        ],
        "lights": [{"type": "directional", "direction": [0, -1, 0], "color": [1, 1, 1]}],
    }
    scene, cam = load_scene_dict(data, device="cpu")
    assert cam is None
    assert scene.n_tri == 36 and scene.n_sph == 1
    assert int(scene.mat_tex[0]) == 2  # checker resolved by name
    # a relative OBJ path is read from the file's directory
    rel = dict(data, objects=[dict(data["objects"][1], obj=dict(
        data["objects"][1]["obj"], path="dodecahedron.obj"))])
    scene_rel, _ = load_scene_dict(rel, base_dir=os.path.join(REPO, "assets"), device="cpu")
    np.testing.assert_array_equal(scene_rel.tri_v.numpy(), scene.tri_v.numpy())


def test_json_scene_errors():
    with pytest.raises(ValueError, match="unknown texture"):
        load_scene_dict({"objects": [{"material": {"texture": "nope"}}]})
    with pytest.raises(ValueError, match="unknown material fields"):
        load_scene_dict({"objects": [{"material": {"glossiness": 1.0}}]})
    with pytest.raises(ValueError, match="unknown light type"):
        load_scene_dict({"lights": [{"type": "area"}]})


def test_dump_load_round_trip():
    b = SceneBuilder()
    b.push_object(MaterialSpec(diffuse_color=(1, 0.8, 0.6), shiness=0.5,
                               smoothness=0.01)).push_triangles(square([
        ((-2, 0, -2), (0, 0)), ((-2, 0, 2), (0, 1)),
        ((2, 0, 2), (1, 0)), ((2, 0, -2), (1, 1)),
    ]))
    b.push_object(MaterialSpec(texture=2, shiness=0.3)).push_sphere((0, 0.5, 0), 0.5)
    b.push_spot_light((0, 10, 0), (0, -1, 0), np.deg2rad(60.0), 1.0, (1, 0.5, 0.9))
    b.push_point_light((0, 0.1, 0), (0.8, 0.8, 1.0))
    scene_a = b.build(device="cpu")

    data = json.loads(json.dumps(dump_builder(b, camera=demo_camera(device="cpu"))))
    scene_b2, cam = load_scene_dict(data, device="cpu")
    assert cam is not None
    for field in ("tri_v", "tri_n", "tri_uv", "sph_c", "sph_r",
                  "mat_diffuse", "mat_tex", "light_color", "light_angle"):
        np.testing.assert_allclose(getattr(scene_a, field).numpy(),
                                   getattr(scene_b2, field).numpy(), atol=1e-6, err_msg=field)


def test_dump_of_the_demo_rebuilds_it_bit_for_bit():
    b = demo_builder()
    data = json.loads(json.dumps(dump_builder(b, camera=demo_camera(device="cpu"))))
    scene, cam = load_scene_dict(data, device="cpu")
    ref = b.build(device="cpu")
    for field in SCENE_FIELDS:
        assert torch.equal(getattr(scene, field), getattr(ref, field)), field
    for k in ("fovy", "center", "toward", "up", "near", "scale"):
        assert torch.equal(getattr(cam, k), getattr(demo_camera(device="cpu"), k)), k


def test_bvh_key_reaches_the_builder(monkeypatch):
    seen = []
    build = tbuilder.SceneBuilder.build

    def spy(self, *args, **kwargs):
        seen.append(kwargs.get("use_bvh"))
        return build(self, *args, **kwargs)

    monkeypatch.setattr(tbuilder.SceneBuilder, "build", spy)
    data = json.loads(json.dumps(dump_builder(demo_builder())))
    for key, blocked in ((None, False), ("auto", False), (True, True), (False, False)):
        d = data if key is None else dict(data, bvh=key)
        scene, _ = load_scene_dict(d, device="cpu")
        assert seen[-1] == ("auto" if key is None else key)
        assert scene.blocked is blocked
        assert all((getattr(scene, f) is not None) is blocked for f in BVH_FIELDS)


LIGHT = [{"type": "directional", "direction": [0, -1, 0], "color": [1, 1, 1]}]
FLOOR = [[[-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2]]]  # face normal +y

# the scenes of tests/test_degenerate_scenes.py, as JSON
DEGENERATE = {
    "spheres": {"objects": [{"material": {"diffuse_color": [1, 0, 0], "shiness": 0.2},
                             "spheres": [{"center": [0, 0.5, 0], "radius": 0.5}]}],
                "lights": LIGHT},
    "tris": {"objects": [{"material": {"diffuse_color": [0, 1, 0], "shiness": 0.3},
                          "squares": FLOOR}],
             "lights": LIGHT},
    "empty": {"lights": LIGHT},
    "glass-sphere": {"objects": [{"material": {
        "diffuse_color": [1, 1, 1], "shiness": 1.0, "smoothness": 0.001,
        "refraction_index": 1.12, "opaque_decay": 0.3, "transparency": 0.96},
        "spheres": [{"center": [0, 0.5, 0], "radius": 0.5}]}],
        "lights": LIGHT},
}


@pytest.mark.parametrize("name", list(DEGENERATE))
def test_degenerate_scenes_render_finite(name):
    scene, _ = load_scene_dict(DEGENERATE[name], device="cpu")
    cfg = RenderConfig(width=10, height=8, depth=3, tile_rays=48)
    img, stats = render_whitted(scene, demo_camera(device="cpu"), cfg)
    photons, est = render_distributed_epoch(scene, demo_camera(device="cpu"), cfg, seed=1)
    assert torch.isfinite(img).all() and torch.isfinite(photons).all()
    assert stats["dropped"] == 0
    if name == "empty":  # sky everywhere: black, every photon filtered
        assert not img.any() and not photons.any()
        assert est["filtered"] == est["primary_rays"] + 16  # a ragged last tile
    else:  # hits: shadow rays or children cast beyond the primaries
        assert stats["casts"] > stats["primary_rays"] and est["casts"] > 96
