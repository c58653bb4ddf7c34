"""SPD `rings` (`spd-rings`, scene/presets.spd_rings_scene): spheres joined by
cylinders, the NFF cones of the port's scene, on the CPU's plain path.

The construction's published counts and rings; the benchmark's scene file
giving the preset's tables bit for bit; the plain path's cone test against
the benchmark's plain reference (benchmark/reference/world.py `_cone`) on
rays chosen to reach its corners; the plain MC walk and Whitted frame at
size factor 1 against the reference with the cells' tolerances; the
counter `mc.cone_tests` against a hand count; the routes that cast no cone
refusing a scene with cones; the JSON scene format's cones; the CLI taking
the preset's own camera.  On a card (the `card` tests, which skip without
one): the kernels' hits, photons and cone counts against the plain path's,
and the Whitted frame at 512x512 against the reference."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu_torch import cli
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import distributed, intersect, kernel_common as kc
from raytracer_tpu_torch.ops import level_kernel, march_kernel, mc_binned, mc_kernel
from raytracer_tpu_torch.render import render_whitted
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.builder import BVH_MIN_TRIS, MaterialSpec, SceneBuilder, triangle
from raytracer_tpu_torch.scene.serialize import dump_builder, load_scene_dict
from raytracer_tpu_torch.scene.types import FACE_BACK, FACE_BOTH, FACE_FRONT, Rays
from raytracer_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import frame, world  # noqa: E402
from rtbench import scenes  # noqa: E402

torch.set_num_threads(2)


def _f32(x) -> float:
    return float(np.format_float_scientific(np.float32(x), unique=True))


def _v(a):
    return [_f32(x) for x in np.asarray(a, np.float64).reshape(-1)]


def _material(m: MaterialSpec) -> dict:
    return {"diffuse_color": _v(m.diffuse_color), "shiness": _f32(m.shiness),
            "specular_color": _v(m.specular_color), "smoothness": _f32(m.smoothness),
            "transparency": _f32(m.transparency), "refraction_index": _f32(m.refraction_index),
            "opaque_decay": _f32(m.opaque_decay), "normal": _v(m.normal), "texture": None}


def spd_rings_data(size_factor: int) -> dict:
    """The preset as the benchmark's scene data (rtbench/scenes.py's format)."""
    centres = presets.spd_rings_centres(size_factor)
    unit = presets.spd_rings_unit()
    h, z = 40.0, float(centres[:, 2].min()) - 1.5
    r_s, r_c = presets.SPD_RINGS_SPHERE_R, presets.SPD_RINGS_CYLINDER_R
    eye, at = presets.spd_rings_view(size_factor)
    return {
        "objects": [
            {"material": _material(presets.SPD_RINGS_FLOOR),
             "squares": [{"p": [_v((-h, -h, z)), _v((h, -h, z)), _v((h, h, z)), _v((-h, h, z))],
                          "uv": [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]}]},
            {"material": _material(presets.SPD_RINGS_SPHERE),
             "spheres": [{"center": _v(c + p), "radius": _f32(r_s)}
                         for c in centres for ring in unit for p in ring]},
            {"material": _material(presets.SPD_RINGS_CYLINDER),
             "cones": [{"base": _v(c + ring[k]), "base_radius": _f32(r_c),
                        "apex": _v(c + ring[(k + 1) % 5]), "apex_radius": _f32(r_c)}
                       for c in centres for ring in unit for k in range(5)]},
        ],
        "lights": [{"type": "point", "origin": list(o), "color": _v(np.full(3, 1 / math.sqrt(3)))}
                   for o in presets.SPD_RINGS_LIGHTS],
        "camera": {"fovy_deg": presets.SPD_BALLS_FOVY_DEG, "center": eye.tolist(),
                   "toward_unnormalized": (at - eye).tolist(), "up": [0.0, 0.0, 1.0],
                   "near": 0.0},
    }


def _same(a, b):
    for name in ("tri_v", "tri_n", "tri_uv", "tri_obj", "tri_fn", "sph_c", "sph_r", "sph_obj",
                 "cone_base", "cone_base_r", "cone_apex", "cone_apex_r", "cone_obj",
                 "mat_diffuse", "mat_shiness", "mat_smoothness", "light_origin", "light_color",
                 "sph_perm", "sph_box", "fovy", "center", "toward", "up", "near", "scale"):
        x, y = getattr(a, name, None), getattr(b, name, None)
        if x is None and y is None:
            continue
        assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y), name


def _limit(cell: str, name: str) -> float:
    with open(os.path.join(BENCH, "limits", f"{cell}.json")) as f:
        return json.load(f)[name]["limit"]


# ---- the construction -------------------------------------------------------


def test_size_factor_7_has_the_published_counts():
    scene, cam = presets.spd_rings_scene(device="cpu")
    assert (scene.n_tri, scene.n_sph, scene.n_cone, scene.n_light) == (2, 4200, 4200, 3)
    assert scene.bvh_node_min is None and scene.sph_perm is not None  # dense, gated spheres
    assert torch.equal(scene.cone_base_r, scene.cone_apex_r)  # cylinders
    assert scene.sph_obj.unique().tolist() == [1] and scene.cone_obj.unique().tolist() == [2]
    assert float(cam.near) == 0.0 and cam.up.tolist() == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("size_factor", [1, 2, 3])
def test_the_size_factor_formula(size_factor):
    """SF (SF + 1) (2 SF + 1) / 6 units of 30 spheres and 30 cylinders, in
    SF layers of 1, 4, 9, ... units."""
    sf = size_factor
    units = sf * (sf + 1) * (2 * sf + 1) // 6
    b = presets.spd_rings_builder(sf)
    assert (len(b._spheres), len(b._cones), len(b._triangles)) == (30 * units, 30 * units, 2)
    z = presets.spd_rings_centres(sf)[:, 2]
    assert [int(n) for n in np.unique(np.round(z, 9), return_counts=True)[1][::-1]] == [
        (i + 1) ** 2 for i in range(sf)]


def test_six_pentagonal_rings_share_the_dodecahedrons_edge_midpoints():
    unit = presets.spd_rings_unit()
    assert unit.shape == (6, 5, 3)
    flat = unit.reshape(30, 3)
    np.testing.assert_allclose(np.linalg.norm(flat, axis=1), 1.0, rtol=1e-14)
    gaps = np.linalg.norm(flat[:, None] - flat[None], axis=-1) + np.eye(30)
    assert gaps.min() > 0.6  # 30 distinct points, 2 sin(18 deg) apart at least
    for ring in unit:  # a regular pentagon on a great circle
        side = np.linalg.norm(ring - np.roll(ring, -1, axis=0), axis=1)
        np.testing.assert_allclose(side, 2 * math.sin(math.pi / 5), rtol=1e-12)
        np.testing.assert_allclose(ring.sum(axis=0), 0.0, atol=1e-12)


def test_every_cylinder_joins_two_consecutive_spheres_of_its_ring():
    scene, _ = presets.spd_rings_scene(2, device="cpu")
    c = scene.sph_c.reshape(-1, 5, 3)  # ring by ring
    base, apex = scene.cone_base.reshape(-1, 5, 3), scene.cone_apex.reshape(-1, 5, 3)
    assert base.shape == c.shape
    # a unit lists its 30 spheres, then its 30 cylinders, ring by ring
    assert torch.equal(base, c) and torch.equal(apex, torch.roll(c, -1, dims=1))
    assert torch.all(scene.cone_base_r == np.float32(presets.SPD_RINGS_CYLINDER_R))
    assert torch.all(scene.sph_r == np.float32(presets.SPD_RINGS_SPHERE_R))


def test_the_benchmark_scene_file_is_the_preset_bit_for_bit():
    with open(os.path.join(BENCH, "scenes", "spd-rings.json")) as f:
        data = json.load(f)
    want = spd_rings_data(7)
    assert data["objects"] == want["objects"] and data["lights"] == want["lights"]
    assert data["camera"] == want["camera"]
    scene, cam = scenes.program_scene(scenes.parse(data), "cpu", use_bvh=False)
    ref_scene, ref_cam = presets.spd_rings_scene(device="cpu")
    _same(scene, ref_scene)
    _same(cam, ref_cam)


# ---- the cone test against the reference's ---------------------------------


def one_cone(base, r0, apex, r1):
    """A RawScene of one cone (id 0) and the port's Scene of it."""
    raw = scenes.parse({
        "objects": [{"cones": [{"base": base, "base_radius": r0, "apex": apex,
                                "apex_radius": r1}]}],
        "lights": [], "camera": {"fovy_deg": 60.0, "center": [0.0, 0.0, 5.0],
                                 "toward_unnormalized": [0.0, 0.0, -1.0], "up": [0.0, 1.0, 0.0],
                                 "near": 0.0}})
    return raw, scenes.program_scene(raw, "cpu")[0]


# (name, cone, origin, direction, face, excluded, what the reference gives)
CASES = [
    ("cylinder", ((0, 0, 0), 0.5, (0, 0, 2), 0.5), (2.0, 0.1, 1.0), (-1.0, 0.0, 0.0), FACE_FRONT,
     -1, "front"),
    ("truncated", ((0, 0, 0), 0.6, (0, 0, 2), 0.2), (2.0, 0.0, 0.5), (-1.0, 0.0, 0.1), FACE_FRONT,
     -1, "front"),
    ("true cone", ((0, 0, 0), 0.0, (0, 0, 1.5), 0.7), (1.5, 0.3, 1.2), (-1.0, -0.1, 0.0),
     FACE_FRONT, -1, "front"),
    ("inside after exclusion", ((0, 0, 0), 0.5, (0, 0, 2), 0.5), (0.5, 0.0, 1.0),
     (-1.0, 0.0, 0.0), FACE_BACK, 0, "back"),
    ("along the axis", ((0, 0, 0), 0.5, (0, 0, 2), 0.5), (0.0, 0.0, 5.0), (0.0, 0.0, -1.0),
     FACE_FRONT, -1, "miss"),
    ("grazing", ((0, 0, 0), 0.5, (0, 0, 2), 0.5), (2.0, 0.5, 1.0), (-1.0, 0.0, 0.0), FACE_FRONT,
     -1, None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_cone_test_is_the_references(case):
    """The plain path's candidate (t, face) of one cone against world.py's
    `_cone` at float32, with the exclusion of the ray's own cone on the face
    a shadow ray or a reflection excludes."""
    _, cone, o, d, face, excl, want = case
    raw, scene = one_cone(*cone)
    d = np.asarray(d) / np.linalg.norm(d)
    ot = tuple(torch.tensor([x], dtype=torch.float32) for x in o)
    dt = tuple(torch.tensor([x], dtype=torch.float32) for x in d)
    f = torch.tensor([face], dtype=torch.int32)
    ex = torch.tensor([excl], dtype=torch.int32)
    ex_face = torch.tensor([FACE_BACK if face == FACE_FRONT else FACE_FRONT], dtype=torch.int32)
    t, back = kc._cone_candidates(ot, dt, f, ex, ex_face, torch.ones(1, dtype=torch.bool),
                                  scene.tables)
    w = world.World(raw, "cpu")
    rt, rback = w._cone(torch.stack(ot, 1), torch.stack(dt, 1), f.long(), ex.long(),
                        ex_face.long(), 0, 1)
    hit = float(t[0, 0]) < kc.BIG
    assert hit == bool(torch.isfinite(rt[0, 0]))
    if want is not None:
        assert hit == (want != "miss")
    if hit:
        assert float(t[0, 0]) == pytest.approx(float(rt[0, 0]), rel=1e-6)
        assert bool(back[0, 0]) == bool(rback[0, 0]) == (want == "back")


def test_a_ray_leaving_an_open_cylinder_meets_its_inside():
    """From a point on the outside of an open cylinder, along -x into it, a
    ray of either face that excludes its own cone's front drops that root
    alone and meets the far wall's inside at t = 1, as the reference does."""
    raw, scene = one_cone((0, 0, 0), 0.5, (0, 0, 2), 0.5)
    o = (torch.tensor([0.5]), torch.tensor([0.0]), torch.tensor([1.0]))
    d = (torch.tensor([-1.0]), torch.tensor([0.0]), torch.tensor([0.0]))
    i32 = lambda v: torch.tensor([v], dtype=torch.int32)
    h = kc.full_sweep(o, d, i32(FACE_BOTH), i32(0), i32(FACE_FRONT),
                      torch.ones(1, dtype=torch.bool), scene.tables)
    assert bool(h["valid"][0]) and bool(h["backface"][0]) and int(h["prim"][0]) == 0
    assert float(h["t"][0]) == pytest.approx(1.0, abs=1e-6)
    assert float(h["nx"][0]) == pytest.approx(1.0, abs=1e-6)  # the inside faces +x there
    ref = world.World(raw, "cpu").cast(torch.stack(o, 1), torch.stack(d, 1),
                                       torch.tensor([FACE_BOTH]), torch.tensor([0]),
                                       torch.tensor([FACE_FRONT]))
    assert bool(ref.valid[0]) and bool(ref.backface[0])
    assert float(ref.t[0]) == pytest.approx(float(h["t"][0]), rel=1e-6)


# ---- the plain path against the reference at size factor 1 -----------------


@pytest.fixture(scope="module")
def sf1():
    raw = scenes.parse(spd_rings_data(1))
    scene, camera = scenes.program_scene(raw, "cpu", use_bvh=False)
    _same(scene, presets.spd_rings_scene(1, device="cpu")[0])
    return raw, scene, camera


def test_plain_mc_walk_at_size_factor_1_matches_the_reference(sf1):
    """32x32, seeded draws (the timed path's, worked out by the reference's
    frame.pixel_draws), the cell's tolerances (1e-3 + 2e-2 |ref| a channel)
    and its photon limit."""
    raw, scene, _ = sf1
    cfg = RenderConfig(width=32, height=32, depth=5, tile_rays=256)
    pixels = np.arange(cfg.width * cfg.height)
    clip = torch.as_tensor(frame.clips(cfg.width, cfg.height, pixels))
    lens, unifs = frame.pixel_draws(pixels, cfg.width, cfg.height, cfg.tile_rays, cfg.depth,
                                    2**31 + 29, 4, "cpu")
    o, d = frame.shoot_focus(raw.camera, clip, lens, cfg.blur, cfg.focus)
    got = distributed.trace_distributed(scene, o, d, unifs, cfg).photon
    with world.tf32_off():
        ref = world.distributed(world.World(raw, "cpu"), o, d, unifs, cfg.depth)
    assert float(ref.abs().sum()) > 0
    bad = ((got - ref).abs() > 1e-3 + 2e-2 * ref.abs()).any(dim=1).float().mean()
    assert float(bad) <= _limit("spd-rings.progressive", "photon_bad_share")


def test_plain_whitted_frame_at_size_factor_1_matches_the_reference(sf1):
    """The Whitted frame of the preset's view (every pixel, 40x40) against
    the reference at the preview cells' tolerances and pixel limit; the
    frame hits spheres, cylinders and the floor."""
    raw, scene, camera = sf1
    cfg = RenderConfig(width=40, height=40, depth=5, tile_rays=512)
    img, stats = render_whitted(scene, camera, cfg)
    assert stats["dropped"] == 0
    pixels = np.arange(cfg.width * cfg.height)
    clip = torch.as_tensor(frame.clips(cfg.width, cfg.height, pixels))
    o, d = frame.shoot(raw.camera, clip)
    with world.tf32_off():
        w = world.World(raw, "cpu")
        ref = world.whitted(w, o, d, cfg.depth)
        first = w.cast(o, d, torch.zeros(len(pixels), dtype=torch.long),
                       torch.full((len(pixels),), -1), torch.zeros(len(pixels), dtype=torch.long))
    kinds = torch.bucketize(first.prim, torch.tensor([0, 2, 32]), right=True)
    assert set(kinds[first.valid].tolist()) == {1, 2, 3}  # floor, spheres, cylinders
    bad = ((img.reshape(-1, 3) - ref).abs() > 1e-3 + 2e-2 * ref.abs()).any(dim=1)
    assert float(bad.float().mean()) <= _limit("demo.preview", "pixel_bad_share")


# ---- mc.cone_tests ------------------------------------------------------------


def two_cylinders(device="cpu"):
    """Cylinders A (cone 0) and B (cone 1) along z from -1 to 1 at x = 0 and
    x = 3, radius 0.5; a sphere S (radius 0.8) at (1.5, 0, 5), no triangle;
    point lights L0 at (0, 0, 10) and L1 at (-3, 0, 0.5)."""
    b = SceneBuilder()
    p = b.push_object(MaterialSpec())
    p.push_sphere((1.5, 0.0, 5.0), 0.8)
    for x in (0.0, 3.0):
        p.push_cone((x, 0.0, -1.0), 0.5, (x, 0.0, 1.0), 0.5)
    b.push_point_light((0.0, 0.0, 10.0), (1.0, 1.0, 1.0))
    b.push_point_light((-3.0, 0.0, 0.5), (1.0, 1.0, 1.0))
    return b.build(device=device)


# (origin, direction, cone tests): a nearest sweep tests both cylinders; a
# shadow ray tests none where the sphere occludes it, else every cylinder
# but the shading point's own up to its first occluder
HAND = [
    # A's side at (0, 0.5, 0.2): turned from both lights, no shadow ray
    ((0.0, 5.0, 0.2), (0.0, -1.0, 0.0), 2),
    # A's side at (-0.5, 0, 0.2): turned from L0; toward L1 it tests B alone
    ((-5.0, 0.0, 0.2), (1.0, 0.0, 0.0), 2 + 1),
    # B's side at (2.5, 0, 0.5): S occludes L0 (no cone test); toward L1, A
    # occludes first
    ((2.0, 0.0, 0.5), (1.0, 0.0, 0.0), 2 + 1),
    ((10.0, 10.0, 10.0), (1.0, 0.0, 0.0), 2),  # a miss: no shade
]


def _hand_rays(device):
    o = torch.tensor([h[0] for h in HAND], device=device)
    d = torch.tensor([h[1] for h in HAND], device=device)
    return o, d, torch.rand((0, 3, len(HAND)), device=device)


def test_cone_tests_on_the_plain_path_are_the_hand_count():
    scene = two_cylinders()
    o, d, unifs = _hand_rays("cpu")
    lanes = torch.zeros(len(HAND), dtype=torch.int64)
    mc_kernel.trace(scene, o, d, unifs, 0, 100.0, 10, cone_tests=lanes)
    assert lanes.tolist() == [h[2] for h in HAND]
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.unit("rt.test"):
            mc_kernel.trace(scene, o, d, unifs, 0, 100.0, 10)
        mc_kernel.trace(scene, o, d, unifs, 0, 100.0, 10)  # outside the unit: not counted
    assert tracing.take().counters["mc.cone_tests"] == sum(h[2] for h in HAND)


def test_cone_tests_of_a_walk_lie_between_the_nearest_sweeps_and_every_cast(sf1):
    raw, scene, _ = sf1
    n = 24 * 24
    pixels = np.arange(n)
    clip = torch.as_tensor(frame.clips(24, 24, pixels))
    lens, unifs = frame.pixel_draws(pixels, 24, 24, n, 3, 5, 0, "cpu")
    o, d = frame.shoot_focus(raw.camera, clip, lens, 0.04, 3.0)
    lanes = torch.zeros(n, dtype=torch.int64)
    _, casts = mc_kernel.trace(scene, o, d, unifs, 3, 100.0, 10, cone_tests=lanes)
    assert n * 30 <= int(lanes.sum()) <= int(casts) * 30


# ---- the routes that cast no cone -----------------------------------------


def _blocked_with_cones():
    b = SceneBuilder()
    p = b.push_object(MaterialSpec())
    for i in range(BVH_MIN_TRIS):
        x = float(i % 32)
        z = float(i // 32)
        p.push_triangle(triangle([((x, 0.0, z), (0, 0)), ((x + 1, 0.0, z), (0, 0)),
                                  ((x, 0.0, z + 1), (0, 0))]))
    p.push_cone((0.0, 1.0, 0.0), 0.2, (0.0, 2.0, 0.0), 0.2)
    b.push_point_light((0.0, 10.0, 0.0), (1.0, 1.0, 1.0))
    return b.build(device="cpu")


ROUTES = {
    "blocked MC walk": lambda s, o, d: mc_kernel.trace(s, o, d, torch.rand(1, 3, 4), 1, 100.0,
                                                       10),
    "binned MC walk": lambda s, o, d: mc_binned.trace(s, o, d, torch.rand(1, 3, 4), 1, 100.0,
                                                      10),
    "blocked level": lambda s, o, d: level_kernel.process_level(
        s, level_kernel.Pool(torch.zeros(11, 4), torch.zeros(5, 4, dtype=torch.int32)), True,
        True, 1e-3, 100.0, 10),
    "unfused cast": lambda s, o, d: intersect.cast(s, Rays.primary(o, d)),
    "unfused any-hit": lambda s, o, d: intersect.cast_any_hit(s, Rays.primary(o, d)),
    "unfused march": lambda s, o, d: march_kernel.march(
        s, o, d, d, torch.zeros(4, dtype=torch.int32), torch.ones(4), torch.ones(4, dtype=bool),
        100.0, 10),
    "per-thread MC walk": lambda s, o, d: mc_kernel.trace_per_thread(
        s, o, d, torch.rand(1, 3, 4), 1, 100.0, 10),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_without_cones_refuse_a_scene_with_cones(route):
    scene = _blocked_with_cones()
    assert scene.blocked and scene.n_cone == 1
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, -1.0, 0.0]] * 4)
    with pytest.raises(NotImplementedError, match="cones"):
        ROUTES[route](scene, o, d)


# ---- the JSON scene format --------------------------------------------------


def test_json_scene_round_trips_cones():
    b = presets.spd_rings_builder(1)
    data = dump_builder(b, presets.spd_rings_camera(1, device="cpu"))
    cone, ring = data["objects"][2]["cones"][0], presets.spd_rings_unit()[0]
    assert sorted(cone) == ["apex", "apex_radius", "base", "base_radius"]
    f32 = lambda x: np.asarray(x, np.float32)
    assert np.array_equal(f32(cone["base"]), f32(ring[0]))
    assert np.array_equal(f32(cone["apex"]), f32(ring[1]))
    assert f32(cone["base_radius"]) == f32(cone["apex_radius"]) == f32(0.05)
    scene, cam = load_scene_dict(json.loads(json.dumps(data)), device="cpu")
    _same(scene, b.build(device="cpu"))
    _same(cam, presets.spd_rings_camera(1, device="cpu"))


@pytest.mark.parametrize("cone, material, match", [
    ({"base": [0, 0, 0], "base_radius": 0.1, "apex": [0, 0, 0], "apex_radius": 0.1}, {},
     "no length"),
    ({"base": [0, 0, 0], "base_radius": -0.1, "apex": [0, 0, 1], "apex_radius": 0.1}, {},
     "negative"),
    ({"base": [0, 0, 0], "base_radius": 0.0, "apex": [0, 0, 1], "apex_radius": 0.0}, {},
     "both are 0"),
    ({"base": [0, 0, 0], "base_radius": 0.1, "apex": [0, 0, 1], "apex_radius": 0.1},
     {"texture": "stripes"}, "texture"),
    ({"base": [0, 0, 0], "base_radius": 0.1, "apex": [0, 0, 1], "apex_radius": 0.1},
     {"transparency": 0.5}, "transparent"),
])
def test_json_scene_refuses_what_the_harness_refuses(cone, material, match):
    data = {"objects": [{"material": material, "cones": [cone]}], "lights": []}
    with pytest.raises(ValueError, match=match):
        load_scene_dict(data, device="cpu")
    harness = {"objects": [{"material": material, "cones": [cone]}], "lights": [],
               "camera": {"fovy_deg": 60.0, "center": [0.0, 0.0, 5.0],
                          "toward_unnormalized": [0.0, 0.0, -1.0], "up": [0.0, 1.0, 0.0],
                          "near": 0.0}}
    with pytest.raises(ValueError, match=match):
        scenes.parse(harness)


# ---- the CLI ----------------------------------------------------------------


def test_cli_takes_the_presets_own_camera():
    args = cli.build_parser().parse_args(["--scene", "spd-rings", "--device", "cpu"])
    scene, cam = cli._scene(args, torch.device("cpu"))
    _same(cam, presets.spd_rings_camera(device="cpu"))
    assert (scene.n_sph, scene.n_cone) == (4200, 4200)


# ---- on a card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _primary_pool(camera, cfg, device):
    """Level 0's pool of a Whitted frame: every pixel's primary ray."""
    from raytracer_tpu_torch.ops import camera as camera_ops

    n = cfg.width * cfg.height
    ys, xs = np.divmod(np.arange(n), cfg.width)
    clip = torch.as_tensor(np.stack([(xs - cfg.width / 2) / cfg.height,
                                     (cfg.height / 2 - ys) / cfg.height], 1),
                           dtype=torch.float32, device=device)
    o, d = camera_ops.shoot(camera, clip)
    f = torch.zeros((11, n), device=device)
    f[0:3], f[3:6], f[6], f[7] = o.t(), d.t(), 1.0, 1.0
    i = torch.zeros((5, n), dtype=torch.int32, device=device)
    i[1], i[3], i[4] = -1, torch.arange(n, device=device, dtype=torch.int32), 1
    return level_kernel.Pool(f, i)


@pytest.mark.card
def test_the_kernels_cone_hits_are_the_plain_paths(card):
    """The staged level kernel's hits (its reflect child's origin and
    excluded primitive) against the plain level's, run on the card over the
    same tables, on every pixel of a 128x128 primary level of spd-rings,
    and the shades (its contributions).  The cone test is rounded as
    written on both sides, so a cone's hit point is the plain one bit for
    bit; the kernels' sphere test is not (nvcc fuses its products), so a
    sphere's lies within 1e-4."""
    scene, camera = presets.spd_rings_scene(device=card)
    cfg = RenderConfig(width=128, height=128)
    pool = _primary_pool(camera, cfg, card)
    got = level_kernel.process_level(scene, pool, False, True, 1e-3, 100.0, 10)
    plain = level_kernel.process_level_plain(scene.geom, scene.textures, pool, False, True,
                                             1e-3, 100.0, 10)
    prim, prim_plain = got[1].i[1], plain[1].i[1]
    assert int((prim >= 4202).sum()) > 1000  # the frame meets cylinders
    assert float((prim == prim_plain).float().mean()) > 0.999
    same = prim == prim_plain
    cone = same & (prim >= 4202)
    assert torch.equal(got[1].f[0:3][:, cone], plain[1].f[0:3][:, cone])
    torch.testing.assert_close(got[1].f[0:3][:, same], plain[1].f[0:3][:, same],
                               rtol=0, atol=1e-4)
    close = ((got[0] - plain[0]).abs() <= 1e-4 + 1e-3 * plain[0].abs()).all(dim=0)
    assert float(close.float().mean()) > 0.999


@pytest.mark.card
def test_the_main_paths_cone_count_is_the_counting_instantiations(card):
    """One 128x128 epoch's walk: the counting instantiation (ConeCount) gives
    the photons of the main path's walk bit for bit; the main path's
    recorded `mc.cone_tests` is its sum; each lane's count is the plain
    walk's on nearly every lane (a lane whose path parts on a rounding
    counts otherwise)."""
    scene, camera = presets.spd_rings_scene(device=card)
    raw = scenes.parse(spd_rings_data(7))
    w = h = 128
    pixels = np.arange(w * h)
    clip = torch.as_tensor(frame.clips(w, h, pixels), device=card)
    lens, unifs = frame.pixel_draws(pixels, w, h, 65536, 5, 2**33 + 11, 3, card)
    o, d = frame.shoot_focus(raw.camera, clip, lens, 0.04, 3.0)
    o, d = o.contiguous(), d.contiguous()
    p_main, c_main = mc_kernel.trace(scene, o, d, unifs, 5, 100.0, 10)
    lanes = torch.zeros(w * h, dtype=torch.int64, device=card)
    p_count, c_count = mc_kernel.trace(scene, o, d, unifs, 5, 100.0, 10, cone_tests=lanes)
    assert torch.equal(p_main, p_count) and int(c_main) == int(c_count)
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with tracing.unit("rt.test"):
            mc_kernel.trace(scene, o, d, unifs, 5, 100.0, 10)
    assert tracing.take().counters["mc.cone_tests"] == int(lanes.sum()) > 0
    cpu = scene.to("cpu")
    plain = torch.zeros(w * h, dtype=torch.int64)
    sl = slice(0, 2048)  # the plain walk over a stripe of the frame
    mc_kernel.trace(cpu, o[sl].cpu(), d[sl].cpu(), unifs[:, :, sl].cpu().contiguous(), 5,
                    100.0, 10, cone_tests=plain[sl])
    assert float((lanes[sl].cpu() == plain[sl]).float().mean()) > 0.99


# The Whitted frame's pixel limit.  The reference's cone quadratic (and the
# port's, which rounds the same formula in another order) cancels on a ray
# that grazes a cylinder from afar (|rho_w|^2 ~ 200 against r^2 = 0.0025),
# so the two part on a band of rays a few 1e-4 wide at each silhouette,
# and the mirror reflections between thin cylinders carry a parted ray on:
# 2.5 % of pixels against demo.preview's 0.01 (the kernel and the plain
# path agree on all but 0.2 %); the bfloat16 control reads ~0.3.
WHITTED_PIXEL_LIMIT = 0.05


@pytest.mark.card
def test_the_whitted_frame_of_spd_rings_matches_the_reference(card):
    """512x512, depth 5: 16,384 pixels drawn from a seed against the plain
    reference at demo.preview's tolerances, under WHITTED_PIXEL_LIMIT, which
    the reference in bfloat16 (the cells' control) fails."""
    raw = scenes.parse(spd_rings_data(7))
    scene, camera = scenes.program_scene(raw, card, use_bvh=False)
    cfg = RenderConfig(width=512, height=512, depth=5)
    img, stats = render_whitted(scene, camera, cfg)
    assert stats["dropped"] <= _limit("demo.preview", "dropped")
    pixels = np.sort(np.random.default_rng(2**31 + 3).choice(512 * 512, 16384, replace=False))
    clip = torch.as_tensor(frame.clips(512, 512, pixels), device=card)
    o, d = frame.shoot(raw.camera, clip)
    bf = torch.bfloat16
    with world.tf32_off():
        ref = world.whitted(world.World(raw, card), o, d, cfg.depth)
        ctl = world.whitted(world.World(raw, card, bf), o.to(bf), d.to(bf), cfg.depth).float()
    got = img.reshape(-1, 3)[torch.as_tensor(pixels, device=img.device)].to(card)
    share = lambda x: float(((x - ref).abs() > 1e-3 + 2e-2 * ref.abs()).any(dim=1).float().mean())
    assert share(got) <= WHITTED_PIXEL_LIMIT < share(ctl)
