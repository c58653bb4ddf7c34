"""The SPD sphereflake (`spd-balls`, scene/presets.spd_balls_scene) and the
MC walk's sphere-test counter `mc.sph_tests`, on the CPU's plain path.

The construction's SPD properties; the benchmark's scene file giving the
preset's tables bit for bit; the plain MC walk at size factor 2 (91
spheres) held against the benchmark's plain reference
(benchmark/reference/world.py) with the cell's tolerances; the counter
against a hand count on three spheres; the CLI taking the preset's own
camera.  On a card (the `card` tests, which skip without one), the main
path's count against the counting instantiation's `sph` row."""

import dataclasses
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
from raytracer_tpu_torch.ops import distributed, mc_kernel
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.builder import MaterialSpec, SceneBuilder
from raytracer_tpu_torch.utils import kernels, tracing

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


def spd_data(size_factor: int) -> dict:
    """The preset as the benchmark's scene data (rtbench/scenes.py's format)."""
    c, r, _ = presets.spd_balls_spheres(size_factor)
    h, z = 12.0, -0.5
    eye = [2.1, 1.3, 1.7]
    return {
        "objects": [
            {"material": _material(presets.SPD_BALLS_FLOOR),
             "squares": [{"p": [_v((-h, -h, z)), _v((h, -h, z)), _v((h, h, z)), _v((-h, h, z))],
                          "uv": [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]}]},
            {"material": _material(presets.SPD_BALLS_SPHERE),
             "spheres": [{"center": _v(ci), "radius": _f32(ri)} for ci, ri in zip(c, r)]},
        ],
        "lights": [{"type": "point", "origin": list(o), "color": _v(np.full(3, 1 / math.sqrt(3)))}
                   for o in ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))],
        "camera": {"fovy_deg": presets.SPD_BALLS_FOVY_DEG, "center": eye,
                   "toward_unnormalized": [-x for x in eye], "up": [0.0, 0.0, 1.0], "near": 0.0},
    }


def _same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y), f.name
        elif f.name != "textures":
            assert x == y, f.name


@pytest.fixture(scope="module")
def flake():
    return presets.spd_balls_spheres(4)


# ---- the construction -------------------------------------------------------


def test_objset_has_six_equatorial_and_three_upper_unit_directions():
    o = presets.spd_objset()
    assert o.shape == (9, 3)
    np.testing.assert_allclose(np.linalg.norm(o, axis=1), 1.0, atol=1e-15)
    z = np.sort(o[:, 2])
    np.testing.assert_allclose(z[:6], 0.0, atol=1e-15)
    np.testing.assert_allclose(z[6:], math.sqrt(2.0 / 3.0), atol=1e-15)


def test_size_factor_4_has_7381_spheres_of_radius_half_over_powers_of_3(flake):
    centers, radii, parent = flake
    assert centers.shape == (7381, 3) and radii.shape == parent.shape == (7381,)
    level = np.zeros(7381, dtype=int)
    for i in range(1, 7381):  # depth first: a parent comes before its children
        assert parent[i] < i
        level[i] = level[parent[i]] + 1
    assert np.bincount(level).tolist() == [1, 9, 81, 729, 6561]
    np.testing.assert_allclose(radii, 0.5 * 3.0 ** -level, rtol=1e-15)
    np.testing.assert_array_equal(centers[0], 0.0)


def test_each_child_touches_its_parent_along_an_objset_direction(flake):
    centers, radii, parent = flake
    child = np.arange(1, 7381)
    gap = np.linalg.norm(centers[child] - centers[parent[child]], axis=1)
    np.testing.assert_allclose(gap, radii[child] + radii[parent[child]], rtol=1e-13)
    first = centers[parent == 0]  # the root's children, in objset order
    first = first / np.linalg.norm(first, axis=1, keepdims=True)
    np.testing.assert_allclose(first, presets.spd_objset(), atol=1e-15)


def test_no_two_spheres_overlap_and_the_root_is_lowest(flake):
    centers, radii, _ = flake
    worst = np.inf
    for lo in range(0, len(centers), 1024):
        d = np.linalg.norm(centers[lo:lo + 1024, None] - centers[None], axis=-1)
        reach = radii[lo:lo + 1024, None] + radii[None]
        gap = (d - reach) / reach
        gap[np.arange(gap.shape[0]), np.arange(lo, lo + gap.shape[0])] = np.inf
        worst = min(worst, gap.min())
    assert worst > -1e-12  # children touch their parents; nothing overlaps
    assert (centers[:, 2] - radii).min() == -0.5


def test_the_floor_lights_camera_and_materials():
    scene, cam = presets.spd_balls_scene(device="cpu")
    assert (scene.n_tri, scene.n_sph, scene.n_light) == (2, 7381, 3)
    assert scene.bvh_node_min is None  # below BVH_MIN_TRIS: the dense walks
    assert torch.all(scene.tri_v[..., 2] == -0.5)
    assert torch.equal(scene.tri_fn, torch.tensor([[0.0, 0.0, 1.0]] * 2))
    assert torch.equal(scene.tri_v[..., :2].abs(), torch.full((2, 3, 2), 12.0))
    assert scene.light_type.tolist() == [2, 2, 2]  # point lights
    assert scene.light_origin.tolist() == [[4, 3, 2], [1, -4, 4], [-3, 1, 5]]
    assert torch.equal(scene.light_color, torch.full((3, 3), np.float32(1 / math.sqrt(3))))
    assert scene.sph_obj.unique().tolist() == [1] and scene.tri_obj.tolist() == [0, 0]
    assert scene.mat_shiness.tolist() == [0.0, 0.5]
    # the whole vertical field of view is SPD's 45 degrees: clip +-0.5 x tan(fovy / 2)
    assert 2 * math.degrees(math.atan(0.5 * float(cam.scale))) == pytest.approx(45.0, abs=1e-4)
    assert float(cam.near) == 0.0
    assert float(torch.linalg.vector_norm(cam.center.double())) == pytest.approx(3.0, abs=2e-3)
    assert cam.up.tolist() == [0.0, 0.0, 1.0]


def test_the_benchmark_scene_file_is_the_preset_bit_for_bit():
    with open(os.path.join(BENCH, "scenes", "spd-balls.json")) as f:
        data = json.load(f)
    want = spd_data(4)
    assert data["objects"] == want["objects"] and data["lights"] == want["lights"]
    assert data["camera"] == want["camera"]
    scene, cam = scenes.program_scene(scenes.parse(data), "cpu", use_bvh=False)
    ref_scene, ref_cam = presets.spd_balls_scene(device="cpu")
    _same(scene, ref_scene)
    _same(cam, ref_cam)


# ---- the plain walk against the benchmark's reference ------------------------


def test_plain_mc_walk_at_size_factor_2_matches_the_reference():
    """32x32, seeded draws (the timed path's, worked out by the reference's
    frame.pixel_draws), the cell's tolerances (rtbench/entries/progressive:
    1e-3 + 2e-2 |ref| a channel) and its photon limit."""
    raw = scenes.parse(spd_data(2))
    assert raw.n_sph == 91
    scene, _ = scenes.program_scene(raw, "cpu", use_bvh=False)
    _same(scene, presets.spd_balls_scene(2, device="cpu")[0])
    cfg = RenderConfig(width=32, height=32, depth=5, tile_rays=256)
    pixels = np.arange(cfg.width * cfg.height)
    clip = torch.as_tensor(frame.clips(cfg.width, cfg.height, pixels))
    lens, unifs = frame.pixel_draws(pixels, cfg.width, cfg.height, cfg.tile_rays, cfg.depth,
                                    2**31 + 17, 3, "cpu")
    o, d = frame.shoot_focus(raw.camera, clip, lens, cfg.blur, cfg.focus)
    got = distributed.trace_distributed(scene, o, d, unifs, cfg).photon
    with world.tf32_off():
        ref = world.distributed(world.World(raw, "cpu"), o, d, unifs, cfg.depth)
    assert float(ref.abs().sum()) > 0
    bad = ((got - ref).abs() > 1e-3 + 2e-2 * ref.abs()).any(dim=1).float().mean()
    with open(os.path.join(BENCH, "limits", "spd-balls.progressive.json")) as f:
        assert float(bad) <= json.load(f)["photon_bad_share"]["limit"]


# ---- mc.sph_tests -----------------------------------------------------------


def three_spheres(device="cpu"):
    """A (idx 0) at the origin, B (1) 3 below it, C (2) 3 along +x, radius
    0.5, no triangle; one point light at (0, 0, 10)."""
    b = SceneBuilder()
    p = b.push_object(MaterialSpec())
    for c in ((0.0, 0.0, 0.0), (0.0, 0.0, -3.0), (3.0, 0.0, 0.0)):
        p.push_sphere(c, 0.5)
    b.push_point_light((0.0, 0.0, 10.0), (1.0, 1.0, 1.0))
    return b.build(device=device)


# (origin, direction, sphere tests): a nearest sweep tests all 3; the
# terminal shade's shadow ray toward the light tests every sphere but the
# point's own up to its first occluder
HAND = [
    ((0.0, 0.0, 5.0), (0.0, 0.0, -1.0), 3 + 2),  # A's top: B, C clear
    ((3.0, 0.0, 5.0), (0.0, 0.0, -1.0), 3 + 2),  # C's top: A, B clear
    ((0.3, 0.0, -1.0), (0.0, 0.0, -1.0), 3 + 1),  # B's top: A occludes first
    ((10.0, 10.0, 10.0), (1.0, 0.0, 0.0), 3),  # a miss: no shade
]


def _hand_rays(device):
    o = torch.tensor([h[0] for h in HAND], device=device)
    d = torch.tensor([h[1] for h in HAND], device=device)
    return o, d, torch.rand((0, 3, len(HAND)), device=device)


def test_sph_tests_on_the_plain_path_are_the_hand_count():
    scene = three_spheres()
    o, d, unifs = _hand_rays("cpu")
    lanes = torch.zeros(len(HAND), dtype=torch.int64)
    _, casts = mc_kernel.trace(scene, o, d, unifs, 0, 100.0, 10, sph_tests=lanes)
    assert lanes.tolist() == [h[2] for h in HAND]
    assert int(casts) == 1 + 1 + 1 + 1 + 3  # four primaries, three shadow rays
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.unit("rt.test"):
            mc_kernel.trace(scene, o, d, unifs, 0, 100.0, 10)
        mc_kernel.trace(scene, o, d, unifs, 0, 100.0, 10)  # outside the unit: not counted
    assert tracing.take().counters["mc.sph_tests"] == 17


def test_sph_tests_of_a_walk_lie_between_the_nearest_sweeps_and_every_cast():
    """Every cast tests at most every sphere, and every lane's primary
    sweep tests all of them."""
    scene, cam = presets.spd_balls_scene(1, device="cpu")  # 10 spheres
    cfg = RenderConfig(width=24, height=24, depth=3, tile_rays=576)
    pixels = np.arange(576)
    raw = scenes.parse(spd_data(1))
    clip = torch.as_tensor(frame.clips(24, 24, pixels))
    lens, unifs = frame.pixel_draws(pixels, 24, 24, 576, 3, 5, 0, "cpu")
    o, d = frame.shoot_focus(raw.camera, clip, lens, cfg.blur, cfg.focus)
    lanes = torch.zeros(576, dtype=torch.int64)
    _, casts = mc_kernel.trace(scene, o, d, unifs, 3, 100.0, 10, sph_tests=lanes)
    assert 576 * 10 <= int(lanes.sum()) <= int(casts) * 10


# ---- the CLI ----------------------------------------------------------------


def _cli_scene(name):
    args = cli.build_parser().parse_args(["--scene", name, "--device", "cpu"])
    return cli._scene(args, torch.device("cpu"))


def test_cli_takes_the_presets_own_camera():
    scene, cam = _cli_scene("spd-balls")
    want_scene, want_cam = presets.spd_balls_scene(device="cpu")
    _same(cam, want_cam)
    assert scene.n_sph == 7381
    _, demo_cam = _cli_scene("demo")
    _same(demo_cam, presets.demo_camera(device="cpu"))


# ---- on a card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_counts(scene, o, d, unifs, depth):
    """(the main path's sph_tests, the counting instantiation's sph row,
    the per-thread yardstick's sph_tests) for the same draws."""
    n = o.shape[0]
    main = torch.zeros(n, dtype=torch.int64, device=o.device)
    p_main, c_main = mc_kernel.trace(scene, o, d, unifs, depth, 100.0, 10, sph_tests=main)
    work = torch.zeros((len(kernels.WORK_ROWS), n), dtype=torch.int32, device=o.device)
    p_work, c_work = mc_kernel.trace(scene, o, d, unifs, depth, 100.0, 10, work=work)
    thread = torch.zeros(n, dtype=torch.int64, device=o.device)
    mc_kernel.trace_per_thread(scene, o, d, unifs, depth, 100.0, 10, sph_tests=thread)
    assert torch.equal(p_main, p_work) and int(c_main) == int(c_work)
    return main, work[kernels.WORK_ROWS.index("sph")].long(), thread


@pytest.mark.card
def test_the_hand_count_on_the_card(card):
    o, d, unifs = _hand_rays(card)
    main, row, thread = _card_counts(three_spheres(card), o, d, unifs, 0)
    assert main.tolist() == row.tolist() == thread.tolist() == [h[2] for h in HAND]


@pytest.mark.card
@pytest.mark.parametrize("size_factor", [2, 4])
def test_the_main_paths_count_is_the_counting_instantiations_on_the_card(card, size_factor):
    scene, _ = presets.spd_balls_scene(size_factor, device=card)
    raw = scenes.parse(spd_data(size_factor))
    w = h = 128
    pixels = np.arange(w * h)
    clip = torch.as_tensor(frame.clips(w, h, pixels), device=card)
    lens, unifs = frame.pixel_draws(pixels, w, h, 65536, 5, 2**33 + 5, 7, card)
    o, d = frame.shoot_focus(raw.camera, clip, lens, 0.04, 3.0)
    main, row, thread = _card_counts(scene, o.contiguous(), d.contiguous(), unifs, 5)
    assert torch.equal(main, row) and torch.equal(main, thread)
    assert int(main.sum()) > 0
