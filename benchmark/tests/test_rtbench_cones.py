"""NFF cones and cylinders in the benchmark's scene format and its plain
reference: `scenes.parse`'s arrays and refusals, `World`'s cone test
against closed forms and against a float64 root-find of the implicit
surface, the per-root exclusion, the shadow limit, the casts of the
Whitted and Monte-Carlo walks, the roofline's count, and `program_scene`,
which hands a cone to the port's `push_cone` or refuses the scene."""

import copy
import math

import numpy as np
import pytest
import torch

from reference import world
from rtbench import readings, scenes

FRONT, BACK, BOTH = world.FRONT, world.BACK, world.BOTH
MAT = {"diffuse_color": [0.8, 0.6, 0.4], "shiness": 0.3, "smoothness": 0.1}
CAMERA = {"fovy_deg": 45.0, "center": [0.0, -6.0, 1.0], "toward_unnormalized": [0.0, 1.0, 0.0],
          "up": [0.0, 0.0, 1.0], "near": 0.0}
LIGHTS = [{"type": "point", "origin": [2.0, -3.0, 4.0], "color": [1.0, 1.0, 1.0]}]
CYLINDER = {"base": [0.0, 0.0, 0.0], "base_radius": 0.5, "apex": [0.0, 0.0, 2.0],
            "apex_radius": 0.5}
CONE = {"base": [0.0, 0.0, 0.0], "base_radius": 1.0, "apex": [0.0, 0.0, 1.0],
        "apex_radius": 0.0}


def scene_data(*cones, far=True, material=None):
    """One object of `cones`; with `far`, a triangle and a sphere out of
    every test ray's way first, so a cone's id is T + S + its index."""
    objects = []
    if far:
        objects.append({"material": MAT,
                        "triangles": [{"p": [[50, 50, 50], [51, 50, 50], [50, 51, 50]]}],
                        "spheres": [{"center": [-50.0, -50.0, -50.0], "radius": 1.0}]})
    objects.append({"material": dict(MAT, **(material or {})), "cones": list(cones)})
    return {"objects": objects, "lights": LIGHTS, "camera": CAMERA}


def one(v, dtype=torch.float32):
    return torch.tensor([v], dtype=dtype)


def cast(w, o, d, face, excl_prim=-1, excl_face=FRONT, limit=None):
    lim = None if limit is None else one(limit, w.dtype)
    return w.cast(one(o, w.dtype), one(d, w.dtype), torch.tensor([face]),
                  torch.tensor([excl_prim]), torch.tensor([excl_face]), limit=lim)


# --- the scene format -------------------------------------------------------

def test_parse_reads_a_cone_object():
    raw = scenes.parse(scene_data(CYLINDER, CONE))
    assert (raw.n_tri, raw.n_sph, raw.n_cone) == (1, 1, 2)
    assert raw.cone_base.shape == (2, 3) and raw.cone_apex.shape == (2, 3)
    assert raw.cone_base_r.shape == (2,) and raw.cone_apex_r.shape == (2,)
    for a in (raw.cone_base, raw.cone_apex, raw.cone_base_r, raw.cone_apex_r):
        assert a.dtype == np.float32
    assert raw.cone_obj.dtype == np.int32 and raw.cone_obj.tolist() == [1, 1]
    np.testing.assert_array_equal(raw.cone_apex, [[0, 0, 2], [0, 0, 1]])
    np.testing.assert_array_equal(raw.cone_base_r, [0.5, 1.0])
    np.testing.assert_array_equal(raw.cone_apex_r, [0.5, 0.0])


@pytest.mark.parametrize("name", ["demo", "terrain", "spd-balls"])
def test_the_benchmarks_scenes_have_no_cones(name):
    raw = scenes.load(name)
    assert raw.n_cone == 0
    assert raw.cone_base.shape == (0, 3) and raw.cone_apex.shape == (0, 3)
    assert raw.cone_base_r.shape == raw.cone_apex_r.shape == raw.cone_obj.shape == (0,)
    assert raw.cone_base.dtype == np.float32 and raw.cone_obj.dtype == np.int32


REFUSED = {
    "zero_axis": (dict(CYLINDER, apex=[0.0, 0.0, 0.0]), None, "no length"),
    "negative_radius": (dict(CYLINDER, base_radius=-0.1), None, "negative"),
    "both_radii_0": (dict(CYLINDER, base_radius=0.0, apex_radius=0.0), None, "both are 0"),
    "texture": (CYLINDER, {"texture": "checker"}, "no uv"),
    "transparency": (CYLINDER, {"transparency": 0.5}, "no inside"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_parse_refuses_a_cone_it_cannot_render(case):
    cone, material, why = REFUSED[case]
    with pytest.raises(ValueError, match=why):
        scenes.parse(scene_data(cone, material=material))


@pytest.mark.parametrize("key", ["cone", "cylinders", "disc"])
def test_parse_refuses_an_object_key_it_does_not_know(key):
    data = scene_data(CYLINDER)
    data["objects"][1][key] = [CYLINDER]
    with pytest.raises(ValueError, match="unknown keys"):
        scenes.parse(data)


# --- the reference's cone test: closed forms --------------------------------

@pytest.fixture(scope="module")
def cylinder():
    return world.World(scenes.parse(scene_data(CYLINDER)), "cpu")


def test_cylinder_front_and_back_from_outside(cylinder):
    hit = cast(cylinder, [3.0, 0.0, 1.0], [-1.0, 0.0, 0.0], FRONT)
    assert hit.prim.item() == 2 and not hit.backface.item()
    assert hit.t.item() == pytest.approx(2.5, abs=1e-6)
    np.testing.assert_allclose(hit.normal[0], [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(hit.uv[0], [0.0, 0.0])
    assert hit.obj.item() == 1
    hit = cast(cylinder, [3.0, 0.0, 1.0], [-1.0, 0.0, 0.0], BACK)
    assert hit.prim.item() == 2 and hit.backface.item()
    assert hit.t.item() == pytest.approx(3.5, abs=1e-6)
    # the normal at x = -0.5 points out along -x, flipped on the back face
    np.testing.assert_allclose(hit.normal[0], [1.0, 0.0, 0.0], atol=1e-6)


def test_cylinder_from_inside(cylinder):
    hit = cast(cylinder, [0.0, 0.0, 1.0], [1.0, 0.0, 0.0], BOTH)
    assert hit.prim.item() == 2 and hit.backface.item()
    assert hit.t.item() == pytest.approx(0.5, abs=1e-6)
    assert not cast(cylinder, [0.0, 0.0, 1.0], [1.0, 0.0, 0.0], FRONT).valid.item()


@pytest.mark.parametrize("o", [[0.2, 0.0, -1.0], [0.5, 0.0, -1.0], [3.0, 0.0, -1.0]])
def test_a_ray_parallel_to_the_axis_misses(cylinder, o):
    assert not cast(cylinder, o, [0.0, 0.0, 1.0], BOTH).valid.item()


def test_the_open_ends_let_a_ray_through(cylinder):
    # in through the open top, down the inside to the wall: a back face
    d = [0.3, 0.0, -1.0]
    n = math.hypot(*d)
    hit = cast(cylinder, [0.0, 0.0, 3.0], [x / n for x in d], BOTH)
    assert hit.backface.item() and hit.pos[0, 0].item() == pytest.approx(0.5, abs=1e-6)
    # over the top without touching the wall
    assert not cast(cylinder, [-3.0, 0.0, 2.5], [1.0, 0.0, 0.0], BOTH).valid.item()


def test_cone_hit_and_its_normal():
    w = world.World(scenes.parse(scene_data(CONE)), "cpu")
    hit = cast(w, [2.0, 0.0, 0.5], [-1.0, 0.0, 0.0], FRONT)
    assert hit.prim.item() == 2 and not hit.backface.item()
    assert hit.t.item() == pytest.approx(1.5, abs=1e-6)
    np.testing.assert_allclose(hit.normal[0], [math.sqrt(0.5), 0.0, math.sqrt(0.5)], atol=1e-6)


def test_a_ray_along_a_generator_has_one_root():
    """Parallel to the cone's side at x > 0 (alpha = 0), up through the
    inside and out through the side at x < 0, z = 0.75."""
    w = world.World(scenes.parse(scene_data(CONE)), "cpu")
    d = [-math.sqrt(0.5), 0.0, math.sqrt(0.5)]
    hit = cast(w, [1.0, 0.0, -0.5], d, BOTH)
    assert hit.prim.item() == 2 and hit.backface.item()
    assert hit.t.item() == pytest.approx(1.25 * math.sqrt(2.0), abs=1e-6)
    np.testing.assert_allclose(hit.normal[0], [math.sqrt(0.5), 0.0, -math.sqrt(0.5)], atol=1e-6)
    assert not cast(w, [1.0, 0.0, -0.5], d, FRONT).valid.item()


# --- the reference's cone test against a float64 root-find ------------------

def random_cones(rng, n):
    cones = []
    for i in range(n):
        base = rng.uniform(-1.0, 1.0, 3)
        axis = rng.normal(size=3)
        apex = base + axis / np.linalg.norm(axis) * rng.uniform(0.2, 1.0)
        r0 = rng.uniform(0.02, 0.3)
        r1 = (r0, 0.0, rng.uniform(0.02, 0.3))[i % 3]  # cylinders, full cones, truncated
        if i % 6 == 4:
            r0, r1 = r1, r0  # a tip at the base
        cones.append({"base": base.tolist(), "base_radius": float(r0), "apex": apex.tolist(),
                      "apex_radius": float(r1)})
    return cones


def random_rays(rng, n):
    """Origins 3 out, aimed at points of the cones' box."""
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-1.0, 1.0, (n, 3)) - o
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def root_find(raw, o, d, front_only):
    """(prim, t) of each ray's nearest hit in float64: along a ray the
    implicit surface f(p) = |p's part off the axis|^2 - r(h)^2 is a
    quadratic in t, fitted through three of its values and solved by
    np.roots; a root counts where t > 0 and 0 <= h <= L, and faces front
    where f falls along the ray."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    base, apex = raw.cone_base.astype(np.float64), raw.cone_apex.astype(np.float64)
    r0, r1 = raw.cone_base_r.astype(np.float64), raw.cone_apex_r.astype(np.float64)
    first = raw.n_tri + raw.n_sph
    prim, best = np.full(len(o), -1), np.full(len(o), np.inf)
    for c in range(raw.n_cone):
        length = np.linalg.norm(apex[c] - base[c])
        a = (apex[c] - base[c]) / length

        def f(p):
            h = (p - base[c]) @ a
            rho = (p - base[c]) - h[..., None] * a
            return (rho * rho).sum(-1) - (r0[c] + (r1[c] - r0[c]) * h / length) ** 2

        for i in range(len(o)):
            ts = np.array([0.0, 1.0, 2.0])
            coef = np.polyfit(ts, f(o[i] + ts[:, None] * d[i]), 2)
            for t in np.roots(coef):
                if abs(t.imag) > 0 or t.real <= 0.0:
                    continue
                t = t.real
                h = (o[i] + t * d[i] - base[c]) @ a
                if not 0.0 <= h <= length:
                    continue
                if front_only and np.polyval(np.polyder(coef), t) > 0.0:
                    continue
                if t <= best[i]:
                    prim[i], best[i] = first + c, t
    return prim, best


@pytest.fixture(scope="module")
def random_scene():
    rng = np.random.default_rng(20241)
    raw = scenes.parse(scene_data(*random_cones(rng, 64)))
    o, d = random_rays(rng, 1000)
    return raw, o, d


@pytest.mark.parametrize("face", [BOTH, FRONT])
@pytest.mark.parametrize("on", ["cpu", "card"])
def test_cast_agrees_with_a_float64_root_find(random_scene, face, on, request):
    """On the CPU, and on the card (`card`: skips without one), where a
    cone cell's check would run it."""
    raw, o, d = random_scene
    dev = "cpu" if on == "cpu" else request.getfixturevalue("card")
    w, n = world.World(raw, dev), len(o)
    with world.tf32_off():
        hit = w.cast(torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
                     torch.full((n,), face, device=dev), torch.full((n,), -1, device=dev),
                     torch.full((n,), FRONT, device=dev))
    prim, t = root_find(raw, o, d, front_only=face == FRONT)
    assert (prim >= 0).sum() > 300  # most rays meet a cone
    np.testing.assert_array_equal(hit.prim.cpu().numpy(), prim)
    hits = prim >= 0
    np.testing.assert_allclose(hit.t.cpu().numpy()[hits], t[hits], rtol=1e-4)


def test_cone_test_runs_in_the_bfloat16_control(random_scene):
    """The control runs the same cone test in bfloat16: the closed forms
    to its precision, and on the random scene hits that are cones at t > 0
    (bfloat16 rounds |rho_w|^2 - q^2 far off the cone's own size, so many
    thin cones seen from afar come out wrong, as the control should)."""
    bf = torch.bfloat16
    cyl = world.World(scenes.parse(scene_data(CYLINDER)), "cpu", bf)
    for face, t, back in ((FRONT, 2.5, False), (BACK, 3.5, True)):
        hit = cast(cyl, [3.0, 0.0, 1.0], [-1.0, 0.0, 0.0], face)
        assert hit.t.dtype == bf and hit.prim.item() == 2 and hit.backface.item() == back
        assert hit.t.item() == pytest.approx(t, rel=1e-2)
    cone = world.World(scenes.parse(scene_data(CONE)), "cpu", bf)
    hit = cast(cone, [2.0, 0.0, 0.5], [-1.0, 0.0, 0.0], FRONT)
    assert hit.t.item() == pytest.approx(1.5, rel=1e-2)
    np.testing.assert_allclose(hit.normal[0].float(), [math.sqrt(0.5), 0.0, math.sqrt(0.5)],
                               atol=1e-2)
    raw, o, d = random_scene
    w, n = world.World(raw, "cpu", bf), len(o)
    hit = w.cast(torch.as_tensor(o).to(bf), torch.as_tensor(d).to(bf), torch.full((n,), BOTH),
                 torch.full((n,), -1), torch.full((n,), FRONT))
    assert hit.valid.any()
    assert ((hit.prim[hit.valid] >= 2) & (hit.prim[hit.valid] < 2 + raw.n_cone)).all()
    assert (hit.t[hit.valid] > 0.0).all() and torch.isfinite(hit.t[hit.valid]).all()


# --- exclusion, shadows and the walks ---------------------------------------

@pytest.mark.parametrize("excl_prim, excl_face, t", [
    (2, FRONT, 3.5),  # the front root dropped, the same cylinder's back root stays
    (2, BACK, 2.5),
    (2, BOTH, None),
    (0, BOTH, 2.5),  # another prim excluded
])
def test_the_exclusion_drops_a_root_not_the_cone(cylinder, excl_prim, excl_face, t):
    hit = cast(cylinder, [3.0, 0.0, 1.0], [-1.0, 0.0, 0.0], BOTH, excl_prim, excl_face)
    if t is None:
        assert not hit.valid.item()
    else:
        assert hit.prim.item() == 2 and hit.t.item() == pytest.approx(t, abs=1e-6)


@pytest.mark.parametrize("excl_prim, excl_face, limit, blocked", [
    (-1, FRONT, 3.0, True),  # the front root at 2.5 lies nearer
    (-1, FRONT, 2.0, False),
    (2, FRONT, 3.0, False),  # the back root at 3.5 is left, beyond the limit
    (2, FRONT, 4.0, True),
    (2, BOTH, 4.0, False),
])
def test_the_shadow_limit_sees_cones(cylinder, excl_prim, excl_face, limit, blocked):
    got = cast(cylinder, [3.0, 0.0, 1.0], [-1.0, 0.0, 0.0], BOTH, excl_prim, excl_face, limit)
    assert got.item() == blocked


def test_walks_cast_cones():
    """A cylinder between the camera and a floor: the Whitted and Monte-Carlo
    walks see it (in float32 and in the bfloat16 control), and the shade at
    a floor point behind it from the light is blocked."""
    floor = {"material": MAT, "squares": [{"p": [[-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]]}]}
    data = scene_data(CYLINDER, far=False)
    data["objects"].insert(0, floor)
    data["lights"] = [{"type": "point", "origin": [0.0, -3.0, 1.0], "color": [1.0, 1.0, 1.0]}]
    no_cones = copy.deepcopy(data)
    no_cones["objects"][1]["cones"] = []
    raw, bare = scenes.parse(data), scenes.parse(no_cones)
    rng = np.random.default_rng(3)
    o = np.tile(np.asarray(CAMERA["center"], np.float32), (64, 1))
    d = np.stack([rng.uniform(-0.15, 0.15, 64), np.ones(64), rng.uniform(-0.3, 0.05, 64)], 1)
    o, d = torch.as_tensor(o), torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                                               dtype=torch.float32)
    unifs = torch.as_tensor(rng.uniform(0.0, 1.0, (3, 3, 64)), dtype=torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        w, w0 = world.World(raw, "cpu", dtype), world.World(bare, "cpu", dtype)
        x, xd, xu = o.to(dtype), d.to(dtype), unifs.to(dtype)
        hit = w.cast(x, xd, torch.full((64,), FRONT), torch.full((64,), -1),
                     torch.full((64,), FRONT))
        assert (hit.prim == 2).any() and (hit.prim == 0).any() | (hit.prim == 1).any()
        img, img0 = world.whitted(w, x, xd, depth=2), world.whitted(w0, x, xd, depth=2)
        assert torch.isfinite(img).all() and not torch.equal(img, img0)
        ph = world.distributed(w, x, xd, xu, depth=3)
        ph0 = world.distributed(w0, x, xd, xu, depth=3)
        assert torch.isfinite(ph).all() and not torch.equal(ph, ph0)
    # the floor point behind the cylinder from the light: in its shadow
    w = world.World(raw, "cpu")
    p, light = torch.tensor([[0.0, 3.0, 0.0]]), torch.tensor([0.0, -3.0, 1.0])
    to_light = light - p
    dist = torch.linalg.vector_norm(to_light, dim=-1)
    back = torch.tensor([BACK])
    assert w.cast(p, to_light / dist[:, None], back, torch.tensor([-1]), back, limit=dist).item()


# --- the roofline's count and the program's scene --------------------------

def test_the_roofline_counts_cones():
    from raytracer_tpu_torch.config import RenderConfig

    ctx = {"units": 1, "casts": 1e12, "cfg": RenderConfig()}
    plain = readings.mc_least_ms(dict(ctx, raw=scenes.parse(scene_data())))
    coned = readings.mc_least_ms(dict(ctx, raw=scenes.parse(scene_data(CYLINDER, CONE))))
    # ops-bound at 10^12 casts: 2 cones add 2 x OPS_CONE operations a cast
    assert coned - plain == pytest.approx(1e12 * 2 * readings.OPS_CONE / readings.PEAK_FP32 * 1e3,
                                          rel=1e-9)


def test_program_scene_refuses_cones_the_port_cannot_build():
    with pytest.raises(NotImplementedError, match="push_cone"):
        scenes.program_scene(scenes.parse(scene_data(CYLINDER)), "cpu")


def test_program_scene_hands_push_cone_each_cone(monkeypatch):
    from raytracer_tpu_torch.scene import builder

    calls = []

    class Proxy(builder.ObjectProxy):
        def push_cone(self, base, base_radius, apex, apex_radius):
            calls.append((self.object_index, np.asarray(base).tolist(), base_radius,
                          np.asarray(apex).tolist(), apex_radius))
            return self

    class Builder(builder.SceneBuilder):
        def push_object(self, material):
            self._materials.append(material)
            return Proxy(self, len(self._materials) - 1)

    monkeypatch.setattr(builder, "SceneBuilder", Builder)
    scene, _ = scenes.program_scene(scenes.parse(scene_data(CYLINDER, CONE)), "cpu")
    assert calls == [(1, [0.0, 0.0, 0.0], 0.5, [0.0, 0.0, 2.0], 0.5),
                     (1, [0.0, 0.0, 0.0], 1.0, [0.0, 0.0, 1.0], 0.0)]
    assert all(isinstance(c[2], float) and isinstance(c[4], float) for c in calls)


def test_program_scene_makes_no_new_call_without_cones(monkeypatch):
    from raytracer_tpu_torch.scene import builder

    def refuse(*args):
        raise AssertionError("push_cone called on a scene without cones")

    monkeypatch.setattr(builder.ObjectProxy, "push_cone", refuse, raising=False)
    scenes.program_scene(scenes.parse(scene_data()), "cpu")
