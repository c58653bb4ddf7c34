"""The sphere chunk table (scene/blocked.py build_sph_chunks) and the sphere
sweeps it gates, on the CPU's plain path.

The table's invariants; the plain gated nearest, shadow and interior
sweeps against the plain linear ones on the sphereflake at size factors 2
and 3 (91 and 820 spheres), on random rays, grazing rays, rays from sphere
surfaces and planted exact ties, each giving the same hits and strictly
fewer sphere tests; the whole plain MC walk gated against linear; the
counter `mc.sph_box_tests`; the constants the kernels share.  On a card
(the `card` tests, which skip without one) the gated kernels against the
linear ones, bit for bit, and their counts."""

import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.ops import mc_kernel
from raytracer_tpu_torch.scene import presets
from raytracer_tpu_torch.scene.blocked import (SPH_CHUNK, SPH_PAD, SPH_SUP, build_sph_chunks,
                                               validate_sph_chunks)
from raytracer_tpu_torch.scene.builder import MaterialSpec, SceneBuilder
from raytracer_tpu_torch.scene.bvh import build_bvh
from raytracer_tpu_torch.scene.types import FACE_BACK, FACE_FRONT, NO_EXCLUDE
from raytracer_tpu_torch.utils import kernels, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import frame  # noqa: E402
from rtbench import scenes  # noqa: E402

torch.set_num_threads(2)

# the planted ties (flake_with_ties): a copy of sphere TIE_SPHERE appended
# last, and a sphere touching a triangle where a ray meets both at t = 1
TIE_SPHERE = 5
TOUCH_C, TOUCH_R = (5.0, 0.0, 1.5), 0.5


def flake_with_ties(size_factor: int, device="cpu"):
    """The sphereflake, plus: a copy of sphere TIE_SPHERE (the same centre
    and radius, the last index: an exact tie on every ray that hits it), a
    triangle in the plane z = 1 facing -z around (5, 0), and the sphere
    TOUCH_C, TOUCH_R resting on it from above, so that the ray from (5, 0,
    0) along +z meets both at exactly t = 1."""
    b = presets.spd_balls_builder(size_factor)
    centers, radii, _ = presets.spd_balls_spheres(size_factor)
    extra = b.push_object(MaterialSpec(shiness=0.5))
    extra.push_sphere(centers[TIE_SPHERE], float(radii[TIE_SPHERE]))
    extra.push_sphere(TOUCH_C, TOUCH_R)
    extra.push_triangles([[  # wound so that its normal is -z
        _vertex((4.0, -1.0, 1.0)), _vertex((6.0, 1.0, 1.0)), _vertex((6.0, -1.0, 1.0))]])
    return b.build(device=device)


def _vertex(p):
    from raytracer_tpu_torch.scene.builder import Vertex

    return Vertex(np.asarray(p, np.float32), np.asarray((0, 0, -1), np.float32),
                  np.zeros(2, np.float32))


def spd_camera() -> dict:
    """The benchmark's spd-balls camera (every size factor's)."""
    with open(os.path.join(BENCH, "scenes", "spd-balls.json")) as f:
        return scenes.parse(json.load(f)).camera


def linear(scene):
    """The same scene without the sphere chunk table."""
    return dataclasses.replace(scene, sph_perm=None, sph_box=None)


def _unit(v):
    return v / v.norm(dim=1, keepdim=True)


def _dist2(c, o, d):
    """The sweeps' squared distance of centres c from rays (o, d), rounded as
    they round it."""
    wx, wy, wz = c[:, 0] - o[:, 0], c[:, 1] - o[:, 1], c[:, 2] - o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    qx = wy * dz - wz * dy
    qy = wz * dx - wx * dz
    qz = wx * dy - wy * dx
    return qx * qx + qy * qy + qz * qz


def grazing_rays(scene, n, gen):
    """Rays whose f32 squared distance from a sphere's centre lies within
    one ulp of its f32 r^2, about half of them accepted (dist2 <= r^2), from
    origins 1 to 20 units away -> (o, d, the sphere index, accepted)."""
    c_all, r2_all = scene.sph_c, scene.sph_r ** 2
    os_, ds, js, acc = [], [], [], []
    while sum(len(x) for x in os_) < n:
        j = torch.randint(0, scene.n_sph, (4096,), generator=gen)
        d = _unit(torch.randn(4096, 3, generator=gen))
        e = _unit(torch.linalg.cross(d, torch.randn(4096, 3, generator=gen)))
        c, r = c_all[j], scene.sph_r[j]
        far = 1.0 + 19.0 * torch.rand(4096, 1, generator=gen)
        scale = 1.0 + (torch.rand(4096, 1, generator=gen) - 0.5) * 4e-6
        o = c + e * (r[:, None] * scale) - d * far
        d2, r2 = _dist2(c, o, d), r2_all[j]
        keep = (d2 - r2).abs() <= torch.finfo(torch.float32).eps * r2
        os_.append(o[keep])
        ds.append(d[keep])
        js.append(j[keep])
        acc.append(d2[keep] <= r2[keep])
    o, d, j, acc = (torch.cat(x)[:n] for x in (os_, ds, js, acc))
    return o, d, j, acc


def surface_points(scene, n, gen):
    """Points on sphere surfaces (f32) with outward normals -> (p, normal,
    sphere index)."""
    j = torch.randint(0, scene.n_sph, (n,), generator=gen)
    nrm = _unit(torch.randn(n, 3, generator=gen))
    return scene.sph_c[j] + nrm * scene.sph_r[j][:, None], nrm, j


def ray_sets(scene, gen):
    """name -> (o, d, face, excl_prim, excl_face) for the nearest sweep."""
    n = 2048
    i32 = lambda v: torch.full((n,), v, dtype=torch.int32)
    front = i32(FACE_FRONT)
    out = {}
    o = torch.randn(n, 3, generator=gen) * 3.0
    tgt = scene.sph_c[torch.randint(0, scene.n_sph, (n,), generator=gen)]
    out["random"] = (o, _unit(tgt + 0.05 * torch.randn(n, 3, generator=gen) - o), front,
                     i32(NO_EXCLUDE), front)
    o, d, _, _ = grazing_rays(scene, n, gen)
    out["grazing"] = (o, d, front, i32(NO_EXCLUDE), front)
    p, nrm, j = surface_points(scene, n, gen)
    d = _unit(torch.randn(n, 3, generator=gen))
    d = torch.where((d * nrm).sum(1, keepdim=True) < 0, -d, d)  # leaving the surface
    excl_face = torch.where(torch.rand(n, generator=gen) < 0.5, FACE_FRONT, FACE_BACK)
    out["surface"] = (p, d, front, (scene.n_tri + j).to(torch.int32), excl_face.to(torch.int32))
    # the ties: rays at the copied sphere, and the ray onto the touching pair
    c = scene.sph_c[TIE_SPHERE]
    o = c + _unit(torch.randn(n, 3, generator=gen)) * 2.0
    o[0] = torch.tensor([TOUCH_C[0], TOUCH_C[1], 0.0])
    d = _unit(c + 0.3 * float(scene.sph_r[TIE_SPHERE]) * torch.randn(n, 3, generator=gen) - o)
    d[0] = torch.tensor([0.0, 0.0, 1.0])
    out["ties"] = (o, d, front, i32(NO_EXCLUDE), front)
    return out


@pytest.fixture(scope="module", params=[2, 3])
def flakes(request):
    scene = flake_with_ties(request.param)
    assert scene.sph_perm is not None
    return scene, linear(scene)


def _sweep(fn, n):
    with kc.count_sph_tests(n) as (tests, boxes):
        out = fn()
    return out, tests, boxes


# ---- the table -------------------------------------------------------------


@pytest.mark.parametrize("size_factor", [2, 3, 4])
def test_the_chunk_table_holds_every_sphere_once_in_its_boxes(size_factor):
    scene = flake_with_ties(size_factor)
    perm, box = scene.sph_perm.numpy(), scene.sph_box.numpy()
    validate_sph_chunks(perm, box, scene.sph_c.numpy(), scene.sph_r.numpy())
    s = scene.n_sph
    assert box.shape == (-(-s // SPH_CHUNK), 8) and perm.shape == (box.shape[0] * SPH_CHUNK,)
    tb = scene.tables
    rows, sup = tb.sph_rows, tb.sph_sup
    live = scene.sph_perm >= 0
    # the id column is exact, the rest of a live row is pack_sph's
    assert torch.equal(rows[live, kc.SPH_ID].long(), scene.sph_perm[live].long())
    assert torch.equal(rows[live][:, [0, 1, 2, 3, 4]], tb.sph[scene.sph_perm[live].long()][:, :5])
    # pad rows trail, index -1 and r^2 -1: no squared distance lies below it
    assert (~live[s:]).all() and live[:s].all()
    assert (rows[~live, kc.SPH_ID] == -1).all() and (rows[~live, 3] == -1.0).all()
    # every sphere's f32 c +- r inside its chunk's and its supergroup's box
    lo = (scene.sph_c - scene.sph_r[:, None])
    hi = (scene.sph_c + scene.sph_r[:, None])
    chunk = torch.empty(s, dtype=torch.long)
    chunk[scene.sph_perm[live].long()] = torch.arange(perm.shape[0])[live] // SPH_CHUNK
    for tiers in (torch.as_tensor(box)[chunk], sup[chunk // SPH_SUP]):
        assert (lo >= tiers[:, 0:3]).all() and (hi <= tiers[:, 3:6]).all()
    assert sup.shape == (-(-box.shape[0] // SPH_SUP), 8)
    # widened past c +- r by SPH_PAD times the spheres' reach, not a bare ulp
    reach = float((scene.sph_c.abs() + scene.sph_r[:, None]).max())
    assert float((lo - torch.as_tensor(box)[chunk][:, 0:3]).min()) >= SPH_PAD * reach * 0.99


@pytest.mark.parametrize("n_sph,blocked,table", [(3, False, False), (SPH_CHUNK, False, False),
                                                 (SPH_CHUNK + 1, False, True),
                                                 (SPH_CHUNK + 1, True, False)])
def test_only_dense_scenes_past_one_chunk_of_spheres_carry_the_table(n_sph, blocked, table):
    b = SceneBuilder()
    obj = b.push_object(MaterialSpec())
    for i in range(n_sph):
        obj.push_sphere((float(i), 0.0, 0.0), 0.25)
    obj.push_triangles([[_vertex((0.0, -1.0, 0.0)), _vertex((1.0, -1.0, 0.0)),
                         _vertex((0.0, -1.0, 1.0))]])
    b.push_point_light((0.0, 5.0, 0.0), (1.0, 1.0, 1.0))
    scene = b.build(use_bvh=blocked, device="cpu")
    assert scene.blocked is blocked
    assert (scene.sph_perm is not None) is table and (scene.sph_box is not None) is table
    assert (scene.tables.sph_rows is not None) is table
    assert presets.demo_scene(device="cpu").sph_perm is None  # 4 spheres
    moved = scene.to("meta")
    assert (moved.sph_perm is not None) is table
    if table:
        assert moved.sph_perm.device.type == moved.sph_box.device.type == "meta"


@pytest.mark.parametrize("size_factor", [3, 4])
def test_chunks_are_leaves_tighter_than_the_bvh_leaf_order_cut_in_chunks(size_factor):
    """Every chunk but the last is full, and the chunks' boxes offer a ray
    (their summed surface areas) under three quarters of what build_bvh's
    leaf order, cut into chunks, offers: its cuts join leaves of distant
    subtrees."""
    c, r, _ = presets.spd_balls_spheres(size_factor)
    c, r = c.astype(np.float32), r.astype(np.float32)
    perm, box = build_sph_chunks(c, r)
    sizes = [np.count_nonzero(perm[k * SPH_CHUNK:(k + 1) * SPH_CHUNK] >= 0)
             for k in range(box.shape[0])]
    assert sizes[:-1] == [SPH_CHUNK] * (len(sizes) - 1) and sum(sizes) == len(r)
    lo, hi = c - r[:, None], c + r[:, None]

    def area(order):
        total = 0.0
        for k in range(0, len(order), SPH_CHUNK):
            e = hi[order[k:k + SPH_CHUNK]].max(axis=0) - lo[order[k:k + SPH_CHUNK]].min(axis=0)
            total += 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])
        return total

    leaves = build_bvh(np.stack([lo, hi, c], axis=1)).prim_order
    assert area(perm[perm >= 0]) < 0.75 * area(leaves)


def test_the_kernels_share_the_tables_constants():
    with open(os.path.join(kernels.CSRC, "common.cuh")) as f:
        text = f.read()
    const = lambda name: re.search(rf"constexpr \w+ {name} = ([\d.e+-]+)f?;", text).group(1)
    assert int(const("SPH_CHUNK")) == SPH_CHUNK and int(const("SPH_SUP")) == SPH_SUP
    assert int(const("SPH_ID")) == kc.SPH_ID
    assert float(const("SPH_PAD")) == SPH_PAD


# ---- the plain gated sweeps against the linear ones --------------------------


@pytest.mark.parametrize("rays", ["random", "grazing", "surface", "ties"])
def test_gated_nearest_sweep_gives_the_linear_hits(flakes, rays):
    scene, lin = flakes
    o, d, face, excl_prim, excl_face = ray_sets(scene, torch.Generator().manual_seed(7))[rays]
    n = o.shape[0]
    args = ((o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2]), face, excl_prim,
            excl_face, torch.ones(n, dtype=torch.bool))
    got, tests, boxes = _sweep(lambda: kc.full_sweep(*args, scene.tables), n)
    want, lin_tests, lin_boxes = _sweep(lambda: kc.full_sweep(*args, lin.tables), n)
    for k in ("t", "prim", "backface", "valid", "px", "py", "pz", "nx", "ny", "nz", "u", "v"):
        assert torch.equal(got[k], want[k]), k
    assert int(tests.sum()) < int(lin_tests.sum()) == n * scene.n_sph
    assert int(boxes.min()) >= -(-scene.sph_box.shape[0] // SPH_SUP) and int(lin_boxes.sum()) == 0
    assert float(got["valid"].float().mean()) > 0.3
    if rays == "ties":
        tie = scene.n_tri + scene.n_sph - 2  # the copy wins its sphere's ties
        assert (got["prim"][1:] == tie).sum() > n // 4
        assert not (got["prim"][1:] == scene.n_tri + TIE_SPHERE).any()
        assert float(got["t"][0]) == 1.0 and int(got["prim"][0]) == scene.n_tri + scene.n_sph - 1
        nb = torch.ones(1, dtype=torch.bool)  # the triangle, alone, at the same t
        tri = kc._tri_nearest((o[:1, 0], o[:1, 1], o[:1, 2]), (d[:1, 0], d[:1, 1], d[:1, 2]),
                              face[:1], excl_prim[:1], excl_face[:1], nb, scene.tables)
        assert float(tri[0][0]) == 1.0 and int(tri[1][0]) == scene.n_tri - 1
    if rays == "grazing":
        _, _, j, accepted = grazing_rays(scene, n, torch.Generator().manual_seed(7))
        assert 0.2 < float(accepted.float().mean()) < 0.8


def _shadow_rays(scene, gen, n=2048):
    """Shading points on sphere surfaces (their sphere left out) and random
    points, each with a light 1 to 10 units away -> (p, self_prim, the
    light's lt dict)."""
    p, nrm, j = surface_points(scene, n, gen)
    self_prim = (scene.n_tri + j).to(torch.int32)
    rand = torch.rand(n, generator=gen) < 0.25
    p = torch.where(rand[:, None], torch.randn(n, 3, generator=gen), p)
    self_prim = torch.where(rand, NO_EXCLUDE, self_prim).to(torch.int32)
    light = p + _unit(torch.randn(n, 3, generator=gen)) * (1.0 + 9.0 * torch.rand(n, 1,
                                                                                  generator=gen))
    off = p - light
    mag = off.norm(dim=1)
    nd = -(off / mag[:, None])
    lt = dict(ndx=nd[:, 0], ndy=nd[:, 1], ndz=nd[:, 2], slim=mag,
              act=torch.rand(n, generator=gen) < 0.9)
    return p, self_prim, lt


def test_gated_shadow_sweep_gives_the_linear_occlusion(flakes):
    scene, lin = flakes
    p, self_prim, lt = _shadow_rays(scene, torch.Generator().manual_seed(11))
    n = p.shape[0]
    got, tests, boxes = _sweep(lambda: kc._SphShadow(p[:, 0], p[:, 1], p[:, 2], self_prim,
                                                     scene.tables).blocked(lt, lt["act"]), n)
    want, lin_tests, _ = _sweep(lambda: kc._SphShadow(p[:, 0], p[:, 1], p[:, 2], self_prim,
                                                      lin.tables).blocked(lt, lt["act"]), n)
    assert torch.equal(got & lt["act"], want & lt["act"])
    assert 0.1 < float(want[lt["act"]].float().mean()) < 0.9
    assert int(tests.sum()) < int(lin_tests.sum())
    assert int(tests[~lt["act"]].sum()) == int(boxes[~lt["act"]].sum()) == 0


def test_gated_interior_sweep_gives_the_linear_hits(flakes):
    scene, lin = flakes
    gen = torch.Generator().manual_seed(13)
    n = 2048
    j = torch.randint(0, scene.n_sph, (n,), generator=gen)
    inside = 0.5 * torch.randn(n, 3, generator=gen).clamp(-1.0, 1.0)
    p = scene.sph_c[j] + scene.sph_r[j][:, None] * inside
    d = _unit(torch.randn(n, 3, generator=gen))
    active = torch.rand(n, generator=gen) < 0.9
    args = (p[:, 0], p[:, 1], p[:, 2], d[:, 0], d[:, 1], d[:, 2], active)
    got, tests, _ = _sweep(lambda: kc.back_sweep_with_normal(*args, scene.tables), n)
    want, lin_tests, _ = _sweep(lambda: kc.back_sweep_with_normal(*args, lin.tables), n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float((want[0][active] < kc.BIG).float().mean()) > 0.9
    assert int(tests.sum()) < int(lin_tests.sum())


@pytest.mark.parametrize("size_factor", [2, 3])
def test_plain_mc_walk_gated_is_the_linear_walk(size_factor):
    """The whole plain walk at 32x32, depth 5, on the sphereflake: the same
    photons and casts, far fewer sphere tests, and box tests counted."""
    scene, cam = presets.spd_balls_scene(size_factor, device="cpu")
    w = h = 32
    pixels = np.arange(w * h)
    clip = torch.as_tensor(frame.clips(w, h, pixels))
    lens, unifs = frame.pixel_draws(pixels, w, h, 1024, 5, 2**32 + 3, 1, "cpu")
    o, d = frame.shoot_focus(spd_camera(), clip, lens, 0.04, 3.0)
    out = {}
    for name, s in (("gated", scene), ("linear", linear(scene))):
        tests, boxes = (torch.zeros(w * h, dtype=torch.int64) for _ in range(2))
        photon, casts = mc_kernel.trace(s, o, d, unifs, 5, 100.0, 10, sph_tests=tests,
                                        sph_box_tests=boxes)
        out[name] = photon, int(casts), tests, boxes
    (pg, cg, tg, bg), (pl, cl, tl, bl) = out["gated"], out["linear"]
    assert torch.equal(pg, pl) and cg == cl
    assert int(tg.sum()) * 2 < int(tl.sum()) and int(bg.sum()) > 0 and int(bl.sum()) == 0
    assert float(pg.abs().sum()) > 0


def test_the_box_tests_counter_reads_only_on_a_gated_walk():
    scene, _ = presets.spd_balls_scene(2, device="cpu")
    demo = presets.demo_scene(device="cpu")
    gen = torch.Generator().manual_seed(3)
    o = torch.tensor([[2.1, 1.3, 1.7]]).repeat(64, 1)
    d = _unit(-o + 0.2 * torch.randn(64, 3, generator=gen))
    unifs = torch.rand((1, 3, 64), generator=gen)
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.unit("rt.test"):
            mc_kernel.trace(scene, o, d, unifs, 1, 100.0, 10)
    got = tracing.take().counters
    boxes = torch.zeros(64, dtype=torch.int64)
    mc_kernel.trace(scene, o, d, unifs, 1, 100.0, 10, sph_box_tests=boxes)
    assert got["mc.sph_box_tests"] == int(boxes.sum()) > 0 and got["mc.sph_tests"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.unit("rt.test"):
            mc_kernel.trace(demo, o, d, unifs, 1, 100.0, 10)
    got = tracing.take().counters
    assert "mc.sph_box_tests" not in got and got["mc.sph_tests"] > 0


# ---- on a card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_walk(scene, o, d, unifs, per_thread=False, work=False):
    n = o.shape[0]
    tests, boxes = (torch.zeros(n, dtype=torch.int64, device=o.device) for _ in range(2))
    w = (torch.zeros((len(kernels.WORK_ROWS), n), dtype=torch.int32, device=o.device)
         if work else None)
    fn = mc_kernel.trace_per_thread if per_thread else mc_kernel.trace
    photon, casts = fn(scene, o, d, unifs, 5, 100.0, 10, work=w, sph_tests=tests,
                       sph_box_tests=boxes)
    return photon, int(casts), tests, boxes, w


def _card_rays(card, w=128, h=128):
    pixels = np.arange(w * h)
    clip = torch.as_tensor(frame.clips(w, h, pixels), device=card)
    lens, unifs = frame.pixel_draws(pixels, w, h, 65536, 5, 2**33 + 9, 4, card)
    o, d = frame.shoot_focus(spd_camera(), clip, lens, 0.04, 3.0)
    return o.contiguous(), d.contiguous(), unifs


@pytest.mark.card
@pytest.mark.parametrize("size_factor", [2, 4])
def test_the_gated_walk_is_the_linear_walk_on_the_card(card, size_factor):
    scene, _ = presets.spd_balls_scene(size_factor, device=card)
    o, d, unifs = _card_rays(card)
    pg, cg, tg, bg, _ = _card_walk(scene, o, d, unifs)
    pl, cl, tl, bl, _ = _card_walk(linear(scene), o, d, unifs)
    assert torch.equal(pg, pl) and cg == cl
    assert int(tg.sum()) < int(tl.sum()) and int(bg.sum()) > 0 and int(bl.sum()) == 0
    tt, ct, _, _, _ = _card_walk(scene, o, d, unifs, per_thread=True)
    assert torch.equal(tt, pg) and ct == cg


@pytest.mark.card
@pytest.mark.parametrize("size_factor", [2, 4])
def test_the_gated_counts_agree_on_the_card(card, size_factor):
    """main (SphCount) == the counting instantiation's rows == the per-thread
    yardstick, lane for lane, for the sphere and the box tests; at size
    factor 4 a cast tests at most 400 spheres and 40 to 120 boxes."""
    scene, _ = presets.spd_balls_scene(size_factor, device=card)
    o, d, unifs = _card_rays(card)
    pm, cm, tm, bm, _ = _card_walk(scene, o, d, unifs)
    pw, cw, _, _, work = _card_walk(scene, o, d, unifs, work=True)
    _, _, tt, bt, _ = _card_walk(scene, o, d, unifs, per_thread=True)
    assert torch.equal(pm, pw) and cm == cw
    row = lambda name: work[kernels.WORK_ROWS.index(name)].long()
    assert torch.equal(tm, row("sph")) and torch.equal(tm, tt)
    assert torch.equal(bm, row("box")) and torch.equal(bm, bt)
    if size_factor == 4:
        assert int(tm.sum()) <= 400 * cm
        assert 40 * cm <= int(bm.sum()) <= 120 * cm
