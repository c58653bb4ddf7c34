"""The port's BVH / blocked build and blocked sweeps against raytracer_tpu.

The tables must equal the JAX package's exactly (both build them in
numpy from the same vertices).  The blocked plain sweeps are held against
the dense plain sweeps on the same scene and against JAX's `cast`, which on
the CPU traverses the BVH (ops/intersect_bvh.py).  Rays are numpy-seeded
and cover all three faces, exclusions and axis-parallel directions.

Tolerances: blocked and dense nearest sweeps compute each triangle's t
with the same arithmetic and break ties on the larger original id, so
their winners agree exactly; against JAX's BVH traversal >= 99.5 % of
winners (f32 op order in the JAX gathers), floats within atol = rtol =
1e-4.  Blocked shadows use the unfactored per-lane direction and the dense
ones the factored-target algebra, which agree in real arithmetic but not
bit for bit at razor edges (raytracer_tpu/ops/kernel_common.py:1419):
>= 99.5 % of lanes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import intersect as jintersect
from raytracer_tpu.scene import blocked as jblocked
from raytracer_tpu.scene import bvh as jbvh
from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu.scene.types import Rays
from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.scene import presets as tpresets
from raytracer_tpu_torch.scene.blocked import (
    BLK_CHUNK,
    SUP_CHUNKS,
    build_blocked,
    validate_blocked,
)
from raytracer_tpu_torch.scene.bvh import build_bvh, validate_bvh
from raytracer_tpu_torch.scene.convert import from_jax_scene
from raytracer_tpu_torch.scene.types import BVH_FIELDS
from raytracer_tpu_torch.utils import kernels

torch.set_num_threads(1)

N = 3072
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def mesh():
    """mesh_scene(grid=24): 1,164 triangles in 10 chunks, 2 supergroups."""
    scene, _ = tpresets.mesh_scene(24)
    return scene, kc.DenseGeom(scene.tables), scene.geom


@pytest.mark.parametrize("grid", [4, 8])
def test_bvh_and_blocked_tables_equal_jax(grid):
    jscene, _, _ = jpresets.mesh_scene(grid)
    scene, _ = tpresets.mesh_scene(grid)
    for name in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(scene, name).numpy(),
                                      np.asarray(getattr(jscene, name)), err_msg=name)
    assert scene.bvh_depth == jscene.bvh_depth
    tri_v = scene.tri_v.numpy()
    bvh, jb = build_bvh(tri_v), jbvh.build_bvh(tri_v)
    for f in dataclasses.fields(bvh):
        np.testing.assert_array_equal(getattr(bvh, f.name), getattr(jb, f.name), err_msg=f.name)
    perm, boxes = build_blocked(tri_v, bvh.prim_order)
    jperm, jboxes = jblocked.build_blocked(tri_v, jb.prim_order)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(boxes, jboxes)
    validate_bvh(bvh, tri_v)
    validate_blocked(perm, boxes, tri_v)
    # chunk padding: a multiple of SUP_CHUNKS chunks, pad chunks inverted
    nch = boxes.shape[0]
    assert nch % SUP_CHUNKS == 0 and perm.shape[0] == nch * BLK_CHUNK
    used = -(-scene.n_tri // BLK_CHUNK)
    assert (boxes[used:, 0:3] > 1e38).all() and (boxes[used:, 3:6] < -1e38).all()


def _rays(n, seed):
    """Origins above the terrain, aimed at points on it and around the
    glass cube and spheres; every 8th lane axis-parallel instead; faces
    0/1/2."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-3.5, 0.2, -3.5], [3.5, 3.0, 3.5], size=(n, 3)).astype(np.float32)
    target = rng.uniform([-3.0, -0.4, -3.0], [3.0, 1.4, 3.0], size=(n, 3)).astype(np.float32)
    d = target - o
    axis = np.arange(n) % 8 == 0
    ax = np.zeros((axis.sum(), 3), np.float32)
    ax[np.arange(axis.sum()), rng.integers(0, 3, axis.sum())] = rng.choice([-1.0, 1.0], axis.sum())
    d[axis] = ax
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    face = rng.choice([0, 1, 2], size=n).astype(np.int32)
    return o, d.astype(np.float32), face


def _sweep(geom, o, d, face, excl, excl_face):
    n = o.shape[0]
    t = torch.as_tensor
    return geom.nearest(tuple(t(o.T.copy())), tuple(t(d.T.copy())), t(face), t(excl),
                        t(excl_face), torch.ones(n, dtype=torch.bool))


def test_blocked_nearest_matches_dense_and_jax_cast(mesh):
    scene, dense, blocked = mesh
    o, d, face = _rays(N, 1)
    n = o.shape[0]
    no_excl = np.full(n, -1, np.int32)
    first = _sweep(dense, o, d, face, no_excl, np.zeros(n, np.int32))
    # exclude each ray's own hit on a third of the lanes, face by lane
    excl = np.where(np.arange(n) % 3 == 0, first["prim"].numpy(), -1).astype(np.int32)
    excl_face = (np.arange(n) % 3).astype(np.int32)
    ref = _sweep(dense, o, d, face, excl, excl_face)
    got = _sweep(blocked, o, d, face, excl, excl_face)
    assert ref["valid"].float().mean() > 0.3
    for k in ("valid", "prim", "obj", "backface"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)
    for k in ("t", "px", "py", "pz", "nx", "ny", "nz", "u", "v"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), err_msg=k, **TOL)

    jscene, _, _ = jpresets.mesh_scene(24)
    rays = Rays(o=jnp.asarray(o), d=jnp.asarray(d), face=jnp.asarray(face),
                excl_prim=jnp.asarray(excl), excl_face=jnp.asarray(excl_face))
    h = jintersect.cast(jscene, rays)
    jprim = np.where(np.asarray(h.valid), np.asarray(h.prim), -1)
    same = got["prim"].numpy() == jprim
    assert same.mean() >= 0.995, (~same).sum()
    sel = same & np.asarray(h.valid)
    np.testing.assert_allclose(got["t"].numpy()[sel], np.asarray(h.t)[sel], **TOL)
    np.testing.assert_allclose(np.stack([got[k].numpy() for k in ("nx", "ny", "nz")], -1)[sel],
                               np.asarray(h.normal)[sel], **TOL)


def _shuffled(bt: kc.BlkTables, seed):
    """The same blocked tables with supergroups, and chunks within each,
    in a random order; every chunk is visited (n_chunks = NCH), so the
    pad chunks and the pad rows are swept too."""
    rng = np.random.default_rng(seed)
    nch = bt.box.shape[0]
    order = np.concatenate([s * SUP_CHUNKS + rng.permutation(SUP_CHUNKS)
                            for s in rng.permutation(nch // SUP_CHUNKS)])
    rows = (order[:, None] * BLK_CHUNK + np.arange(BLK_CHUNK)).reshape(-1)
    box = bt.box[order].contiguous()
    return kc.BlkTables(bt.tri[rows].contiguous(), box, kc.pack_sup(box),
                        bt.chunk_of_prim, nch)


def test_shuffled_supergroup_order_gives_identical_hits(mesh):
    scene, _, blocked = mesh
    o, d, face = _rays(N, 2)
    n = o.shape[0]
    args = (o, d, face, np.full(n, -1, np.int32), np.zeros(n, np.int32))
    ref = _sweep(blocked, *args)
    got = _sweep(kc.BlockedGeom(scene.tables, _shuffled(scene.blk_tables, 5)), *args)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    # the interior sweep too
    p = tuple(torch.as_tensor(o.T.copy()))
    dd = tuple(torch.as_tensor(d.T.copy()))
    act = torch.ones(n, dtype=torch.bool)
    for a, b in zip(blocked.back(*p, *dd, act),
                    kc.BlockedGeom(scene.tables, _shuffled(scene.blk_tables, 6)).back(*p, *dd, act)):
        assert torch.equal(a, b)


def test_blocked_shadows_and_march_match_dense(mesh):
    scene, dense, blocked = mesh
    o, d, _ = _rays(N, 3)
    n = o.shape[0]
    front = np.zeros(n, np.int32)
    h = _sweep(dense, o, d, front, np.full(n, -1, np.int32), front)
    valid = h["valid"]
    m = kc.eval_material(scene.tables, scene.textures, h["obj"], h["u"], h["v"])
    dt = tuple(torch.as_tensor(d.T.copy()))
    shade = {}
    for name, geom in (("dense", dense), ("blocked", blocked)):
        shade[name] = kc.shade_at(geom, m, h["px"], h["py"], h["pz"], h["nx"], h["ny"],
                                  h["nz"], *dt, valid, h["prim"])
    a, b = shade["blocked"], shade["dense"]
    assert (a[3] == b[3]).float().mean() >= 0.995  # shadow rays per lane
    rgb_a, rgb_b = torch.stack(a[:3], -1).numpy(), torch.stack(b[:3], -1).numpy()
    close = np.all(np.abs(rgb_a - rgb_b) <= 1e-4 + 1e-4 * np.abs(rgb_b), axis=-1)
    assert close.mean() >= 0.995, (~close).sum()
    assert (rgb_b[valid.numpy()] > 0).any() and (rgb_b[valid.numpy()] == 0).any()

    # interior march: glass cube and glass sphere hits, both geometries
    want = valid & (m["transparency"] > 0)
    assert int(want.sum()) > 20
    pos = (h["px"], h["py"], h["pz"])
    nrm = (h["nx"], h["ny"], h["nz"])
    mr = {name: kc.march_rows(*pos, *nrm, *dt, m["refraction"], want, geom, 100.0, 10)
          for name, geom in (("dense", dense), ("blocked", blocked))}
    for k in ("escaped", "iters", "prim"):
        assert torch.equal(mr["blocked"][k], mr["dense"][k]), k
    sel = mr["dense"]["escaped"].numpy()
    for k in ("travel", "ex", "ey", "ez", "odx", "ody", "odz"):
        np.testing.assert_allclose(mr["blocked"][k].numpy()[sel], mr["dense"][k].numpy()[sel],
                                   err_msg=k, **TOL)


def test_slab_test_keeps_the_nan_miss_and_inclusive_tmax():
    box = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    o = torch.tensor([[-1.0, 0.5, 0.5], [0.0, -1.0, 0.5], [-1.0, 0.5, 0.5], [2.0, 2.0, 2.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    inv = 1.0 / d
    tmax = torch.tensor([1.0, 10.0, 0.5, 10.0])
    got = kc.slab(box, *o.T, *inv.T, tmax)
    # enters at t == tmax: inclusive; origin in the x = 0 face plane with
    # dx = 0 gives 0 * inf = NaN: a miss; box beyond tmax; box behind
    assert got.tolist() == [True, False, False, False]


def _check_hot_tables(scene):
    """The cooperative sweeps' tables against the blocked rows they mirror."""
    bt = scene.blk_tables
    nch = bt.box.shape[0]
    assert torch.equal(bt.hot, bt.tri[:, :kc.HOT_COLS])
    assert bt.ids.dtype == torch.int32 and torch.equal(bt.ids, bt.tri[:, kc.BLK_ID].to(torch.int32))
    assert torch.equal(bt.ids, scene.blk_perm)
    ids = bt.ids.view(nch, BLK_CHUNK)
    assert bt.live.dtype == torch.int32 and torch.equal(bt.live, (ids >= 0).sum(1).to(torch.int32))
    assert int(bt.live.sum()) == scene.n_tri and int(bt.live[bt.n_chunks:].sum()) == 0
    # every pad row lies after its chunk's live rows: a row loop that runs to
    # live[c] sees exactly the rows a loop that stops at the first pad row sees
    k = torch.arange(BLK_CHUNK)[None, :]
    assert torch.equal(ids >= 0, k < bt.live[:, None])
    # 64-byte rows on a 16-byte-aligned base, as the kernels' float4 loads need
    assert bt.hot.dtype == torch.float32 and bt.hot.is_contiguous()
    assert bt.hot.stride(0) * bt.hot.element_size() == 64 and bt.hot.data_ptr() % 16 == 0
    # the triangles' rows invert the ids
    assert bt.row_of_tri.dtype == torch.int32 and bt.row_of_tri.shape == (scene.n_tri,)
    assert torch.equal(bt.ids[bt.row_of_tri.long()], torch.arange(scene.n_tri, dtype=torch.int32))
    assert torch.equal(bt.chunk_of_prim[:scene.n_tri], bt.row_of_tri.long() // BLK_CHUNK)
    kc.check_tables(scene.tables, scene.device, bt)
    geo = kc.kernel_geometry(scene.tables, bt, hot=True)
    assert geo[-4:] == (bt.hot, bt.ids, bt.live, bt.row_of_tri)
    assert len(geo) == len(kernels._TABLES + kernels._BLK + kernels._HOT)


@pytest.mark.parametrize("grid", [8, 24])
def test_hot_tables_mirror_the_blocked_rows(grid):
    scene, _ = tpresets.mesh_scene(grid)
    _check_hot_tables(scene)
    # a scene moved to a device rebuilds them from its blk_perm
    _check_hot_tables(scene.to("cpu"))


def test_hot_tables_of_a_scene_carried_over_from_jax():
    jscene, _, _ = jpresets.mesh_scene(8)
    fields = {f.name: np.asarray(getattr(jscene, f.name)) for f in dataclasses.fields(jscene)
              if isinstance(getattr(jscene, f.name), jnp.ndarray)}
    scene = from_jax_scene(fields)
    assert scene.blocked
    _check_hot_tables(scene)
    ours, _ = tpresets.mesh_scene(8)
    for name in ("hot", "ids", "live", "row_of_tri"):
        assert torch.equal(getattr(scene.blk_tables, name), getattr(ours.blk_tables, name)), name


def test_check_tables_refuses_hot_tables_the_kernels_cannot_read():
    scene, _ = tpresets.mesh_scene(8)
    tb, bt = scene.tables, scene.blk_tables
    with pytest.raises(ValueError):
        kc.check_tables(tb, scene.device, bt._replace(ids=bt.ids.long()))
    with pytest.raises(ValueError):
        kc.check_tables(tb, scene.device, bt._replace(live=bt.live[:-1]))
    with pytest.raises(ValueError):  # rows cut out of a wider table: not contiguous
        kc.check_tables(tb, scene.device, bt._replace(hot=bt.tri[:, :kc.HOT_COLS]))
    with pytest.raises(ValueError):
        kc.kernel_geometry(tb, bt._replace(hot=None), hot=True)


def test_chunk_log_reduces_lanes_per_group_and_per_pass():
    log = kc.ChunkLog(70, "cpu", groups=(32, 64))
    a = torch.zeros(70, dtype=torch.bool)
    a[[0, 1, 40, 69]] = True
    b = torch.zeros(70, dtype=torch.bool)
    b[[1, 2]] = True
    log.enter(3, a)  # a sweep of its own: groups 0, 1 and 2 of 32 enter chunk 3
    with log.one_pass():  # two lights: chunk 3 twice, chunk 5 once
        log.enter(3, a)
        log.enter(3, b)
        log.enter(5, b)
    assert log.lane.tolist()[:3] == [2, 4, 2] and int(log.lane.sum()) == 4 + 4 + 2 + 2
    assert log.group[32].tolist() == [1 + 1 + 1, 1 + 1, 1 + 1]
    assert log.group[64].tolist() == [1 + 1 + 1, 1 + 1]


def test_plain_blocked_sweeps_report_the_chunks_they_enter(mesh):
    scene, _, blocked = mesh
    o, d, face = _rays(N, 4)
    n = o.shape[0]
    args = (o, d, face, np.full(n, -1, np.int32), np.zeros(n, np.int32))
    ref = _sweep(blocked, *args)
    with kc.count_chunks(n) as log:
        got = _sweep(blocked, *args)
    assert kc._chunk_log is None
    for k in ref:  # logging changes no result
        assert torch.equal(got[k], ref[k]), k
    lane, warp = log.lane, log.group[32]
    # a lane that hit a triangle entered the winner's chunk
    tri_hit = ref["valid"] & (ref["prim"] < scene.n_tri)
    assert bool((lane[tri_hit] >= 1).all()) and int(lane.max()) <= scene.blk_tables.n_chunks
    # a warp stages the union of its lanes' chunks
    per_warp = lane.view(-1, 32)
    assert bool((warp >= per_warp.max(dim=1).values).all())
    assert bool((warp <= per_warp.sum(dim=1)).all()) and int(warp.sum()) < int(lane.sum())
    # the shadow rays of one shading point share one pass over the chunks
    h = ref
    m = kc.eval_material(scene.tables, scene.textures, h["obj"], h["u"], h["v"])
    dt = tuple(torch.as_tensor(d.T.copy()))
    shade = lambda: kc.shade_at(blocked, m, h["px"], h["py"], h["pz"], h["nx"], h["ny"], h["nz"],
                                *dt, h["valid"], h["prim"])
    with kc.count_chunks(n, groups=(1,)) as log:
        got = shade()
    assert all(torch.equal(a, b) for a, b in zip(got, shade()))
    rays = got[3]  # shadow rays per lane
    assert int(log.lane.sum()) > int(log.group[1].sum()) > 0  # lights share chunks
    assert bool((log.lane[rays == 0] == 0).all()) and bool((log.group[1] <= log.lane).all())
