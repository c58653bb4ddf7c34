"""The port's casts and standalone sweep kernels (plain versions) against
raytracer_tpu.

The same numpy-seeded rays go through the JAX functions and the port's.
The JAX Pallas kernels run in interpret mode (as tests/test_pallas.py runs
them), the JAX casts on their jnp path; the port's wrappers take their
plain versions, because the tensors lie on the CPU.

Tolerances: the sweeps are the same f32 formulas in the same order, so
validity, winner index and backface are held EQUAL lane for lane and t
within rtol 1e-5; a winner's attributes (gathers here, one-hot
contractions there) within atol 1e-5.  Miss lanes are compared by `valid`
only: their other fields are garbage in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import intersect as jintersect
from raytracer_tpu.ops import intersect_bvh as jbvh
from raytracer_tpu.ops import intersect_pallas as jpallas
from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu.scene.types import Rays as JaxRays
from raytracer_tpu_torch.ops import intersect, intersect_bvh, intersect_kernel
from raytracer_tpu_torch.scene import presets as tpresets
from raytracer_tpu_torch.scene.builder import SceneBuilder
from raytracer_tpu_torch.scene.types import BVH_FIELDS, FACE_BACK, Rays

torch.set_num_threads(1)

N = 640  # as tests/test_pallas.py: not a multiple of the TPU tile


def random_rays(n_prim, seed=0, n=N):
    """Rays with random face, excl_prim and excl_face, as
    tests/test_pallas.py:15-32 makes them -> dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 2 + np.array([0.5, 1, 0.5], np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(o=o, d=d,
                face=rng.integers(0, 3, size=n).astype(np.int32),
                excl_prim=rng.integers(-1, n_prim, size=n).astype(np.int32),
                excl_face=rng.integers(0, 3, size=n).astype(np.int32))


def both(fields):
    return (JaxRays(**{k: jnp.asarray(v) for k, v in fields.items()}),
            Rays(**{k: torch.as_tensor(v) for k, v in fields.items()}))


def without_bvh(scene):
    """The same scene as a dense one."""
    return dataclasses.replace(scene, **dict.fromkeys(BVH_FIELDS), bvh_depth=0)


def bvh_only(scene):
    """The same scene with its BVH and no blocked layout."""
    return dataclasses.replace(scene, blk_perm=None, blk_box=None)


@pytest.fixture(scope="module")
def demo():
    jscene, _ = jpresets.demo_scene()
    jrays, rays = both(random_rays(jscene.n_prim))
    return jscene, jrays, tpresets.demo_scene(), rays


def test_nearest_hit_matches_jax_kernel(demo):
    jscene, jrays, scene, rays = demo
    t_ref, idx_ref, bf_ref, valid_ref = (np.asarray(x) for x in
                                         jpallas.nearest_hit(jscene, jrays, interpret=True))
    before = intersect_kernel.COUNTS_NEAREST.plain
    t, idx, bf, valid = (x.numpy() for x in intersect_kernel.nearest_hit(scene, rays))
    assert intersect_kernel.COUNTS_NEAREST.plain == before + 1
    assert 0.05 < valid.mean() < 0.95
    np.testing.assert_array_equal(valid, valid_ref)
    np.testing.assert_array_equal(idx[valid], idx_ref[valid])
    np.testing.assert_array_equal(bf[valid], bf_ref[valid])
    np.testing.assert_allclose(t[valid], t_ref[valid], rtol=1e-5)
    # a miss: t = +inf, idx = -1 (intersect_pallas.py:294-298)
    assert np.all(np.isinf(t[~valid])) and np.all(idx[~valid] == -1)


def test_nearest_hit_respects_active(demo):
    _, _, scene, rays = demo
    active = torch.arange(N) % 3 != 0
    t, idx, _, valid = intersect_kernel.nearest_hit(scene, rays, active)
    t_all, idx_all, _, valid_all = intersect_kernel.nearest_hit(scene, rays)
    assert not bool(valid[~active].any()) and bool(torch.all(idx[~active] == -1))
    assert torch.equal(valid[active], valid_all[active])
    assert torch.equal(idx[active], idx_all[active])


@pytest.mark.parametrize("limited", [True, False])
def test_any_hit_matches_jax_kernel(demo, limited):
    jscene, jrays, scene, rays = demo
    limit = np.random.default_rng(1).uniform(0.1, 10.0, size=N).astype(np.float32)
    ref = np.asarray(jpallas.any_hit(jscene, jrays,
                                     limit=jnp.asarray(limit) if limited else None,
                                     interpret=True))
    before = intersect_kernel.COUNTS_ANY.plain
    got = intersect_kernel.any_hit(scene, rays,
                                   limit=torch.as_tensor(limit) if limited else None).numpy()
    assert intersect_kernel.COUNTS_ANY.plain == before + 1
    assert 0.02 < got.mean() < 0.95
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["nearest_hit", "any_hit"])
def test_sweep_plain_lanes_do_not_depend_on_their_order_or_neighbours(demo, kind):
    """The nearest-hit and any-hit kernels take their active lanes listed in
    any order and write each lane's result where the lane sits: a lane's
    result may not depend on where it or the other active lanes sit.  The
    plain version on the lanes shuffled, and on the active lanes alone,
    gives every lane's result exactly; an inactive lane misses."""
    _, _, scene, rays = demo
    rng = np.random.default_rng(4)
    active = torch.as_tensor(rng.uniform(size=N) < 0.6)
    limit = torch.as_tensor(rng.uniform(0.1, 10.0, size=N).astype(np.float32))

    def run(idx):
        sub = Rays(**{f.name: getattr(rays, f.name)[idx] for f in dataclasses.fields(rays)})
        if kind == "nearest_hit":
            return intersect_kernel.nearest_hit_plain(scene.tables, sub, active[idx])
        return (intersect_kernel.any_hit_plain(scene.tables, sub, active[idx], limit[idx]),)

    ref = run(torch.arange(N))
    hit = ref[-1]  # valid / blocked
    assert 0.1 < float(hit[active].float().mean()) < 0.95 and not bool(hit[~active].any())
    perm = torch.as_tensor(rng.permutation(N))
    for got, r in zip(run(perm), ref):
        assert torch.equal(got, r[perm])
    listed = torch.nonzero(active).squeeze(1)
    for got, r in zip(run(listed), ref):
        assert torch.equal(got, r[listed])
    if kind == "nearest_hit":  # a miss where inactive: t = +inf, idx = -1
        assert bool(torch.isinf(ref[0][~active]).all()) and bool((ref[1][~active] == -1).all())


def test_cast_matches_jax_cast_on_valid_lanes(demo):
    jscene, jrays, scene, rays = demo
    ref = jax.jit(lambda r: jintersect.cast(jscene, r))(jrays)
    got = intersect.cast(scene, rays)
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    for name in ("prim", "obj", "backface"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[v],
                                      np.asarray(getattr(ref, name))[v], err_msg=name)
    np.testing.assert_allclose(got.t.numpy()[v], np.asarray(ref.t)[v], rtol=1e-5)
    for name in ("pos", "normal", "uv"):
        np.testing.assert_allclose(getattr(got, name).numpy()[v],
                                   np.asarray(getattr(ref, name))[v], atol=1e-5, err_msg=name)
    assert np.all(np.isinf(got.t.numpy()[~v])) and np.all(got.prim.numpy()[~v] == -1)
    # both kinds of primitive win somewhere
    prim = got.prim.numpy()[v]
    assert (prim < scene.n_tri).any() and (prim >= scene.n_tri).any()


def test_cast_geom_leaves_uv_and_obj_zero(demo):
    _, _, scene, rays = demo
    full, geom = intersect.cast(scene, rays), intersect.cast(scene, rays, attrs="geom")
    assert torch.equal(full.valid, geom.valid) and torch.equal(full.prim, geom.prim)
    assert torch.equal(full.normal, geom.normal) and torch.equal(full.pos, geom.pos)
    assert not bool(geom.uv.any()) and not bool(geom.obj.any())


@pytest.mark.parametrize("limited", [True, False])
def test_cast_any_hit_matches_jax(demo, limited):
    jscene, jrays, scene, rays = demo
    limit = np.random.default_rng(2).uniform(0.1, 10.0, size=N).astype(np.float32)
    active = np.random.default_rng(3).uniform(size=N) < 0.8
    ref = jintersect.cast_any_hit(jscene, jrays, active=jnp.asarray(active),
                                  limit=jnp.asarray(limit) if limited else None)
    got = intersect.cast_any_hit(scene, rays, active=torch.as_tensor(active),
                                 limit=torch.as_tensor(limit) if limited else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got.numpy()[~active].any()


@pytest.fixture(scope="module")
def mesh():
    jscene, _, _ = jpresets.mesh_scene(24)
    fields = random_rays(jscene.n_prim, seed=5)
    fields["o"] = fields["o"] * np.float32(0.5) + np.array([0, 1.5, 0], np.float32)
    jrays, rays = both(fields)
    return jscene, jrays, tpresets.mesh_scene(24)[0], rays


def test_tri_nearest_bvh_matches_jax(mesh):
    """Equal index on valid lanes, t within rtol 1e-5."""
    jscene, jrays, scene, rays = mesh
    active = np.arange(N) % 7 != 0
    t_ref, idx_ref, bf_ref = (np.asarray(x) for x in jax.jit(
        lambda r, a: jbvh.tri_nearest_bvh(jscene, r, a))(jrays, jnp.asarray(active)))
    t, idx, bf = (x.numpy() for x in
                  intersect_bvh.tri_nearest_bvh(scene, rays, torch.as_tensor(active)))
    v = np.isfinite(t_ref)
    assert 0.05 < v.mean() < 1.0
    np.testing.assert_array_equal(np.isfinite(t), v)
    np.testing.assert_array_equal(idx[v], idx_ref[v])
    np.testing.assert_array_equal(bf[v], bf_ref[v])
    np.testing.assert_allclose(t[v], t_ref[v], rtol=1e-5)
    assert not np.isfinite(t[~active]).any()


def test_bvh_cast_equals_the_dense_cast_of_the_same_scene(mesh):
    """_cast_bvh (the BVH for triangles, the dense sweep for spheres)
    against the nearest-hit sweep over the same tables: the lexicographic
    (t, index) update makes the BVH's visit order invisible."""
    _, _, scene, rays = mesh
    a = intersect.cast(bvh_only(scene), rays)
    before = intersect_kernel.COUNTS_NEAREST.plain
    b = intersect.cast(without_bvh(scene), rays)
    assert intersect_kernel.COUNTS_NEAREST.plain == before + 1  # only the dense one
    for name in ("valid", "prim", "obj", "backface", "t", "pos", "normal", "uv"):
        x, y = getattr(a, name)[a.valid], getattr(b, name)[b.valid]
        assert torch.equal(x, y), name
    limit = torch.as_tensor(np.random.default_rng(6).uniform(0.1, 4.0, size=N)
                            .astype(np.float32))
    assert torch.equal(intersect.cast_any_hit(bvh_only(scene), rays, limit=limit),
                       intersect.cast_any_hit(without_bvh(scene), rays, limit=limit))


def test_cast_of_an_empty_scene_misses_everywhere(demo):
    _, _, _, rays = demo
    empty = SceneBuilder().build()
    assert empty.n_prim == 0
    h = intersect.cast(empty, rays)
    assert not bool(h.valid.any()) and bool(torch.all(h.prim == -1))
    assert bool(torch.isinf(h.t).all())
    assert not bool(intersect.cast_any_hit(empty, rays).any())


def test_wrappers_take_dense_scenes_on_cpu_or_cuda_only(demo, mesh):
    """CPU tensors take the plain version; any other device launches the
    kernel or raises, before anything is built."""
    _, _, scene, rays = demo
    meta = Rays(**{f.name: getattr(rays, f.name).to("meta")
                   for f in dataclasses.fields(rays)})
    with pytest.raises(ValueError, match="unsupported device"):
        intersect_kernel.nearest_hit(scene.to("meta"), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        intersect_kernel.any_hit(scene.to("meta"), meta)
    # the per-thread yardsticks launch a kernel or raise: no plain version
    with pytest.raises(ValueError, match="unsupported device"):
        intersect_kernel.nearest_hit_per_thread(scene, rays)
    with pytest.raises(ValueError, match="unsupported device"):
        intersect_kernel.any_hit_per_thread(scene, rays, limit=rays.o[:, 0])
    back = torch.full((N,), FACE_BACK, dtype=torch.int32)
    dirs = torch.zeros((2, N, 3))  # the demo has three lights
    with pytest.raises(ValueError, match="2 directions for 3 lights"):
        intersect_kernel.shadow_any_hit(scene, rays.o, dirs, back, dirs[..., 0],
                                        dirs[..., 0] > 0)
