"""The port's materials, lights and direct shading (unfused path) against
raytracer_tpu, and the shadow kernel's plain version against the JAX
shadow kernel in interpret mode.

Inputs are numpy-seeded, or the demo scene's primary hits from the JAX
cast (carried across as numpy, so both packages shade the very same hit
records).  Tolerances: materials, lights and shading rtol 1e-4 / atol 1e-5
(pow / acos / sin differ in the last ulps between XLA and PyTorch);
shadow predicates and the shadow-ray counters EQUAL.  The JAX get_shade
on the CPU takes its per-light cast_any_hit loop, the port's the shadow
kernel's plain version (the factored-target algebra): where they are held
equal here, both algebras agree on this frame, as
tests/test_shadow_fused.py demands of the JAX kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import camera as jcamera
from raytracer_tpu.ops import intersect_pallas as jpallas
from raytracer_tpu.ops import lights as jlights
from raytracer_tpu.ops import materials as jmaterials
from raytracer_tpu.ops import shade as jshade
from raytracer_tpu.ops.intersect import cast as jax_cast
from raytracer_tpu.render import clip_coords
from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu.scene import textures as jtextures
from raytracer_tpu.scene.types import Rays as JaxRays
from raytracer_tpu.utils import vec as jvec
from raytracer_tpu_torch.ops import camera as camera_ops
from raytracer_tpu_torch.ops import intersect, intersect_kernel, lights, materials, shade
from raytracer_tpu_torch.scene import presets as tpresets
from raytracer_tpu_torch.scene import textures
from raytracer_tpu_torch.scene.types import BVH_FIELDS, FACE_BACK, Rays
from raytracer_tpu_torch.utils import vec

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
HIT_FIELDS = ("pos", "normal", "uv", "prim", "obj", "valid")


def tt(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def hits():
    """The demo's primary hits at 40x24 (as tests/test_shadow_fused.py),
    from the JAX cast -> (jax scene, jax textures, jax Hits, ray_d, torch
    scene, dict of torch hit fields, torch ray_d)."""
    jscene, jtex = jpresets.demo_scene()
    o, d = jcamera.shoot(jpresets.demo_camera(), jnp.asarray(clip_coords(40, 24)))
    h = jax.jit(lambda r: jax_cast(jscene, r))(JaxRays.primary(o, d))
    return (jscene, jtex, h, d, tpresets.demo_scene(device="cpu"),
            {k: tt(getattr(h, k)) for k in HIT_FIELDS}, tt(d))


@pytest.mark.parametrize("name", ["stripes_diffuse", "stripes_normal", "checker_diffuse",
                                  "_const_normal"])
def test_host_textures_match_jax(name):
    """Negative uv included: `(x as i32) % 2` truncates toward zero."""
    uv = np.random.default_rng(0).uniform(-2.0, 2.0, size=(2000, 2)).astype(np.float32)
    ref = getattr(jtextures, name)(jnp.asarray(uv))
    got = getattr(textures, name)(torch.as_tensor(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_vec_helpers_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(500, 3)).astype(np.float32)
    n = rng.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:5] = [0.0, 0.0, -1.0]  # the antiparallel fallback
    for fn in ("dot", "distance", "reflect", "rotate_from_z"):
        ref = getattr(jvec, fn)(jnp.asarray(n), jnp.asarray(a))
        got = getattr(vec, fn)(torch.as_tensor(n), torch.as_tensor(a))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, err_msg=fn)
    assert vec.F32_EPS == jvec.F32_EPS


def test_eval_material_matches_jax(hits):
    jscene, jtex, h, _, scene, th, _ = hits
    ref = jmaterials.eval_material(jscene, jtex, h.obj, h.uv)
    got = materials.eval_material(scene, scene.textures, th["obj"], th["uv"])
    v = th["valid"].numpy()
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(got, f.name).numpy()[v],
                                   np.asarray(getattr(ref, f.name))[v], err_msg=f.name, **TOL)
    # every object's row, and both textures, are exercised
    tex = scene.mat_tex[th["obj"][th["valid"]].long()]
    assert set(tex.tolist()) == {0, 1, 2}
    n_adj = materials.adjust_normal(got, th["normal"]).numpy()
    np.testing.assert_allclose(n_adj[v], np.asarray(jmaterials.adjust_normal(ref, h.normal))[v],
                               **TOL)


def test_approximate_directional_matches_jax(hits):
    """Random points around the demo's lights (a spot with its cone, a
    point and a directional light): the 1/d attenuation and the cone."""
    jscene, _, _, _, scene, _, _ = hits
    pos = np.random.default_rng(2).uniform(-12.0, 14.0, size=(3000, 3)).astype(np.float32)
    ref = jlights.approximate_directional(jscene, jnp.asarray(pos))
    got = lights.approximate_directional(scene, torch.as_tensor(pos))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert 0 < got.valid.float().mean() < 1  # some points lie outside the spot's cone
    for name in ("direction", "color", "has_origin", "origin"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)
    assert sorted(scene.light_type.tolist()) == [0, 1, 2]


def test_brdf_terms_match_jax(hits):
    jscene, jtex, h, d, scene, th, td = hits
    jmat = jmaterials.eval_material(jscene, jtex, h.obj, h.uv)
    mat = materials.eval_material(scene, scene.textures, th["obj"], th["uv"])
    ld = np.random.default_rng(3).normal(size=(d.shape[0], 3)).astype(np.float32)
    ld /= np.linalg.norm(ld, axis=-1, keepdims=True)
    v = th["valid"].numpy()
    np.testing.assert_allclose(
        materials.get_diffuse(mat, th["normal"], torch.as_tensor(ld)).numpy()[v],
        np.asarray(jmaterials.get_diffuse(jmat, h.normal, jnp.asarray(ld)))[v], **TOL)
    np.testing.assert_allclose(
        materials.get_specular(mat, th["normal"], torch.as_tensor(ld), -td).numpy()[v],
        np.asarray(jmaterials.get_specular(jmat, h.normal, jnp.asarray(ld), -d))[v], **TOL)


def test_get_shade_matches_jax_with_equal_counters(hits):
    jscene, jtex, h, d, scene, th, td = hits
    jcounters, counters = [], []
    ref = jshade.get_shade(jscene, jtex, h.pos, h.normal, h.uv, h.prim, h.obj, d, h.valid,
                           jcounters)
    before = intersect_kernel.COUNTS_SHADOW.plain
    got = shade.get_shade(scene, scene.textures, th["pos"], th["normal"], th["uv"], th["prim"],
                          th["obj"], td, th["valid"], counters)
    assert intersect_kernel.COUNTS_SHADOW.plain == before + 1  # one call for all lights
    assert [int(c) for c in counters] == [int(c) for c in jcounters]
    assert len(counters) == scene.n_light and all(int(c) > 0 for c in counters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert not bool(got[~th["valid"]].any()) and float(got.max()) > 0.1


def shadow_inputs(scene, th):
    """What get_shade hands the shadow kernel for these hits."""
    ls = lights.approximate_directional(scene, th["pos"])
    dirs = -ls.direction.permute(1, 0, 2).contiguous()
    actives = th["valid"] & ls.valid.t()
    dist = vec.distance(th["pos"][None], ls.origin[:, None])
    limits = torch.where(ls.has_origin[:, None] > 0.5, dist, torch.inf)
    return dirs, limits, actives


def test_shadow_plain_matches_jax_kernel_and_per_light_any_hit(hits):
    jscene, _, h, _, scene, th, _ = hits
    dirs, limits, actives = shadow_inputs(scene, th)
    ref = np.asarray(jpallas.shadow_any_hit(
        jscene, h.pos, jnp.asarray(dirs.numpy()), h.prim, jnp.asarray(limits.numpy()),
        jnp.asarray(actives.numpy()), interpret=True))
    got = intersect_kernel.shadow_any_hit(scene, th["pos"], dirs, th["prim"], limits, actives)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.02 < got.float().mean() < 0.9 and not bool(got[~actives].any())
    back = torch.full_like(th["prim"], FACE_BACK)
    for li in range(scene.n_light):
        rays = Rays(o=th["pos"], d=dirs[li], face=back, excl_prim=th["prim"], excl_face=back)
        per_light = intersect.cast_any_hit(scene, rays, active=actives[li], limit=limits[li])
        assert torch.equal(got[li], per_light), f"light {li}"


def test_shadow_limit_is_derived_from_the_callers_limit(hits):
    """Half the light's distance as the limit frees lanes whose occluder
    lies beyond it; the per-light any-hit sweep says which."""
    _, _, _, _, scene, th, _ = hits
    dirs, limits, actives = shadow_inputs(scene, th)
    half = limits * 0.5
    got = intersect_kernel.shadow_any_hit(scene, th["pos"], dirs, th["prim"], half, actives)
    full = intersect_kernel.shadow_any_hit(scene, th["pos"], dirs, th["prim"], limits, actives)
    back = torch.full_like(th["prim"], FACE_BACK)
    same = 0
    for li in range(scene.n_light):
        rays = Rays(o=th["pos"], d=dirs[li], face=back, excl_prim=th["prim"], excl_face=back)
        want = intersect.cast_any_hit(scene, rays, active=actives[li], limit=half[li])
        same += int((got[li] == want).sum())
    assert same >= 0.999 * got.numel()  # two algebras: razor edges may differ
    assert int(got.sum()) < int(full.sum())


def test_get_shade_on_a_bvh_scene_loops_over_cast_any_hit():
    """mesh_scene(24) with its BVH and no blocked layout: the per-light
    loop, against the shadow sweep of the same scene taken dense."""
    scene, cam = tpresets.mesh_scene(24, device="cpu")
    bvh = dataclasses.replace(scene, blk_perm=None, blk_box=None)
    dense = dataclasses.replace(scene, **dict.fromkeys(BVH_FIELDS), bvh_depth=0)
    o, d = camera_ops.shoot(cam, torch.as_tensor(clip_coords(31, 23)))
    h = intersect.cast(dense, Rays.primary(o, d))
    ca, cb = [], []
    before = intersect_kernel.COUNTS_SHADOW.plain
    a = shade.get_shade_hits(bvh, bvh.textures, h, d, h.valid, ca)
    assert intersect_kernel.COUNTS_SHADOW.plain == before
    b = shade.get_shade_hits(dense, dense.textures, h, d, h.valid, cb)
    assert intersect_kernel.COUNTS_SHADOW.plain == before + 1
    assert [int(c) for c in ca] == [int(c) for c in cb]
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=-1).float().mean()
    assert close >= 0.995, float(close)  # direct t against the factored target


def test_shadow_plain_lanes_do_not_depend_on_their_order_or_neighbours(hits):
    """The shadow kernel takes the lanes with an active light listed in any
    order and writes each lane's result where the lane sits: a lane's
    results may not depend on where it or the other active lanes sit.  The
    plain version on the lanes shuffled, and on the lanes with an active
    light alone, gives every (light, lane) result exactly; a lane with no
    active light is blocked for no light."""
    _, _, _, _, scene, th, _ = hits
    dirs, limits, actives = shadow_inputs(scene, th)
    actives = actives.clone()
    rng = np.random.default_rng(5)
    actives &= torch.as_tensor(rng.uniform(size=tuple(actives.shape)) < 0.6)
    n = actives.shape[1]
    run = lambda idx: intersect_kernel.shadow_any_hit_plain(
        scene.tables, th["pos"][idx], dirs[:, idx], th["prim"][idx], limits[:, idx],
        actives[:, idx])
    ref = run(torch.arange(n))
    some = actives.any(0)
    assert 0 < int(some.sum()) < n and int(ref.sum()) > 0
    perm = torch.as_tensor(rng.permutation(n))
    assert torch.equal(run(perm), ref[:, perm])
    listed = torch.nonzero(some).squeeze(1)
    assert torch.equal(run(listed), ref[:, listed])
    assert not bool(ref[:, ~some].any())
