"""The port's interior march (plain version of the march kernel, and the
masked loop of BVH scenes) against raytracer_tpu.

The demo's primary hits at 48x32 (1536 rays, as tests/test_march_pallas.py)
come from the JAX cast and go, as numpy, through the JAX march kernel in
interpret mode, the JAX while-loop march and the port's.  Tolerances are
those of tests/test_march_pallas.py: escape flags may differ on < 1 % of
lanes (marginal total-internal-reflection decisions flip with the order of
float operations); on lanes that escape in both, travel and the exit ray
within 1e-4 and the exit primitive equal; the cast count within 1 %.  What
a lane that never marched holds differs between the packages, so only
`escaped` and the casts are compared there; the port writes zeros.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.ops import camera as jcamera
from raytracer_tpu.ops import march_pallas as jmarch
from raytracer_tpu.ops import materials as jmaterials
from raytracer_tpu.ops import trace as jtrace
from raytracer_tpu.ops.intersect import cast as jax_cast
from raytracer_tpu.render import clip_coords
from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu.scene.types import Rays as JaxRays
from raytracer_tpu_torch.ops import camera as camera_ops
from raytracer_tpu_torch.ops import intersect, march_kernel, materials, trace
from raytracer_tpu_torch.scene import presets as tpresets
from raytracer_tpu_torch.scene.types import BVH_FIELDS, Rays

torch.set_num_threads(1)

MD, MR = 100.0, 10


def tt(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def glass():
    """-> (jax scene, jax march inputs, torch scene, torch march inputs):
    inputs are (pos, normal, ray_d, prim, k, want)."""
    jscene, jtex = jpresets.demo_scene()
    o, d = jcamera.shoot(jpresets.demo_camera(), jnp.asarray(clip_coords(48, 32)))
    h = jax.jit(lambda r: jax_cast(jscene, r))(JaxRays.primary(o, d))
    mat = jmaterials.eval_material(jscene, jtex, h.obj, h.uv)
    want = h.valid & (mat.transparency > 0.0)
    assert int(want.sum()) > 40, "the frame should contain glass hits"
    jin = (h.pos, h.normal, d, h.prim, mat.refraction, want)
    return jscene, jin, tpresets.demo_scene(), tuple(tt(x) for x in jin)


def compare(got, ref, want):
    """got / ref: (escaped, travel, esc_o, esc_d, esc_prim, casts) as numpy."""
    e_got, e_ref = got[0], ref[0]
    assert (e_got != e_ref).sum() < 0.01 * want.sum(), "escape flags disagree"
    assert not e_got[~want].any()
    both = e_got & e_ref
    assert both.sum() > 40
    np.testing.assert_allclose(got[1][both], ref[1][both], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2][both], ref[2][both], atol=1e-4)
    np.testing.assert_allclose(got[3][both], ref[3][both], atol=1e-4)
    np.testing.assert_array_equal(got[4][both], ref[4][both])
    assert abs(int(got[5]) - int(ref[5])) <= 0.01 * int(ref[5])


def test_march_plain_matches_jax_kernel(glass):
    jscene, jin, scene, tin = glass
    ref = jmarch.march(jscene, *jin, max_distance=MD, max_retries=MR, interpret=True)
    before = march_kernel.COUNTS.plain
    got = march_kernel.march(scene, *tin, MD, MR)
    assert march_kernel.COUNTS.plain == before + 1
    compare([x.numpy() for x in got], [np.asarray(x) for x in ref], tin[5].numpy())


def test_refract_march_matches_jax_while_loop(glass):
    jscene, jin, scene, tin = glass
    ref = jtrace.refract_march(jscene, *jin, JaxConfig(depth=5))
    got = trace.refract_march(scene, *tin, MD, MR)
    assert isinstance(got, trace.MarchResult)
    compare([x.numpy() for x in got], [np.asarray(x) for x in ref], tin[5].numpy())


def test_lanes_that_never_marched_hold_zeros(glass):
    _, _, scene, tin = glass
    pos, normal, ray_d, prim, k, want = tin
    escaped, travel, esc_o, esc_d, esc_prim, iters = march_kernel.march_plain(
        scene.tables, pos, normal, ray_d, k, want, MD, MR)
    idle = iters == 0
    assert bool(idle[~want].all()) and bool((iters[want] >= 0).all())
    for x in (escaped, travel, esc_o, esc_d, esc_prim):
        assert not bool(x[idle].any())
    assert 1 <= int(iters.max()) <= MR + 1
    # the entry primitive is accepted and unused (march_pallas.py:297-300)
    other = march_kernel.march(scene, pos, normal, ray_d, torch.zeros_like(prim), k, want, MD, MR)
    assert torch.equal(other[0], escaped) and int(other[5]) == int(iters.sum())


def test_refract_dir_matches_jax():
    rng = np.random.default_rng(0)
    n = rng.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    k = rng.uniform(0.5, 2.0, size=500).astype(np.float32)
    ref, ok_ref = jtrace.refract_dir(jnp.asarray(n), jnp.asarray(d), jnp.asarray(k))
    got, ok = trace.refract_dir(torch.as_tensor(n), torch.as_tensor(d), torch.as_tensor(k))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    assert 0 < ok.float().mean() < 1  # total internal reflection occurs
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_bvh_scene_marches_by_the_masked_loop_over_cast():
    """mesh_scene(24)'s glass cube and sphere: the loop over `cast` (BVH
    scene) against the march sweep of the same scene taken dense."""
    scene, cam = tpresets.mesh_scene(24)
    bvh = dataclasses.replace(scene, blk_perm=None, blk_box=None)
    dense = dataclasses.replace(scene, **dict.fromkeys(BVH_FIELDS), bvh_depth=0)
    o, d = camera_ops.shoot(cam, torch.as_tensor(clip_coords(47, 31)))
    h = intersect.cast(dense, Rays.primary(o, d))
    mat = materials.eval_material(dense, dense.textures, h.obj, h.uv)
    want = h.valid & (mat.transparency > 0.0)
    assert int(want.sum()) > 40
    args = (h.pos, h.normal, d, h.prim, mat.refraction, want, MD, MR)
    before = march_kernel.COUNTS.plain
    got = trace.refract_march(bvh, *args)
    assert march_kernel.COUNTS.plain == before  # no sweep over the dense tables
    ref = trace.refract_march(dense, *args)
    assert march_kernel.COUNTS.plain == before + 1
    compare([x.numpy() for x in got], [x.numpy() for x in ref], want.numpy())


def test_march_wrapper_refuses_other_devices(glass):
    _, _, scene, tin = glass
    meta = tuple(x.to("meta") for x in tin)
    with pytest.raises(ValueError, match="unsupported device"):
        march_kernel.march(scene.to("meta"), *meta, MD, MR)


def test_march_plain_lanes_do_not_depend_on_their_order_or_neighbours(glass):
    """The march kernel takes its marching lanes listed in any order and
    writes each lane's result where the lane sits: a lane's outputs may not
    depend on where it or the other wanted lanes sit.  The plain version on
    the lanes shuffled, and on the wanted lanes alone, gives every lane's
    outputs and casts exactly; a lane that is not wanted gives zeros."""
    _, _, scene, tin = glass
    pos, normal, ray_d, _, k, want = tin
    n = pos.shape[0]
    run = lambda idx: march_kernel.march_plain(scene.tables, pos[idx], normal[idx], ray_d[idx],
                                               k[idx], want[idx], MD, MR)
    ref = run(torch.arange(n))
    assert int(want.sum()) > 40 and int(ref[5][want].sum()) > int(want.sum())
    perm = torch.as_tensor(np.random.default_rng(3).permutation(n))
    for got, r in zip(run(perm), ref):
        assert torch.equal(got, r[perm])
    listed = torch.nonzero(want).squeeze(1)
    for got, r in zip(run(listed), ref):
        assert torch.equal(got, r[listed])
        assert not bool(r[~want].any())
