"""The port's plain dense blocks against raytracer_tpu/ops/kernel_common.py.

Both sides run eagerly on the demo scene's packed tables with the same
numpy-seeded rays (the JAX side in its row layout).  Tolerances: integer
results (winners, object ids, flags, cast counts) must agree on >= 99.5 %
of lanes — an f32 near-tie may pick another winner; floats agree within
atol = rtol = 1e-4, which absorbs the TPU blocks' acos/atan2 polynomials
(~1e-6 rad) and reassociation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.ops import kernel_common as jkc
from raytracer_tpu.ops.intersect_pallas import pack_sph, pack_tri
from raytracer_tpu.scene.presets import demo_scene
from raytracer_tpu.scene.textures import DEFAULT_TEXTURES as JAX_TEXTURES
from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.scene.presets import demo_scene as torch_demo_scene

torch.set_num_threads(1)

N = 2048
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def scenes():
    jscene, _ = demo_scene()
    return jscene, torch_demo_scene(device="cpu")


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 2.0 + [1.0, 1.5, 1.0]).astype(np.float32)
    target = (rng.normal(size=(n, 3)) * 0.8 + [0.0, 0.8, 0.0]).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    face = rng.choice([0, 1, 2], size=n).astype(np.int32)
    return o, d.astype(np.float32), face


def _jrows(a):
    """[N, k] numpy -> tuple of k [1, N] jnp rows."""
    return tuple(jnp.asarray(np.ascontiguousarray(a[:, i]))[None, :] for i in range(a.shape[1]))


def _trows(a):
    return tuple(torch.as_tensor(np.ascontiguousarray(a[:, i])) for i in range(a.shape[1]))


def _np(x):
    return np.asarray(x).reshape(-1)


def _agree_int(a, b, frac=0.995):
    a, b = _np(a), _np(b)
    assert (a == b).mean() >= frac, (a != b).sum()
    return a == b


def _jax_hits(jscene, o, d, face):
    n = o.shape[0]
    tri, sph = pack_tri(jscene), pack_sph(jscene)
    return jkc.full_sweep(_jrows(o), _jrows(d), jnp.asarray(face)[None, :],
                          jnp.full((1, n), -1, jnp.int32), jnp.zeros((1, n), jnp.int32),
                          jnp.ones((1, n), bool), tri, sph, jscene.n_tri, jscene.n_sph)


def test_full_sweep_matches(scenes):
    jscene, tscene = scenes
    o, d, face = _rays(N, 3)
    n = o.shape[0]
    # exclude each ray's own primary hit on a third of the lanes
    ref0 = _jax_hits(jscene, o, d, face)
    excl = np.where(np.arange(n) % 3 == 0, _np(ref0["prim"]), -1).astype(np.int32)
    excl_face = np.where(np.arange(n) % 2 == 0, 2, 1).astype(np.int32)
    tri, sph = pack_tri(jscene), pack_sph(jscene)
    ref = jkc.full_sweep(_jrows(o), _jrows(d), jnp.asarray(face)[None, :],
                         jnp.asarray(excl)[None, :], jnp.asarray(excl_face)[None, :],
                         jnp.ones((1, n), bool), tri, sph, jscene.n_tri, jscene.n_sph)
    got = kc.full_sweep(_trows(o), _trows(d), torch.as_tensor(face), torch.as_tensor(excl),
                        torch.as_tensor(excl_face), torch.ones(n, dtype=torch.bool),
                        tscene.tables)
    same = _agree_int(got["prim"], ref["prim"])
    for k in ("valid", "obj", "backface"):
        _agree_int(got[k], ref[k])
    sel = same & _np(ref["valid"])
    assert sel.sum() > N // 4
    for k in ("t", "px", "py", "pz", "nx", "ny", "nz", "u", "v"):
        np.testing.assert_allclose(_np(got[k])[sel], _np(ref[k])[sel], err_msg=k, **TOL)


def test_eval_material_matches(scenes):
    jscene, tscene = scenes
    rng = np.random.default_rng(7)
    obj = rng.integers(0, jscene.n_obj, size=N).astype(np.int32)
    uv = rng.uniform(-1.5, 1.5, size=(N, 2)).astype(np.float32)
    ref = jkc.eval_material(jkc.pack_materials(jscene), JAX_TEXTURES,
                            jnp.asarray(obj)[None, :], jnp.asarray(uv[:, 0])[None, :],
                            jnp.asarray(uv[:, 1])[None, :])
    got = kc.eval_material(tscene.tables, tscene.textures, torch.as_tensor(obj),
                           torch.as_tensor(uv[:, 0]), torch.as_tensor(uv[:, 1]))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), err_msg=k, atol=1e-6, rtol=1e-6)


def test_get_shade_with_shadows_matches(scenes):
    jscene, tscene = scenes
    o, d, _ = _rays(N, 11)
    front = np.zeros(N, np.int32)
    h = _jax_hits(jscene, o, d, front)
    valid = _np(h["valid"])
    assert valid.mean() > 0.3
    mat = jkc.pack_materials(jscene)
    m = jkc.eval_material(mat, JAX_TEXTURES, h["obj"], h["u"], h["v"])
    na = jkc.rotate_from_z(h["nx"], h["ny"], h["nz"], m["tnx"], m["tny"], m["tnz"])
    sweep = jkc._ShadowSweep(h["px"], h["py"], h["pz"], h["prim"], pack_tri(jscene),
                             pack_sph(jscene), jscene.n_tri, jscene.n_sph)
    vd = tuple(-r for r in _jrows(d))
    ref = jkc.get_shade(m, jkc.pack_lights(jscene), h["px"], h["py"], h["pz"], *na, *vd,
                        h["valid"], sweep, jscene.n_light)

    t = lambda x: torch.as_tensor(_np(x).copy())
    mt = kc.eval_material(tscene.tables, tscene.textures, t(h["obj"]), t(h["u"]), t(h["v"]))
    nat = kc.rotate_from_z(t(h["nx"]), t(h["ny"]), t(h["nz"]), mt["tnx"], mt["tny"], mt["tnz"])
    got = kc.get_shade(mt, tscene.geom, t(h["px"]), t(h["py"]), t(h["pz"]), *nat,
                       *(-x for x in _trows(d)), t(h["valid"]), t(h["prim"]))
    same = _agree_int(got[3], ref[3])  # shadow rays cast per lane
    rgb_got = np.stack([_np(x) for x in got[:3]], -1)
    rgb_ref = np.stack([_np(x) for x in ref[:3]], -1)
    close = np.all(np.abs(rgb_got - rgb_ref) <= 1e-4 + 1e-4 * np.abs(rgb_ref), axis=-1)
    # a razor-edge shadow flip changes one light's whole term on that lane
    assert close.mean() >= 0.995, (~close).sum()
    assert (rgb_ref[same & valid] > 0).any()


def test_march_rows_matches(scenes):
    jscene, tscene = scenes
    o, d, _ = _rays(4 * N, 5)
    n = o.shape[0]
    h = _jax_hits(jscene, o, d, np.zeros(n, np.int32))
    mat = np.asarray(jkc.pack_materials(jscene))
    obj = _np(h["obj"])
    k = mat[obj, 9].astype(np.float32)
    want = _np(h["valid"]) & (mat[obj, 8] > 0)
    assert want.sum() > 100
    pos = [h[c] for c in ("px", "py", "pz")]
    nrm = [h[c] for c in ("nx", "ny", "nz")]
    ref = jkc.march_rows(*pos, *nrm, *_jrows(d), jnp.asarray(k)[None, :],
                         jnp.asarray(want)[None, :], pack_tri(jscene), pack_sph(jscene),
                         jscene.n_tri, jscene.n_sph, 100.0, 10)
    t = lambda x: torch.as_tensor(_np(x).copy())
    got = kc.march_rows(*(t(x) for x in pos), *(t(x) for x in nrm), *_trows(d),
                        torch.as_tensor(k), torch.as_tensor(want), tscene.geom, 100.0, 10)
    esc = _agree_int(got["escaped"], ref["escaped"])
    _agree_int(got["iters"], ref["iters"])
    same = esc & _agree_int(got["prim"], ref["prim"]) & _np(ref["escaped"])
    assert same.sum() > 50
    for key in ("travel", "ex", "ey", "ez", "odx", "ody", "odz"):
        np.testing.assert_allclose(_np(got[key])[same], _np(ref[key])[same], err_msg=key, **TOL)


def test_powf_keeps_the_kernel_domain_rule():
    base = torch.tensor([0.0, -1.0, 0.5, 2.0])
    expo = torch.tensor([0.0, 2.0, 3.0, 0.5])
    got = kc.powf(base, expo)
    ref = np.asarray(jkc.powf(jnp.asarray(base.numpy()), jnp.asarray(expo.numpy())))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert got[0] == 0.0  # 0^0 is 0 here, not C's 1
