"""raytracer_tpu_torch's render_step / render_steps / render_epochs against
its own render_whitted and render_distributed_epoch (which the other port
tests hold against the JAX package), their stats keys against the JAX
package's, get_up_right against JAX's, the H100 roofline's bound, and the
package's exports."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu
import raytracer_tpu_torch
from raytracer_tpu.ops.tangent import get_up_right as jax_get_up_right
from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu.scene.types import Hits as JaxHits
from raytracer_tpu_torch.config import NORTH_STAR_CONFIG, REFERENCE_CONFIG, RenderConfig
from raytracer_tpu_torch.ops.tangent import get_up_right
from raytracer_tpu_torch.render import (
    _clips,
    render_distributed_epoch,
    render_epochs,
    render_step,
    render_steps,
    render_whitted,
    tile_draws,
)
from raytracer_tpu_torch.scene import presets as tpresets
from raytracer_tpu_torch.scene.builder import MaterialSpec, SceneBuilder, square
from raytracer_tpu_torch.scene.types import Hits
from raytracer_tpu_torch.utils import kernels, roofline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(width=24, height=16, depth=3, tile_rays=128)  # 3 tiles of 128


@pytest.fixture(scope="module")
def demo():
    return tpresets.demo_scene(device="cpu"), tpresets.demo_camera(device="cpu")


def assert_stats(got, want):
    assert set(got) == set(want) and all(got[k] == want[k] for k in want), (got, want)


def test_render_step_is_whitted_plus_one_epoch(demo):
    scene, cam = demo
    img, photons, st = render_step(scene, cam, CFG, seed=3, epoch=5)
    ref_img, wst = render_whitted(scene, cam, CFG)
    ref_ph, est = render_distributed_epoch(scene, cam, CFG, seed=3, epoch=5)
    assert torch.equal(img, ref_img) and torch.equal(photons, ref_ph)
    assert_stats(st, {"casts": wst["casts"] + est["casts"], "dropped": wst["dropped"],
                      "filtered": est["filtered"], "primary_rays": CFG.width * CFG.height})


def test_render_steps_returns_the_last_step_and_sums(demo):
    scene, cam = demo
    img, photons, st = render_steps(scene, cam, CFG, 3, 2, epoch=4)
    steps = [render_step(scene, cam, CFG, seed=3, epoch=e) for e in (4, 5)]
    assert torch.equal(img, steps[-1][0]) and torch.equal(photons, steps[-1][1])
    assert not torch.equal(steps[0][1], steps[1][1])  # each step its own epoch
    total = lambda k: sum(s[2][k] for s in steps)
    assert_stats(st, {"casts": total("casts"), "dropped": total("dropped"),
                      "filtered": total("filtered"),
                      "primary_rays": 2 * CFG.width * CFG.height, "steps": 2})


def test_render_epochs_is_the_sum_of_its_epochs(demo):
    scene, cam = demo
    accum, st = render_epochs(scene, cam, CFG, 7, 3, epoch=2)
    ref = torch.zeros_like(accum)
    casts = filtered = 0
    for e in (2, 3, 4):
        ph, est = render_distributed_epoch(scene, cam, CFG, seed=7, epoch=e)
        ref = ref + ph
        casts += est["casts"]
        filtered += est["filtered"]
    assert torch.equal(accum, ref)
    assert_stats(st, {"casts": casts, "filtered": filtered,
                      "primary_rays": 3 * CFG.width * CFG.height, "epochs": 3})


def test_draws_per_epoch_reach_each_epoch(demo):
    scene, cam = demo
    clips = _clips(CFG, "cpu")[0]
    draws = [[tile_draws(CFG, 11, e, t, clip.shape[0], "cpu") for t, clip in enumerate(clips)]
             for e in (0, 1)]
    accum, _ = render_epochs(scene, cam, CFG, 0, 2, draws=draws)
    ref, _ = render_epochs(scene, cam, CFG, 11, 2)
    assert torch.equal(accum, ref)
    _, photons, _ = render_steps(scene, cam, CFG, 0, 2, draws=draws)
    assert torch.equal(photons, render_distributed_epoch(scene, cam, CFG, seed=11, epoch=1)[0])
    with pytest.raises(ValueError, match="draws for 1 epochs"):
        render_epochs(scene, cam, CFG, 0, 2, draws=draws[:1])


def _jax_stats_keys(fn_name):
    """The keys of the stats dict that raytracer_tpu/render.py's `fn_name`
    returns, read from its source (running it would compile a frame)."""
    path = os.path.join(ROOT, "raytracer_tpu", "render.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return {k.value for k in ret.value.elts[-1].keys}


@pytest.mark.parametrize("fn_name", ["render_step", "render_steps", "render_epochs",
                                     "render_whitted", "render_distributed_epoch"])
def test_stats_keys_match_the_jax_package(demo, fn_name):
    scene, cam = demo
    cfg = dataclasses.replace(CFG, width=8, height=8, depth=1)
    fn = getattr(raytracer_tpu_torch.render, fn_name)
    extra = {"render_steps": (0, 1), "render_epochs": (0, 1)}.get(fn_name, ())
    stats = fn(scene, cam, cfg, *extra)[-1]
    assert set(stats) == _jax_stats_keys(fn_name)


def _hits(prims, normals):
    """Hits fields as numpy: valid lanes on `prims` with `normals`."""
    n = len(prims)
    z = lambda *s: np.zeros(s, np.float32)
    return dict(valid=np.ones(n, bool), t=np.ones(n, np.float32),
               prim=np.asarray(prims, np.int32), obj=np.zeros(n, np.int32), pos=z(n, 3),
               normal=np.asarray(normals, np.float32), uv=z(n, 2), backface=np.zeros(n, bool))


def test_get_up_right_matches_jax():
    b = SceneBuilder()
    quad = [((-1, 0, -1), (0, 0)), ((-1, 0, 1), (0, 1)), ((1, 0, 1), (1, 1)), ((1, 0, -1), (1, 0))]
    b.push_object(MaterialSpec()).push_triangles(square(quad))  # invertible uv
    b.push_object(MaterialSpec()).push_triangles(square([(p, (0, 0)) for p, _ in quad]))
    b.push_object(MaterialSpec()).push_sphere((0, 1, 0), 0.5)
    scene = b.build(device="cpu")
    jscene, _ = jpresets.demo_scene()
    tscene = tpresets.demo_scene(device="cpu")
    rng = np.random.default_rng(0)
    for sc, jsc in ((scene, None), (tscene, jscene)):
        prims = list(range(sc.n_prim))
        normals = rng.normal(size=(len(prims), 3))
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        up, right = get_up_right(sc, Hits(**{k: torch.as_tensor(v) for k, v in
                                             _hits(prims, normals).items()}))
        if jsc is None:  # the JAX function on the same arrays
            jsc = dataclasses.make_dataclass("S", ["n_tri", "tri_v", "tri_uv"])(
                sc.n_tri, jnp.asarray(sc.tri_v.numpy()), jnp.asarray(sc.tri_uv.numpy()))
        jh = JaxHits(**{k: jnp.asarray(v) for k, v in _hits(prims, normals).items()})
        ju, jr = jax_get_up_right(jsc, jh)
        np.testing.assert_allclose(up.numpy(), np.asarray(ju), atol=1e-6)
        np.testing.assert_allclose(right.numpy(), np.asarray(jr), atol=1e-6)
    # a degenerate uv mapping gives zero vectors, not NaN
    up, right = get_up_right(scene, Hits(**{k: torch.as_tensor(v) for k, v in
                                            _hits([2, 3], [[0, 1, 0]] * 2).items()}))
    assert not up.any() and not right.any()


def test_roofline_bound_reproduces_the_kernel_table():
    """Two bounds of PERF.md's kernel table from their counts: the blocked MC
    kernel's frame (82.9 G FP32 operations: 1.237 ms) and the binned
    primary's tile 0 (10.3 MB: 0.0031 ms, by bytes)."""
    work = torch.zeros((len(kernels.WORK_ROWS), 1), dtype=torch.int64)
    work[kernels.WORK_ROWS.index("plane"), 0] = 8_290_000_000  # 10 operations a test
    ms, by, ops = roofline.bound(0, work)
    assert (round(ms, 3), by, ops) == (1.237, "operations", 82_900_000_000)
    work.zero_()
    work[kernels.WORK_ROWS.index("tri"), 0] = 2_710_000
    ms, by, ops = roofline.bound(10_300_000, work)
    assert (round(ms, 4), by, ops) == (0.0031, "bytes", 16_260_000)
    # every counted kind at its own charge; the clocks and cycles charge nothing
    work = torch.ones((len(kernels.WORK_ROWS), 2), dtype=torch.int32)
    assert roofline.bound(0, work)[2] == 2 * (6 + 10 + 14 + 30 + 31)
    assert roofline.PEAK_BYTES == 3.35e12 and roofline.PEAK_FP32 == 67e12


def test_package_exports_match_the_jax_package():
    assert sorted(raytracer_tpu_torch.__all__) == sorted(raytracer_tpu.__all__)
    for name in raytracer_tpu_torch.__all__:
        assert getattr(raytracer_tpu_torch, name) is not None, name
    assert REFERENCE_CONFIG == RenderConfig()
    assert (NORTH_STAR_CONFIG.width, NORTH_STAR_CONFIG.height) == (1024, 1024)
    assert sorted(raytracer_tpu_torch.PRESETS) == sorted([*raytracer_tpu.PRESETS, "spd-balls"])


def test_exported_path_renders_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """The makers and loaders the package exports build on the card by
    default, so render_step(s) / render_epochs, which follow the scene,
    run there; where CUDA is absent they raise instead of quietly
    rendering on the CPU.  device="cpu" asks for the plain path."""
    from raytracer_tpu_torch.scene.serialize import dump_builder, load_scene_dict, load_scene_file

    pkg = raytracer_tpu_torch
    data = dump_builder(tpresets.demo_builder(), tpresets.demo_camera(device="cpu"))
    path = tmp_path / "demo.json"
    path.write_text(json.dumps(data))
    makers = {
        "demo_scene": pkg.demo_scene, "demo_camera": pkg.demo_camera,
        "mesh_scene": lambda: tpresets.mesh_scene(2),
        "SceneBuilder.build": lambda: pkg.SceneBuilder().build(),
        "Camera.create": lambda: pkg.Camera.create(60.0, (0, 0, 0), (0, 0, -1), (0, 1, 0), 0.0),
        "load_scene_dict": lambda: load_scene_dict(data),
        "load_scene_file": lambda: load_scene_file(str(path)),
        **{f"PRESETS[{k!r}]": v for k, v in pkg.PRESETS.items()},
    }

    def devices(x):
        if isinstance(x, tuple):
            return set().union(*(devices(y) for y in x if y is not None))
        return {(x.tri_v if isinstance(x, pkg.Scene) else x.fovy).device.type}

    if torch.cuda.is_available():
        for name, make in makers.items():
            assert devices(make()) == {"cuda"}, name
        return
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pkg.render_steps(pkg.demo_scene(), pkg.demo_camera(), REFERENCE_CONFIG, 0, 2)
    for name, make in (("demo_scene", pkg.demo_scene), ("demo_camera", pkg.demo_camera),
                       ("load_scene_dict", lambda device: load_scene_dict(data, device=device))):
        assert devices(make(device="cpu")) == {"cpu"}, name


def test_importing_the_package_builds_and_launches_nothing():
    code = ("import sys, raytracer_tpu_torch\n"
            "from raytracer_tpu_torch.utils import kernels\n"
            "assert kernels.library.cache_info().currsize == 0\n"
            "assert not any(m.split('.')[0] in ('triton', 'raytracer_tpu') "
            "for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
