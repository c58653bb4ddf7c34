"""raytracer_tpu_torch presets against raytracer_tpu's and the oracle goldens.

Each maker's Scene is held field by field against the JAX maker's build
(numpy, no jit), and the five committed depth-5 oracle renders
(tests/golden/oracle_*_64x48_d5.npy, tests/test_presets_golden.py) are
rendered through the port's plain path at the JAX test's own thresholds.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.scene import presets as jpresets
from raytracer_tpu_torch.cli import _scene, build_parser
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.render import render_whitted
from raytracer_tpu_torch.scene import presets as tpresets
from raytracer_tpu_torch.scene.convert import from_jax_scene
from raytracer_tpu_torch.scene.types import SCENE_FIELDS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
OBJ = os.path.join(ROOT, "assets", "dodecahedron.obj")


def assert_scene_equal(got, ref):
    for name in SCENE_FIELDS:
        a, b = getattr(got, name).numpy(), getattr(ref, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=name)


def from_jax(jscene):
    return from_jax_scene({f.name: np.asarray(getattr(jscene, f.name))
                           for f in dataclasses.fields(jscene)
                           if isinstance(getattr(jscene, f.name), jnp.ndarray)})


def test_presets_have_the_jax_keys_and_makers():
    """Every preset of the JAX package, and the port's own `spd-balls`."""
    assert sorted(tpresets.PRESETS) == sorted([*jpresets.PRESETS, "spd-balls"])
    for key, maker in jpresets.PRESETS.items():
        assert tpresets.PRESETS[key].__name__ == maker.__name__, key


@pytest.mark.parametrize("name", ["spheres_scene", "triangles_scene", "recursive_scene",
                                  "obj_scene", "full_scene"])
def test_preset_matches_jax_field_by_field(name):
    jscene, _ = getattr(jpresets, name)()
    got = getattr(tpresets, name)(device="cpu")
    assert [t.name for t in got.textures] == ["const", "stripes", "checker"]
    assert got.bvh_node_min is None and jscene.bvh_node_min is None
    assert_scene_equal(got, from_jax(jscene))


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - b) ** 2)
    if mse == 0:
        return np.inf
    peak = max(b.max(), 1e-6)
    return 10 * np.log10(peak * peak / mse)


@pytest.mark.parametrize(
    "name,maker,min_db",
    [
        # the thresholds of tests/test_presets_golden.py:59-75
        ("01-spheres", "spheres_scene", 60),
        ("02-triangles", "triangles_scene", 40),
        ("03-recursive", "recursive_scene", 60),
        ("06-obj", "obj_scene", 60),
        ("demo", "demo_scene", 60),
    ],
    ids=["01-spheres", "02-triangles", "03-recursive", "06-obj", "demo"],
)
def test_preset_matches_committed_oracle_depth5(name, maker, min_db):
    golden = np.load(os.path.join(GOLDEN, f"oracle_{name}_64x48_d5.npy"))
    cfg = RenderConfig(width=64, height=48, depth=5, tile_rays=64 * 48)
    img, stats = render_whitted(getattr(tpresets, maker)(device="cpu"), tpresets.demo_camera(device="cpu"), cfg)
    assert stats["dropped"] == 0
    psnr = _psnr(img.numpy(), golden)
    assert psnr > min_db, f"PSNR {psnr:.1f} dB vs committed oracle"


def test_obj_path_missing_falls_back_to_the_built_in_mesh():
    built_in = tpresets.demo_scene(device="cpu")
    assert_scene_equal(tpresets.demo_scene(obj_path=os.path.join(ROOT, "no_such.obj"), device="cpu"),
                       built_in)
    # the asset is the same dodecahedron written out, so it also matches
    jscene, _ = jpresets.demo_scene(obj_path=OBJ)
    assert_scene_equal(tpresets.demo_scene(obj_path=OBJ, device="cpu"), from_jax(jscene))


def test_cli_obj_reaches_the_presets_that_take_it():
    args = build_parser().parse_args(["--obj", "no_such.obj", "--scene", "08-full"])
    scene, camera = _scene(args, torch.device("cpu"))
    assert_scene_equal(scene, tpresets.demo_scene(device="cpu"))
    # a preset without obj_path ignores it
    args = build_parser().parse_args(["--obj", OBJ, "--scene", "01-spheres"])
    scene, _ = _scene(args, torch.device("cpu"))
    assert_scene_equal(scene, tpresets.spheres_scene(device="cpu"))
    np.testing.assert_array_equal(camera.center.numpy(), [2.0, 2.5, 2.0])
