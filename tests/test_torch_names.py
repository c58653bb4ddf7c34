"""The last public names of raytracer_tpu that the port carries: the named
colours, FACE_BOTH, TEXTURE_CONST and progressive.write_image, each held
against the JAX package's value on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from raytracer_tpu.ops.intersect import cast as jax_cast
from raytracer_tpu.parallel import progressive as jprogressive
from raytracer_tpu.scene import builder as jbuilder
from raytracer_tpu.scene import textures as jtextures
from raytracer_tpu.scene import types as jtypes
from raytracer_tpu.scene.types import Rays as JaxRays
from raytracer_tpu.utils import color as jcolor
from raytracer_tpu_torch.ops.intersect import cast
from raytracer_tpu_torch.parallel import progressive
from raytracer_tpu_torch.scene import builder, textures, types
from raytracer_tpu_torch.scene.types import Rays
from raytracer_tpu_torch.utils import color

torch.set_num_threads(1)

COLOURS = ("BLACK", "WHITE", "RED", "GREEN", "BLUE", "YELLOW", "CYAN", "MAGENTA")


@pytest.mark.parametrize("name", COLOURS)
def test_named_colours_are_the_jax_packages(name):
    np.testing.assert_array_equal(np.asarray(getattr(color, name), np.float32),
                                  getattr(jcolor, name))


@pytest.mark.parametrize("module, jax_module, name", [
    (types, jtypes, "FACE_FRONT"), (types, jtypes, "FACE_BACK"), (types, jtypes, "FACE_BOTH"),
    (textures, jtextures, "TEXTURE_CONST"), (textures, jtextures, "TEXTURE_STRIPES"),
    (textures, jtextures, "TEXTURE_CHECKER")])
def test_encodings_are_the_jax_packages(module, jax_module, name):
    assert getattr(module, name) == getattr(jax_module, name)


def _simple(b, spec, square):
    """tests/test_intersect.py's scene: a unit sphere at z = -3 before a wall
    at z = -6 whose face normal points +z."""
    b.push_object(spec(diffuse_color=(1, 0, 0))).push_sphere((0, 0, -3), 1.0)
    b.push_object(spec(diffuse_color=(0, 1, 0))).push_triangles(square([
        ((-2, -2, -6), (0, 0)), ((2, -2, -6), (0, 1)),
        ((2, 2, -6), (1, 0)), ((-2, 2, -6), (1, 1))]))
    b.push_directional_light((0, -1, 0), (1, 1, 1))
    return b


@pytest.fixture(scope="module")
def simple():
    jscene = _simple(jbuilder.SceneBuilder(), jbuilder.MaterialSpec, jbuilder.square).build()
    scene = _simple(builder.SceneBuilder(), builder.MaterialSpec, builder.square).build(
        device="cpu")
    return jscene, scene


# (origin, face): from inside the sphere FACE_BOTH takes its far shell as a
# back face (tests/test_intersect.py:63); from outside, the near shell
@pytest.mark.parametrize("origin, face, t, backface", [
    ((0, 0, -3), types.FACE_BOTH, 1.0, True),
    ((0, 0, 0), types.FACE_BOTH, 2.0, False),
    ((0, 0, -3), types.FACE_FRONT, 3.0, False),
    ((0, 0, -3), types.FACE_BACK, 1.0, True)])
def test_cast_under_each_face_is_the_jax_packages(simple, origin, face, t, backface):
    jscene, scene = simple
    fields = dict(o=np.array([origin], np.float32), d=np.array([[0, 0, -1]], np.float32),
                  face=np.array([face], np.int32), excl_prim=np.array([-1], np.int32),
                  excl_face=np.array([types.FACE_FRONT], np.int32))
    want = jax_cast(jscene, JaxRays(**{k: jnp.asarray(v) for k, v in fields.items()}))
    got = cast(scene, Rays(**{k: torch.as_tensor(v) for k, v in fields.items()}))
    assert bool(got.valid[0]) and bool(want.valid[0])
    assert float(got.t[0]) == pytest.approx(t, abs=1e-5)
    assert float(got.t[0]) == pytest.approx(float(want.t[0]), rel=1e-6)
    assert bool(got.backface[0]) == bool(want.backface[0]) == backface
    assert int(got.prim[0]) == int(want.prim[0])


@pytest.mark.parametrize("seed, shape, scale", [(0, (48, 64, 3), 1.0), (1, (7, 5, 3), 4.0),
                                                (2, (16, 16, 3), 0.01)])
def test_write_image_writes_the_jax_packages_png(tmp_path, seed, shape, scale):
    """A linear buffer over and under [0, 1] (clamped), written by both
    packages: the same PNG bytes."""
    img = np.random.default_rng(seed).uniform(-0.1, 1.2, size=shape).astype(np.float32) * scale
    progressive.write_image(str(tmp_path / "port.png"), torch.as_tensor(img))
    jprogressive.write_image(str(tmp_path / "jax.png"), jnp.asarray(img))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
