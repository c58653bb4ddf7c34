"""Scene presets: the reference's demo scene and camera, the test subsets
of BASELINE.json, and the large-mesh terrain.

Counterpart of raytracer_tpu/scene/presets.py:27-212 (src/main.rs:809-1083):
9 objects (dodecahedron, floor, striped bump-mapped wall, two glass slabs,
red/clear/checker/green spheres), 3 lights (white directional, pink spot,
bluish point) and the demo camera; of presets.py:214-316, the subset
scenes 01-spheres, 02/05-triangles, 03/04-recursive and 06/07-obj; and of
presets.py:321-410, the heightfield terrain `mesh_scene` that the JAX
package's mesh bench and goldens render.  A maker returns a Scene whose
`textures` are DEFAULT_TEXTURES (the JAX makers return a (scene,
textures) pair); makers build on the card unless given device="cpu".

The port's own preset, with no JAX counterpart: `spd-balls`, the
sphereflake of the Standard Procedural Databases (7,381 spheres, its own
z-up view), whose maker returns (scene, camera).
"""

from __future__ import annotations

import os

import numpy as np

from raytracer_tpu_torch.scene.builder import MaterialSpec, SceneBuilder, Vertex, square
from raytracer_tpu_torch.scene.geometry import dodecahedron_triangles
from raytracer_tpu_torch.scene.textures import TEXTURE_CHECKER, TEXTURE_STRIPES
from raytracer_tpu_torch.scene.types import DEFAULT_DEVICE, Camera, Scene
from raytracer_tpu_torch.utils.obj import load_obj_triangles

WHITE = (1.0, 1.0, 1.0)
YELLOW = (1.0, 1.0, 0.0)
BLUE = (0.0, 0.0, 1.0)

# The demo bake transform for the OBJ mesh (src/main.rs:802).
_DODE_TRANSFORM = lambda p: p / 3.0 + np.asarray([0.7, 1.0, -0.5], np.float32)


def demo_camera(device=DEFAULT_DEVICE) -> Camera:
    """fovy 60deg, center (2, 2.5, 2), toward -(1,1,1)/sqrt(3), up +y,
    near -0.1 (src/main.rs:1077-1083)."""
    return Camera.create(
        fovy_deg=60.0,
        center=(2.0, 2.5, 2.0),
        toward=np.asarray([-1.0, -1.0, -1.0]) / np.sqrt(3.0),
        up=(0.0, 1.0, 0.0),
        near=-0.1,
        device=device,
    )


def _dodecahedron_tris(obj_path=None):
    if obj_path and os.path.exists(obj_path):
        return load_obj_triangles(obj_path, transform=_DODE_TRANSFORM)
    return dodecahedron_triangles(transform=_DODE_TRANSFORM)


def _floor(b: SceneBuilder, half: float = 2.0) -> None:
    """The tan floor square, x and z in [-half, half]."""
    b.push_object(
        MaterialSpec(diffuse_color=(1.0, 0.8, 0.6), shiness=0.5, smoothness=0.01)
    ).push_triangles(square([
        ((-half, 0.0, -half), (0.0, 0.0)),
        ((-half, 0.0, half), (0.0, 1.0)),
        ((half, 0.0, half), (1.0, 0.0)),
        ((half, 0.0, -half), (0.0, 1.0)),
    ]))


def _slab(p, x0, x1, z0, z1):
    """Six faces of an axis-aligned glass slab, y in [1.0, 1.5], in the
    reference's vertex/uv order (src/main.rs:879-977)."""
    p.push_triangles(square([
        ((x1, 1.5, z1), (0.0, 0.0)), ((x0, 1.5, z1), (0.0, 1.0)),
        ((x0, 1.0, z1), (1.0, 0.0)), ((x1, 1.0, z1), (0.0, 1.0)),
    ]))
    p.push_triangles(square([
        ((x1, 1.0, z0), (0.0, 1.0)), ((x0, 1.0, z0), (1.0, 0.0)),
        ((x0, 1.5, z0), (0.0, 1.0)), ((x1, 1.5, z0), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((x1, 1.5, z0), (0.0, 1.0)), ((x0, 1.5, z0), (1.0, 0.0)),
        ((x0, 1.5, z1), (0.0, 1.0)), ((x1, 1.5, z1), (0.0, 0.0)),
    ]))


def demo_builder(obj_path: str | None = None) -> SceneBuilder:
    """The demo scene's builder, before build (scene/serialize.dump_builder
    writes it as JSON).  An `obj_path` that does not exist falls back to
    the built-in dodecahedron, as in the JAX package."""
    b = SceneBuilder()

    # Dodecahedron: white, shiness 0.1 (src/main.rs:812-825)
    b.push_object(
        MaterialSpec(
            diffuse_color=WHITE, shiness=0.1, specular_color=WHITE,
            smoothness=1.0, refraction_index=1.0, opaque_decay=0.0,
            transparency=0.0,
        )
    ).push_triangles(_dodecahedron_tris(obj_path))

    # Floor: tan square, shiness 0.5 (src/main.rs:826-844)
    _floor(b)

    # Striped wall with procedural bump normal (src/main.rs:845-877)
    b.push_object(
        MaterialSpec(
            shiness=0.0, specular_color=WHITE, smoothness=0.00001,
            texture=TEXTURE_STRIPES,
        )
    ).push_triangles(square([
        ((-2.0, 2.0, -2.0), (0.0, 0.0)),
        ((-2.0, 2.0, 2.0), (0.0, 1.0)),
        ((-2.0, -2.0, 2.0), (1.0, 0.0)),
        ((-2.0, -2.0, -2.0), (1.0, 1.0)),
    ]))

    glass = MaterialSpec(
        diffuse_color=(1.0, 0.8, 0.6), shiness=1.0, specular_color=WHITE,
        smoothness=0.00001, refraction_index=1.6, opaque_decay=0.1,
        transparency=1.0,
    )

    # Glass slab 1: x in [-0.5, 0.5], z in [0.6, 0.7] (src/main.rs:879-927)
    p = b.push_object(glass)
    _slab(p, -0.5, 0.5, 0.6, 0.7)
    p.push_triangles(square([
        ((0.5, 1.0, 0.7), (0.0, 1.0)), ((-0.5, 1.0, 0.7), (1.0, 0.0)),
        ((-0.5, 1.0, 0.6), (0.0, 1.0)), ((0.5, 1.0, 0.6), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((-0.5, 1.5, 0.6), (0.0, 1.0)), ((-0.5, 1.0, 0.6), (1.0, 0.0)),
        ((-0.5, 1.0, 0.7), (0.0, 1.0)), ((-0.5, 1.5, 0.7), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((0.5, 1.0, 0.6), (0.0, 1.0)), ((0.5, 1.5, 0.6), (1.0, 0.0)),
        ((0.5, 1.5, 0.7), (0.0, 1.0)), ((0.5, 1.0, 0.7), (0.0, 0.0)),
    ]))

    # Glass slab 2: x in [-0.3, 0.3], z in [0.71, 0.81]
    # (src/main.rs:929-977; its faces come in another order than slab 1's)
    p = b.push_object(glass)
    _slab(p, -0.3, 0.3, 0.71, 0.81)
    p.push_triangles(square([
        ((-0.3, 1.5, 0.71), (0.0, 1.0)), ((-0.3, 1.0, 0.71), (1.0, 0.0)),
        ((-0.3, 1.0, 0.81), (0.0, 1.0)), ((-0.3, 1.5, 0.81), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((0.3, 1.0, 0.81), (0.0, 1.0)), ((-0.3, 1.0, 0.81), (1.0, 0.0)),
        ((-0.3, 1.0, 0.71), (0.0, 1.0)), ((0.3, 1.0, 0.71), (0.0, 0.0)),
    ]))
    p.push_triangles(square([
        ((0.3, 1.0, 0.71), (0.0, 1.0)), ((0.3, 1.5, 0.71), (1.0, 0.0)),
        ((0.3, 1.5, 0.81), (0.0, 1.0)), ((0.3, 1.0, 0.81), (0.0, 0.0)),
    ]))

    # Red sphere, yellow specular (src/main.rs:979-996)
    b.push_object(
        MaterialSpec(
            diffuse_color=(1.0, 0.2, 0.2), shiness=0.2, specular_color=YELLOW,
            smoothness=0.2,
        )
    ).push_sphere((-0.5, 0.5, 0.5 / np.sqrt(3.0)), 0.5)

    # Clear sphere: ior 1.12, transparency 0.96 (src/main.rs:998-1014)
    b.push_object(
        MaterialSpec(
            diffuse_color=WHITE, shiness=1.0, specular_color=WHITE,
            smoothness=0.001, refraction_index=1.12, opaque_decay=0.3,
            transparency=0.96,
        )
    ).push_sphere((0.5, 0.5, 0.5 / np.sqrt(3.0)), 0.5)

    # Diagonal-checker textured sphere (src/main.rs:1016-1038)
    b.push_object(
        MaterialSpec(
            shiness=0.3, specular_color=BLUE, smoothness=0.7,
            texture=TEXTURE_CHECKER,
        )
    ).push_sphere((0.0, 0.5, -1.0 / np.sqrt(3.0)), 0.5)

    # Green sphere on top (src/main.rs:1040-1056)
    b.push_object(
        MaterialSpec(
            diffuse_color=(0.5, 1.0, 0.2), shiness=0.5, specular_color=WHITE,
            smoothness=0.01,
        )
    ).push_sphere((0.0, 0.5 + np.sqrt(2.0 / 3.0), 0.0), 0.5)

    _demo_lights(b)
    return b


def demo_scene(obj_path: str | None = None, device=DEFAULT_DEVICE) -> Scene:
    return demo_builder(obj_path).build(device=device)


def _demo_lights(b: SceneBuilder) -> None:
    # White directional (src/main.rs:1058-1062)
    b.push_directional_light(
        direction=np.asarray([-1.0, -1.0, 0.0]) / np.sqrt(2.0),
        color=(1.0, 0.98, 0.95),
    )
    # Pink spot from y=10, 60deg cone, softness 1 (src/main.rs:1064-1070)
    b.push_spot_light(
        origin=(0.0, 10.0, 0.0),
        direction=(0.0, -1.0, 0.0),
        angle_rad=np.deg2rad(60.0),
        softness=1.0,
        color=(1.0, 0.5, 0.9),
    )
    # Bluish point at (0, 0.1, 0) (src/main.rs:1072-1075)
    b.push_point_light(origin=(0.0, 0.1, 0.0), color=(0.8, 0.8, 1.0))


# ---------------------------------------------------------------------------
# BASELINE.json config presets (subsets of the demo scene for testing)
# ---------------------------------------------------------------------------

def spheres_scene(device=DEFAULT_DEVICE) -> Scene:
    """01-spheres: 3 Phong spheres over a floor, direct lighting only."""
    b = SceneBuilder()
    _floor(b, 4.0)
    b.push_object(
        MaterialSpec(diffuse_color=(1.0, 0.2, 0.2), shiness=0.2,
                     specular_color=YELLOW, smoothness=0.2)
    ).push_sphere((-0.9, 0.5, 0.0), 0.5)
    b.push_object(
        MaterialSpec(diffuse_color=(0.2, 1.0, 0.2), shiness=0.4, smoothness=0.1)
    ).push_sphere((0.0, 0.5, -0.6), 0.5)
    b.push_object(
        MaterialSpec(diffuse_color=(0.2, 0.2, 1.0), shiness=0.3, smoothness=0.05)
    ).push_sphere((0.9, 0.5, 0.0), 0.5)
    _demo_lights(b)
    return b.build(device=device)


def triangles_scene(device=DEFAULT_DEVICE) -> Scene:
    """02/05: mixed sphere/triangle scene with shadows + speculars."""
    b = SceneBuilder()
    _floor(b)
    b.push_object(
        MaterialSpec(texture=TEXTURE_STRIPES, shiness=0.0, smoothness=0.00001)
    ).push_triangles(square([
        ((-2.0, 2.0, -2.0), (0.0, 0.0)),
        ((-2.0, 2.0, 2.0), (0.0, 1.0)),
        ((-2.0, -2.0, 2.0), (1.0, 0.0)),
        ((-2.0, -2.0, -2.0), (1.0, 1.0)),
    ]))
    b.push_object(
        MaterialSpec(diffuse_color=(1.0, 0.2, 0.2), shiness=0.2,
                     specular_color=YELLOW, smoothness=0.2)
    ).push_sphere((-0.5, 0.5, 0.3), 0.5)
    b.push_object(
        MaterialSpec(diffuse_color=(0.5, 1.0, 0.2), shiness=0.5, smoothness=0.01)
    ).push_sphere((0.5, 0.5, -0.3), 0.5)
    _demo_lights(b)
    return b.build(device=device)


def recursive_scene(device=DEFAULT_DEVICE) -> Scene:
    """03/04: mirror + glass at bounce depth 5."""
    b = SceneBuilder()
    _floor(b)
    # Mirror sphere
    b.push_object(
        MaterialSpec(diffuse_color=WHITE, shiness=1.0, smoothness=0.00001)
    ).push_sphere((-0.55, 0.5, 0.0), 0.5)
    # Glass sphere
    b.push_object(
        MaterialSpec(diffuse_color=WHITE, shiness=1.0, smoothness=0.001,
                     refraction_index=1.12, opaque_decay=0.3, transparency=0.96)
    ).push_sphere((0.55, 0.5, 0.0), 0.5)
    _demo_lights(b)
    return b.build(device=device)


def obj_scene(device=DEFAULT_DEVICE) -> Scene:
    """06/07: OBJ dodecahedron + textured sphere."""
    b = SceneBuilder()
    b.push_object(
        MaterialSpec(diffuse_color=WHITE, shiness=0.1, smoothness=1.0)
    ).push_triangles(dodecahedron_triangles(
        transform=lambda p: p / 2.0 + np.asarray([0.0, 0.8, 0.0], np.float32)))
    _floor(b)
    b.push_object(
        MaterialSpec(texture=TEXTURE_CHECKER, shiness=0.3, specular_color=BLUE,
                     smoothness=0.7)
    ).push_sphere((1.0, 0.5, 0.8), 0.5)
    _demo_lights(b)
    return b.build(device=device)


def full_scene(obj_path: str | None = None, device=DEFAULT_DEVICE) -> Scene:
    """08-full: the complete demo scene (DoF + photon scatter pass)."""
    return demo_scene(obj_path, device)


def terrain_triangles(grid: int):
    """Smooth-shaded heightfield mesh: 2*grid^2 triangles on x,z in [-3,3],
    with analytic per-vertex normals (presets.py:321-362).  Returns a list
    of Vertex triples for ObjectProxy.push_triangles."""

    def h(x, z):
        return (0.45 * np.sin(1.3 * x) * np.cos(1.1 * z)
                + 0.15 * np.sin(3.1 * x + 1.0) * np.cos(2.7 * z))

    def grad(x, z):
        dx = (0.45 * 1.3 * np.cos(1.3 * x) * np.cos(1.1 * z)
              + 0.15 * 3.1 * np.cos(3.1 * x + 1.0) * np.cos(2.7 * z))
        dz = (-0.45 * 1.1 * np.sin(1.3 * x) * np.sin(1.1 * z)
              - 0.15 * 2.7 * np.sin(3.1 * x + 1.0) * np.sin(2.7 * z))
        return dx, dz

    xs = np.linspace(-3.0, 3.0, grid + 1)
    zs = np.linspace(-3.0, 3.0, grid + 1)

    def vert(i, j):
        x, z = float(xs[i]), float(zs[j])
        y = float(h(x, z))
        dx, dz = grad(x, z)
        n = np.asarray([-dx, 1.0, -dz], np.float32)
        n = n / np.linalg.norm(n)
        uv = np.asarray([i / grid, j / grid], np.float32)
        return Vertex(np.asarray([x, y, z], np.float32), n, uv)

    tris = []
    for i in range(grid):
        for j in range(grid):
            v00, v10 = vert(i, j), vert(i + 1, j)
            v01, v11 = vert(i, j + 1), vert(i + 1, j + 1)
            # wind both CCW seen from +y so face normals point up
            tris.append([v00, v01, v11])
            tris.append([v00, v11, v10])
    return tris


def mesh_scene(grid: int = 24, device=DEFAULT_DEVICE) -> tuple[Scene, Camera]:
    """Large-mesh preset (presets.py:365-410): a 2*grid^2-triangle terrain,
    a mirror and a glass sphere, and a 12-triangle glass cube whose
    interior march runs against the blocked table, under the demo lights.
    grid=24 -> 1,164 triangles; grid=75 -> 11,262 (the JAX bench's
    "mesh11k"); grid=160 -> 51,212.  Always builds the BVH / blocked
    layout.  Returns (scene, camera)."""
    b = SceneBuilder()
    b.push_object(
        MaterialSpec(diffuse_color=(0.55, 0.65, 0.45), shiness=0.25,
                     specular_color=WHITE, smoothness=0.03)
    ).push_triangles(terrain_triangles(grid))
    b.push_object(
        MaterialSpec(diffuse_color=(0.9, 0.9, 0.95), shiness=0.85,
                     specular_color=WHITE, smoothness=0.4)
    ).push_sphere((-1.0, 1.2, 0.3), 0.55)
    b.push_object(
        MaterialSpec(diffuse_color=WHITE, transparency=0.95,
                     refraction_index=1.25, opaque_decay=0.6,
                     specular_color=WHITE, smoothness=0.5)
    ).push_sphere((0.9, 1.1, -0.7), 0.45)
    glass = b.push_object(
        MaterialSpec(diffuse_color=WHITE, transparency=1.0,
                     refraction_index=1.5, opaque_decay=0.25,
                     specular_color=WHITE, smoothness=0.6)
    )
    c, r = np.asarray([0.1, 1.0, 1.1]), 0.35
    corners = [c + r * np.asarray(s)
               for s in [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
                         (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]]
    uv0 = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))
    for face in [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
                 (2, 3, 7, 6), (1, 2, 6, 5), (0, 4, 7, 3)]:
        glass.push_triangles(square(
            [(corners[k], uv0[m]) for m, k in enumerate(face)]
        ))
    _demo_lights(b)
    cam = Camera.create(
        fovy_deg=55.0,
        center=(3.2, 2.6, 3.2),
        toward=np.asarray([-1.0, -0.75, -1.0])
        / np.linalg.norm([-1.0, -0.75, -1.0]),
        up=(0.0, 1.0, 0.0),
        near=-0.1,
        device=device,
    )
    return b.build(use_bvh=True, device=device), cam


# ---------------------------------------------------------------------------
# SPD `balls`: the sphereflake of E. Haines's Standard Procedural Databases
# ---------------------------------------------------------------------------

def _axis_angle(axis, angle: float) -> np.ndarray:
    """The right-handed rotation by `angle` about `axis` (Rodrigues), float64."""
    k = np.asarray(axis, np.float64)
    k = k / np.linalg.norm(k)
    cross = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return (np.eye(3) * np.cos(angle) + np.sin(angle) * cross
            + (1.0 - np.cos(angle)) * np.outer(k, k))


def _from_z(a: np.ndarray) -> np.ndarray:
    """The rotation carrying +z onto the unit vector a along the shortest
    arc (the identity for +z; by pi about +x for -z)."""
    v = np.array([-a[1], a[0], 0.0])  # +z x a
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if a[2] > 0.0 else np.diag([1.0, -1.0, -1.0])
    cross = np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])
    return np.eye(3) + cross + cross @ cross / (1.0 + a[2])


def spd_objset() -> np.ndarray:
    """The 9 unit directions of a sphere's children about its axis +z
    (balls.c's objset): (1, 1, 0), (1, 0, -1), (0, 1, -1) over sqrt(2),
    rotated by asin(2 / sqrt(6)) about (1, -1, 0) / sqrt(2), then copied
    about +z at 0, 120 and 240 degrees: six on the equator, three at
    z = sqrt(2/3)."""
    s = 1.0 / np.sqrt(2.0)
    tilt = _axis_angle((1.0, -1.0, 0.0), np.arcsin(2.0 / np.sqrt(6.0)))
    base = np.array([[s, s, 0.0], [s, 0.0, -s], [0.0, s, -s]]) @ tilt.T
    return np.array([_axis_angle((0.0, 0.0, 1.0), a) @ v
                     for a in (0.0, 2.0 * np.pi / 3.0, 4.0 * np.pi / 3.0) for v in base])


def spd_balls_spheres(size_factor: int = 4):
    """The sphereflake's spheres, depth first, in float64 -> (centers [S, 3],
    radii [S], parent [S] (-1 for the root)).  The root: (0, 0, 0), radius
    0.5, axis +z; a sphere (c, r, axis a) with levels left gets 9 children,
    one along each d = R o (R carries +z onto a, o in spd_objset()), at
    c + d (r + r/3) with radius r/3 and axis d: each touches its parent.
    size_factor levels below the root: (9^(size_factor+1) - 1) / 8 spheres."""
    objset = spd_objset()
    centers, radii, parents = [], [], []

    def add(c, r, axis, levels, parent):
        index = len(centers)
        centers.append(c)
        radii.append(r)
        parents.append(parent)
        if levels:
            rot = _from_z(axis)
            for o in objset:
                d = rot @ o
                add(c + d * (r + r / 3.0), r / 3.0, d, levels - 1, index)

    add(np.zeros(3), 0.5, np.array([0.0, 0.0, 1.0]), size_factor, -1)
    return np.array(centers), np.array(radii), np.array(parents)


SPD_BALLS_SPHERE = MaterialSpec(  # NFF "f 1 .9 .7 Kd 0.5 Ks 0.5 Shine 3"
    diffuse_color=(0.5, 0.45, 0.35), shiness=0.5, specular_color=WHITE,
    smoothness=1.0 / 3.0)
SPD_BALLS_FLOOR = MaterialSpec(  # NFF "f 1 .75 .33 Kd 0.8 Ks 0"
    diffuse_color=(0.8, 0.6, 0.264), shiness=0.0, specular_color=WHITE)


def spd_balls_builder(size_factor: int = 4) -> SceneBuilder:
    """SPD `balls` (E. Haines, IEEE CG&A 7(11), 1987), z up: the sphereflake
    of spd_balls_spheres over a floor square at z = -0.5 (half-side 12, two
    triangles), under three white point lights of intensity 1/sqrt(3).
    Materials map NFF's onto MaterialSpec: diffuse_color = Kd x colour,
    shiness = Ks (the reflect weight), smoothness = 1 / Phong power (the
    specular exponent is 1 / smoothness)."""
    b = SceneBuilder()
    h, z = 12.0, -0.5
    b.push_object(SPD_BALLS_FLOOR).push_triangles(square([
        ((-h, -h, z), (0.0, 0.0)), ((h, -h, z), (1.0, 0.0)),
        ((h, h, z), (1.0, 1.0)), ((-h, h, z), (0.0, 1.0)),
    ]))
    flake = b.push_object(SPD_BALLS_SPHERE)
    centers, radii, _ = spd_balls_spheres(size_factor)
    for c, r in zip(centers, radii):
        flake.push_sphere(c, float(r))
    white = np.full(3, 1.0 / np.sqrt(3.0))
    for origin in ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0)):
        b.push_point_light(origin=origin, color=white)
    return b


# NFF's `angle` is the whole vertical field of view; the camera's fovy
# scales clip coordinates of +-0.5 by tan(fovy / 2) (main.rs:85-90), so an
# angle A takes fovy = 2 atan(2 tan(A / 2)).
SPD_BALLS_FOVY_DEG = 2.0 * float(np.degrees(np.arctan(2.0 * np.tan(np.radians(45.0 / 2.0)))))


def spd_balls_camera(device=DEFAULT_DEVICE) -> Camera:
    """SPD `balls`' view: from (2.1, 1.3, 1.7) toward the origin, up +z,
    a 45 degree field of view (SPD_BALLS_FOVY_DEG); the rays start at the
    eye (near 0), 3.0 from the flake's centre, the renderer's default
    focus."""
    eye = np.asarray([2.1, 1.3, 1.7])
    return Camera.create(fovy_deg=SPD_BALLS_FOVY_DEG, center=eye,
                         toward=-eye / np.linalg.norm(eye), up=(0.0, 0.0, 1.0), near=0.0,
                         device=device)


def spd_balls_scene(size_factor: int = 4, device=DEFAULT_DEVICE) -> tuple[Scene, Camera]:
    """SPD `balls` at `size_factor` (4: 7,381 spheres and the 2-triangle
    floor, on the dense walks) -> (scene, its own camera)."""
    return (spd_balls_builder(size_factor).build(device=device),
            spd_balls_camera(device))


PRESETS = {
    "01-spheres": spheres_scene,
    "02-triangles": triangles_scene,
    "03-recursive": recursive_scene,
    "04-recursive": recursive_scene,  # 03/04 share the BASELINE config
    "05-triangles": triangles_scene,  # 02/05 share the BASELINE config
    "06-obj": obj_scene,
    "07-obj": obj_scene,  # 06/07 share the BASELINE config
    "08-full": full_scene,
    "full": full_scene,
    "demo": demo_scene,
    "spd-balls": spd_balls_scene,  # the port's own: returns (scene, camera)
}
