"""Scene data files -> raw primitives, and the program's scene built from them.

A scene file (benchmark/scenes/<name>.json) holds a deployment's scene as
data: objects (a material and its triangles, squares, spheres, cones, a box,
or a heightfield generated from a few numbers), lights and the camera.
`load` turns it into `RawScene`, plain float32 numpy arrays; `parse`
refuses an object key it does not know, so no geometry is dropped unseen.
Both sides are handed the same RawScene: the program builds its Scene from
it through its own builder (`program_scene`, the API a user of the port
calls), and the plain reference (benchmark/reference/) reads the arrays
themselves.

A cone is NFF's `c` record (E. Haines, the SPD's Neutral File Format):
`{"base": [x, y, z], "base_radius": r0, "apex": [x, y, z], "apex_radius":
r1}`, an open truncated cone with no end caps, a cylinder where r0 == r1.

The arithmetic follows the port's presets step for step (per-vertex
scalar numpy, float32 rounding at the same places), so the demo file and
the terrain file give the tables of `demo_scene()` and `mesh_scene(75)` bit
for bit (benchmark/tests/test_rtbench_harness.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np

F32 = np.float32
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(HERE, "scenes")

MATERIAL_DEFAULTS = {
    "diffuse_color": (1.0, 1.0, 1.0), "shiness": 0.0, "specular_color": (1.0, 1.0, 1.0),
    "smoothness": 0.0, "transparency": 0.0, "refraction_index": 1.0, "opaque_decay": 0.0,
    "normal": (0.0, 0.0, 1.0), "texture": None,
}
TEXTURES = (None, "stripes", "checker")  # the port's texture ids 0, 1, 2
OBJECT_KEYS = {"material", "triangles", "squares", "heightfield", "box", "spheres", "cones"}


@dataclasses.dataclass
class RawScene:
    tri_v: np.ndarray  # [T, 3, 3] float32 vertex positions
    tri_n: np.ndarray  # [T, 3, 3] float32 vertex normals
    tri_uv: np.ndarray  # [T, 3, 2] float32
    tri_obj: np.ndarray  # [T] int32
    sph_c: np.ndarray  # [S, 3] float32
    sph_r: np.ndarray  # [S] float32
    sph_obj: np.ndarray  # [S] int32
    materials: List[dict]  # MATERIAL_DEFAULTS' keys
    lights: List[dict]  # type, origin [3], direction [3] (unit), color [3], angle, softness
    camera: dict  # fovy_deg, fovy (radians, float32), center, toward (unit), up, near
    cone_base: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3), F32))
    cone_base_r: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, F32))
    cone_apex: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3), F32))
    cone_apex_r: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, F32))
    cone_obj: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))

    @property
    def n_tri(self) -> int:
        return int(self.tri_v.shape[0])

    @property
    def n_sph(self) -> int:
        return int(self.sph_c.shape[0])

    @property
    def n_cone(self) -> int:
        return int(self.cone_base.shape[0])


def _v3(x) -> np.ndarray:
    return np.asarray(x, dtype=F32).reshape(3)


def _flat(positions, uvs):
    """A flat-normal triangle: n = normalize((v1-v0) x (v2-v1)) in float32."""
    p = [_v3(q) for q in positions]
    n = np.cross(p[1] - p[0], p[2] - p[1])
    n = n / np.linalg.norm(n)
    return p, [n.copy() for _ in range(3)], [np.asarray(u, F32).reshape(2) for u in uvs]


def _square(corners, uvs):
    return [_flat([corners[0], corners[1], corners[2]], [uvs[0], uvs[1], uvs[2]]),
            _flat([corners[0], corners[2], corners[3]], [uvs[0], uvs[2], uvs[3]])]


def _heightfield(spec):
    """2 * grid^2 smooth-shaded triangles over x, z in [-extent, extent]:
    y = sum amp sin(fx x + px) cos(fz z), normals from the analytic gradient."""
    grid, ext, terms = int(spec["grid"]), float(spec["extent"]), spec["terms"]

    def h(x, z):
        return sum(t["amp"] * np.sin(t["fx"] * x + t["px"]) * np.cos(t["fz"] * z) for t in terms)

    def grad(x, z):
        dx = sum(t["amp"] * t["fx"] * np.cos(t["fx"] * x + t["px"]) * np.cos(t["fz"] * z)
                 for t in terms)
        dz = sum(-t["amp"] * t["fz"] * np.sin(t["fx"] * x + t["px"]) * np.sin(t["fz"] * z)
                 for t in terms)
        return dx, dz

    xs = np.linspace(-ext, ext, grid + 1)
    cache = {}

    def vert(i, j):
        if (i, j) not in cache:
            x, z = float(xs[i]), float(xs[j])
            dx, dz = grad(x, z)
            n = np.asarray([-dx, 1.0, -dz], F32)
            n = n / np.linalg.norm(n)
            cache[i, j] = (np.asarray([x, float(h(x, z)), z], F32), n,
                           np.asarray([i / grid, j / grid], F32))
        return cache[i, j]

    tris = []
    for i in range(grid):
        for j in range(grid):
            v00, v10, v01, v11 = vert(i, j), vert(i + 1, j), vert(i, j + 1), vert(i + 1, j + 1)
            for a, b, c in ((v00, v01, v11), (v00, v11, v10)):
                tris.append(([a[0], b[0], c[0]], [a[1], b[1], c[1]], [a[2], b[2], c[2]]))
    return tris


def _box(spec):
    c, r = np.asarray(spec["center"]), float(spec["half"])
    corners = [c + r * np.asarray(s) for s in spec["corner_signs"]]
    tris = []
    for face in spec["faces"]:
        tris += _square([corners[k] for k in face], spec["uv"])
    return tris


def _light(spec) -> dict:
    kind = spec["type"]
    d = _v3(spec.get("direction", (0.0, -1.0, 0.0)))
    if kind != "point":
        d = d / np.linalg.norm(d)
    return {"type": kind, "origin": _v3(spec.get("origin", (0.0, 0.0, 0.0))), "direction": d,
            "color": _v3(spec["color"]),
            "angle": F32(np.deg2rad(float(spec["angle_deg"]))) if kind == "spot" else F32(0.0),
            "softness": F32(spec.get("softness", 0.0)) if kind == "spot" else F32(0.0)}


def _cone(spec, mat) -> tuple:
    """(base, base radius, apex, apex radius) of one NFF cone, refused where
    it has no surface or its object asks what an open cone cannot give: a
    texture (a cone hit has no uv) or transparency (an open surface has no
    inside for the refraction march to cross)."""
    base, apex = _v3(spec["base"]), _v3(spec["apex"])
    r0, r1 = F32(spec["base_radius"]), F32(spec["apex_radius"])
    if not np.linalg.norm(apex - base) > 0.0:
        raise ValueError(f"cone {spec}: its axis has no length")
    if r0 < 0.0 or r1 < 0.0 or (r0 == 0.0 and r1 == 0.0):
        raise ValueError(f"cone {spec}: a radius is negative, or both are 0")
    if mat["texture"] is not None:
        raise ValueError(f"cone {spec}: a cone hit has no uv, so its object takes no texture")
    if mat["transparency"] > 0.0:
        raise ValueError(f"cone {spec}: an open cone has no inside, so its object is not "
                         "transparent")
    return base, r0, apex, r1


def parse(data: dict) -> RawScene:
    tri_v, tri_n, tri_uv, tri_obj, sph_c, sph_r, sph_obj, mats = [], [], [], [], [], [], [], []
    cones, cone_obj = [], []
    for idx, obj in enumerate(data["objects"]):
        unknown = sorted(set(obj) - OBJECT_KEYS)
        if unknown:
            raise ValueError(f"object {idx}: unknown keys {unknown} (known: {sorted(OBJECT_KEYS)})")
        mat = dict(MATERIAL_DEFAULTS, **obj.get("material", {}))
        if mat["texture"] not in TEXTURES:
            raise ValueError(f"unknown texture {mat['texture']!r}")
        mats.append(mat)
        tris = []
        for t in obj.get("triangles", []):
            if "n" in t:
                tris.append(([_v3(p) for p in t["p"]], [_v3(n) for n in t["n"]],
                             [np.asarray(u, F32) for u in t["uv"]]))
            else:
                tris.append(_flat(t["p"], t.get("uv", [(0.0, 0.0)] * 3)))
        for sq in obj.get("squares", []):
            tris += _square(sq["p"], sq.get("uv", [(0.0, 0.0)] * 4))
        if "heightfield" in obj:
            tris += _heightfield(obj["heightfield"])
        if "box" in obj:
            tris += _box(obj["box"])
        for p, n, uv in tris:
            tri_v.append(np.stack(p))
            tri_n.append(np.stack(n))
            tri_uv.append(np.stack(uv))
            tri_obj.append(idx)
        for s in obj.get("spheres", []):
            sph_c.append(_v3(s["center"]))
            sph_r.append(F32(s["radius"]))
            sph_obj.append(idx)
        for c in obj.get("cones", []):
            cones.append(_cone(c, mat))
            cone_obj.append(idx)
    cam = data["camera"]
    toward = np.asarray(cam["toward_unnormalized"], np.float64)
    camera = {"fovy_deg": float(cam["fovy_deg"]), "fovy": F32(np.deg2rad(float(cam["fovy_deg"]))),
              "center": _v3(cam["center"]),
              "toward": _v3(toward / np.linalg.norm(toward)), "up": _v3(cam["up"]),
              "near": F32(cam["near"])}
    arr = lambda x, shape, dt=F32: (np.stack(x).astype(dt) if x else np.zeros(shape, dt))
    return RawScene(
        tri_v=arr(tri_v, (0, 3, 3)), tri_n=arr(tri_n, (0, 3, 3)), tri_uv=arr(tri_uv, (0, 3, 2)),
        tri_obj=np.asarray(tri_obj, np.int32), sph_c=arr(sph_c, (0, 3)),
        sph_r=np.asarray(sph_r, F32), sph_obj=np.asarray(sph_obj, np.int32), materials=mats,
        lights=[_light(l) for l in data["lights"]], camera=camera,
        cone_base=arr([c[0] for c in cones], (0, 3)),
        cone_base_r=np.asarray([c[1] for c in cones], F32),
        cone_apex=arr([c[2] for c in cones], (0, 3)),
        cone_apex_r=np.asarray([c[3] for c in cones], F32), cone_obj=np.asarray(cone_obj, np.int32))


def load(name: str) -> RawScene:
    """benchmark/scenes/<name>.json -> RawScene."""
    with open(os.path.join(SCENES, f"{name}.json")) as f:
        return parse(json.load(f))


def program_scene(raw: RawScene, device, use_bvh="auto"):
    """The port's (Scene, Camera) of `raw`, through its SceneBuilder.  A
    cone goes to its object's `push_cone(base, base_radius, apex,
    apex_radius)`; where the port has no such call, a scene with cones
    raises here and is never built without them."""
    from raytracer_tpu_torch.scene.builder import MaterialSpec, SceneBuilder, Vertex
    from raytracer_tpu_torch.scene.types import Camera

    b = SceneBuilder()
    proxies = []
    for m in raw.materials:
        spec = {k: v for k, v in m.items() if k != "texture"}
        proxies.append(b.push_object(MaterialSpec(**spec, texture=TEXTURES.index(m["texture"]))))
    if any(not hasattr(proxies[i], "push_cone") for i in set(raw.cone_obj.tolist())):
        raise NotImplementedError("the port's scene builder has no push_cone: a scene with "
                                  "cones cannot be built")
    for i in range(raw.n_tri):
        proxies[raw.tri_obj[i]].push_triangle(
            [Vertex(raw.tri_v[i, j], raw.tri_n[i, j], raw.tri_uv[i, j]) for j in range(3)])
    for i in range(raw.n_sph):
        proxies[raw.sph_obj[i]].push_sphere(raw.sph_c[i], float(raw.sph_r[i]))
    for i in range(raw.n_cone):
        proxies[raw.cone_obj[i]].push_cone(raw.cone_base[i], float(raw.cone_base_r[i]),
                                           raw.cone_apex[i], float(raw.cone_apex_r[i]))
    for l in raw.lights:
        if l["type"] == "directional":
            b.push_directional_light(l["direction"], l["color"])
        elif l["type"] == "spot":
            b.push_spot_light(l["origin"], l["direction"], float(l["angle"]),
                              float(l["softness"]), l["color"])
        else:
            b.push_point_light(l["origin"], l["color"])
    c = raw.camera
    camera = Camera.create(fovy_deg=c["fovy_deg"], center=c["center"], toward=c["toward"],
                           up=c["up"], near=float(c["near"]), device=device)
    return b.build(use_bvh=use_bvh, device=device), camera
