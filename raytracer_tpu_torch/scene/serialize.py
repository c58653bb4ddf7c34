"""JSON scene format (counterpart of raytracer_tpu/scene/serialize.py).

The reference hardcodes its whole scene in main() (src/main.rs:809-1083);
this format exposes the same authoring surface as the builder DSL, one to
one, and is the JAX package's format unchanged:

{
  "camera": {"fovy_deg": 60, "center": [2,2.5,2], "toward": [-1,-1,-1],
              "up": [0,1,0], "near": -0.1},
  "objects": [
    {"material": {"diffuse_color": [1,0.8,0.6], "shiness": 0.5,
                   "smoothness": 0.01, "texture": "stripes", ...},
     "spheres": [{"center": [0,0.5,0], "radius": 0.5}],
     "triangles": [[[x,y,z],[x,y,z],[x,y,z]]],            # flat normals
     "squares":   [[[..4 corners..]]],                     # 2 tris each
     "obj": {"path": "mesh.obj", "scale": 0.333, "offset": [0.7,1,-0.5]}}
  ],
  "lights": [
    {"type": "directional", "direction": [-1,-1,0], "color": [1,0.98,0.95]},
    {"type": "spot", "origin": [0,10,0], "direction": [0,-1,0],
     "angle_deg": 60, "softness": 1, "color": [1,0.5,0.9]},
    {"type": "point", "origin": [0,0.1,0], "color": [0.8,0.8,1]}
  ],
  "bvh": "auto"
}

Triangle/square vertices may be [x,y,z] or {"p": [x,y,z], "uv": [u,v]}.
An OBJ path is relative to the file's directory.  Texture names resolve
against scene/textures.DEFAULT_TEXTURES.  "bvh" (true / false / "auto")
goes to SceneBuilder.build(use_bvh=...).  The camera's near defaults to
0.0.  The loaders build on the card unless given device="cpu".
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from raytracer_tpu_torch.scene.builder import MaterialSpec, SceneBuilder, square, triangle
from raytracer_tpu_torch.scene.textures import DEFAULT_TEXTURES
from raytracer_tpu_torch.scene.types import (
    DEFAULT_DEVICE,
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    LIGHT_SPOT,
    Camera,
    Scene,
)
from raytracer_tpu_torch.utils.obj import load_obj_triangles


def _vertex(v):
    if isinstance(v, dict):
        return (v["p"], v.get("uv", (0.0, 0.0)))
    return (v, (0.0, 0.0))


def _material(spec: dict) -> MaterialSpec:
    tex = spec.get("texture", 0)
    if isinstance(tex, str):
        names = [t.name for t in DEFAULT_TEXTURES]
        if tex not in names:
            raise ValueError(f"unknown texture {tex!r}; have {names[1:]}")
        tex = names.index(tex)
    fields = dict(spec, texture=tex)
    unknown = set(fields) - set(MaterialSpec.__dataclass_fields__)
    if unknown:
        raise ValueError(f"unknown material fields: {sorted(unknown)}")
    return MaterialSpec(**fields)


def load_scene_dict(data: dict, base_dir: str = ".",
                    device=DEFAULT_DEVICE) -> Tuple[Scene, Optional[Camera]]:
    """Build (scene, camera or None) on `device` from a parsed JSON dict."""
    b = SceneBuilder()
    for obj in data.get("objects", []):
        proxy = b.push_object(_material(obj.get("material", {})))
        for sph in obj.get("spheres", []):
            proxy.push_sphere(sph["center"], sph["radius"])
        for tri in obj.get("triangles", []):
            proxy.push_triangle(triangle([_vertex(v) for v in tri]))
        for sq in obj.get("squares", []):
            proxy.push_triangles(square([_vertex(v) for v in sq]))
        if "obj" in obj:
            spec = obj["obj"]
            scale = float(spec.get("scale", 1.0))
            offset = np.asarray(spec.get("offset", (0.0, 0.0, 0.0)), np.float32)
            path = os.path.join(base_dir, spec["path"])  # an absolute path stays
            proxy.push_triangles(
                load_obj_triangles(path, transform=lambda p: p * scale + offset))

    for light in data.get("lights", []):
        kind = light["type"]
        if kind == "directional":
            b.push_directional_light(light["direction"], light["color"])
        elif kind == "spot":
            b.push_spot_light(
                light["origin"], light["direction"],
                np.deg2rad(float(light["angle_deg"])),
                float(light.get("softness", 1.0)), light["color"],
            )
        elif kind == "point":
            b.push_point_light(light["origin"], light["color"])
        else:
            raise ValueError(f"unknown light type {kind!r}")

    camera = None
    if "camera" in data:
        c = data["camera"]
        camera = Camera.create(
            fovy_deg=float(c.get("fovy_deg", 60.0)),
            center=c["center"],
            toward=c["toward"],
            up=c.get("up", (0.0, 1.0, 0.0)),
            near=float(c.get("near", 0.0)),
            device=device,
        )
    return b.build(use_bvh=data.get("bvh", "auto"), device=device), camera


def load_scene_file(path: str, device=DEFAULT_DEVICE) -> Tuple[Scene, Optional[Camera]]:
    """Load a JSON scene file -> (scene, camera or None) on `device`."""
    with open(path) as f:
        data = json.load(f)
    return load_scene_dict(data, base_dir=os.path.dirname(os.path.abspath(path)),
                           device=device)


def _floats(x) -> list:
    return [float(v) for v in np.asarray(x).reshape(-1)]


def dump_builder(builder: SceneBuilder, camera: Optional[Camera] = None) -> dict:
    """A SceneBuilder (before build) as the JSON format.

    Triangles are written as vertex triples with uvs (flat normals are
    rebuilt on load, as the builder's `triangle` made them), so dump ->
    load -> build reproduces the same Scene arrays."""
    objects = []
    for idx, mat in enumerate(builder._materials):
        tex = mat.texture
        entry: dict = {"material": {
            "diffuse_color": _floats(mat.diffuse_color),
            "shiness": mat.shiness,
            "specular_color": _floats(mat.specular_color),
            "smoothness": mat.smoothness,
            "transparency": mat.transparency,
            "refraction_index": mat.refraction_index,
            "opaque_decay": mat.opaque_decay,
            "normal": _floats(mat.normal),
            "texture": DEFAULT_TEXTURES[tex].name if tex else 0,
        }}
        tris = [[{"p": _floats(v.position), "uv": _floats(v.uv)} for v in verts]
                for obj_idx, verts in builder._triangles if obj_idx == idx]
        if tris:
            entry["triangles"] = tris
        sphs = [{"center": _floats(c), "radius": r}
                for obj_idx, c, r in builder._spheres if obj_idx == idx]
        if sphs:
            entry["spheres"] = sphs
        objects.append(entry)

    lights = []
    for light in builder._lights:
        if light["type"] == LIGHT_DIRECTIONAL:
            lights.append({"type": "directional", "direction": _floats(light["direction"]),
                           "color": _floats(light["color"])})
        elif light["type"] == LIGHT_SPOT:
            lights.append({"type": "spot", "origin": _floats(light["origin"]),
                           "direction": _floats(light["direction"]),
                           "angle_deg": float(np.rad2deg(light["angle"])),
                           "softness": float(light["softness"]),
                           "color": _floats(light["color"])})
        elif light["type"] == LIGHT_POINT:
            lights.append({"type": "point", "origin": _floats(light["origin"]),
                           "color": _floats(light["color"])})

    out: dict = {"objects": objects, "lights": lights}
    if camera is not None:
        out["camera"] = {
            "fovy_deg": float(np.rad2deg(camera.fovy.item())),
            "center": _floats(camera.center.cpu()),
            "toward": _floats(camera.toward.cpu()),
            "up": _floats(camera.up.cpu()),
            "near": float(camera.near.item()),
        }
    return out
