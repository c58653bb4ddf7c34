"""Host-side scene construction -> torch Scene.

Counterpart of raytracer_tpu/scene/builder.py: the same builder chain
(push_object / push_triangles / push_sphere / push_*_light) and the same
numpy precomputation of the intersection constants, returning torch
tensors.  From BVH_MIN_TRIS triangles on (or when asked), the scene also
carries a BVH (scene/bvh.py) and the blocked layout derived from its leaf
order (scene/blocked.py), as raytracer_tpu/scene/builder.py:229-252 does.
A scene without them and of more than SPH_CHUNK spheres, or of spheres and
cones, carries the sphere chunk table (scene/blocked.py build_sph_chunks),
which the dense MC walk gates its sphere sweeps by (the walk that casts
cones gates its spheres always).

`push_cone` adds an NFF cone (E. Haines, the SPD's Neutral File Format,
record `c`): an open truncated cone from `base` (radius r0) to `apex`
(radius r1), with no end caps, a cylinder where r0 == r1.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from raytracer_tpu_torch.scene.blocked import SPH_CHUNK, build_blocked, build_sph_chunks
from raytracer_tpu_torch.scene.bvh import build_bvh
from raytracer_tpu_torch.scene.textures import DEFAULT_TEXTURES
from raytracer_tpu_torch.scene.types import (
    DEFAULT_DEVICE,
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    LIGHT_SPOT,
    Scene,
    render_device,
)

# Triangle count from which the JAX package builds a BVH / blocked layout
# (raytracer_tpu/scene/builder.py:230).
BVH_MIN_TRIS = 512


def _v3(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).reshape(3)


def _v2(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).reshape(2)


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material description (reference: src/materials.rs:20-31);
    texture > 0 selects a procedural texture (scene/textures.py)."""

    diffuse_color: Sequence[float] = (1.0, 1.0, 1.0)
    shiness: float = 0.0
    specular_color: Sequence[float] = (1.0, 1.0, 1.0)
    smoothness: float = 0.0
    transparency: float = 0.0
    refraction_index: float = 1.0
    opaque_decay: float = 0.0
    normal: Sequence[float] = (0.0, 0.0, 1.0)
    texture: int = 0


@dataclasses.dataclass
class Vertex:
    """PositionNormalUV (reference: src/geometric.rs:43-47)."""

    position: np.ndarray
    normal: np.ndarray
    uv: np.ndarray


def triangle(positions_uvs: Sequence[Tuple[Sequence[float], Sequence[float]]]):
    """Flat-normal triangle from 3 (position, uv) pairs: n = normalize(
    (v1-v0) x (v2-v1)) (reference: src/main.rs:730-739)."""
    p = [_v3(pu[0]) for pu in positions_uvs]
    uv = [_v2(pu[1]) for pu in positions_uvs]
    n = np.cross(p[1] - p[0], p[2] - p[1])
    n = n / np.linalg.norm(n)
    return [Vertex(p[i], n.copy(), uv[i]) for i in range(3)]


def square(positions_uvs: Sequence[Tuple[Sequence[float], Sequence[float]]]):
    """Two triangles (0,1,2) and (0,2,3) (reference: src/main.rs:741-746)."""
    v = list(positions_uvs)
    return [triangle([v[0], v[1], v[2]]), triangle([v[0], v[2], v[3]])]


class ObjectProxy:
    def __init__(self, builder: "SceneBuilder", object_index: int):
        self._b = builder
        self.object_index = object_index

    def push_triangle(self, vertices: Sequence[Vertex]) -> "ObjectProxy":
        assert len(vertices) == 3
        self._b._triangles.append((self.object_index, list(vertices)))
        return self

    def push_triangles(self, triangles) -> "ObjectProxy":
        for t in triangles:
            self.push_triangle(t)
        return self

    def push_sphere(self, center, radius: float) -> "ObjectProxy":
        self._b._spheres.append((self.object_index, _v3(center), float(radius)))
        return self

    def push_cone(self, base, base_radius: float, apex, apex_radius: float) -> "ObjectProxy":
        """An NFF cone, refused where it has no surface or its object asks
        what an open cone cannot give: a texture (a cone hit has no uv) or
        transparency (an open surface has no inside for the refraction
        march to cross)."""
        base, apex = _v3(base), _v3(apex)
        r0, r1 = np.float32(base_radius), np.float32(apex_radius)
        spec = (base.tolist(), float(r0), apex.tolist(), float(r1))
        if not np.linalg.norm(apex - base) > 0.0:
            raise ValueError(f"cone {spec}: its axis has no length")
        if r0 < 0.0 or r1 < 0.0 or (r0 == 0.0 and r1 == 0.0):
            raise ValueError(f"cone {spec}: a radius is negative, or both are 0")
        mat = self._b._materials[self.object_index]
        if mat.texture:
            raise ValueError(f"cone {spec}: a cone hit has no uv, so its object takes no texture")
        if mat.transparency > 0.0:
            raise ValueError(f"cone {spec}: an open cone has no inside, so its object is not "
                             "transparent")
        self._b._cones.append((self.object_index, base, float(r0), apex, float(r1)))
        return self


class SceneBuilder:
    """Accumulates objects/primitives/lights, then build() -> Scene."""

    def __init__(self):
        self._materials: List[MaterialSpec] = []
        self._triangles: List[Tuple[int, List[Vertex]]] = []
        self._spheres: List[Tuple[int, np.ndarray, float]] = []
        self._cones: List[Tuple[int, np.ndarray, float, np.ndarray, float]] = []
        self._lights: List[dict] = []

    def push_object(self, material: MaterialSpec) -> ObjectProxy:
        self._materials.append(material)
        return ObjectProxy(self, len(self._materials) - 1)

    def push_directional_light(self, direction, color):
        d = _v3(direction)
        self._lights.append(dict(
            type=LIGHT_DIRECTIONAL, origin=np.zeros(3, np.float32),
            direction=d / np.linalg.norm(d), color=_v3(color), angle=0.0,
            softness=0.0, has_origin=0.0,
        ))

    def push_spot_light(self, origin, direction, angle_rad: float,
                        softness: float, color):
        d = _v3(direction)
        self._lights.append(dict(
            type=LIGHT_SPOT, origin=_v3(origin),
            direction=d / np.linalg.norm(d), color=_v3(color),
            angle=float(angle_rad), softness=float(softness), has_origin=1.0,
        ))

    def push_point_light(self, origin, color):
        self._lights.append(dict(
            type=LIGHT_POINT, origin=_v3(origin),
            direction=np.array([0.0, -1.0, 0.0], np.float32),
            color=_v3(color), angle=0.0, softness=0.0, has_origin=1.0,
        ))

    def build(self, textures=DEFAULT_TEXTURES, use_bvh: bool | str = "auto",
              device=DEFAULT_DEVICE) -> Scene:
        """Flatten to a Scene on `device` (the tables are made on the host).

        use_bvh: True / False / "auto" (BVH and blocked layout from
        BVH_MIN_TRIS triangles on)."""
        dev = render_device(device)
        f32 = np.float32
        T = len(self._triangles)
        S = len(self._spheres)
        L = len(self._lights)

        tri_v = np.zeros((T, 3, 3), f32)
        tri_n = np.zeros((T, 3, 3), f32)
        tri_uv = np.zeros((T, 3, 2), f32)
        tri_obj = np.zeros((T,), np.int32)
        for i, (obj, verts) in enumerate(self._triangles):
            for j, v in enumerate(verts):
                tri_v[i, j] = v.position
                tri_n[i, j] = v.normal
                tri_uv[i, j] = v.uv
            tri_obj[i] = obj

        # face normal a x b with a = v1-v0, b = v2-v1 (primitives.rs:37-42)
        fn = np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 1])
        with np.errstate(invalid="ignore", divide="ignore"):
            fn = fn / np.linalg.norm(fn, axis=-1, keepdims=True)
        tri_d = np.einsum("ij,ij->i", fn, tri_v[:, 0])
        # signed-area edge tests (main.rs:218-227): area_i = g_i.p + h_i,
        # g_i = fn x e_i; edges/anchors in the reference's order
        edges = np.stack([tri_v[:, 2] - tri_v[:, 1], tri_v[:, 0] - tri_v[:, 2],
                          tri_v[:, 1] - tri_v[:, 0]], axis=1)
        anchors = np.stack([tri_v[:, 1], tri_v[:, 2], tri_v[:, 0]], axis=1)
        tri_g = np.cross(fn[:, None, :], edges)
        tri_h = -np.einsum("tij,tij->ti", tri_g, anchors)
        tri_area2 = np.einsum(
            "ij,ij->i",
            np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0]), fn,
        )

        sph_c = np.zeros((S, 3), f32)
        sph_r = np.zeros((S,), f32)
        sph_obj = np.zeros((S,), np.int32)
        for i, (obj, c, r) in enumerate(self._spheres):
            sph_c[i], sph_r[i], sph_obj[i] = c, r, obj

        mats = self._materials or [MaterialSpec()]
        mat = lambda get: np.asarray([get(m) for m in mats], f32)
        lights = self._lights
        lf = lambda key, w: np.asarray([l[key] for l in lights], f32).reshape(L, *w)

        t = torch.as_tensor
        opt: dict = {}
        if (use_bvh is True or (use_bvh == "auto" and T >= BVH_MIN_TRIS)) and T > 0:
            bvh = build_bvh(tri_v)
            perm, boxes = build_blocked(tri_v, bvh.prim_order)
            opt = dict(
                bvh_node_min=t(bvh.node_min), bvh_node_max=t(bvh.node_max),
                bvh_node_right=t(bvh.node_right), bvh_node_count=t(bvh.node_count),
                bvh_prim_order=t(bvh.prim_order), bvh_depth=bvh.depth,
                blk_perm=t(perm), blk_box=t(boxes),
            )
        C = len(self._cones)
        if (S > SPH_CHUNK or (C and S)) and not opt:  # the blocked walks sweep spheres linearly
            sph_perm, sph_box = build_sph_chunks(sph_c, sph_r)
            opt.update(sph_perm=t(sph_perm), sph_box=t(sph_box))
        if C:
            col = lambda k, dt=f32: np.asarray([c[k] for c in self._cones], dt)
            opt.update(cone_base=t(col(1)), cone_base_r=t(col(2)), cone_apex=t(col(3)),
                       cone_apex_r=t(col(4)), cone_obj=t(col(0, np.int32)))
        return Scene(
            **opt,
            tri_v=t(tri_v), tri_n=t(tri_n), tri_uv=t(tri_uv), tri_obj=t(tri_obj),
            tri_fn=t(fn.astype(f32)), tri_d=t(tri_d.astype(f32)),
            tri_g=t(tri_g.astype(f32)), tri_h=t(tri_h.astype(f32)),
            tri_area2=t(tri_area2.astype(f32)),
            sph_c=t(sph_c), sph_r=t(sph_r), sph_obj=t(sph_obj),
            mat_diffuse=t(np.stack([_v3(m.diffuse_color) for m in mats])),
            mat_shiness=t(mat(lambda m: m.shiness)),
            mat_specular=t(np.stack([_v3(m.specular_color) for m in mats])),
            mat_smoothness=t(mat(lambda m: m.smoothness)),
            mat_transparency=t(mat(lambda m: m.transparency)),
            mat_refraction=t(mat(lambda m: m.refraction_index)),
            mat_decay=t(mat(lambda m: m.opaque_decay)),
            mat_normal=t(np.stack([_v3(m.normal) for m in mats])),
            mat_tex=t(np.asarray([m.texture for m in mats], np.int32)),
            light_type=t(np.asarray([l["type"] for l in lights], np.int32)),
            light_origin=t(lf("origin", (3,))),
            light_dir=t(lf("direction", (3,))),
            light_color=t(lf("color", (3,))),
            light_angle=t(lf("angle", ())),
            light_softness=t(lf("softness", ())),
            light_has_origin=t(lf("has_origin", ())),
            textures=tuple(textures),
        ).to(dev)
