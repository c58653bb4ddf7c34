"""Nearest-hit and any-hit casts of the unfused path.

Counterpart of raytracer_tpu/ops/intersect.py:151-385 (World::cast,
src/main.rs:180-326).  On a dense scene `cast` launches the nearest-hit
kernel and `cast_any_hit` the any-hit kernel (ops/intersect_kernel.py; CPU
tensors take their plain versions); a scene with a BVH traverses it for
the triangles (ops/intersect_bvh.py) and sweeps the spheres densely.  The
winner's attributes are row gathers by its index
(ops/kernel_common.hit_attributes, the block the fused kernels' plain
versions finish a hit with), not the TPU's one-hot contractions.

Semantics as the JAX module's docstring lists them: face culling,
exclusion by (primitive, face), last-wins ties with spheres after
triangles, the signed-area inside test, an interpolated normal that is not
renormalised and is negated on backface hits, non-finite t a miss.  A miss
lane holds garbage in everything but `valid`, `t` (+inf) and `prim` (-1):
every consumer masks by `valid`.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops import intersect_bvh, intersect_kernel
from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.scene.types import Hits, Rays, Scene


def _hits(scene: Scene, rays: Rays, active, t, idx, bf, attrs: str) -> Hits:
    """Hits of the winners (t: BIG or +inf on a miss; idx: -1)."""
    cols = lambda x: (x[:, 0], x[:, 1], x[:, 2])
    tb = scene.tables
    h = kc.hit_attributes(cols(rays.o), cols(rays.d), active, tb,
                          torch.clamp_max(t, kc.BIG), idx, bf, tb.tri, idx)
    valid = h["valid"]
    full = attrs == "full"
    return Hits(
        valid=valid,
        t=torch.where(valid, t, torch.inf),
        prim=torch.where(valid, idx, -1),
        obj=torch.where(valid, h["obj"], 0) if full else torch.zeros_like(idx),
        pos=torch.stack([h["px"], h["py"], h["pz"]], dim=-1),
        normal=torch.stack([h["nx"], h["ny"], h["nz"]], dim=-1),
        uv=(torch.stack([h["u"], h["v"]], dim=-1) if full
            else rays.o.new_zeros((idx.shape[0], 2))),
        backface=h["backface"],
    )


def _cast_bvh(scene: Scene, rays: Rays, active, attrs: str) -> Hits:
    """Large-scene route (intersect.py:201-266): the BVH for triangles, the
    dense sweep for spheres, which win exact ties."""
    t, idx, bf = intersect_bvh.nearest_tri(scene, rays, active)
    cols = lambda x: (x[:, 0], x[:, 1], x[:, 2])
    t, idx, bf = kc._sph_nearest(cols(rays.o), cols(rays.d), rays.face, rays.excl_prim,
                                 rays.excl_face, active, scene.tables, t, idx, bf)
    return _hits(scene, rays, active, t, idx, bf, attrs)


def cast(scene: Scene, rays: Rays, active=None, attrs: str = "full") -> Hits:
    """Nearest-hit cast of a ray batch against the whole scene.

    attrs="geom" leaves Hits.uv and Hits.obj zero, for callers that need
    geometry only (the interior march).  `active` masks out dead lanes
    (their result is valid=False)."""
    scene.require_no_cones("the unfused path's cast (ops/intersect.py)")
    n, dev = rays.o.shape[0], rays.o.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    if scene.n_prim == 0:
        z3 = rays.o.new_zeros((n, 3))
        zi = torch.zeros((n,), dtype=torch.int32, device=dev)
        return Hits(valid=torch.zeros_like(active), t=rays.o.new_full((n,), torch.inf),
                    prim=zi - 1, obj=zi, pos=z3, normal=z3, uv=rays.o.new_zeros((n, 2)),
                    backface=torch.zeros_like(active))
    if scene.bvh_node_min is not None:
        return _cast_bvh(scene, rays, active, attrs)
    t, idx, bf, _ = intersect_kernel.nearest_hit(scene, rays, active)
    return _hits(scene, rays, active, t, idx, bf, attrs)


def cast_any_hit(scene: Scene, rays: Rays, active=None, limit=None):
    """Occlusion predicate: does any valid hit exist with t < limit?

    The reference's shadow test (the nearest hit accepted iff nearer than
    the light's origin, any hit for a directional light,
    src/main.rs:435-448).  limit: [N] or None (any hit at all).  Returns
    bool [N]."""
    scene.require_no_cones("the unfused path's any-hit cast (ops/intersect.py)")
    n, dev = rays.o.shape[0], rays.o.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    if scene.bvh_node_min is not None:
        hit = _cast_bvh(scene, rays, active, attrs="geom")
        return hit.valid & (hit.t < (torch.inf if limit is None else limit))
    if scene.n_prim == 0:
        return torch.zeros_like(active)
    return intersect_kernel.any_hit(scene, rays, active, limit)
