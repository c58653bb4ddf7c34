"""Carry scenes and cameras across from the JAX package.

The parity tests build a scene with raytracer_tpu, pass its arrays here as
numpy, and feed the resulting torch Scene to this package, so both render
exactly the same geometry.  This module imports no jax itself.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from raytracer_tpu_torch.scene.textures import DEFAULT_TEXTURES
from raytracer_tpu_torch.scene.types import BVH_FIELDS, SCENE_FIELDS, Camera, Scene

_INT_FIELDS = ("tri_obj", "sph_obj", "mat_tex", "light_type", "bvh_node_right",
               "bvh_node_count", "bvh_prim_order", "blk_perm")


def from_jax_scene(fields: Mapping[str, np.ndarray],
                   textures=DEFAULT_TEXTURES) -> Scene:
    """Scene from a mapping of raytracer_tpu Scene field names to numpy
    arrays.  The BVH and blocked fields are carried where the mapping has
    them (with `bvh_depth`), so both packages traverse the same tables;
    other names are ignored.

    `textures`: the port's counterparts of the JAX scene's texture tuple,
    in the same order, since `mat_tex` indexes it (0 = the constant
    placeholder).  A tuple of textures with host forms only (e.g.
    textures.host_only(DEFAULT_TEXTURES), or user textures) makes a scene
    that renders through the unfused path."""
    def conv(name):
        dtype = np.int32 if name in _INT_FIELDS else np.float32
        return torch.tensor(np.asarray(fields[name], dtype=dtype))

    opt = {name: conv(name) for name in BVH_FIELDS
           if fields.get(name) is not None}
    if "bvh_depth" in fields:
        opt["bvh_depth"] = int(fields["bvh_depth"])
    textures = tuple(textures)
    top = int(np.max(fields["mat_tex"], initial=0))
    if top >= len(textures):
        raise ValueError(f"mat_tex names texture {top}, but only {len(textures)} given")
    return Scene(**{name: conv(name) for name in SCENE_FIELDS}, **opt, textures=textures)


def from_jax_camera(fovy, center, toward, up, near) -> Camera:
    """Camera from raytracer_tpu Camera fields as numpy (fovy in radians)."""
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    return Camera(fovy=f32(fovy), center=f32(center), toward=f32(toward),
                  up=f32(up), near=f32(near))
