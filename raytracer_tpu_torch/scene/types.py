"""SoA scene representation: dataclasses of torch tensors.

Counterpart of raytracer_tpu/scene/types.py: triangles, spheres, a material
table indexed by object id and a light table, with the intersection
constants (face normals, plane offsets, edge-test vectors) precomputed on
the host by scene/builder.py.  Primitive ids form one index space: triangle
i has id i, sphere j has id n_tri + j.

Scenes with many triangles also carry the BVH (scene/bvh.py) and the
blocked layout derived from it (scene/blocked.py); the kernels take the
blocked branch when `Scene.blocked` holds.  Other scenes with more spheres
than one chunk holds, or with spheres and cones, carry the sphere chunk
table (scene/blocked.py build_sph_chunks), which the MC walk's dense routes
gate their sphere sweeps by.

A scene may also hold NFF cones (the SPD's `c` record): open truncated
cones with no caps, a cylinder where both radii are equal.  Cone j has id
n_tri + n_sph + j, after the spheres.  Only the dense fused kernels (the
staged MC walk with its gated spheres, and the dense level kernel) and
their plain versions cast them; every other route refuses a scene with
cones (`require_no_cones`).

Scenes and cameras are made on the card unless the caller asks for the CPU
(`device="cpu"`, the plain PyTorch path): see `render_device`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def render_device(device=DEFAULT_DEVICE) -> torch.device:
    """`device` as a torch.device; a CUDA device where CUDA is absent
    raises rather than render on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' for the "
                           "plain PyTorch path")
    return dev


# FaceDirection encoding (reference: src/main.rs:52-67).
FACE_FRONT = 0
FACE_BACK = 1
FACE_BOTH = 2  # neither face culled

# Light type encoding (reference: src/lights.rs:26-30).
LIGHT_DIRECTIONAL = 0
LIGHT_SPOT = 1
LIGHT_POINT = 2

# "No exclusion" sentinel for a ray's excluded primitive.
NO_EXCLUDE = -1

# Tensor fields of Scene, in declaration order.
SCENE_FIELDS = (
    "tri_v", "tri_n", "tri_uv", "tri_obj", "tri_fn", "tri_d", "tri_g",
    "tri_h", "tri_area2", "sph_c", "sph_r", "sph_obj", "mat_diffuse",
    "mat_shiness", "mat_specular", "mat_smoothness", "mat_transparency",
    "mat_refraction", "mat_decay", "mat_normal", "mat_tex", "light_type",
    "light_origin", "light_dir", "light_color", "light_angle",
    "light_softness", "light_has_origin",
)

# Optional tensor fields of Scene: the BVH and the blocked layout
# (raytracer_tpu/scene/types.py:94-104); None on dense scenes.
BVH_FIELDS = (
    "bvh_node_min", "bvh_node_max", "bvh_node_right", "bvh_node_count",
    "bvh_prim_order", "blk_perm", "blk_box",
)

# Optional tensor fields of Scene: the sphere chunk table; None on blocked
# scenes and on scenes of at most SPH_CHUNK spheres and no cones.
SPH_CHUNK_FIELDS = ("sph_perm", "sph_box")

# Optional tensor fields of Scene: the cones; None on a scene without one.
CONE_FIELDS = ("cone_base", "cone_base_r", "cone_apex", "cone_apex_r", "cone_obj")


@dataclasses.dataclass(frozen=True)
class Scene:
    """Scene tensors (shapes as in raytracer_tpu/scene/types.py) plus the
    texture set the material table's tex ids index into."""

    tri_v: torch.Tensor  # [T, 3, 3] vertex positions
    tri_n: torch.Tensor  # [T, 3, 3] vertex normals
    tri_uv: torch.Tensor  # [T, 3, 2] vertex uvs
    tri_obj: torch.Tensor  # [T] int32 object id
    tri_fn: torch.Tensor  # [T, 3] unit face normal
    tri_d: torch.Tensor  # [T] plane offset fn.v0
    tri_g: torch.Tensor  # [T, 3, 3] edge-test vectors
    tri_h: torch.Tensor  # [T, 3] edge-test offsets
    tri_area2: torch.Tensor  # [T]
    sph_c: torch.Tensor  # [S, 3]
    sph_r: torch.Tensor  # [S]
    sph_obj: torch.Tensor  # [S] int32
    mat_diffuse: torch.Tensor  # [O, 3]
    mat_shiness: torch.Tensor  # [O]
    mat_specular: torch.Tensor  # [O, 3]
    mat_smoothness: torch.Tensor  # [O]
    mat_transparency: torch.Tensor  # [O]
    mat_refraction: torch.Tensor  # [O]
    mat_decay: torch.Tensor  # [O]
    mat_normal: torch.Tensor  # [O, 3] tangent-space normal
    mat_tex: torch.Tensor  # [O] int32 texture id (0 = constant)
    light_type: torch.Tensor  # [L] int32
    light_origin: torch.Tensor  # [L, 3]
    light_dir: torch.Tensor  # [L, 3]
    light_color: torch.Tensor  # [L, 3]
    light_angle: torch.Tensor  # [L]
    light_softness: torch.Tensor  # [L]
    light_has_origin: torch.Tensor  # [L] 1.0 for spot/point
    textures: tuple = ()
    # BVH (scene/bvh.py) and blocked layout (scene/blocked.py)
    bvh_node_min: torch.Tensor | None = None  # [M, 3]
    bvh_node_max: torch.Tensor | None = None  # [M, 3]
    bvh_node_right: torch.Tensor | None = None  # [M] int32
    bvh_node_count: torch.Tensor | None = None  # [M] int32
    bvh_prim_order: torch.Tensor | None = None  # [T] int32
    bvh_depth: int = 0
    blk_perm: torch.Tensor | None = None  # [T_pad] int32 (-1 = pad row)
    blk_box: torch.Tensor | None = None  # [NCH, 8] chunk AABB min/max
    # sphere chunk table (scene/blocked.py build_sph_chunks)
    sph_perm: torch.Tensor | None = None  # [S_pad] int32 (-1 = pad row)
    sph_box: torch.Tensor | None = None  # [NCH, 8] chunk AABB min/max
    # NFF cones: base (radius r0) to apex (radius r1), open, no caps
    cone_base: torch.Tensor | None = None  # [C, 3]
    cone_base_r: torch.Tensor | None = None  # [C]
    cone_apex: torch.Tensor | None = None  # [C, 3]
    cone_apex_r: torch.Tensor | None = None  # [C]
    cone_obj: torch.Tensor | None = None  # [C] int32

    @property
    def device(self) -> torch.device:
        return self.tri_v.device

    @property
    def n_tri(self) -> int:
        return self.tri_v.shape[0]

    @property
    def n_sph(self) -> int:
        return self.sph_c.shape[0]

    @property
    def n_cone(self) -> int:
        return 0 if self.cone_base is None else self.cone_base.shape[0]

    @property
    def n_prim(self) -> int:
        return self.n_tri + self.n_sph + self.n_cone

    @property
    def n_obj(self) -> int:
        return self.mat_shiness.shape[0]

    @property
    def n_light(self) -> int:
        return self.light_type.shape[0]

    @property
    def blocked(self) -> bool:
        """Does the scene take the kernels' blocked branch?"""
        return self.blk_perm is not None and self.n_tri > 0

    def require_no_cones(self, route: str) -> None:
        """Raise NotImplementedError if this scene has cones: `route` (a
        kernel or walk that casts no cone) would render it without them."""
        if self.n_cone:
            raise NotImplementedError(
                f"{route} casts no cones, and this scene has {self.n_cone}: only the dense "
                "fused kernels (the staged MC walk, the level kernel) and their plain "
                "versions render NFF cones")

    def to(self, device) -> "Scene":
        fields = SCENE_FIELDS + tuple(f for f in BVH_FIELDS + SPH_CHUNK_FIELDS + CONE_FIELDS
                                      if getattr(self, f) is not None)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in fields}
        )

    @functools.cached_property
    def tables(self):
        """The packed tables the sweeps read (ops/kernel_common.Tables),
        built once per scene and device."""
        from raytracer_tpu_torch.ops.kernel_common import pack_tables

        return pack_tables(self)

    @functools.cached_property
    def blk_tables(self):
        """The blocked tables (ops/kernel_common.BlkTables) of a blocked
        scene, built once per scene and device."""
        from raytracer_tpu_torch.ops.kernel_common import pack_blocked

        return pack_blocked(self)

    @functools.cached_property
    def geom(self):
        """The geometry the sweeps run on (ops/kernel_common.DenseGeom or
        BlockedGeom)."""
        from raytracer_tpu_torch.ops.kernel_common import BlockedGeom, DenseGeom

        if self.blocked:
            return BlockedGeom(self.tables, self.blk_tables)
        return DenseGeom(self.tables)


@dataclasses.dataclass(frozen=True)
class Rays:
    """SoA ray batch (reference Ray struct: src/main.rs:69-81)."""

    o: torch.Tensor  # [N, 3] origin
    d: torch.Tensor  # [N, 3] direction (unit)
    face: torch.Tensor  # [N] int32 FaceDirection
    excl_prim: torch.Tensor  # [N] int32 global primitive id or NO_EXCLUDE
    excl_face: torch.Tensor  # [N] int32 FaceDirection of the exclusion

    @staticmethod
    def primary(o, d) -> "Rays":
        full = lambda v: torch.full((o.shape[0],), v, dtype=torch.int32, device=o.device)
        return Rays(o=o, d=d, face=full(FACE_FRONT), excl_prim=full(NO_EXCLUDE),
                    excl_face=full(FACE_FRONT))


@dataclasses.dataclass(frozen=True)
class Hits:
    """SoA hit records (reference Hit struct: src/main.rs:139-147).  `valid`
    is False for misses; all other fields of such a lane are garbage and
    must stay masked downstream."""

    valid: torch.Tensor  # [N] bool
    t: torch.Tensor  # [N] travel distance (+inf on a miss)
    prim: torch.Tensor  # [N] int32 global primitive id (-1 on a miss)
    obj: torch.Tensor  # [N] int32 object id
    pos: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3] interpolated shading normal, backface-
    # flipped and NOT renormalized (src/main.rs:248-251)
    uv: torch.Tensor  # [N, 2]
    backface: torch.Tensor  # [N] bool (hit.face_direction == Back)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole / thin-lens camera (reference: src/main.rs:43-127)."""

    fovy: torch.Tensor  # scalar, radians
    center: torch.Tensor  # [3]
    toward: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    near: torch.Tensor  # scalar (the demo's -0.1 puts the origin behind center)
    # tan(fovy / 2), the scale of the image plane's axes (main.rs:85-90),
    # derived from fovy: a host constant evaluated as the reference does
    # (utils/vec.tanf), so no device's tan decides the primary rays
    scale: torch.Tensor = dataclasses.field(init=False, repr=False)  # scalar

    def __post_init__(self):
        from raytracer_tpu_torch.utils.vec import tanf

        half = float(self.fovy) / 2.0  # exact: halving an f32
        object.__setattr__(self, "scale", torch.tensor(
            tanf(half), dtype=torch.float32, device=self.fovy.device))

    @staticmethod
    def create(fovy_deg, center, toward, up, near, device=DEFAULT_DEVICE) -> "Camera":
        dev = render_device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return Camera(
            fovy=f32(np.deg2rad(fovy_deg)),
            center=f32(center),
            toward=f32(toward),
            up=f32(up),
            near=f32(near),
        )

    def to(self, device) -> "Camera":
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self) if f.init})
