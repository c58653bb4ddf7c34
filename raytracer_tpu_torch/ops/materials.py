"""Material evaluation of the unfused path, on [N, 3] tensors.

Counterpart of raytracer_tpu/ops/materials.py:50-119 (the reference's
Material trait, src/materials.rs): gather the per-object material table,
then apply every procedural texture's HOST form branchlessly, selecting by
texture id.  The table lookup is a row gather of the packed [O, 16] table
(ops/kernel_common.pack_materials), not the TPU's one-hot contraction.
The fused kernels' plain versions use ops/kernel_common.eval_material on
lane rows instead.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raytracer_tpu_torch.scene.types import Scene
from raytracer_tpu_torch.utils import vec

F32_EPS = vec.F32_EPS


@dataclasses.dataclass(frozen=True)
class MatSample:
    """Per-ray flattened material sample (ColorMaterial, materials.rs:20-31)."""

    diffuse: torch.Tensor  # [N, 3]
    shiness: torch.Tensor  # [N]
    specular: torch.Tensor  # [N, 3]
    smoothness: torch.Tensor  # [N]
    transparency: torch.Tensor  # [N]
    refraction: torch.Tensor  # [N]
    decay: torch.Tensor  # [N] opaque_decay
    normal: torch.Tensor  # [N, 3] tangent-space normal


def eval_material(scene: Scene, textures, obj, uv) -> MatSample:
    """Gather + texture-evaluate materials for a hit batch.  `textures` is
    the texture tuple (scene/textures.py); texture id 0 keeps the table's
    constant diffuse and normal."""
    m = scene.tables.mat[obj.long().clamp(0, scene.n_obj - 1)]  # [N, 16]
    diffuse = m[:, 0:3]
    normal = m[:, 11:14]
    tex_id = (m[:, 14] + 0.5).to(torch.int32)
    for k in range(1, len(textures)):
        sel = (tex_id == k)[:, None]
        diffuse = torch.where(sel, textures[k].diffuse(uv), diffuse)
        normal = torch.where(sel, textures[k].normal(uv), normal)
    return MatSample(
        diffuse=diffuse, shiness=m[:, 3], specular=m[:, 4:7], smoothness=m[:, 7],
        transparency=m[:, 8], refraction=m[:, 9], decay=m[:, 10], normal=normal,
    )


def adjust_normal(mat: MatSample, hit_normal):
    """Bump mapping: rotate the tangent-space material normal into the frame
    whose +z is the shading normal (materials.rs:40-44)."""
    return vec.rotate_from_z(hit_normal, mat.normal)


def get_diffuse(mat: MatSample, normal, light_dir):
    """Lambert term (materials.rs:46-53); light_dir points toward the
    light.  light_dir may carry leading dimensions ([L, N, 3])."""
    cosine = vec.dot(light_dir, normal)
    return torch.where((cosine > 0.0)[..., None], mat.diffuse * cosine[..., None], 0.0)


def get_specular(mat: MatSample, normal, light_dir, view_dir):
    """Phong lobe with exponent 1/(smoothness+eps) and (n+8)/(8pi) energy
    factor (materials.rs:55-66).  light_dir may carry leading dimensions."""
    cosine = vec.dot(light_dir, normal)
    reflected = 2.0 * cosine[..., None] * normal - light_dir
    e = 1.0 / (mat.smoothness + F32_EPS)
    energy = (e + 8.0) / (8.0 * math.pi)
    amount = torch.pow(torch.clamp_min(vec.dot(reflected, view_dir), 0.0), e) * energy
    return torch.where((cosine > 0.0)[..., None], mat.specular * amount[..., None], 0.0)
