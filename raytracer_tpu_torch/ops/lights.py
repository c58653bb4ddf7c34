"""Light evaluation of the unfused path.

Counterpart of raytracer_tpu/ops/lights.py:46-87
(ApproximateIntoDirectional, src/lights.rs:44-93): every light type
collapses to a per-shading-point directional sample {direction, color,
validity}, for all (point, light) pairs at once.  The distance attenuation
of spot and point lights is the reference's 1/d, not 1/d^2 (lights.rs:64,
76); a spot light is invalid outside its cone.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracer_tpu_torch.scene.types import LIGHT_DIRECTIONAL, LIGHT_SPOT, Scene
from raytracer_tpu_torch.utils import vec

F32_EPS = vec.F32_EPS


@dataclasses.dataclass(frozen=True)
class LightSamples:
    """Directional approximations for all (point, light) pairs."""

    valid: torch.Tensor  # [N, L] (False: spot cone cutoff, lights.rs:58-61)
    direction: torch.Tensor  # [N, L, 3] from the light toward the point
    color: torch.Tensor  # [N, L, 3] attenuated color
    has_origin: torch.Tensor  # [L] 1.0 for spot / point
    origin: torch.Tensor  # [L, 3]


def approximate_directional(scene: Scene, position) -> LightSamples:
    """position: [N, 3] -> samples for every light (lights.rs:85-93)."""
    n, L = position.shape[0], scene.n_light
    ltype = scene.light_type[None, :]  # [1, L]

    offset = position[:, None, :] - scene.light_origin[None, :, :]  # [N, L, 3]
    mag = vec.norm(offset)  # [N, L]
    mag_c = torch.clamp_min(mag, 1e-30)
    offset_dir = offset / mag_c[..., None]

    # spot: angle between the cone axis and the offset (lights.rs:54-71)
    cos_ang = torch.sum(scene.light_dir[None, :, :] * offset, dim=-1) / mag_c
    angle = torch.abs(torch.acos(torch.clamp(cos_ang, -1.0, 1.0)))
    spread = scene.light_angle[None, :]
    in_cone = angle <= spread
    ang_att = torch.pow(
        torch.clamp_min(1.0 - angle / torch.clamp_min(spread, 1e-30), 0.0),
        scene.light_softness[None, :] + F32_EPS)
    dist_att = 1.0 / (mag + F32_EPS)

    is_dir = ltype == LIGHT_DIRECTIONAL
    is_spot = ltype == LIGHT_SPOT
    att = torch.where(is_dir, 1.0, torch.where(is_spot, ang_att * dist_att, dist_att))
    direction = torch.where(is_dir[..., None],
                            scene.light_dir[None, :, :].expand(n, L, 3), offset_dir)
    return LightSamples(
        valid=torch.where(is_spot, in_cone, True),
        direction=direction,
        color=scene.light_color[None, :, :] * att[..., None],
        has_origin=scene.light_has_origin,
        origin=scene.light_origin,
    )
