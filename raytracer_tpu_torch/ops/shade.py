"""Direct lighting of the unfused path, with batched shadow rays.

Counterpart of raytracer_tpu/ops/shade.py:26-107 (World::get_shade,
src/main.rs:407-464): bump-map the normal, approximate each light to a
directional sample, test occlusion (the reference's nearest-hit-versus-
light-origin check is an any-hit predicate bounded by the light's
distance, src/main.rs:435-448), then Lambert + Phong blended by shiness
(450-462).

On a dense scene all lights' shadow tests run in ONE launch of the shadow
kernel (ops/intersect_kernel.shadow_any_hit: shadow rays share their
origin); a scene with a BVH takes the per-light cast_any_hit loop.  The
lights are a leading tensor dimension here ([L, N, ...]) where the JAX
module loops over them; per (light, lane) the arithmetic is the same.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops import intersect_kernel
from raytracer_tpu_torch.ops import materials as mat_ops
from raytracer_tpu_torch.ops.intersect import cast_any_hit
from raytracer_tpu_torch.ops.lights import approximate_directional
from raytracer_tpu_torch.scene.types import FACE_BACK, Hits, Rays, Scene
from raytracer_tpu_torch.utils import vec


def shadow_rays(scene: Scene, pos, n_adj, active):
    """Per-light shadow-ray parameters of a hit batch (the reference's
    loop body, src/main.rs:413-448) -> (LightSamples, to_light [L, N, 3]
    unit directions toward each light, considers [L, N] bool: the lanes
    that cast a shadow ray to that light, limits [L, N]: the light's
    distance, inf for a directional light)."""
    lights = approximate_directional(scene, pos)
    to_light = -lights.direction.permute(1, 0, 2)
    cosine = vec.dot(to_light, n_adj)
    considers = active & lights.valid.t() & (cosine > 0.0)
    light_dist = vec.distance(pos[None, :, :], lights.origin[:, None, :])
    limits = torch.where(lights.has_origin[:, None] > 0.5, light_dist, torch.inf)
    return lights, to_light, considers, limits


def get_shade(scene: Scene, textures, pos, normal, uv, prim, obj, ray_d, active,
              counters=None):
    """Direct radiance at a hit batch -> [N, 3].

    pos / normal / uv / prim / obj describe the hits; ray_d is the incoming
    ray direction (for the view vector).  Lanes with active=False return 0.
    `counters`: an optional list that gets one 0-d tensor per light, the
    shadow rays cast to it."""
    n, L = pos.shape[0], scene.n_light
    if L == 0:
        return torch.zeros_like(pos)
    mat = mat_ops.eval_material(scene, textures, obj, uv)
    n_adj = mat_ops.adjust_normal(mat, normal)
    lights, to_light, considers, limits = shadow_rays(scene, pos, n_adj, active)

    if scene.bvh_node_min is None and scene.n_prim > 0:
        blocked = intersect_kernel.shadow_any_hit(scene, pos, to_light, prim, limits,
                                                  considers)
    else:
        back = torch.full((n,), FACE_BACK, dtype=torch.int32, device=pos.device)
        blocked = torch.stack([
            cast_any_hit(scene, Rays(o=pos, d=to_light[li], face=back, excl_prim=prim,
                                     excl_face=back),
                         active=considers[li], limit=limits[li])
            for li in range(L)])
    if counters is not None:
        counters.extend(considers.sum(dim=1).unbind())

    lit = considers & ~blocked
    lcol = lights.color.permute(1, 0, 2)
    diffuse = mat_ops.get_diffuse(mat, n_adj, to_light) * lcol
    specular = mat_ops.get_specular(mat, n_adj, to_light, -ray_d) * lcol
    contrib = (diffuse * (1.0 - mat.shiness)[:, None]
               + specular * mat.shiness[:, None])
    return torch.where(lit[..., None], contrib, 0.0).sum(dim=0)


def get_shade_hits(scene, textures, hits: Hits, ray_d, active, counters=None):
    return get_shade(scene, textures, hits.pos, hits.normal, hits.uv, hits.prim,
                     hits.obj, ray_d, active, counters)
