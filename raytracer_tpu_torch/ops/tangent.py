"""Per-hit uv tangent frame: World::get_up_right.

Counterpart of raytracer_tpu/ops/tangent.py:21-65 (src/main.rs:616-649).
For a triangle hit, (up, right) map the surface's uv axes into world space
(the inverse-uv-matrix tangent construction bump mapping would use); for a
sphere hit, a frame built from the world +y axis and the shading normal.
The reference never calls it; it is part of the API, and lies on no render
path, so it is plain tensor code.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.scene.types import Hits, Scene
from raytracer_tpu_torch.utils import vec


def get_up_right(scene: Scene, hits: Hits):
    """([N, 3] up, [N, 3] right) world-space uv tangent frame per hit.

    Triangle hits (prim < n_tri, main.rs:618-642): with edge matrix
    [a|b] = [v1-v0 | v2-v0] and uv deltas uv1 / uv2,
        up = [a|b] @ inv(U)[:, 0],   right = [a|b] @ inv(U)[:, 1],
    U = [[uv1.x, uv2.x], [uv1.y, uv2.y]], both normalised.  A degenerate
    uv mapping (det == 0), where the reference's .invert().unwrap()
    panics, gives zero vectors.

    Sphere hits (main.rs:643-647): right = normalize(y x n), up =
    normalize(n x right).  Lanes with hits.valid False hold garbage, as
    in every other Hits consumer."""
    n_tri = scene.n_tri
    prim = hits.prim.long()
    is_tri = (prim < n_tri)[:, None]
    normal = hits.normal

    if n_tri > 0:
        ti = prim.clamp(0, n_tri - 1)
        v, uv = scene.tri_v[ti], scene.tri_uv[ti]  # [N, 3, 3], [N, 3, 2]
        a, b = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        uv1, uv2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
        det = uv1[:, 0] * uv2[:, 1] - uv2[:, 0] * uv1[:, 1]
        ok = (det != 0.0)[:, None]
        inv_det = torch.where(ok[:, 0], 1.0 / torch.where(ok[:, 0], det, 1.0), 0.0)[:, None]
        up_t = (a * uv2[:, 1:2] - b * uv1[:, 1:2]) * inv_det
        right_t = (b * uv1[:, 0:1] - a * uv2[:, 0:1]) * inv_det
        unit = lambda x: x / (vec.norm(x)[:, None] + 1e-30)
        up_t = torch.where(ok, unit(up_t), 0.0)
        right_t = torch.where(ok, unit(right_t), 0.0)
    else:
        up_t = right_t = torch.zeros_like(normal)

    y = torch.zeros_like(normal)
    y[:, 1] = 1.0
    right_s = vec.normalize(torch.linalg.cross(y, normal))
    up_s = vec.normalize(torch.linalg.cross(normal, right_s))
    return torch.where(is_tri, up_t, up_s), torch.where(is_tri, right_t, right_s)
