"""Distributed (Monte-Carlo) tracer: one stochastic sample per primary ray.

Counterpart of raytracer_tpu/ops/distributed.py:77-286
(World::distributed_ray_trace, src/main.rs:521-614).  The reference
recursion picks ONE branch per bounce by Russian roulette and combines
results as ret = A + B * ret_child with per-branch (A, B):

  diffuse/reflect hit   : A = 0.5*shade(next),        B = 0.5*brdf
  diffuse/reflect miss  : A = shade(scattered self),  B = 0
  refract escape + hit  : A = decay^t * shade(next),  B = decay^t
  cosine<=0 / trapped / escape-miss / refract-escape-miss: A = B = 0
  depth exhausted       : A = shade(self),            B = 0

which unrolls forward: per bounce accum += scale*A and scale *= B.

Routing (`trace.fused_ok`, distributed.py:112-123): a scene the fused
kernels take walks whole in ops/mc_kernel.trace (the mega-kernel) or, for
blocked scenes of at least mc_binned.BINNED_MIN_TRIS triangles, in
ops/mc_binned.trace (per-bounce kernels with a sort between bounces).
Every other scene takes the unfused walk below (distributed.py:133-286):
all three branches evaluated masked over the batch, the refract lanes
through the shared interior march (trace.refract_march), then ONE advance
cast and ONE merged shade serve every branch.  Either way the
f32::is_normal photon filter (main.rs:1157-1160) then zeroes every photon
with a zero, subnormal or non-finite channel — including all-black misses.

The draws are an operand: unifs [depth, 3, N] holds (roulette u, lobe
u_phi, lobe theta in [-pi, pi)) per bounce.  render.py makes them with a
torch.Generator; the tests hand in the JAX package's own draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import materials as mat_ops
from raytracer_tpu_torch.ops import mc_binned, mc_kernel
from raytracer_tpu_torch.ops.intersect import cast
from raytracer_tpu_torch.ops.shade import get_shade
from raytracer_tpu_torch.ops.trace import _unit_reflect, fused_ok, refract_march
from raytracer_tpu_torch.scene.types import FACE_BACK, FACE_FRONT, Rays, Scene
from raytracer_tpu_torch.utils import vec
from raytracer_tpu_torch.utils.vec import is_normal_f32

SEL_DIFFUSE = 0
SEL_REFLECT = 1
SEL_REFRACT = 2


class MCResult(NamedTuple):
    photon: torch.Tensor  # [N, 3] (non-is_normal photons zeroed)
    casts: torch.Tensor  # 0-d: rays cast, incl. shadow rays and marches
    filtered: torch.Tensor  # 0-d: photons dropped by the is_normal filter


def roulette(u, w0, w1, w2):
    """weighted_select over 3 weights (src/main.rs:652-666): r ~ U(0, sum),
    the first cumulative bucket wins."""
    r = u * (w0 + w1 + w2)
    return torch.where(r < w0, SEL_DIFFUSE, torch.where(r < w0 + w1, SEL_REFLECT,
                                                        SEL_REFRACT))


def scatter_direction(u_phi, u_theta, axis, exponent):
    """Lobe sample around `axis` (src/main.rs:539-554): phi =
    acos((1-u)^exponent), theta ~ U(-pi, pi), rotated from +z onto axis."""
    phi = torch.acos(torch.pow(1.0 - u_phi, exponent))
    sp = torch.sin(phi)
    lobe = torch.stack([sp * torch.cos(u_theta), sp * torch.sin(u_theta), torch.cos(phi)],
                       dim=-1)
    axis_n = axis / torch.clamp_min(vec.norm(axis), 1e-30)[:, None]
    return vec.rotate_from_z(axis_n, lobe)


def _walk_unfused(scene: Scene, ray_o, ray_d, unifs, cfg: RenderConfig):
    """The unfused roulette walk -> (photon [N, 3] unfiltered, casts 0-d)."""
    n, dev = ray_o.shape[0], ray_o.device
    textures = scene.textures
    md, mr = cfg.max_refract_distance, cfg.max_tir_retries
    full = lambda v: torch.full((n,), v, dtype=torch.int32, device=dev)

    h = cast(scene, Rays.primary(ray_o, ray_d))
    casts = torch.tensor(n, device=dev)
    alive = h.valid
    accum = torch.zeros_like(ray_o)
    scale = torch.ones_like(ray_o)
    cur, cur_ray_d, cur_ray_face = h, ray_d, full(FACE_FRONT)

    for step in range(cfg.depth):
        mat = mat_ops.eval_material(scene, textures, cur.obj, cur.uv)
        w0 = (1.0 - mat.shiness) * (1.0 - mat.transparency)
        w1 = mat.shiness * (1.0 - mat.transparency)
        sel = roulette(unifs[step, 0], w0, w1, mat.transparency)
        is_diffuse, is_refract = sel == SEL_DIFFUSE, sel == SEL_REFRACT

        # scatter lobe: diffuse around -normal with exponent 1, glossy
        # around the incoming direction with exponent smoothness (558, 577,
        # 596)
        exponent = torch.where(is_diffuse, 1.0, mat.smoothness)
        axis = torch.where(is_diffuse[:, None], -cur.normal, cur_ray_d)
        sdir = scatter_direction(unifs[step, 1], unifs[step, 2], axis, exponent)
        cosine = -vec.dot(cur.normal, sdir)
        live = alive & (cosine > 0.0)  # cosine<=0 kills the path (560, 579, 598)

        # the advance ray per branch: diffuse/reflect mirror the scattered
        # direction about the normal (get_reflect, 563/582); refract lanes
        # march through the interior from the scattered hit (601)
        refl = _unit_reflect(sdir, cur.normal)
        excl_face_r = torch.where(cur.backface, FACE_FRONT, FACE_BACK).to(torch.int32)
        march = refract_march(scene, cur.pos, cur.normal, sdir, cur.prim, mat.refraction,
                              live & is_refract, md, mr)
        casts = casts + march.casts
        adv_d = torch.where(is_refract[:, None], march.esc_d, refl)
        adv_face = torch.where(is_refract, FACE_FRONT, cur_ray_face).to(torch.int32)
        adv_active = live & (~is_refract | march.escaped)
        nxt = cast(scene, Rays(
            o=torch.where(is_refract[:, None], march.esc_o, cur.pos), d=adv_d,
            face=adv_face, excl_prim=torch.where(is_refract, march.esc_prim, cur.prim),
            excl_face=torch.where(is_refract, FACE_BACK, excl_face_r).to(torch.int32)),
            active=adv_active)
        casts = casts + adv_active.sum()

        # merged shade: the next hit's where the advance cast hit, else the
        # scattered self-shade (the miss terminal of 571-573/590-592, whose
        # specular takes the scattered direction as the view ray); refract
        # lanes whose escape cast missed contribute black (607)
        use_next = nxt.valid
        pick = lambda a, b: torch.where(use_next, a, b)
        pick_v = lambda a, b: torch.where(use_next[:, None], a, b)
        need_shade = adv_active & (use_next | ~is_refract)
        counters: list = []
        shade = get_shade(scene, textures, pick_v(nxt.pos, cur.pos),
                          pick_v(nxt.normal, cur.normal), pick_v(nxt.uv, cur.uv),
                          pick(nxt.prim, cur.prim), pick(nxt.obj, cur.obj),
                          pick_v(adv_d, sdir), need_shade, counters)
        for c in counters:
            casts = casts + c

        # BRDF against the UNadjusted hit normal (probe.at is the scattered
        # hit, 566-570/585-589), view = the original incoming ray
        brdf = torch.where(is_diffuse[:, None],
                           mat_ops.get_diffuse(mat, cur.normal, refl),
                           mat_ops.get_specular(mat, cur.normal, refl, -cur_ray_d))
        decay = torch.pow(mat.decay, march.travel)[:, None]
        hit = use_next[:, None]
        refl_branch = ~is_refract[:, None]
        A = torch.where(refl_branch, torch.where(hit, 0.5 * shade, shade), decay * shade)
        B = torch.where(refl_branch, torch.where(hit, 0.5 * brdf, 0.0), decay)
        accum = accum + torch.where(need_shade[:, None], scale * A, 0.0)
        scale = scale * torch.where(adv_active[:, None], B, 0.0)

        alive = adv_active & use_next
        cur, cur_ray_d, cur_ray_face = nxt, adv_d, adv_face

    # depth exhausted: surviving paths end with shade(self) (main.rs:524-527)
    counters = []
    shade = get_shade(scene, textures, cur.pos, cur.normal, cur.uv, cur.prim, cur.obj,
                      cur_ray_d, alive, counters)
    for c in counters:
        casts = casts + c
    return accum + torch.where(alive[:, None], scale * shade, 0.0), casts


def trace_distributed(scene: Scene, ray_o, ray_d, unifs,
                      cfg: RenderConfig) -> MCResult:
    """One MC sample per primary ray (main.rs:1150-1160)."""
    if fused_ok(scene):
        use_binned = scene.blocked and scene.n_tri >= mc_binned.BINNED_MIN_TRIS
        tracer = mc_binned.trace if use_binned else mc_kernel.trace
        photon_raw, casts = tracer(
            scene, ray_o, ray_d, unifs, cfg.depth, cfg.max_refract_distance,
            cfg.max_tir_retries,
        )
    else:
        photon_raw, casts = _walk_unfused(scene, ray_o, ray_d, unifs, cfg)
    ok = torch.all(is_normal_f32(photon_raw), dim=-1)
    photon = torch.where(ok[:, None], photon_raw, 0.0)
    return MCResult(photon=photon, casts=casts, filtered=torch.sum(~ok))
