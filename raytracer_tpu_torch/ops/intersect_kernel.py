"""The standalone sweep kernels of the unfused path, and their plain versions.

Counterpart of raytracer_tpu/ops/intersect_pallas.py: `nearest_hit` (:269,
kernel `_kernel` :172), `any_hit` (:302, `_any_kernel` :212) and
`shadow_any_hit` (:438, `_shadow_kernel` :335), with the same arguments and
return conventions.  The CUDA kernels are csrc/intersect_kernels.cu
(`rt_nearest_hit`, `rt_any_hit`, `rt_shadow_any_hit`); they take dense
scenes only, as the TPU kernels do (a BVH scene goes through
ops/intersect_bvh.py).  Each wrapper runs its plain version on CPU tensors
and launches its kernel on CUDA tensors, or raises: there is no fallback.

Conventions (intersect_pallas.py:294-298, :309-312): a miss is t = +inf,
idx = -1, backface False, valid False; `limit` None means "any hit at
all", and limits are clipped to the 3e38 sentinel.

The shadow sweep's triangle limit in the scaled parameter is derived, not
assumed: for a position light the factored algebra aims at the light's
origin along the unnormalised L - p, so a real-unit limit `lim` becomes
lim / |L - p| (exactly 1 when the caller's limit is the light's distance,
which is all ops/shade.get_shade passes; the TPU wrapper hard-codes 1.0,
intersect_pallas.py:471).  A directional light keeps the real limit.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.scene.types import Rays, Scene
from raytracer_tpu_torch.utils import kernels

COUNTS_NEAREST = kernels.LaunchCounts()
COUNTS_ANY = kernels.LaunchCounts()
COUNTS_SHADOW = kernels.LaunchCounts()


def _rows(x):
    """[N, 3] -> its three [N] columns."""
    return x[:, 0], x[:, 1], x[:, 2]


def _active(active, n, dev):
    return torch.ones((n,), dtype=torch.bool, device=dev) if active is None else active


def nearest_hit_plain(tb: kc.Tables, rays: Rays, active):
    """Nearest t, primitive and backface per ray over the dense tables ->
    (t [N] +inf on a miss, idx [N] int32 -1, backface [N] bool, valid [N])."""
    t, idx, bf = kc.nearest_sweep(_rows(rays.o), _rows(rays.d), rays.face,
                                  rays.excl_prim, rays.excl_face, active, tb)
    valid = active & (t < kc.BIG)
    return torch.where(valid, t, torch.inf), idx, bf, valid


def any_hit_plain(tb: kc.Tables, rays: Rays, active, limit):
    """Occlusion: any valid candidate with t < limit ([N], <= 3e38)."""
    args = (_rows(rays.o), _rows(rays.d), rays.face, rays.excl_prim, rays.excl_face,
            active, tb)
    blocked = torch.zeros_like(active)
    if tb.n_tri > 0:
        blocked = blocked | (kc.tri_candidates(*args)[0] < limit).any(dim=0)
    if tb.n_sph > 0:
        blocked = blocked | (kc.sph_candidates(*args)[0] < limit).any(dim=0)
    return blocked


def shadow_any_hit_plain(tb: kc.Tables, pos, dirs, excl_prim, limits, actives):
    """Shadow any-hit for every light from one origin per lane -> blocked
    [L, N] bool; arguments as `shadow_any_hit`."""
    px, py, pz = _rows(pos)
    sweep = kc._ShadowSweep(px, py, pz, excl_prim, tb)
    out = []
    for li in range(dirs.shape[0]):
        L = tb.lights[li]
        is_dir = L[0] == 0.0
        lim = torch.clamp_max(limits[li], kc.BIG)
        offx, offy, offz = px - L[1], py - L[2], pz - L[3]
        mag = torch.sqrt(offx * offx + offy * offy + offz * offz)
        out.append(sweep.blocked(dict(
            s=torch.where(is_dir, 0.0, 1.0),
            tx=torch.where(is_dir, -L[4], L[1]),
            ty=torch.where(is_dir, -L[5], L[2]),
            tz=torch.where(is_dir, -L[6], L[3]),
            tlim=torch.where(is_dir, lim, lim / mag),
            ndx=dirs[li, :, 0], ndy=dirs[li, :, 1], ndz=dirs[li, :, 2],
            slim=lim, act=actives[li])))
    return torch.stack(out) if out else actives.clone()


def _dense_tables(scene: Scene, dev, name: str) -> kc.Tables:
    if dev.type != "cuda":
        raise ValueError(f"intersect_kernel.{name}: unsupported device {dev}")
    if scene.bvh_node_min is not None:
        raise ValueError(f"intersect_kernel.{name} takes dense scenes only")
    kc.check_tables(scene.tables, dev)
    return scene.tables


def _ray_args(rays: Rays, active, n, dev):
    """The six ray arguments of rt_nearest_hit / rt_any_hit, checked."""
    o, d = rays.o.contiguous(), rays.d.contiguous()
    kernels.check("rays.o", o, torch.float32, (n, 3), dev)
    kernels.check("rays.d", d, torch.float32, (n, 3), dev)
    ints = [x.contiguous() for x in (rays.face, rays.excl_prim, rays.excl_face)]
    for name, x in zip(("face", "excl_prim", "excl_face"), ints):
        kernels.check(f"rays.{name}", x, torch.int32, (n,), dev)
    active = active.contiguous()
    kernels.check("active", active, torch.bool, (n,), dev)
    return (o, d, *ints, active)


def nearest_hit(scene: Scene, rays: Rays, active=None, work=None):
    """Winner sweep of a dense scene -> (t [N], idx [N] int32, backface [N]
    bool, valid [N] bool); t is +inf and idx -1 on a miss.  `work` (all
    three wrappers): an optional int32 [len(kernels.WORK_ROWS), N] tensor
    that the kernel's counting instantiation fills with each lane's tests
    by kind."""
    n, dev = rays.o.shape[0], rays.o.device
    active = _active(active, n, dev)
    if dev.type == "cpu":
        COUNTS_NEAREST.plain += 1
        return nearest_hit_plain(scene.tables, rays, active)
    tb = _dense_tables(scene, dev, "nearest_hit")
    args = _ray_args(rays, active, n, dev)
    kernels.check_work(work, n, dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    bf = torch.empty((n,), dtype=torch.bool, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        kernels.launch("rt_nearest_hit", *args, tb.tri, tb.n_tri, tb.sph, tb.n_sph,
                       t, idx, bf, valid, work, n)
        COUNTS_NEAREST.launches += 1
    return t, idx, bf, valid


def any_hit(scene: Scene, rays: Rays, active=None, limit=None, work=None):
    """Occlusion sweep of a dense scene: any valid candidate with
    t < limit.  limit: [N] or None (any hit at all).  Returns bool [N]."""
    n, dev = rays.o.shape[0], rays.o.device
    active = _active(active, n, dev)
    if limit is None:
        limit = torch.full((n,), kc.BIG, dtype=torch.float32, device=dev)
    else:
        limit = torch.clamp_max(limit, kc.BIG)
    if dev.type == "cpu":
        COUNTS_ANY.plain += 1
        return any_hit_plain(scene.tables, rays, active, limit)
    tb = _dense_tables(scene, dev, "any_hit")
    args = _ray_args(rays, active, n, dev)
    limit = limit.contiguous()
    kernels.check("limit", limit, torch.float32, (n,), dev)
    kernels.check_work(work, n, dev)
    blocked = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        kernels.launch("rt_any_hit", *args, limit, tb.tri, tb.n_tri, tb.sph, tb.n_sph,
                       blocked, work, n)
        COUNTS_ANY.launches += 1
    return blocked


def shadow_any_hit(scene: Scene, pos, dirs, excl_prim, limits, actives, work=None):
    """Shadow predicate of a dense scene for all its lights in one launch.

    pos [N, 3]; dirs [L, N, 3] (normalised, toward each light); excl_prim
    [N] int32 (the shaded primitive); limits [L, N] real-unit occluder
    limits (inf = none); actives [L, N] bool.  Returns blocked [L, N] bool.
    Each light's target for the factored triangle algebra (its origin, or
    minus its direction) is read from the scene's light table."""
    L, n, dev = dirs.shape[0], pos.shape[0], pos.device
    if L != scene.n_light:
        raise ValueError(f"shadow_any_hit: {L} directions for {scene.n_light} lights")
    if dev.type == "cpu":
        COUNTS_SHADOW.plain += 1
        return shadow_any_hit_plain(scene.tables, pos, dirs, excl_prim, limits, actives)
    tb = _dense_tables(scene, dev, "shadow_any_hit")
    pos, dirs, excl_prim = pos.contiguous(), dirs.contiguous(), excl_prim.contiguous()
    limits, actives = limits.contiguous(), actives.contiguous()
    kernels.check("pos", pos, torch.float32, (n, 3), dev)
    kernels.check("dirs", dirs, torch.float32, (L, n, 3), dev)
    kernels.check("excl_prim", excl_prim, torch.int32, (n,), dev)
    kernels.check("limits", limits, torch.float32, (L, n), dev)
    kernels.check("actives", actives, torch.bool, (L, n), dev)
    kernels.check_work(work, n, dev)
    blocked = torch.empty((L, n), dtype=torch.bool, device=dev)
    if n and L:
        kernels.launch("rt_shadow_any_hit", pos, dirs, excl_prim, limits, actives,
                       tb.tri, tb.n_tri, tb.sph, tb.n_sph, tb.lights, L, blocked, work, n)
        COUNTS_SHADOW.launches += 1
    return blocked
