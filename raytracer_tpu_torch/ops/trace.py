"""Wavefront Whitted tracer: the level ladder over the level kernel, or,
on the unfused path, over the standalone sweep and march kernels.

Counterpart of raytracer_tpu/ops/trace.py:359-542 (_trace_whitted_packed),
:545-772 (the Pool ladder of the unfused path) and :56-212 (refract_march).
The reference's per-pixel recursion (src/main.rs:466-519, depth 5)
flattens into a fixed-depth loop of levels over bounded ray pools:

  * level 0 runs the primary rays at exact width and delivers straight
    into the framebuffer (identity slots);
  * level 1 is peeled: level 0 emits exactly 2n children, which is already
    a valid pool (capacity_factor 2), so it runs uncompacted and delivers
    with two plain adds;
  * deeper levels run in narrower pools (deep_capacity, then
    tail_capacity, plus fixed slacks), entered through group compaction;
    their radiance rides the `pending` rows down the wavefront, and the
    peeled final level delivers every chain at once (`deliver`: each
    pixel's lanes in lane order, so a frame repeats bit for bit).

Group compaction keeps a group of `group` lanes iff any lane is alive or
owes pending radiance; destinations are a cumsum prefix sum; groups past
the pool's capacity are dropped and COUNTED (`dropped`), never silently.

Routing (`fused_ok`, trace.py:383-394): a dense or blocked scene with a
primitive, whose textures the kernels hold, runs its levels in the fused
level kernel.  Every other scene — a texture set that is not the kernels'
own, a BVH without the blocked layout — takes the unfused path: the same
ladder over the same packed pools, each level run by
`process_level_unfused` (cast, material, shade, reflect child, interior
march, refract child as separate steps, trace.py:545-653).  The JAX
package keeps a second ladder over a Pool of [K, 3] fields for that; here
one ladder serves both, since compaction and delivery are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.ops import march_kernel
from raytracer_tpu_torch.ops import materials as mat_ops
from raytracer_tpu_torch.ops.intersect import cast
from raytracer_tpu_torch.ops.level_kernel import (
    F_C,
    F_PEND,
    F_S,
    I_ALIVE,
    I_EXCL_FACE,
    I_EXCL_PRIM,
    I_FACE,
    I_SLOT,
    N_F,
    N_I,
    Pool,
    process_level,
)
from raytracer_tpu_torch.ops.shade import get_shade
from raytracer_tpu_torch.scene.textures import kernel_textures_ok
from raytracer_tpu_torch.scene.types import FACE_BACK, FACE_FRONT, NO_EXCLUDE, Rays, Scene
from raytracer_tpu_torch.utils import kernels, tracing, vec

DELIVER_COUNTS = kernels.LaunchCounts()
NO_RADIANCE = 0x7FFFFFFF  # deliver's sort key of a lane that owes nothing (csrc/deliver.cu)


class TraceResult(NamedTuple):
    color: torch.Tensor  # [N, 3]
    casts: torch.Tensor  # 0-d: rays cast, incl. shadow rays and marches
    dropped: torch.Tensor  # 0-d: rays lost to pool overflow (want 0)


def fused_ok(scene: Scene) -> bool:
    """Do the fused kernels (level, MC, binned) take this scene?
    (trace.py:383-394, distributed.py:112-114, with the port's texture
    test.)  Otherwise it renders through the unfused path."""
    return ((scene.bvh_node_min is None or scene.blk_perm is not None)
            and scene.n_prim > 0 and kernel_textures_ok(scene.textures))


def refract_dir(normal, direction, k):
    """Snell refraction (src/main.rs:344-352) -> (refracted unit direction
    [N, 3], ok [N]); ok=False is total internal reflection.  cos = -l.n;
    refract iff k^2 >= 1 - cos^2; t = (l + n cos)/k - n sqrt(1 -
    (1-cos^2)/k^2), normalized."""
    cos = -vec.dot(direction, normal)
    sin2 = 1.0 - cos * cos
    ok = k * k >= sin2
    inner = torch.clamp_min(1.0 - sin2 / (k * k), 0.0)
    t = (direction + normal * cos[:, None]) / k[:, None] - normal * torch.sqrt(inner)[:, None]
    return t / torch.clamp_min(vec.norm(t), 1e-30)[:, None], ok


class MarchResult(NamedTuple):
    escaped: torch.Tensor  # [N] bool: Refraction::Escaped
    travel: torch.Tensor  # [N] accumulated interior distance
    esc_o: torch.Tensor  # [N, 3] escape origin
    esc_d: torch.Tensor  # [N, 3] escape direction (unit)
    esc_prim: torch.Tensor  # [N] primitive to exclude on its BACK face
    casts: torch.Tensor  # 0-d: rays cast during the march


def _unit_reflect(d, n):
    r = vec.reflect(d, n)
    return r / torch.clamp_min(vec.norm(r), 1e-30)[:, None]


def refract_march(scene: Scene, pos, normal, ray_d, prim, k, want,
                  max_distance: float, max_retries: int) -> MarchResult:
    """World::get_refract flattened (src/main.rs:343-405; trace.py:84-212).

    pos / normal / ray_d / prim: the entry hit; k: the refraction index
    sample; want: the lanes that refract.  Misses inside the dielectric
    (Refraction::Infinite) and rays still trapped both give escaped=False:
    both call sites treat them as black (508-511, 605-611).

    On a dense scene the whole march runs in one launch of the march
    kernel (ops/march_kernel.py); a scene with a BVH runs the masked loop
    below over `cast`, one iteration per interior bounce while any lane
    still marches."""
    if scene.bvh_node_min is None and scene.n_prim > 0:
        return MarchResult(*march_kernel.march(scene, pos, normal, ray_d, prim, k, want,
                                               max_distance, max_retries))
    n = pos.shape[0]
    back = torch.full((n,), FACE_BACK, dtype=torch.int32, device=pos.device)
    front = torch.full_like(back, FACE_FRONT)

    rin, ok_in = refract_dir(normal, ray_d, k)
    active0 = want & ok_in  # TIR at entry -> Trapped
    h = cast(scene, Rays(o=pos, d=rin, face=back, excl_prim=prim, excl_face=front),
             active=active0, attrs="geom")
    casts = active0.sum()
    alive = active0 & h.valid  # miss -> Infinite -> black
    travel = torch.where(alive, vec.distance(h.pos, pos), 0.0)
    rout, ok_out = refract_dir(h.normal, rin, 1.0 / k)
    has_out = alive & ok_out
    cur_pos, cur_normal, cur_prim, cur_d = h.pos, h.normal, h.prim, rin
    retry = torch.zeros_like(back)

    def pending():
        return alive & ~has_out & (travel <= max_distance) & (retry < max_retries)

    p = pending()
    while bool(p.any()):
        # get_reflect on the interior hit (src/main.rs:380): the new ray
        # keeps face=Back and excludes the hit primitive's FRONT side
        refl = _unit_reflect(cur_d, cur_normal)
        h2 = cast(scene, Rays(o=cur_pos, d=refl, face=back, excl_prim=cur_prim,
                              excl_face=front), active=p, attrs="geom")
        step_alive = p & h2.valid  # interior miss -> Infinite -> dead
        travel = torch.where(step_alive, travel + vec.distance(h2.pos, cur_pos), travel)
        rout2, ok2 = refract_dir(h2.normal, refl, 1.0 / k)
        upd = step_alive[:, None]
        cur_pos = torch.where(upd, h2.pos, cur_pos)
        cur_normal = torch.where(upd, h2.normal, cur_normal)
        cur_prim = torch.where(step_alive, h2.prim, cur_prim)
        cur_d = torch.where(upd, refl, cur_d)
        rout = torch.where(upd, rout2, rout)
        has_out = torch.where(step_alive, ok2, has_out)
        alive = torch.where(p, step_alive, alive)
        retry = retry + p.to(torch.int32)
        casts = casts + p.sum()
        p = pending()

    return MarchResult(escaped=alive & has_out, travel=travel, esc_o=cur_pos,
                       esc_d=rout, esc_prim=cur_prim, casts=casts)


def process_level_unfused(scene: Scene, pool: Pool, last: bool, direct: bool,
                          threshold: float, max_distance: float, max_retries: int):
    """One Whitted level of the unfused path (trace.py:545-653), with
    level_kernel.process_level's signature and results: (contrib [3, K],
    reflect child Pool, refract child Pool, casts 0-d tensor).

    The level's steps are separate calls: `cast` (the nearest-hit kernel),
    the material's host textures, `get_shade` (the shadow kernel),
    `refract_march` (the march kernel).  A lane that is not alive gives
    what the level kernel gives it: children zero, its pending radiance
    delivered through `contrib` on direct levels, otherwise carried on the
    (dead) reflect child together with its slot."""
    f, i = pool.f, pool.i
    k = pool.width
    c, s = f[F_C], f[F_S]
    pend = f[F_PEND:F_PEND + 3].t()
    face, slot = i[I_FACE], i[I_SLOT]
    alive = i[I_ALIVE] != 0
    rays = Rays(o=f[0:3].t().contiguous(), d=f[3:6].t().contiguous(), face=face,
                excl_prim=i[I_EXCL_PRIM], excl_face=i[I_EXCL_FACE])

    hits = cast(scene, rays, active=alive)
    casts = alive.sum()
    live = alive & hits.valid

    mat = mat_ops.eval_material(scene, scene.textures, hits.obj, hits.uv)
    shade_c = (1.0 - mat.shiness) * (1.0 - mat.transparency)
    refl_c = mat.shiness * (1.0 - mat.transparency)
    refr_c = mat.transparency

    # direct shade iff c*shade_c >= THRESHOLD (main.rs:482); at the last
    # level the local shade weight does not apply (488-490)
    need_shade = live & (c * shade_c >= threshold)
    counters: list = []
    shade = get_shade(scene, scene.textures, hits.pos, hits.normal, hits.uv, hits.prim,
                      hits.obj, rays.d, need_shade, counters)
    for sc in counters:
        casts = casts + sc
    coef = s if last else s * shade_c
    p_new = pend + torch.where(need_shade[:, None], shade * coef[:, None], 0.0)

    zero3 = torch.zeros_like(p_new)
    if last:  # final level: no children (main.rs:488-490)
        none = Pool(f.new_zeros((N_F, k)), i.new_zeros((N_I, k)))
        return p_new.t().contiguous(), none, none, casts

    # reflect child (main.rs:493-500, get_reflect 328-341); its exclusion
    # face is the hit's face inverted (341)
    c_r = c * refl_c
    want_r = live & (c_r >= threshold)
    refl = _unit_reflect(rays.d, hits.normal)
    excl_face_r = torch.where(hits.backface, FACE_FRONT, FACE_BACK).to(torch.int32)

    # refract child (main.rs:502-514): the whole interior march
    c_f = c * refr_c
    want_f = live & (c_f > threshold)  # strict > (504)
    march = refract_march(scene, hits.pos, hits.normal, rays.d, hits.prim,
                          mat.refraction, want_f, max_distance, max_retries)
    casts = casts + march.casts
    decay = torch.pow(mat.decay, march.travel)  # opaque_decay^travel (508)
    alive_f = want_f & march.escaped

    # radiance delivery: direct levels emit through contrib; pooled levels
    # ride p_new on exactly one child (reflect by default, also when both
    # children are dead; the refract child when only it lives)
    if direct:
        contrib, pend_r, pend_f = p_new, zero3, zero3
    else:
        carrier_f = (~want_r & alive_f)[:, None]
        contrib = zero3
        pend_r = torch.where(carrier_f, 0.0, p_new)
        pend_f = torch.where(carrier_f, p_new, 0.0)

    def child(o, d, c_, s_, pending, face_, excl_prim, excl_face, alive_):
        cf = torch.cat([o.t(), d.t(), c_[None], s_[None], pending.t()])
        ci = torch.stack([face_, excl_prim, excl_face, slot, alive_.to(torch.int32)])
        # lanes that are not alive: zero, but for the pending they carry
        cf = torch.where(alive, cf, 0.0)
        ci = torch.where(alive, ci, 0)
        return cf, ci

    rf, ri = child(hits.pos, refl, c_r, s * refl_c, pend_r, face, hits.prim,
                   excl_face_r, want_r)
    ff, fi = child(march.esc_o, march.esc_d, c_f, s * refr_c * decay, pend_f,
                   torch.full_like(face, FACE_FRONT), march.esc_prim,
                   torch.full_like(face, FACE_BACK), alive_f)
    if not direct:
        rf[F_PEND:] = torch.where(alive, rf[F_PEND:], pend.t())
        ri[I_SLOT] = slot
    return contrib.t().contiguous(), Pool(rf, ri), Pool(ff, fi), casts


def deliver(img, slot, contrib):
    """img [N, 3] with each lane's radiance contrib [K, 3] added at its
    pixel slot [K], a pixel's lanes in lane order: img[s] + c_a + c_b + ...
    left to right -> a new [N, 3] tensor (raytracer_tpu/ops/trace.py:541,
    `img.at[slot].add`).

    The plain version is index_add, which adds lane after lane on the CPU.
    On the card index_add adds with float atomics in no fixed order, so a
    pixel with three or more lanes could move by an ulp from one render to
    the next; the kernel (csrc/deliver.cu) sorts the lanes by slot, stably,
    and gives each pixel's run of lanes to one thread, which sums them in
    lane order as the CPU does.  Lanes whose radiance is all zeros are
    left out on the card: they change no pixel."""
    with tracing.span("rt.ladder.deliver"):
        if img.device.type == "cpu":
            DELIVER_COUNTS.plain += 1
            return img.index_add(0, slot.long(), contrib)
        dev = img.device
        if dev.type != "cuda":
            raise ValueError(f"trace.deliver: unsupported device {dev}")
        n, k = img.shape[0], slot.shape[0]
        out = img.clone(memory_format=torch.contiguous_format)
        kernels.check("img", out, torch.float32, (n, 3), dev)
        cols = contrib.t().contiguous()  # [3, K]: the pools' own layout
        kernels.check("contrib", cols, torch.float32, (3, k), dev)
        if k:
            # a lane that owes nothing (the pools' empty lanes, all slot 0) is
            # sorted past the frame: adding zeros changes no pixel (but -0,
            # which compares equal to +0), and their run would be one thread's
            key = torch.where((cols != 0.0).any(dim=0), slot.to(torch.int32), NO_RADIANCE)
            slots, lanes = torch.sort(key, stable=True)
            kernels.launch("rt_deliver", out, slots, lanes, cols, n, k)
            DELIVER_COUNTS.launches += 1
        return out


def _group(cfg: RenderConfig) -> int:
    """Compaction group width (cfg.compact_group; 0 = auto).

    The JAX package's auto rule takes 32-lane groups from n >= 65536 to
    amortise the TPU's per-row scatter cost (raytracer_tpu/ops/trace.py:
    359-362).  Here compaction is a prefix sum and one index_copy whose
    cost hardly depends on the width, while 32-lane groups overflow the
    pools on the reference schedule itself (1280x960 in 65536-ray tiles:
    14102 rays dropped, in 3 of 19 tiles, on an H100); 8-lane groups, the
    JAX rule's value below 65536, drop none there.  So auto is 8 at every
    tile size."""
    return cfg.compact_group or 8


def _round128(x: int) -> int:
    return max(128, -(-x // 128) * 128)


def _pack_primary(ray_o, ray_d) -> Pool:
    n = ray_o.shape[0]
    dev = ray_o.device
    f = torch.cat([
        ray_o.t(), ray_d.t(),
        torch.ones((2, n), device=dev),  # c, s
        torch.zeros((3, n), device=dev),  # pending
    ]).contiguous()
    i = torch.zeros((N_I, n), dtype=torch.int32, device=dev)  # face FRONT, excl_face
    i[1] = NO_EXCLUDE
    i[I_SLOT] = torch.arange(n, dtype=torch.int32, device=dev)
    i[I_ALIVE] = 1
    return Pool(f, i)


def _cat(a: Pool, b: Pool) -> Pool:
    return Pool(torch.cat([a.f, b.f], dim=1), torch.cat([a.i, b.i], dim=1))


def _pad(pool: Pool, k: int) -> Pool:
    extra = k - pool.width
    return Pool(torch.nn.functional.pad(pool.f, (0, extra)),
                torch.nn.functional.pad(pool.i, (0, extra)))


def _compact(cands: Pool, k: int, group: int, counted: bool = False):
    """Group compaction into a k-lane pool -> (Pool, dropped 0-d).
    counted: add the pool's lanes to the `ladder.lanes` counter and its
    candidates that are alive or owe pending radiance to `ladder.live` (one
    reduction of the kept lanes' group counts)."""
    with tracing.span("rt.ladder.compact"):
        assert k % group == 0, (k, group)
        c = cands.width
        if c % group:
            cands = _pad(cands, c + (-c) % group)
            c = cands.width
        keep = (cands.i[I_ALIVE] != 0) | torch.any(cands.f[F_PEND:F_PEND + 3] != 0.0, dim=0)
        ng_in, ng_out = c // group, k // group
        gkeepl = keep.view(ng_in, group)
        gkeep = gkeepl.any(dim=1)
        gcount = gkeepl.sum(dim=1)
        if counted:
            tracing.count("ladder.lanes", k)
            tracing.count("ladder.live", gcount)
        order = torch.cumsum(gkeep.to(torch.int64), dim=0) - 1
        fits = gkeep & (order < ng_out)
        dropped = torch.where(gkeep & ~fits, gcount, 0).sum()
        # one extra trash group takes every group that is not kept or not fit
        dest = torch.where(fits, order, ng_out)

        def move(x):
            rows = x.shape[0]
            out = x.new_zeros((rows, ng_out + 1, group))
            out.index_copy_(1, dest, x.view(rows, ng_in, group))
            return out[:, :ng_out].reshape(rows, k).contiguous()

        return Pool(move(cands.f), move(cands.i)), dropped


def trace_whitted(scene: Scene, ray_o, ray_d, cfg: RenderConfig,
                  level_fn=None) -> TraceResult:
    """Whitted-trace a primary ray batch [N, 3] -> per-ray linear RGB.

    Equivalent to World::ray_trace(depth=cfg.depth, contribution=1) per
    pixel (src/main.rs:1096-1102).  `level_fn` runs one level
    (level_kernel.process_level's signature): by default the level kernel
    where `fused_ok(scene)`, else the unfused level; a caller that compares
    a kernel with its plain version on the card passes a plain stand-in.

    Inside a recorded unit (utils/tracing) each level is a span, and the
    pools entering levels 1 .. depth-1 are counted: their lanes
    (`ladder.lanes`) and the lanes alive or owing pending radiance as they
    enter (`ladder.live`, one device reduction a pool)."""
    if level_fn is None:
        level_fn = process_level if fused_ok(scene) else process_level_unfused

    def level(pool, index, last, direct):
        with tracing.span("rt.ladder.level", level=index, width=pool.width):
            return level_fn(scene, pool, last, direct, cfg.threshold,
                            cfg.max_refract_distance, cfg.max_tir_retries)

    def counted(index):
        return index < cfg.depth and tracing.active()

    n = ray_o.shape[0]
    k = _round128(int(n * cfg.capacity_factor))
    group = _group(cfg)
    dropped = torch.zeros((), dtype=torch.int64, device=ray_o.device)

    contrib, rch, fch, casts = level(_pack_primary(ray_o, ray_d), 0, cfg.depth == 0, True)
    img = contrib.t()  # identity slots: the contribution IS the framebuffer
    if cfg.depth == 0:
        return TraceResult(img, casts, dropped)

    # level 1 peel: the 2n candidates already form a pool
    cands = _cat(rch, fch)
    doubled = k >= 2 * n
    if doubled:
        cands = _pad(cands, k)
        if counted(1):
            # level 0 delivers its own radiance, so its children owe none:
            # the live lanes are the alive ones
            tracing.count("ladder.lanes", k)
            tracing.count("ladder.live", cands.i[I_ALIVE])
    else:
        cands, drop = _compact(cands, k, group, counted(1))
        dropped = dropped + drop
    last1 = cfg.depth == 1
    contrib, rch, fch, c1 = level(cands, 1, last1, doubled or last1)
    casts = casts + c1
    if doubled:
        img = img + contrib[:, :n].t() + contrib[:, n:2 * n].t()
    elif last1:
        img = deliver(img, cands.i[I_SLOT], contrib.t())
    if last1:
        return TraceResult(img, casts, dropped)

    # deep levels (>= 2): narrower pool
    k2 = _round128(int(n * cfg.deep_capacity) + cfg.deep_slack)
    pool, drop = _compact(_cat(rch, fch), k2, group, counted(2))
    dropped = dropped + drop
    last2 = cfg.depth == 2
    contrib, rch, fch, c2 = level(pool, 2, last2, last2)
    casts = casts + c2
    if last2:
        img = deliver(img, pool.i[I_SLOT], contrib.t())
        return TraceResult(img, casts, dropped)

    # tail levels (>= 3): narrower once more; the slack absorbs lanes that
    # only carry pending radiance
    k3 = _round128(int(n * cfg.tail_capacity) + cfg.tail_slack)
    pool, drop = _compact(_cat(rch, fch), k3, group, counted(3))
    dropped = dropped + drop
    for index in range(3, cfg.depth):
        _, rch, fch, ci = level(pool, index, False, False)
        casts = casts + ci
        pool, drop = _compact(_cat(rch, fch), k3, group, counted(index + 1))
        dropped = dropped + drop
    # final level peeled: no children; ONE scatter delivers every chain
    contrib, _, _, cl = level(pool, cfg.depth, True, True)
    casts = casts + cl
    img = deliver(img, pool.i[I_SLOT], contrib.t())
    return TraceResult(img, casts, dropped)

