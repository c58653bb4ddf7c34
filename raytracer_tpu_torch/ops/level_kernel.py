"""The Whitted bounce-level kernel and its plain version.

Counterpart of raytracer_tpu/ops/level_pallas.py (`_level_kernel` :73,
`_level_body` :127, wrapper `process_level` :261): one wavefront level of
the flattened ray_trace recursion (src/main.rs:466-519) per launch —
nearest cast with attributes, direct shade with all shadow sweeps
(threshold-gated), the reflect child, the refract child after the whole
interior march, and the pending-radiance carry or `contrib` delivery.
The CUDA kernel is csrc/level_kernel.cu, one instantiation per geometry:
dense scenes launch `rt_level`, blocked (large-mesh) scenes `rt_level_blk`
(level_pallas.py:127-253, the BlockedGeom branch).  `process_level_plain`
below is the same level in plain PyTorch over either geometry.

Pool layout: `Pool.f` [11, K] float32 and `Pool.i` [5, K] int32 (the TPU
kernel bit-casts the int rows into one f32 array; here they stay int32):

  f rows 0-2 o (origin), 3-5 d (direction), 6 c (contribution),
         7 s (accumulated scale), 8-10 pending radiance rgb
  i rows 0 face, 1 excl_prim, 2 excl_face, 3 slot (pixel index), 4 alive

A lane that is not alive gets exactly what a dead TPU tile gives
(level_pallas.py:98-113): no geometry work, children zero, its pending
radiance delivered through `contrib` on direct levels, otherwise carried
on the (dead) reflect child together with its slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.scene.textures import kernel_textures_ok
from raytracer_tpu_torch.scene.types import FACE_BACK, FACE_FRONT, Scene
from raytracer_tpu_torch.utils import kernels

F_O, F_D, F_C, F_S, F_PEND = 0, 3, 6, 7, 8
I_FACE, I_EXCL_PRIM, I_EXCL_FACE, I_SLOT, I_ALIVE = 0, 1, 2, 3, 4
N_F, N_I = 11, 5

COUNTS = kernels.LaunchCounts()  # the dense instantiation
COUNTS_BLK = kernels.LaunchCounts()  # the blocked instantiation


class Pool(NamedTuple):
    f: torch.Tensor  # [11, K] float32
    i: torch.Tensor  # [5, K] int32

    @property
    def width(self) -> int:
        return self.f.shape[1]


def process_level_plain(geom, textures, pool: Pool, last: bool,
                        direct: bool, threshold: float, max_distance: float,
                        max_retries: int):
    """One level in plain PyTorch -> (contrib [3, K], reflect child Pool,
    refract child Pool, casts [K] int32).  geom: a DenseGeom / BlockedGeom
    (Scene.geom)."""
    tb = geom.tb
    f, i = pool.f, pool.i
    K = f.shape[1]
    dev = f.device
    o, d = (f[0], f[1], f[2]), (f[3], f[4], f[5])
    c, s, pend = f[F_C], f[F_S], f[F_PEND:F_PEND + 3]
    face, slot = i[I_FACE], i[I_SLOT]
    alive = i[I_ALIVE] != 0

    h = geom.nearest(o, d, face, i[I_EXCL_PRIM], i[I_EXCL_FACE], alive)
    live = alive & h["valid"]
    casts = alive.to(torch.int32)

    m = kc.eval_material(tb, textures, h["obj"], h["u"], h["v"])
    shade_c = (1.0 - m["shiness"]) * (1.0 - m["transparency"])
    refl_c = m["shiness"] * (1.0 - m["transparency"])
    refr_c = m["transparency"]

    # direct shade iff c*shade_c >= THRESHOLD (main.rs:482); at the last
    # level the local shade weight does not apply (488-490)
    need_shade = live & (c * shade_c >= threshold)
    shr, shg, shb, cnt = kc.shade_at(geom, m, h["px"], h["py"], h["pz"], h["nx"],
                                     h["ny"], h["nz"], *d, need_shade, h["prim"])
    casts = casts + cnt
    coef = s if last else s * shade_c
    p_new = pend + torch.stack([torch.where(need_shade, x * coef, 0.0)
                                for x in (shr, shg, shb)])

    rf, ri = torch.zeros((N_F, K), device=dev), torch.zeros((N_I, K), dtype=torch.int32, device=dev)
    ff, fi = torch.zeros_like(rf), torch.zeros_like(ri)
    if last:  # final level: no children (main.rs:488-490)
        contrib = p_new
    else:
        # reflect child (main.rs:493-500, get_reflect 328-341)
        c_r = c * refl_c
        want_r = live & (c_r >= threshold)
        fx, fy, fz = kc.reflect3(*d, h["nx"], h["ny"], h["nz"])
        rf[0:8] = torch.stack([h["px"], h["py"], h["pz"], fx, fy, fz, c_r, s * refl_c])
        ri[:] = torch.stack([
            face, h["prim"],
            torch.where(h["backface"], FACE_FRONT, FACE_BACK).to(torch.int32),
            slot, want_r.to(torch.int32)])

        # refract child (main.rs:502-514): the whole interior march
        c_f = c * refr_c
        want_f = live & (c_f > threshold)  # strict > (504)
        mm = kc.march_rows(h["px"], h["py"], h["pz"], h["nx"], h["ny"], h["nz"],
                           *d, m["refraction"], want_f, geom, max_distance,
                           max_retries)
        casts = casts + mm["iters"]
        decay = kc.powf(m["decay"], mm["travel"])  # opaque_decay^travel (508)
        alive_f = want_f & mm["escaped"]
        ff[0:8] = torch.stack([mm["ex"], mm["ey"], mm["ez"], mm["odx"], mm["ody"],
                               mm["odz"], c_f, s * refr_c * decay])
        fi[:] = torch.stack([
            torch.full_like(slot, FACE_FRONT), mm["prim"],
            torch.full_like(slot, FACE_BACK), slot, alive_f.to(torch.int32)])

        # radiance delivery: direct levels emit through contrib; pooled
        # levels ride p_new on exactly one child (reflect by default, the
        # refract child when only it lives)
        if direct:
            contrib = p_new
        else:
            carrier_f = ~want_r & alive_f
            contrib = torch.zeros_like(p_new)
            rf[F_PEND:] = torch.where(carrier_f, 0.0, p_new)
            ff[F_PEND:] = torch.where(carrier_f, p_new, 0.0)

    # lanes that are not alive: what a dead tile gives
    dead = ~alive
    rf = torch.where(dead, 0.0, rf)
    ri = torch.where(dead, 0, ri)
    ff = torch.where(dead, 0.0, ff)
    fi = torch.where(dead, 0, fi)
    if direct:
        contrib = torch.where(dead, pend, contrib)
    else:
        contrib = torch.where(dead, 0.0, contrib)
        rf[F_PEND:] = torch.where(dead, pend, rf[F_PEND:])
        ri[I_SLOT] = torch.where(dead, slot, ri[I_SLOT])
    return contrib, Pool(rf, ri), Pool(ff, fi), casts


def process_level(scene: Scene, pool: Pool, last: bool, direct: bool,
                  threshold: float, max_distance: float, max_retries: int,
                  work: torch.Tensor | None = None):
    """One Whitted level over a pool -> (contrib [3, K], reflect child Pool,
    refract child Pool, casts 0-d tensor).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (csrc/level_kernel.cu, the blocked instantiation on a blocked scene)
    or raise — there is no fallback.  `work`: an optional int32
    [len(kernels.WORK_ROWS), K] tensor; given one, the kernel's counting
    instantiation fills it with each lane's tests by kind (chip_smoke.py
    derives the operation bound from it)."""
    dev = pool.f.device
    counts = COUNTS_BLK if scene.blocked else COUNTS
    if dev.type == "cpu":
        counts.plain += 1
        contrib, rch, fch, casts = process_level_plain(
            scene.geom, scene.textures, pool, last, direct, threshold,
            max_distance, max_retries)
        return contrib, rch, fch, casts.sum()
    if dev.type != "cuda":
        raise ValueError(f"level_kernel.process_level: unsupported device {dev}")
    if not kernel_textures_ok(scene.textures):
        raise ValueError("the level kernel holds only DEFAULT_TEXTURES")
    tb = scene.tables
    bt = scene.blk_tables if scene.blocked else None
    kc.check_tables(tb, dev, bt)
    k = pool.width
    kernels.check("pool.f", pool.f, torch.float32, (N_F, k), dev)
    kernels.check("pool.i", pool.i, torch.int32, (N_I, k), dev)
    kernels.check_work(work, k, dev)

    contrib = torch.empty((3, k), dtype=torch.float32, device=dev)
    rch = Pool(torch.empty_like(pool.f), torch.empty_like(pool.i))
    fch = Pool(torch.empty_like(pool.f), torch.empty_like(pool.i))
    casts = torch.empty((k,), dtype=torch.int32, device=dev)
    if k:
        kernels.launch(
            "rt_level_blk" if bt is not None else "rt_level",
            pool.f, pool.i, *kc.kernel_geometry(tb, bt), contrib, rch.f, rch.i,
            fch.f, fch.i, casts, work, k, int(last), int(direct),
            float(threshold), float(max_distance), int(max_retries),
        )
        counts.launches += 1
    return contrib, rch, fch, casts.sum()
