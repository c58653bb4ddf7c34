"""The Monte-Carlo whole-walk kernel and its plain version.

Counterpart of raytracer_tpu/ops/mc_pallas.py (`_mc_kernel` :474, wrapper
`trace` :541): one MC sample per primary ray, walked whole — the primary
cast, `depth` roulette bounces (mc_step: roulette, scatter lobe, interior
march, advance cast, merged next-hit shade, the recurrence accum +=
scale*A; scale *= B), then the depth-exhausted terminal shade
(mc_terminal).  The CUDA kernel is csrc/mc_kernel.cu; `trace_plain` below
is the same walk in plain PyTorch.

The random draws are an operand ([depth, 3, N] uniforms: roulette u, lobe
u_phi, lobe theta), so the kernel, the plain version and the JAX package
can be fed identical randomness and compared lane for lane.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.scene.types import FACE_BACK, FACE_FRONT, NO_EXCLUDE, Scene
from raytracer_tpu_torch.utils import kernels


COUNTS = kernels.LaunchCounts()


def _i32(n, value, device):
    return torch.full((n,), value, dtype=torch.int32, device=device)


def mc_step(tb, textures, max_distance, max_retries, st, u_sel, u_phi, theta):
    """ONE roulette bounce of the distributed walk (main.rs:521-614,
    mc_pallas.mc_step :58).  `st` holds [R] tensors: alive, accum a{r,g,b},
    scale s{r,g,b}, the current hit (cp, cn, cu, cv, cprim, cobj, cback)
    and the incoming direction cd.  Returns (new_st, casts_delta)."""
    alive = st["alive"]
    cpx, cpy, cpz = st["cpx"], st["cpy"], st["cpz"]
    cnx, cny, cnz = st["cnx"], st["cny"], st["cnz"]
    cdx, cdy, cdz = st["cdx"], st["cdy"], st["cdz"]
    cprim = st["cprim"]
    R = alive.shape[0]
    dev = alive.device

    m = kc.eval_material(tb, textures, st["cobj"], st["cu"], st["cv"])
    w0 = (1.0 - m["shiness"]) * (1.0 - m["transparency"])
    w1 = m["shiness"] * (1.0 - m["transparency"])
    w2 = m["transparency"]
    r = u_sel * (w0 + w1 + w2)  # weighted_select (main.rs:652-666)
    sel_d = r < w0
    sel_r = ~sel_d & (r < w0 + w1)
    sel_f = ~sel_d & ~sel_r

    # scatter lobe (main.rs:539-554): diffuse around -normal exp 1, glossy
    # around the incoming direction exp smoothness
    expo = torch.where(sel_d, 1.0, m["smoothness"])
    axx, axy, axz = kc.normalize3(torch.where(sel_d, -cnx, cdx),
                                  torch.where(sel_d, -cny, cdy),
                                  torch.where(sel_d, -cnz, cdz))
    phi = torch.acos(kc.powf(1.0 - u_phi, expo))
    sp = torch.sin(phi)
    sdx, sdy, sdz = kc.rotate_from_z(axx, axy, axz, sp * torch.cos(theta),
                                     sp * torch.sin(theta), torch.cos(phi))

    cosine = -(cnx * sdx + cny * sdy + cnz * sdz)
    live = alive & (cosine > 0.0)  # main.rs:560/579/598
    fx, fy, fz = kc.reflect3(sdx, sdy, sdz, cnx, cny, cnz)
    excl_face_r = torch.where(st["cback"], FACE_FRONT, FACE_BACK).to(torch.int32)

    mm = kc.march_rows(cpx, cpy, cpz, cnx, cny, cnz, sdx, sdy, sdz,
                       m["refraction"], live & sel_f, tb, max_distance,
                       max_retries)
    casts = mm["iters"]

    adv_o = (torch.where(sel_f, mm["ex"], cpx), torch.where(sel_f, mm["ey"], cpy),
             torch.where(sel_f, mm["ez"], cpz))
    adv_d = (torch.where(sel_f, mm["odx"], fx), torch.where(sel_f, mm["ody"], fy),
             torch.where(sel_f, mm["odz"], fz))
    adv_excl_prim = torch.where(sel_f, mm["prim"], cprim)
    adv_excl_face = torch.where(sel_f, FACE_BACK, excl_face_r).to(torch.int32)
    adv_active = live & (~sel_f | mm["escaped"])

    nxt = kc.full_sweep(adv_o, adv_d, _i32(R, FACE_FRONT, dev), adv_excl_prim,
                        adv_excl_face, adv_active, tb)
    casts = casts + adv_active.to(torch.int32)
    use_next = nxt["valid"]

    # merged shade: next hit where the advance cast hit, else the scattered
    # self-shade (miss terminals 571-573/590-592); refract lanes whose
    # escape cast missed contribute black (607)
    pick = lambda a, b: torch.where(use_next, a, b)
    need_shade = adv_active & (use_next | ~sel_f)
    m2 = kc.eval_material(tb, textures, pick(nxt["obj"], st["cobj"]),
                          pick(nxt["u"], st["cu"]), pick(nxt["v"], st["cv"]))
    shr, shg, shb, cnt = kc.shade_at(
        tb, m2, pick(nxt["px"], cpx), pick(nxt["py"], cpy),
        pick(nxt["pz"], cpz), pick(nxt["nx"], cnx), pick(nxt["ny"], cny),
        pick(nxt["nz"], cnz), pick(adv_d[0], sdx), pick(adv_d[1], sdy),
        pick(adv_d[2], sdz), need_shade, pick(nxt["prim"], cprim))
    casts = casts + cnt

    # BRDF against the unadjusted hit normal (566-570/585-589)
    lam = fx * cnx + fy * cny + fz * cnz
    pos_lam = lam > 0.0
    e = 1.0 / (m["smoothness"] + kc.F32_EPS)
    energy = (e + 8.0) / kc._EIGHT_PI
    rfx = 2.0 * lam * cnx - fx
    rfy = 2.0 * lam * cny - fy
    rfz = 2.0 * lam * cnz - fz
    amount = kc.powf(torch.clamp_min(-(rfx * cdx + rfy * cdy + rfz * cdz), 0.0), e) * energy
    decay = kc.powf(m["decay"], mm["travel"])
    is_rb = ~sel_f  # diffuse / reflect branch
    hit_scale = torch.where(use_next, 0.5, 1.0)
    b_base = torch.where(use_next, 0.5, 0.0)

    new = dict(alive=adv_active & use_next)
    for ch, sh, dk, sk in (("r", shr, "dr", "sr"), ("g", shg, "dg", "sg"),
                           ("b", shb, "db", "sb")):
        bd = torch.where(pos_lam, m[dk] * lam, 0.0)
        bs = torch.where(pos_lam, m[sk] * amount, 0.0)
        br = torch.where(sel_d, bd, bs)
        A = torch.where(is_rb, hit_scale * sh, decay * sh)
        B = torch.where(is_rb, b_base * br, decay)
        scale = st["s" + ch]
        new["a" + ch] = st["a" + ch] + torch.where(need_shade, scale * A, 0.0)
        new["s" + ch] = scale * torch.where(adv_active, B, 0.0)
    new.update(
        cpx=nxt["px"], cpy=nxt["py"], cpz=nxt["pz"],
        cnx=nxt["nx"], cny=nxt["ny"], cnz=nxt["nz"], cu=nxt["u"], cv=nxt["v"],
        cprim=nxt["prim"], cobj=nxt["obj"], cback=nxt["backface"],
        cdx=adv_d[0], cdy=adv_d[1], cdz=adv_d[2],
    )
    return new, casts


def trace_plain(tb: kc.Tables, textures, ray_o, ray_d, unifs, depth: int,
                max_distance: float, max_retries: int):
    """The whole walk in plain PyTorch -> (photon [N, 3] unfiltered, casts
    0-d tensor)."""
    n = ray_o.shape[0]
    dev = ray_o.device
    o = (ray_o[:, 0], ray_o[:, 1], ray_o[:, 2])
    d = (ray_d[:, 0], ray_d[:, 1], ray_d[:, 2])
    front = _i32(n, FACE_FRONT, dev)
    h = kc.full_sweep(o, d, front, _i32(n, NO_EXCLUDE, dev), front,
                      torch.ones(n, dtype=torch.bool, device=dev), tb)
    casts = torch.ones(n, dtype=torch.int32, device=dev)  # primary (main.rs:1150)
    zero, one = torch.zeros_like(o[0]), torch.ones_like(o[0])
    st = dict(
        alive=h["valid"], ar=zero, ag=zero, ab=zero, sr=one, sg=one, sb=one,
        cpx=h["px"], cpy=h["py"], cpz=h["pz"], cnx=h["nx"], cny=h["ny"],
        cnz=h["nz"], cu=h["u"], cv=h["v"], cprim=h["prim"], cobj=h["obj"],
        cback=h["backface"], cdx=d[0], cdy=d[1], cdz=d[2],
    )
    for step in range(depth):
        st, dc = mc_step(tb, textures, max_distance, max_retries, st,
                         unifs[step, 0], unifs[step, 1], unifs[step, 2])
        casts = casts + dc

    # depth exhausted: terminate with shade(self) (main.rs:524-527)
    alive = st["alive"]
    m3 = kc.eval_material(tb, textures, st["cobj"], st["cu"], st["cv"])
    shr, shg, shb, cnt = kc.shade_at(
        tb, m3, st["cpx"], st["cpy"], st["cpz"], st["cnx"],
        st["cny"], st["cnz"], st["cdx"], st["cdy"], st["cdz"], alive,
        st["cprim"])
    casts = casts + cnt
    photon = torch.stack([
        st["ar"] + torch.where(alive, st["sr"] * shr, 0.0),
        st["ag"] + torch.where(alive, st["sg"] * shg, 0.0),
        st["ab"] + torch.where(alive, st["sb"] * shb, 0.0),
    ], dim=-1)
    return photon, casts.sum()


def trace(scene: Scene, ray_o, ray_d, unifs, depth: int, max_distance: float,
          max_retries: int):
    """One MC sample per primary ray -> (photon [N, 3] UNfiltered, casts
    0-d tensor).  unifs: [depth, 3, N] float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (csrc/mc_kernel.cu) or raise — there is no fallback."""
    dev = ray_o.device
    n = ray_o.shape[0]
    if dev.type == "cpu":
        COUNTS.plain += 1
        return trace_plain(scene.tables, scene.textures, ray_o, ray_d, unifs,
                           depth, max_distance, max_retries)
    if dev.type != "cuda":
        raise ValueError(f"mc_kernel.trace: unsupported device {dev}")
    if not kc.is_default_textures(scene.textures):
        raise ValueError("the MC kernel holds only DEFAULT_TEXTURES")
    tb = scene.tables
    kc.check_tables(tb, dev)
    kernels.check("ray_o", ray_o, torch.float32, (n, 3), dev)
    kernels.check("ray_d", ray_d, torch.float32, (n, 3), dev)
    kernels.check("unifs", unifs, torch.float32, (depth, 3, n), dev)
    o_t = ray_o.t().contiguous()
    d_t = ray_d.t().contiguous()
    photon = torch.empty((3, n), dtype=torch.float32, device=dev)
    casts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        kernels.launch(
            "rt_mc_trace",
            o_t, d_t, unifs, tb.tri, tb.n_tri, tb.sph, tb.n_sph, tb.mat,
            tb.mat.shape[0], tb.lights, tb.n_light, photon, casts, n, depth,
            float(max_distance), int(max_retries),
        )
        COUNTS.launches += 1
    return photon.t(), casts.sum()

