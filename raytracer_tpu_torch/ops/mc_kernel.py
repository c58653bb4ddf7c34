"""The Monte-Carlo whole-walk kernel and its plain version.

Counterpart of raytracer_tpu/ops/mc_pallas.py (`_mc_kernel` :474, wrapper
`trace` :541): one MC sample per primary ray, walked whole — the primary
cast, `depth` roulette bounces (mc_step: roulette, scatter lobe, interior
march, advance cast, merged next-hit shade, the recurrence accum +=
scale*A; scale *= B), then the depth-exhausted terminal shade
(mc_terminal).  The CUDA kernel is csrc/mc_kernel.cu, one instantiation per
geometry: dense scenes launch `rt_mc_trace`, whose blocks stage the
scene's hot rows in shared memory (csrc/common.cuh DenseRowsGeom; a
table too large to stage is walked per thread), blocked
(large-mesh) scenes `rt_mc_trace_blk` (mc_pallas.py:474-533, the
BlockedGeom branch), whose warps walk the chunks together out of shared
memory (CoopGeom).  `trace_plain` below is the same walk in plain PyTorch
over either geometry.  `trace_per_thread` launches either walk with every
thread reading the tables from global memory alone, as the yardstick the
main path's walks are held against; `trace` never takes it.  An MC epoch
on this route traces the whole frame in one call (render.epoch_frame).

The random draws are an operand ([depth, 3, N] uniforms: roulette u, lobe
u_phi, lobe theta), so the kernel, the plain version and the JAX package
can be fed identical randomness and compared lane for lane.

On a scene that carries the sphere chunk table (a dense scene of more
spheres than one chunk holds: scene/blocked.py build_sph_chunks), both
dense entries launch the instantiations whose sphere sweeps test only the
spheres of the chunks a ray enters (csrc/common.cuh SphGated), with the
linear sweeps' hits; the plain version gates alike.

Asked to (`sph_tests=`), the walk counts its sphere tests: every sweep's,
added once at its end (csrc/common.cuh SphCount, launched only then, so the
untraced walk runs no counting instruction; the plain version through
kernel_common.count_sph_tests), and a gated walk its box tests
(`sph_box_tests=`).  Inside a unit that utils/tracing records, `trace`
asks, and adds the call's sums to the counters `mc.sph_tests` and, on a
gated walk, `mc.sph_box_tests`.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.scene.textures import kernel_textures_ok
from raytracer_tpu_torch.scene.types import FACE_BACK, FACE_FRONT, NO_EXCLUDE, Scene
from raytracer_tpu_torch.utils import kernels, tracing


COUNTS = kernels.LaunchCounts()  # the dense instantiation
COUNTS_THREAD = kernels.LaunchCounts()  # its per-thread yardstick
COUNTS_BLK = kernels.LaunchCounts()  # the blocked instantiation
COUNTS_BLK_THREAD = kernels.LaunchCounts()  # its per-thread yardstick


def _i32(n, value, device):
    return torch.full((n,), value, dtype=torch.int32, device=device)


def scatter(m, st, u_sel, u_phi, theta):
    """Roulette select and lobe sample at the current hit (main.rs:539-554,
    652-666) -> (sel_d, sel_f, scattered direction sd, reflected f, live)."""
    cnx, cny, cnz = st["cnx"], st["cny"], st["cnz"]
    cdx, cdy, cdz = st["cdx"], st["cdy"], st["cdz"]
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
    sd = kc.rotate_from_z(axx, axy, axz, sp * torch.cos(theta),
                          sp * torch.sin(theta), torch.cos(phi))
    cosine = -(cnx * sd[0] + cny * sd[1] + cnz * sd[2])
    live = st["alive"] & (cosine > 0.0)  # main.rs:560/579/598
    f = kc.reflect3(*sd, cnx, cny, cnz)
    return sel_d, sel_f, sd, f, live


def advance(geom, max_distance, max_retries, m, st, sel_f, sd, f, live):
    """The interior march of refract lanes, then the advance cast ->
    (march dict, advance direction, adv_active, next hit, casts)."""
    cp = (st["cpx"], st["cpy"], st["cpz"])
    cprim = st["cprim"]
    R = cprim.shape[0]
    mm = kc.march_rows(*cp, st["cnx"], st["cny"], st["cnz"], *sd,
                       m["refraction"], live & sel_f, geom, max_distance,
                       max_retries)
    adv_o = tuple(torch.where(sel_f, mm[k], c) for k, c in zip(("ex", "ey", "ez"), cp))
    adv_d = tuple(torch.where(sel_f, mm[k], c) for k, c in zip(("odx", "ody", "odz"), f))
    excl_face_r = torch.where(st["cback"], FACE_FRONT, FACE_BACK).to(torch.int32)
    adv_excl_prim = torch.where(sel_f, mm["prim"], cprim)
    adv_excl_face = torch.where(sel_f, FACE_BACK, excl_face_r).to(torch.int32)
    adv_active = live & (~sel_f | mm["escaped"])
    nxt = geom.nearest(adv_o, adv_d, _i32(R, FACE_FRONT, cprim.device), adv_excl_prim,
                       adv_excl_face, adv_active)
    casts = mm["iters"] + adv_active.to(torch.int32)
    return mm, adv_d, adv_active, nxt, casts


def brdf(m, st, f, sel_d):
    """BRDF against the unadjusted hit normal (main.rs:566-570/585-589) ->
    {"r", "g", "b"}."""
    cnx, cny, cnz = st["cnx"], st["cny"], st["cnz"]
    fx, fy, fz = f
    lam = fx * cnx + fy * cny + fz * cnz
    pos_lam = lam > 0.0
    e = 1.0 / (m["smoothness"] + kc.F32_EPS)
    energy = (e + 8.0) / kc._EIGHT_PI
    rfx = 2.0 * lam * cnx - fx
    rfy = 2.0 * lam * cny - fy
    rfz = 2.0 * lam * cnz - fz
    amount = kc.powf(torch.clamp_min(-(rfx * st["cdx"] + rfy * st["cdy"] + rfz * st["cdz"]),
                                     0.0), e) * energy
    out = {}
    for ch, dk, sk in (("r", "dr", "sr"), ("g", "dg", "sg"), ("b", "db", "sb")):
        bd = torch.where(pos_lam, m[dk] * lam, 0.0)
        bs = torch.where(pos_lam, m[sk] * amount, 0.0)
        out[ch] = torch.where(sel_d, bd, bs)
    return out


def next_hit(nxt, adv_d):
    """The walk state's current-hit fields after an advance cast."""
    return dict(
        cpx=nxt["px"], cpy=nxt["py"], cpz=nxt["pz"],
        cnx=nxt["nx"], cny=nxt["ny"], cnz=nxt["nz"], cu=nxt["u"], cv=nxt["v"],
        cprim=nxt["prim"], cobj=nxt["obj"], cback=nxt["backface"],
        cdx=adv_d[0], cdy=adv_d[1], cdz=adv_d[2],
    )


def mc_step(geom, textures, max_distance, max_retries, st, u_sel, u_phi, theta):
    """ONE roulette bounce of the distributed walk (main.rs:521-614,
    mc_pallas.mc_step :58).  geom: a DenseGeom / BlockedGeom
    (Scene.geom); `st` holds [R] tensors: alive, accum a{r,g,b}, scale s{r,g,b},
    the current hit (cp, cn, cu, cv, cprim, cobj, cback) and the incoming
    direction cd.  Returns (new_st, casts_delta)."""
    m = kc.eval_material(geom.tb, textures, st["cobj"], st["cu"], st["cv"])
    sel_d, sel_f, sd, f, live = scatter(m, st, u_sel, u_phi, theta)
    mm, adv_d, adv_active, nxt, casts = advance(geom, max_distance, max_retries,
                                                m, st, sel_f, sd, f, live)
    use_next = nxt["valid"]

    # merged shade: next hit where the advance cast hit, else the scattered
    # self-shade (miss terminals 571-573/590-592); refract lanes whose
    # escape cast missed contribute black (607)
    pick = lambda a, b: torch.where(use_next, a, b)
    need_shade = adv_active & (use_next | ~sel_f)
    m2 = kc.eval_material(geom.tb, textures, pick(nxt["obj"], st["cobj"]),
                          pick(nxt["u"], st["cu"]), pick(nxt["v"], st["cv"]))
    shr, shg, shb, cnt = kc.shade_at(
        geom, m2, pick(nxt["px"], st["cpx"]), pick(nxt["py"], st["cpy"]),
        pick(nxt["pz"], st["cpz"]), pick(nxt["nx"], st["cnx"]), pick(nxt["ny"], st["cny"]),
        pick(nxt["nz"], st["cnz"]), pick(adv_d[0], sd[0]), pick(adv_d[1], sd[1]),
        pick(adv_d[2], sd[2]), need_shade, pick(nxt["prim"], st["cprim"]))
    casts = casts + cnt

    br = brdf(m, st, f, sel_d)
    decay = kc.powf(m["decay"], mm["travel"])
    is_rb = ~sel_f  # diffuse / reflect branch
    hit_scale = torch.where(use_next, 0.5, 1.0)
    b_base = torch.where(use_next, 0.5, 0.0)

    new = dict(alive=adv_active & use_next)
    for ch, sh in (("r", shr), ("g", shg), ("b", shb)):
        A = torch.where(is_rb, hit_scale * sh, decay * sh)
        B = torch.where(is_rb, b_base * br[ch], decay)
        scale = st["s" + ch]
        new["a" + ch] = st["a" + ch] + torch.where(need_shade, scale * A, 0.0)
        new["s" + ch] = scale * torch.where(adv_active, B, 0.0)
    new.update(next_hit(nxt, adv_d))
    return new, casts


def trace_plain(geom, textures, ray_o, ray_d, unifs, depth: int,
                max_distance: float, max_retries: int):
    """The whole walk in plain PyTorch -> (photon [N, 3] unfiltered, casts
    0-d tensor).  geom: a DenseGeom / BlockedGeom (Scene.geom)."""
    n = ray_o.shape[0]
    dev = ray_o.device
    o = (ray_o[:, 0], ray_o[:, 1], ray_o[:, 2])
    d = (ray_d[:, 0], ray_d[:, 1], ray_d[:, 2])
    front = _i32(n, FACE_FRONT, dev)
    h = geom.nearest(o, d, front, _i32(n, NO_EXCLUDE, dev), front,
                     torch.ones(n, dtype=torch.bool, device=dev))
    casts = torch.ones(n, dtype=torch.int32, device=dev)  # primary (main.rs:1150)
    zero, one = torch.zeros_like(o[0]), torch.ones_like(o[0])
    st = dict(
        alive=h["valid"], ar=zero, ag=zero, ab=zero, sr=one, sg=one, sb=one,
        cpx=h["px"], cpy=h["py"], cpz=h["pz"], cnx=h["nx"], cny=h["ny"],
        cnz=h["nz"], cu=h["u"], cv=h["v"], cprim=h["prim"], cobj=h["obj"],
        cback=h["backface"], cdx=d[0], cdy=d[1], cdz=d[2],
    )
    for step in range(depth):
        st, dc = mc_step(geom, textures, max_distance, max_retries, st,
                         unifs[step, 0], unifs[step, 1], unifs[step, 2])
        casts = casts + dc

    # depth exhausted: terminate with shade(self) (main.rs:524-527)
    alive = st["alive"]
    m3 = kc.eval_material(geom.tb, textures, st["cobj"], st["cu"], st["cv"])
    shr, shg, shb, cnt = kc.shade_at(
        geom, m3, st["cpx"], st["cpy"], st["cpz"], st["cnx"],
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
          max_retries: int, work: torch.Tensor | None = None,
          sph_tests: torch.Tensor | None = None, sph_box_tests: torch.Tensor | None = None):
    """One MC sample per primary ray -> (photon [N, 3] UNfiltered, casts
    0-d tensor).  unifs: [depth, 3, N] float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (csrc/mc_kernel.cu: the staged dense instantiation, or the cooperative
    blocked one on a blocked scene) or raise — there is no fallback.
    `work`: an optional int32 [len(kernels.WORK_ROWS), N] tensor; given one,
    the kernel's counting instantiation fills it with each lane's tests by
    kind.  `sph_tests`, `sph_box_tests`: optional int64 [N] tensors; given
    one, it receives each lane's sphere tests, or its sphere gate's box tests
    (0 where the walk's sphere sweeps are linear).  Inside a recorded unit
    (utils/tracing) their sums are counted as `mc.sph_tests` and, on a
    gated walk, `mc.sph_box_tests`."""
    n, dev = ray_o.shape[0], ray_o.device
    if tracing.active():
        if sph_tests is None:
            sph_tests = torch.empty((n,), dtype=torch.int64, device=dev)
        if sph_box_tests is None and scene.sph_perm is not None:
            sph_box_tests = torch.empty((n,), dtype=torch.int64, device=dev)
    counts = COUNTS_BLK if scene.blocked else COUNTS
    if dev.type == "cpu":
        counts.plain += 1
        if sph_tests is None and sph_box_tests is None:
            return trace_plain(scene.geom, scene.textures, ray_o, ray_d, unifs,
                               depth, max_distance, max_retries)
        outs = [t for t in (sph_tests, sph_box_tests) if t is not None]
        for t in outs:
            kernels.check("sph_tests", t, torch.int64, (n,), dev)
        with kc.count_sph_tests(n, dev) as (lanes, boxes):
            out = trace_plain(scene.geom, scene.textures, ray_o, ray_d, unifs,
                              depth, max_distance, max_retries)
        if sph_tests is not None:
            sph_tests.copy_(lanes)
        if sph_box_tests is not None:
            sph_box_tests.copy_(boxes)
    else:
        out = _launch("rt_mc_trace_blk" if scene.blocked else "rt_mc_trace", True, counts,
                      scene, ray_o, ray_d, unifs, depth, max_distance, max_retries, work,
                      sph_tests, sph_box_tests)
    if sph_tests is not None:
        tracing.count("mc.sph_tests", sph_tests)
    if sph_box_tests is not None and scene.sph_perm is not None:
        tracing.count("mc.sph_box_tests", sph_box_tests)
    return out


def trace_per_thread(scene: Scene, ray_o, ray_d, unifs, depth: int, max_distance: float,
                     max_retries: int, work: torch.Tensor | None = None,
                     sph_tests: torch.Tensor | None = None,
                     sph_box_tests: torch.Tensor | None = None):
    """`trace` on CUDA tensors through the kernel's per-thread
    instantiation (every thread sweeps the dense table, or walks its own
    chunk list, out of global memory alone).  The main path's walk must
    give its photons, casts and test counts; nothing on the main path calls
    this, and it counts nothing into utils/tracing."""
    if scene.blocked:
        return _launch("rt_mc_trace_blk_thread", False, COUNTS_BLK_THREAD, scene, ray_o, ray_d,
                       unifs, depth, max_distance, max_retries, work, sph_tests, sph_box_tests)
    return _launch("rt_mc_trace_thread", False, COUNTS_THREAD, scene, ray_o, ray_d, unifs, depth,
                   max_distance, max_retries, work, sph_tests, sph_box_tests)


def _launch(entry: str, hot: bool, counts, scene: Scene, ray_o, ray_d, unifs, depth,
            max_distance, max_retries, work, sph_tests, sph_box_tests):
    """Check the operands and launch C entry `entry` (`hot`: it takes the
    hot rows of the staged or cooperative walk; a dense entry takes the
    sphere chunk table and `sph_box_tests`, a blocked one neither, and its
    `sph_box_tests` is zeroed) and advance its launch counter `counts`."""
    dev = ray_o.device
    n = ray_o.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"mc_kernel.trace: unsupported device {dev}")
    if not kernel_textures_ok(scene.textures):
        raise ValueError("the MC kernel holds only DEFAULT_TEXTURES")
    tb = scene.tables
    bt = scene.blk_tables if scene.blocked else None
    kc.check_tables(tb, dev, bt)
    kernels.check("ray_o", ray_o, torch.float32, (n, 3), dev)
    kernels.check("ray_d", ray_d, torch.float32, (n, 3), dev)
    kernels.check("unifs", unifs, torch.float32, (depth, 3, n), dev)
    kernels.check_work(work, n, dev)
    for t in (sph_tests, sph_box_tests):
        if t is not None:
            kernels.check("sph_tests", t, torch.int64, (n,), dev)
    o_t = ray_o.t().contiguous()
    d_t = ray_d.t().contiguous()
    photon = torch.empty((3, n), dtype=torch.float32, device=dev)
    casts = torch.empty((n,), dtype=torch.int32, device=dev)
    outs = (photon, casts, work, sph_tests)
    if bt is None:
        outs += (sph_box_tests,)
    elif sph_box_tests is not None:
        sph_box_tests.zero_()
    if n:
        kernels.launch(entry, o_t, d_t, unifs, *kc.kernel_geometry(tb, bt, hot, bt is None),
                       *outs, n, depth, float(max_distance), int(max_retries))
        counts.launches += 1
    return photon.t(), casts.sum()
