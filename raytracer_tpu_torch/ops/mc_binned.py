"""Binned per-bounce Monte-Carlo path for blocked (large-mesh) scenes.

Counterpart of raytracer_tpu/ops/mc_binned.py (`_primary_kernel` :131,
`_bounce_kernel` :157, `_terminal_kernel` :190, host loop `trace` :328) and of
the deferred-shading walk it runs (mc_pallas.mc_step_deferred :232,
mc_terminal_deferred :414).  The whole-walk mega-kernel (mc_kernel.py)
keeps a lane's rays in one thread from the primary cast to the terminal;
on a large mesh the bounce rays of neighbouring lanes scatter, so here the
walk is cut at every bounce: the walk state lives in device memory and,
before every bounce, lanes are sorted by (dead?, the blocked chunk of the
current hit, the predicted outgoing octant), as on the TPU, and then dealt
round-robin over the warps (`deal_lanes`): on the GPU a launch waits for
its slowest warp, so an even mix of live, marching and dead lanes in every
warp is worth more than neighbours that start from the same leaf boxes.

Three CUDA kernels (csrc/mc_binned.cu), each with its plain version here.
All three walk the blocked chunks warp by warp out of shared memory
(csrc/common.cuh CoopGeom), and each has a per-thread yardstick
(`*_per_thread`: every thread traversing alone) that the walk never takes:

  * primary:  the primary cast into the walk state, in the rays' order;
              the kernel deals the camera rays over its warps itself
              (`primary_lanes`), so that every warp holds the same mix of
              sky and mesh;
  * bounce:   one deferred-shading bounce (`first` skips the deferred
              shade of bounce 0, where nothing is deferred yet), on the
              lanes sorted and dealt (above);
  * terminal: the last deferred shade and the depth-exhausted terminal
              shade in one shadow sweep -> photons in sorted lane order.

Walk state: `sf` [21, N] float32 and `si` [5, N] int32 (the TPU bit-casts
the int rows into one [26, N] f32 array; here ints stay ints):

  sf rows 0-2 accum rgb, 3-5 scale rgb, 6-8 hit point, 9-11 hit normal,
          12-13 uv, 14-16 incoming direction, 17 df (deferred blend
          factor), 18-20 pr/pg/pb (the pre-update scale of the bounce that
          deferred its hit-shade)
  si rows 0 alive, 1 prim, 2 obj, 3 backface, 4 slot (primary ray index)

Each lane carries its slot: a bounce's uniforms are gathered by slot before
it runs, and the photons are scattered back by slot with an ADD.  The TPU
pads N to whole 512-lane tiles and pins the pad lanes, dead with zero
accumulation, to slot 0 (mc_binned.py:416-427, 509-515); the CUDA kernels
mask the ragged edge of their last block instead, so this path has no pad
lanes, and the scatter-add is a permutation.  Photons equal the
mega-kernel's lane for lane and the cast counters are equal
(tests/test_torch_mesh.py).  The TPU's per-tile supergroup visit order,
its RT_BINNED_TILE / RT_BINNED_KEY knobs and the "cell" key are not
ported: the key is always the origin chunk.
"""

from __future__ import annotations

import functools

import torch

from raytracer_tpu_torch.ops import kernel_common as kc
from raytracer_tpu_torch.ops import mc_kernel
from raytracer_tpu_torch.scene.textures import kernel_textures_ok
from raytracer_tpu_torch.scene.types import FACE_FRONT, NO_EXCLUDE, Scene
from raytracer_tpu_torch.utils import kernels

# Blocked scenes from this many triangles on take this path
# (ops/distributed.py); below it the mega-kernel.  Set from the card: the
# 1024x1024 MC epoch through the blocked MC kernel (one launch) against
# the binned route, on one NVIDIA H100 80GB HBM3 at 700 W
# (scripts/time_torch_kernels.py --sections routes), took 0.026-0.028 /
# 0.035-0.036 / 0.049 / 0.070-0.071 s against 0.36-0.41 / 0.34-0.37 /
# 0.49-0.51 / 0.28-0.39 s at 1,164 / 11,262 / 51,212 / 204,812 triangles
# (mesh_scene(24 / 75 / 160 / 320)): the binned route, 80 % idle on the
# host's sort dispatch, won at no size, so the threshold lies above every
# size measured.  Measured again with the cooperative primary (the same
# script and card): binned 0.19-0.22 / 0.16-0.19 / 0.17-0.23 / 0.22-0.28 s
# against 0.023-0.024 / 0.033-0.035 / 0.045-0.047 / 0.068-0.070 s: still
# above every size.  The JAX package's 4096 (raytracer_tpu/ops/mc_binned.py
# :47-52) was tuned on the TPU.  The checks of the binned kernels lower it.
BINNED_MIN_TRIS = 1 << 30

F_A, F_S, F_P, F_N, F_UV, F_D, F_DF, F_PR = 0, 3, 6, 9, 12, 14, 17, 18
I_ALIVE, I_PRIM, I_OBJ, I_BACK, I_SLOT = 0, 1, 2, 3, 4
N_F, N_I = 21, 5

_F_KEYS = ("ar", "ag", "ab", "sr", "sg", "sb", "cpx", "cpy", "cpz", "cnx",
           "cny", "cnz", "cu", "cv", "cdx", "cdy", "cdz", "df", "pr", "pg", "pb")
_I_KEYS = ("alive", "cprim", "cobj", "cback", "slot")

COUNTS_PRIMARY = kernels.LaunchCounts()
COUNTS_BOUNCE = kernels.LaunchCounts()
COUNTS_TERMINAL = kernels.LaunchCounts()
# the per-thread yardsticks of the cooperative primary, bounce and terminal
COUNTS_PRIMARY_THREAD = kernels.LaunchCounts()
COUNTS_BOUNCE_THREAD = kernels.LaunchCounts()
COUNTS_TERMINAL_THREAD = kernels.LaunchCounts()


def unpack(sf, si) -> dict:
    """[21, N] + [5, N] -> the walk-state dict of mc_kernel.mc_step (plus
    df, pr, pg, pb and slot); alive and cback as bool."""
    st = {k: sf[r] for r, k in enumerate(_F_KEYS)}
    st.update({k: si[r] for r, k in enumerate(_I_KEYS)})
    st["alive"] = st["alive"] != 0
    st["cback"] = st["cback"] != 0
    return st


def pack(st: dict):
    sf = torch.stack([st[k] for k in _F_KEYS]).contiguous()
    si = torch.stack([st[k].to(torch.int32) for k in _I_KEYS]).contiguous()
    return sf, si


# ---------------------------------------------------------------------------
# Plain versions of the three kernels
# ---------------------------------------------------------------------------


def primary_plain(geom, o_t, d_t):
    """Primary cast -> (sf, si, casts [N]); o_t, d_t: [3, N] rows."""
    n = o_t.shape[1]
    dev = o_t.device
    front = torch.full((n,), FACE_FRONT, dtype=torch.int32, device=dev)
    h = geom.nearest(tuple(o_t), tuple(d_t), front,
                     torch.full((n,), NO_EXCLUDE, dtype=torch.int32, device=dev),
                     front, torch.ones(n, dtype=torch.bool, device=dev))
    zero, one = torch.zeros_like(o_t[0]), torch.ones_like(o_t[0])
    st = dict(
        alive=h["valid"], ar=zero, ag=zero, ab=zero, sr=one, sg=one, sb=one,
        cpx=h["px"], cpy=h["py"], cpz=h["pz"], cnx=h["nx"], cny=h["ny"],
        cnz=h["nz"], cu=h["u"], cv=h["v"], cprim=h["prim"], cobj=h["obj"],
        cback=h["backface"], cdx=d_t[0], cdy=d_t[1], cdz=d_t[2],
        df=zero, pr=zero, pg=zero, pb=zero,  # nothing deferred yet
        slot=torch.arange(n, dtype=torch.int32, device=dev),
    )
    sf, si = pack(st)
    return sf, si, torch.ones(n, dtype=torch.int32, device=dev)


def bounce_plain(geom, textures, sf, si, u, first: bool,
                 max_distance: float, max_retries: int):
    """One deferred-shading bounce (mc_step_deferred) -> (sf, si, casts [N]).

    u: [3, N] this bounce's uniforms in the state's lane order.  Where a
    lane is alive: the previous bounce's deferred hit-shade at the current
    hit (unless `first`), then mc_step's roulette, march and advance cast;
    lanes whose advance cast missed shade their scattered self at once,
    lanes that hit defer their shade (df, pr/pg/pb) to the next kernel.  A
    dead lane's state is final and passes through."""
    st = unpack(sf, si)
    alive = st["alive"]
    m = kc.eval_material(geom.tb, textures, st["cobj"], st["cu"], st["cv"])
    cp = (st["cpx"], st["cpy"], st["cpz"])
    na = kc.rotate_from_z(st["cnx"], st["cny"], st["cnz"], m["tnx"], m["tny"], m["tnz"])
    acc = {ch: st["a" + ch] for ch in "rgb"}
    casts = torch.zeros_like(st["cprim"])
    if not first:  # the previous bounce's hit-shade, view = -incoming
        *sh, cnt = kc.get_shade(m, geom, *cp, *na, -st["cdx"], -st["cdy"],
                                -st["cdz"], alive, st["cprim"])
        casts = casts + cnt
        for ch, x in zip("rgb", sh):
            acc[ch] = acc[ch] + torch.where(alive, st["p" + ch] * (st["df"] * x), 0.0)

    sel_d, sel_f, sd, f, live = mc_kernel.scatter(m, st, u[0], u[1], u[2])
    mm, adv_d, adv_active, nxt, c2 = mc_kernel.advance(
        geom, max_distance, max_retries, m, st, sel_f, sd, f, live)
    casts = casts + c2
    use_next = nxt["valid"]
    is_rb = ~sel_f
    # advance misses shade the scattered self now (refract misses: black)
    ns_miss = adv_active & ~use_next & is_rb
    *sh, cnt = kc.get_shade(m, geom, *cp, *na, -sd[0], -sd[1], -sd[2], ns_miss,
                            st["cprim"])
    casts = casts + cnt

    br = mc_kernel.brdf(m, st, f, sel_d)
    decay = kc.powf(m["decay"], mm["travel"])
    b_base = torch.where(use_next, 0.5, 0.0)
    new = dict(alive=adv_active & use_next, df=torch.where(is_rb, 0.5, decay))
    for ch, x in zip("rgb", sh):
        scale = st["s" + ch]
        new["a" + ch] = acc[ch] + torch.where(ns_miss, scale * x, 0.0)
        new["p" + ch] = scale  # pre-update scale rides with the deferral
        B = torch.where(is_rb, b_base * br[ch], decay)
        new["s" + ch] = scale * torch.where(adv_active, B, 0.0)
    new.update(mc_kernel.next_hit(nxt, adv_d))
    out = {k: torch.where(alive, new[k], st[k]) if k in new else st[k] for k in st}
    sf2, si2 = pack(out)
    return sf2, si2, torch.where(alive, casts, 0)


def terminal_plain(geom, textures, sf, si, first: bool):
    """The last bounce's deferred shade and the depth-exhausted terminal
    shade (mc_terminal_deferred) from ONE shadow sweep -> (photon [3, N] in
    the state's lane order, casts [N]).  Both shades count their shadow
    rays, as the mega-kernel does."""
    st = unpack(sf, si)
    alive = st["alive"]
    m = kc.eval_material(geom.tb, textures, st["cobj"], st["cu"], st["cv"])
    *sh, cnt = kc.shade_at(geom, m, st["cpx"], st["cpy"], st["cpz"], st["cnx"],
                           st["cny"], st["cnz"], st["cdx"], st["cdy"], st["cdz"],
                           alive, st["cprim"])
    acc = {ch: st["a" + ch] for ch in "rgb"}
    if not first:
        for ch, x in zip("rgb", sh):
            acc[ch] = acc[ch] + torch.where(alive, st["p" + ch] * (st["df"] * x), 0.0)
        cnt = cnt + cnt  # the deferred shade's shadow rays (same mask)
    photon = torch.stack([acc[ch] + torch.where(alive, st["s" + ch] * x, 0.0)
                          for ch, x in zip("rgb", sh)])
    return photon, cnt


# ---------------------------------------------------------------------------
# The sort between bounces
# ---------------------------------------------------------------------------


def predict_out_dir(scene: Scene, st: dict, u):
    """The direction the next bounce will advance along, replayed from the
    carried state and the lane's own uniforms u [3, N]
    (mc_binned._predict_out_dir :224): the roulette from the material
    table, the lobe sample, its reflection about the hit normal; refract
    lanes keep the lobe sample (their march exit is unknown here).  It
    feeds the sort key only: any permutation is correct."""
    cobj = st["cobj"].long().clamp(0, scene.n_obj - 1)
    shin = scene.mat_shiness[cobj]
    transp = scene.mat_transparency[cobj]
    smooth = scene.mat_smoothness[cobj]
    w0 = (1.0 - shin) * (1.0 - transp)
    w1 = shin * (1.0 - transp)
    r = u[0] * (w0 + w1 + transp)
    sel_d = r < w0
    sel_f = ~sel_d & (r >= w0 + w1)
    m = dict(shiness=shin, transparency=transp, smoothness=smooth)
    # scatter's roulette agrees with the one above; its lobe is the sample
    _, _, sd, f, _ = mc_kernel.scatter(m, st, u[0], u[1], u[2])
    return tuple(torch.where(sel_f, a, b) for a, b in zip(sd, f)), sel_f


def sort_state(scene: Scene, sf, si, u_step):
    """Stable sort of the lanes by (dead?, origin chunk, refract?, predicted
    octant) (mc_binned._sort_state :271 with its default "chunk" key):
    the chunk of the blocked layout that holds the current hit primitive
    (spheres get pseudo-chunks past the triangle chunks).  u_step: [3, N]
    this bounce's uniforms in SLOT order."""
    st = unpack(sf, si)
    u = u_step[:, st["slot"].long()]
    (pdx, pdy, pdz), sel_f = predict_out_dir(scene, st, u)
    cop = scene.blk_tables.chunk_of_prim
    locality = cop[st["cprim"].long().clamp(0, cop.shape[0] - 1)]
    octant = ((pdx < 0).long() << 2) | ((pdy < 0).long() << 1) | (pdz < 0).long()
    key = torch.where(st["alive"], (locality << 4) | (sel_f.long() << 3) | octant,
                      1 << 30)
    perm = torch.argsort(key, stable=True)
    return sf[:, perm].contiguous(), si[:, perm].contiguous()


@functools.lru_cache(maxsize=8)
def _deal_order(n: int, device) -> torch.Tensor:
    """[n] gather index that deals lanes 0, 1, 2, ... round-robin to the
    ceil(n / 32) warps of a launch: warp w gets lanes w, w + W, w + 2 W, ..."""
    warps = -(-n // 32)
    return torch.argsort(torch.arange(n, device=device) % warps, stable=True)


def primary_lanes(n: int, device=None) -> torch.Tensor:
    """[ceil(n / 128) * 128] the lane that each thread of the cooperative
    primary kernel takes (csrc/mc_binned.cu dealt_lane): the n lanes dealt
    round-robin over the launch's ceil(n / 32) warps, n for a thread past
    them.  A `work` output's columns in this order are the threads'."""
    t = torch.arange(-(-n // 128) * 128, device=device)
    warps = -(-n // 32)
    return torch.where(t // 32 < warps, t // 32 + (t % 32) * warps, n)


def deal_lanes(sf, si):
    """The sorted lanes dealt round-robin over the warps.  The sort packs
    the lanes that will march, and the live lanes of late bounces, into a
    few neighbouring warps, and a launch lasts as long as its slowest warp:
    on an NVIDIA H100 (80GB HBM3, 700 W) the bounce kernel of a mesh11k tile
    then takes 1.2 ms a launch with the median block done after 0.03 ms,
    and 0.26 ms dealt.  Dealt, every warp
    holds the same mix of live, marching and dead lanes.  The cooperative
    sweeps lose the chunks that sorted neighbours share, which costs less
    than the tail (PERF.md).  Any permutation is correct."""
    order = _deal_order(sf.shape[1], sf.device)
    return sf[:, order].contiguous(), si[:, order].contiguous()


# ---------------------------------------------------------------------------
# Wrappers: plain on CPU tensors, the kernel on CUDA tensors
# ---------------------------------------------------------------------------


def _cuda_args(scene: Scene, dev, name: str, hot: bool = False):
    if dev.type != "cuda":
        raise ValueError(f"mc_binned.{name}: unsupported device {dev}")
    if not scene.blocked:
        raise ValueError("the binned MC kernels take blocked scenes only")
    if not kernel_textures_ok(scene.textures):
        raise ValueError("the binned MC kernels hold only DEFAULT_TEXTURES")
    tb, bt = scene.tables, scene.blk_tables
    kc.check_tables(tb, dev, bt)
    return kc.kernel_geometry(tb, bt, hot)


def _check_state(sf, si, n, dev):
    kernels.check("sf", sf, torch.float32, (N_F, n), dev)
    kernels.check("si", si, torch.int32, (N_I, n), dev)


def primary(scene: Scene, o_t, d_t, work=None):
    """Primary cast -> (sf, si, casts [N]); o_t, d_t: [3, N] float32.
    `work` (all three wrappers): optional int32 [len(kernels.WORK_ROWS), N],
    filled with each lane's tests by kind (the counting instantiation)."""
    if o_t.device.type == "cpu":
        COUNTS_PRIMARY.plain += 1
        return primary_plain(scene.geom, o_t, d_t)
    return _launch_primary("rt_binned_primary", True, COUNTS_PRIMARY, scene, o_t, d_t, work)


def primary_per_thread(scene: Scene, o_t, d_t, work=None):
    """`primary` on CUDA tensors through the kernel's per-thread
    instantiation.  The cooperative primary must give its state, casts and
    test counts; the walk never calls this."""
    return _launch_primary("rt_binned_primary_thread", False, COUNTS_PRIMARY_THREAD, scene,
                           o_t, d_t, work)


def _launch_primary(entry: str, hot: bool, counts, scene: Scene, o_t, d_t, work):
    """As _launch_bounce, for the primary kernel."""
    dev, n = o_t.device, o_t.shape[1]
    geo = _cuda_args(scene, dev, "primary", hot)
    kernels.check("o_t", o_t, torch.float32, (3, n), dev)
    kernels.check("d_t", d_t, torch.float32, (3, n), dev)
    kernels.check_work(work, n, dev)
    sf = torch.empty((N_F, n), dtype=torch.float32, device=dev)
    si = torch.empty((N_I, n), dtype=torch.int32, device=dev)
    casts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        kernels.launch(entry, o_t, d_t, *geo, sf, si, casts, work, n)
        counts.launches += 1
    return sf, si, casts


def bounce(scene: Scene, sf, si, u, first: bool, max_distance: float,
           max_retries: int, work=None):
    """One deferred-shading bounce -> (sf, si, casts [N]); u: [3, N]
    uniforms in the state's lane order."""
    if sf.device.type == "cpu":
        COUNTS_BOUNCE.plain += 1
        return bounce_plain(scene.geom, scene.textures, sf, si, u, first,
                            max_distance, max_retries)
    return _launch_bounce("rt_binned_bounce", True, COUNTS_BOUNCE, scene, sf, si, u, first,
                          max_distance, max_retries, work)


def bounce_per_thread(scene: Scene, sf, si, u, first: bool, max_distance: float,
                      max_retries: int, work=None):
    """`bounce` on CUDA tensors through the kernel's per-thread instantiation
    (every thread walks its own chunk list out of global memory).  The
    cooperative bounce must give its state, casts and test counts; the walk
    never calls this."""
    return _launch_bounce("rt_binned_bounce_thread", False, COUNTS_BOUNCE_THREAD, scene, sf, si,
                          u, first, max_distance, max_retries, work)


def _launch_bounce(entry: str, hot: bool, counts, scene: Scene, sf, si, u, first,
                   max_distance, max_retries, work):
    """Check the operands and launch C entry `entry` (`hot`: it takes the
    cooperative walk's tables) and advance its launch counter `counts`."""
    dev, n = sf.device, sf.shape[1]
    geo = _cuda_args(scene, dev, "bounce", hot)
    _check_state(sf, si, n, dev)
    kernels.check("u", u, torch.float32, (3, n), dev)
    kernels.check_work(work, n, dev)
    out_f, out_i = torch.empty_like(sf), torch.empty_like(si)
    casts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        kernels.launch(entry, sf, si, u, *geo, out_f, out_i, casts, work, n, int(first),
                       float(max_distance), int(max_retries))
        counts.launches += 1
    return out_f, out_i, casts


def terminal(scene: Scene, sf, si, first: bool, work=None):
    """The last deferred shade + terminal -> (photon [3, N] in the state's
    lane order, casts [N])."""
    if sf.device.type == "cpu":
        COUNTS_TERMINAL.plain += 1
        return terminal_plain(scene.geom, scene.textures, sf, si, first)
    return _launch_terminal("rt_binned_terminal", True, COUNTS_TERMINAL, scene, sf, si, first,
                            work)


def terminal_per_thread(scene: Scene, sf, si, first: bool, work=None):
    """`terminal` on CUDA tensors through the kernel's per-thread
    instantiation.  The cooperative terminal must give its photons, casts
    and test counts; the walk never calls this."""
    return _launch_terminal("rt_binned_terminal_thread", False, COUNTS_TERMINAL_THREAD, scene,
                            sf, si, first, work)


def _launch_terminal(entry: str, hot: bool, counts, scene: Scene, sf, si, first, work):
    """As _launch_bounce, for the terminal kernel."""
    dev, n = sf.device, sf.shape[1]
    geo = _cuda_args(scene, dev, "terminal", hot)
    _check_state(sf, si, n, dev)
    kernels.check_work(work, n, dev)
    photon = torch.empty((3, n), dtype=torch.float32, device=dev)
    casts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        kernels.launch(entry, sf, si, *geo, photon, casts, work, n, int(first))
        counts.launches += 1
    return photon, casts


def trace(scene: Scene, ray_o, ray_d, unifs, depth: int, max_distance: float,
          max_retries: int):
    """Binned per-bounce MC walk of a blocked scene -> (photon [N, 3]
    UNfiltered, casts 0-d tensor); the contract of mc_kernel.trace.
    unifs: [depth, 3, N] in slot (primary ray) order."""
    if not scene.blocked:
        raise ValueError("the binned MC path takes blocked scenes only")
    n = ray_o.shape[0]
    sf, si, c0 = primary(scene, ray_o.t().contiguous(), ray_d.t().contiguous())
    casts = c0.sum()
    for step in range(depth):
        sf, si = deal_lanes(*sort_state(scene, sf, si, unifs[step]))
        u = unifs[step][:, si[I_SLOT].long()].contiguous()  # draws by slot
        sf, si, dc = bounce(scene, sf, si, u, step == 0, max_distance, max_retries)
        casts = casts + dc.sum()
    rows, dc = terminal(scene, sf, si, depth == 0)
    casts = casts + dc.sum()
    # un-permute: scatter-ADD each lane's photon to its slot
    photon = torch.zeros((n, 3), dtype=rows.dtype, device=rows.device)
    photon.index_add_(0, si[I_SLOT].long(), rows.t())
    return photon, casts
