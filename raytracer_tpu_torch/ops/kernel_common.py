"""Building blocks of the kernels, as plain PyTorch.

Counterpart of raytracer_tpu/ops/kernel_common.py:105-894 (the dense
blocks), :894-1786 (the blocked large-mesh blocks and the DenseGeom /
BlockedGeom switch) and intersect_pallas.py:42-85 (the table packers).
These are the plain versions the CUDA kernels are held against:
csrc/common.cuh holds the same blocks as __device__ functions, one thread
per ray.  Here each lane quantity is a 1-D [R] tensor and each (primitive,
lane) quantity a [T, R] tensor; the plain versions run on any device.

The blocked sweeps gate PER LANE, as the kernels do: a lane tests a
supergroup's box, then each of its chunks' boxes, bounded by its current
best hit (or shadow limit), and the chunk's triangles only where its ray
enters the box.  The TPU's per-tile gate (`any(hit_box)` over a 512-lane
tile), its supergroup visit order and its HBM chunk streaming are not
ported: any visit order gives the same hits, and the permuted table stays
in global memory.

The sphere sweeps gate the same way where the scene carries the sphere
chunk table (scene/blocked.py build_sph_chunks; Tables.sph_rows): a lane
tests a supergroup's box, each of its chunks' boxes, and a chunk's spheres
only where its ray enters the box before its current best hit (or shadow
limit).  The hits are the linear sweep's: the least t, ties to the larger
primitive id.  The MC kernel's dense routes gate as these do
(csrc/common.cuh SphGated); the other kernels sweep every sphere.

What differs from the TPU blocks (the TPU workarounds are not ported):
  * torch.acos / torch.atan2 / torch.pow replace the Mosaic polynomials;
  * a gather by winner index replaces the one-hot MXU contraction
    (matmul_cols);
  * `powf` keeps kernel_common.powf's domain rule: base <= 0 gives 0, so
    decay^travel is 0 for decay 0 even at travel 0.

Semantics kept exactly (raytracer_tpu/ops/intersect.py:1-39): face
culling, exclusion by (prim, face), last-wins ties (spheres after
triangles, update on <=), non-finite t is a miss, the 3e38 sentinel, and
the factored-target shadow algebra (_ShadowSweep below).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.scene.blocked import BLK_CHUNK, SPH_CHUNK, SPH_PAD, SPH_SUP, SUP_CHUNKS
from raytracer_tpu_torch.scene.types import FACE_BACK, FACE_FRONT, Scene
from raytracer_tpu_torch.utils.kernels import check

BIG = 3.0e38
F32_EPS = float(np.finfo(np.float32).eps)
_INV_PI = float(np.float32(1.0 / np.pi))
_HALF_INV_PI = float(np.float32(0.5 / np.pi))
_EIGHT_PI = float(np.float32(8.0 * np.pi))

TRI_COLS, SPH_COLS, MAT_COLS, LIGHT_COLS = 34, 8, 16, 16
# A sphere chunk row: pack_sph's columns with the ORIGINAL sphere index in
# column 5 (as float32: exact below 2^24); -1 on a pad row, whose r^2 is -1.
SPH_ID = 5
# Blocked triangle rows: pack_tri's 34 columns, the original triangle id
# (34, as float32: exact below 2^24) and one pad column (a 144-byte row).
BLK_COLS, BLK_ID = 36, 34
# The hot table of the warp-cooperative sweeps: the 16 columns of a blocked
# row that decide a hit (fn 0:3, d 3, g0..g2 4:13, h 13:16), a 64-byte row.
HOT_COLS = 16


class Tables(NamedTuple):
    """Packed scene tables (float32, contiguous, on the scene's device)."""

    tri: torch.Tensor  # [T, 34] pack_tri
    sph: torch.Tensor  # [S, 8] pack_sph
    mat: torch.Tensor  # [O, 16] pack_materials
    lights: torch.Tensor  # [L, 16] pack_lights
    n_tri: int
    n_sph: int
    n_light: int
    # what the dense kernels' staged walks read of `tri`: its first 16
    # columns as 64-byte rows
    hot: torch.Tensor | None = None  # [T, 16]
    # the sphere chunk table (pack_sph_chunks), on scenes that carry one
    sph_rows: torch.Tensor | None = None  # [NCH * SPH_CHUNK, 8] rows in chunk order
    sph_box: torch.Tensor | None = None  # [NCH, 8] chunk AABBs: min xyz 0:3, max xyz 3:6
    sph_sup: torch.Tensor | None = None  # [ceil(NCH / SPH_SUP), 8] supergroup AABBs


def pack_tri(scene: Scene) -> torch.Tensor:
    """[T, 34]: fn(0:3), d(3), g0(4:7), g1(7:10), g2(10:13), h(13:16),
    n0(16:19), n1(19:22), n2(22:25), uv0(25:27), uv1(27:29), uv2(29:31),
    area2(31), obj(32), pad(33)."""
    T = scene.n_tri
    return torch.cat([
        scene.tri_fn, scene.tri_d[:, None],
        scene.tri_g[:, 0, :], scene.tri_g[:, 1, :], scene.tri_g[:, 2, :],
        scene.tri_h,
        scene.tri_n[:, 0, :], scene.tri_n[:, 1, :], scene.tri_n[:, 2, :],
        scene.tri_uv[:, 0, :], scene.tri_uv[:, 1, :], scene.tri_uv[:, 2, :],
        scene.tri_area2[:, None], scene.tri_obj[:, None].float(),
        scene.tri_v.new_zeros((T, 1)),
    ], dim=1).float().contiguous()


def pack_sph(scene: Scene) -> torch.Tensor:
    """[S, 8]: cx, cy, cz, r^2, obj (+3 pad)."""
    S = scene.n_sph
    return torch.cat([
        scene.sph_c, (scene.sph_r ** 2)[:, None], scene.sph_obj[:, None].float(),
        scene.sph_c.new_zeros((S, 3)),
    ], dim=1).float().contiguous()


def pack_materials(scene: Scene) -> torch.Tensor:
    """[O, 16]: diffuse(0:3), shiness(3), specular(4:7), smoothness(7),
    transparency(8), refraction(9), decay(10), normal(11:14), tex_id(14)."""
    O = scene.n_obj
    return torch.cat([
        scene.mat_diffuse, scene.mat_shiness[:, None], scene.mat_specular,
        scene.mat_smoothness[:, None], scene.mat_transparency[:, None],
        scene.mat_refraction[:, None], scene.mat_decay[:, None],
        scene.mat_normal, scene.mat_tex[:, None].float(),
        scene.mat_diffuse.new_zeros((O, 1)),
    ], dim=1).float().contiguous()


def pack_lights(scene: Scene) -> torch.Tensor:
    """[L, 16]: type(0), origin(1:4), dir(4:7), color(7:10), angle(10),
    softness(11), has_origin(12)."""
    L = scene.n_light
    return torch.cat([
        scene.light_type[:, None].float(), scene.light_origin, scene.light_dir,
        scene.light_color, scene.light_angle[:, None],
        scene.light_softness[:, None], scene.light_has_origin[:, None],
        scene.light_origin.new_zeros((L, 3)),
    ], dim=1).float().contiguous()


def pack_sph_chunks(scene: Scene, sph: torch.Tensor):
    """The sphere chunk table from Scene.sph_perm / sph_box and pack_sph's
    rows -> (rows [S_pad, 8]: the rows in chunk order, the original index
    in column SPH_ID; pad rows r^2 -1 and index -1, so no ray hits one;
    box [NCH, 8]; sup [ceil(NCH / SPH_SUP), 8], the union of each
    SPH_SUP chunks' boxes, the last supergroup's of the chunks it has)."""
    perm = scene.sph_perm.long()
    live = perm >= 0
    rows = torch.where(live[:, None], sph[perm.clamp(min=0)], 0.0)
    rows[:, 3] = torch.where(live, rows[:, 3], -1.0)
    rows[:, SPH_ID] = torch.where(live, perm, -1).float()
    box = scene.sph_box.float().contiguous()
    groups = box.split(SPH_SUP)
    sup = torch.stack([torch.cat([g[:, 0:3].amin(dim=0), g[:, 3:6].amax(dim=0),
                                  g.new_zeros(2)]) for g in groups])
    return rows.contiguous(), box, sup.contiguous()


def pack_tables(scene: Scene) -> Tables:
    tri = pack_tri(scene)
    sph = pack_sph(scene)
    chunks = () if scene.sph_perm is None else pack_sph_chunks(scene, sph)
    return Tables(tri, sph, pack_materials(scene), pack_lights(scene),
                  scene.n_tri, scene.n_sph, scene.n_light, tri[:, :HOT_COLS].contiguous(),
                  *chunks)


class BlkTables(NamedTuple):
    """Blocked tables of a large mesh (float32, contiguous, on the scene's
    device), kernel_common.py:891-933."""

    tri: torch.Tensor  # [T_pad, 36] pack_tri_blocked
    box: torch.Tensor  # [NCH, 8] chunk AABBs: min xyz 0:3, max xyz 3:6
    sup: torch.Tensor  # [NCH / 8, 8] supergroup AABBs (pack_sup)
    chunk_of_prim: torch.Tensor  # [T + max(S, 1)] int64: chunk per primitive
    n_chunks: int  # chunks that hold at least one triangle
    # what the warp-cooperative sweeps read (pack_hot); the plain sweeps and
    # the per-thread kernels read `tri` alone
    hot: torch.Tensor | None = None  # [T_pad, 16] columns 0:16 of `tri`
    ids: torch.Tensor | None = None  # [T_pad] int32 original id (-1 = pad row)
    live: torch.Tensor | None = None  # [NCH] int32 live rows of each chunk
    row_of_tri: torch.Tensor | None = None  # [T] int32 blocked row of a triangle


def pack_tri_blocked(scene: Scene, base: torch.Tensor) -> torch.Tensor:
    """[T_pad, 36]: `base` (pack_tri's [T, 34]) in blk_perm order, then the
    ORIGINAL triangle id and a zero pad column.  Pad rows (perm == -1) are
    all zero with id -1: their plane test divides 0/0 and fails."""
    perm = scene.blk_perm.long()
    live = perm >= 0
    rows = torch.where(live[:, None], base[perm.clamp(min=0)], 0.0)
    ids = torch.where(live, perm, -1).float()[:, None]
    return torch.cat([rows, ids, torch.zeros_like(ids)], dim=1).contiguous()


def pack_sup(box: torch.Tensor) -> torch.Tensor:
    """[NCH / 8, 8] supergroup AABBs, the union of SUP_CHUNKS chunk boxes
    (kernel_common.pack_sup8 :920 without the TPU's 8x row replication)."""
    g = box.view(-1, SUP_CHUNKS, 8)
    return torch.cat([g[:, :, 0:3].amin(dim=1), g[:, :, 3:6].amax(dim=1),
                      box.new_zeros((g.shape[0], 2))], dim=1).contiguous()


def pack_hot(tri: torch.Tensor, perm: torch.Tensor, n_tri: int):
    """The cooperative sweeps' tables from the blocked rows `tri` [T_pad, 36]
    and blk_perm -> (hot [T_pad, 16] float32, the columns of a row that
    decide a hit, as 64-byte rows; ids [T_pad] int32, the original triangle
    of each row, -1 on pad rows; live [NCH] int32, each chunk's row count:
    pad rows trail the live ones, so a row loop runs to a bound it knows
    before it starts; row_of_tri [T] int32, the inverse of ids, by which a
    lane finds its excluded triangle's row without reading an id)."""
    perm = perm.long()
    is_live = perm >= 0
    hot = tri[:, :HOT_COLS].contiguous()
    ids = torch.where(is_live, perm, -1).to(torch.int32)
    live = is_live.view(-1, BLK_CHUNK).sum(dim=1).to(torch.int32)
    rows = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    row_of_tri = torch.zeros(n_tri, dtype=torch.int32, device=perm.device)
    row_of_tri[perm[is_live]] = rows[is_live]
    return hot, ids, live, row_of_tri


def pack_blocked(scene: Scene) -> BlkTables:
    box = scene.blk_box.float().contiguous()
    tri = pack_tri_blocked(scene, scene.tables.tri)
    hot, ids, live, row_of_tri = pack_hot(tri, scene.blk_perm, scene.n_tri)
    chunk_of_tri = row_of_tri.long() // BLK_CHUNK
    chunk_of_prim = torch.cat([chunk_of_tri, box.shape[0] + torch.arange(
        max(scene.n_sph, 1), dtype=torch.int64, device=box.device)])
    return BlkTables(tri, box, pack_sup(box), chunk_of_prim,
                     -(-scene.n_tri // BLK_CHUNK), hot, ids, live, row_of_tri)


# ---------------------------------------------------------------------------
# Small vector helpers on (x, y, z) tuples of [R] tensors
# ---------------------------------------------------------------------------


def powf(base, expo):
    """base**expo with kernel_common.powf's rule: 0 wherever base <= 0."""
    r = torch.pow(torch.clamp_min(base, 1e-37), expo)
    return torch.where(base <= 0.0, 0.0, r)


def normalize3(x, y, z):
    inv = torch.rsqrt(torch.clamp_min(x * x + y * y + z * z, 1e-30))
    return x * inv, y * inv, z * inv


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def rotate_from_z(nx, ny, nz, vx, vy, vz):
    """Rotation taking +z onto n, applied to v (utils/vec.rotate_from_z)."""
    qw = 1.0 + nz
    qx = -ny
    qy = nx
    q2 = torch.clamp_min(qw * qw + qx * qx + qy * qy, 1e-12)
    tx = qy * vz + qw * vx
    ty = -qx * vz + qw * vy
    tz = qx * vy - qy * vx + qw * vz
    s = 2.0 / q2
    rx = vx + s * (qy * tz)
    ry = vy + s * (-(qx * tz))
    rz = vz + s * (qx * ty - qy * tx)
    anti = nz < -1.0 + 1e-6
    return (torch.where(anti, -vx, rx), torch.where(anti, vy, ry),
            torch.where(anti, -vz, rz))


def reflect3(dx, dy, dz, nx, ny, nz):
    """l - 2 (l.n) n, normalized (main.rs:329)."""
    dn = dot3(dx, dy, dz, nx, ny, nz)
    return normalize3(dx - 2.0 * dn * nx, dy - 2.0 * dn * ny, dz - 2.0 * dn * nz)


def refract3(nx, ny, nz, dx, dy, dz, k):
    """Snell refraction (src/main.rs:344-352) -> (tx, ty, tz, ok);
    ok=False is total internal reflection."""
    cos = -(dx * nx + dy * ny + dz * nz)
    sin2 = 1.0 - cos * cos
    ok = k * k >= sin2
    root = torch.sqrt(torch.clamp_min(1.0 - sin2 / (k * k), 0.0))
    tx = (dx + nx * cos) / k - nx * root
    ty = (dy + ny * cos) / k - ny * root
    tz = (dz + nz * cos) / k - nz * root
    tx, ty, tz = normalize3(tx, ty, tz)
    return tx, ty, tz, ok


def _col(table, c):
    return table[:, c:c + 1]


def _excl_crit(excl_face, backface):
    is_front = excl_face == FACE_FRONT
    is_back = excl_face == FACE_BACK
    return (is_front & ~backface) | (is_back & backface) | (~is_front & ~is_back)


def _winner(tm, rows):
    """Nearest of [P, R] candidate t's (BIG = none), last index on ties."""
    t_min = tm.min(dim=0).values
    win = torch.where(tm == t_min, rows, -1).max(dim=0).values
    return t_min, win


def _gather_rows(table, idx, hit):
    """Winner's table row per lane, zeros where `hit` is False (the one-hot
    contraction's result for a lane with no winner in this table)."""
    rows = table[idx.clamp(0, table.shape[0] - 1).long()]
    return torch.where(hit[:, None], rows, 0.0)


# ---------------------------------------------------------------------------
# Nearest sweep with all attributes (World::cast)
# ---------------------------------------------------------------------------


def tri_candidates(o, d, face, excl_prim, excl_face, active, tb: Tables):
    """Every triangle's candidate t per lane (intersect_pallas._tri_sweep
    :97) -> (tm [T, R], BIG where the triangle is no valid hit; backface
    [T, R])."""
    ox, oy, oz = o
    dx, dy, dz = d
    tri = tb.tri
    fn0, fn1, fn2 = _col(tri, 0), _col(tri, 1), _col(tri, 2)
    no_d = fn0 * dx + fn1 * dy + fn2 * dz
    backface = no_d > 0.0
    cull = (backface & (face == FACE_FRONT)) | (~backface & (face == FACE_BACK))
    t = (_col(tri, 3) - (fn0 * ox + fn1 * oy + fn2 * oz)) / no_d
    prim = torch.arange(tb.n_tri, dtype=torch.int32, device=ox.device)[:, None]
    excl = (excl_prim == prim) & _excl_crit(excl_face, backface)
    ok = active & ~cull & ~excl & (t > 0.0)
    for e in range(3):
        g0, g1, g2 = _col(tri, 4 + 3 * e), _col(tri, 5 + 3 * e), _col(tri, 6 + 3 * e)
        h = _col(tri, 13 + e)
        og = g0 * ox + g1 * oy + g2 * oz
        dg = g0 * dx + g1 * dy + g2 * dz
        ok = ok & (og + h + t * dg >= 0.0)
    ok = ok & torch.isfinite(t)
    return torch.where(ok, t, BIG), backface


def _sph_terms(sph, o, d):
    """Sphere rows `sph` [K, 8] against the rays o + t d: the squared
    distance of each centre from each ray, the t of its closest approach and
    the half chord (main.rs:255-281; csrc/common.cuh sph_ray) -> [K, R]
    each."""
    (ox, oy, oz), (dx, dy, dz) = o, d
    wx, wy, wz = _col(sph, 0) - ox, _col(sph, 1) - oy, _col(sph, 2) - oz
    qx = wy * dz - wz * dy
    qy = wz * dx - wx * dz
    qz = wx * dy - wy * dx
    dist2 = qx * qx + qy * qy + qz * qz
    tc = dx * wx + dy * wy + dz * wz
    return dist2, tc, torch.sqrt(torch.clamp_min(_col(sph, 3) - dist2, 0.0))


def _sph_blocks(tb: Tables, o, d, tmax_fn, gate):
    """The sphere rows a sweep tests for lanes `gate`: yields (rows [K, 8],
    ids [K, 1] int32, the spheres' indices, -1 on a pad row; the [R] mask
    of lanes that test them).  Linear: every sphere at once, for gate();
    over the sphere chunk table: each chunk whose boxes a lane's ray enters
    within tmax_fn() (_sph_chunks)."""
    if tb.sph_rows is None:
        if tb.n_sph > 0:
            yield tb.sph, torch.arange(tb.n_sph, dtype=torch.int32,
                                       device=tb.sph.device)[:, None], gate()
        return
    for c, enter in _sph_chunks(tb, o, d, tmax_fn, gate):
        rows = tb.sph_rows[c * SPH_CHUNK:(c + 1) * SPH_CHUNK]
        yield rows, _col(rows, SPH_ID).to(torch.int32), enter


def sph_candidates(o, d, face, excl_prim, excl_face, active, tb: Tables):
    """Every sphere's candidate t per lane (intersect_pallas._sph_sweep
    :127) -> (tm [S, R], BIG where invalid; backface [S, R])."""
    prim = tb.n_tri + torch.arange(tb.n_sph, dtype=torch.int32, device=o[0].device)[:, None]
    return _sph_rows_candidates(o, d, face, excl_prim, excl_face, active, tb.sph, prim)


def _sph_rows_candidates(o, d, face, excl_prim, excl_face, active, sph, prim):
    """sph_candidates over sphere rows `sph` [K, 8] of primitive ids `prim`
    [K, 1] -> (tm [K, R], backface [K, R])."""
    dist2, tc, kk = _sph_terms(sph, o, d)
    is_back = face == FACE_BACK
    is_front = face == FACE_FRONT
    backface = is_back | (~is_front & ~is_back & (tc < kk))
    t = torch.where(backface, tc + kk, tc - kk)
    excl = (excl_prim == prim) & _excl_crit(excl_face, backface)
    ok = active & (dist2 <= _col(sph, 3)) & (t > 0.0) & ~excl & torch.isfinite(t)
    return torch.where(ok, t, BIG), backface


def _tri_nearest(o, d, face, excl_prim, excl_face, active, tb: Tables):
    """Nearest triangle per lane -> (best_t BIG on a miss, best_i -1,
    best_bf)."""
    R = o[0].shape[0]
    dev = o[0].device
    best_t = torch.full((R,), BIG, device=dev)
    best_i = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_bf = torch.zeros((R,), dtype=torch.bool, device=dev)
    if tb.n_tri > 0:
        tm, backface = tri_candidates(o, d, face, excl_prim, excl_face, active, tb)
        prim = torch.arange(tb.n_tri, dtype=torch.int32, device=dev)[:, None]
        t_min, win = _winner(tm, prim)
        found = t_min < BIG
        bf = torch.gather(backface, 0, win.clamp(min=0).long()[None])[0] & (win >= 0)
        best_t = torch.where(found, t_min, best_t)
        best_i = torch.where(found, win, best_i)
        best_bf = torch.where(found, bf, best_bf)
    return best_t, best_i, best_bf


def _sph_nearest(o, d, face, excl_prim, excl_face, active, tb: Tables,
                 best_t, best_i, best_bf):
    """Spheres after the triangles: the least t wins, ties to the larger
    primitive id, a sphere's being above every triangle's (so a sphere wins
    an exact tie, as an update on <= in index order gives); a block of
    spheres at a time (_sph_blocks), the same winners in any order."""
    for rows, ids, enter in _sph_blocks(tb, o, d, lambda: best_t, lambda: active):
        _sph_tests(enter, (ids >= 0).sum())
        prim = tb.n_tri + ids
        tm, backface = _sph_rows_candidates(o, d, face, excl_prim, excl_face, enter, rows, prim)
        t_min, win = _winner(tm, prim)
        loc = torch.where(prim == win, torch.arange(rows.shape[0], device=tm.device)[:, None],
                          -1).max(dim=0).values.clamp(min=0)
        bf = torch.gather(backface, 0, loc[None])[0]
        better = (t_min < BIG) & ((t_min < best_t) | ((t_min == best_t) & (win > best_i)))
        best_t = torch.where(better, t_min, best_t)
        best_i = torch.where(better, win, best_i)
        best_bf = torch.where(better, bf, best_bf)
    return best_t, best_i, best_bf


def nearest_sweep(o, d, face, excl_prim, excl_face, active, tb: Tables):
    """Nearest t, primitive and backface per lane over the dense tables,
    without attributes (intersect_pallas._kernel :172): last index wins
    among equal t, a sphere beats a triangle at equal t.  Returns (t [R],
    BIG on a miss; prim [R] int32, -1; backface [R] bool)."""
    best = _tri_nearest(o, d, face, excl_prim, excl_face, active, tb)
    return _sph_nearest(o, d, face, excl_prim, excl_face, active, tb, *best)


def full_sweep(o, d, face, excl_prim, excl_face, active, tb: Tables):
    """Nearest hit with attributes (kernel_common.full_sweep :238).

    o/d: (x, y, z) tuples of [R]; face/excl_prim/excl_face: [R] int32;
    active: [R] bool.  Returns dict(valid, t, prim, obj, backface, px, py,
    pz, nx, ny, nz, u, v), all [R]."""
    best_t, best_i, best_bf = _tri_nearest(o, d, face, excl_prim, excl_face, active, tb)
    return _finish_hit(o, d, face, excl_prim, excl_face, active, tb,
                       best_t, best_i, best_bf, tb.tri, best_i)


def _finish_hit(o, d, face, excl_prim, excl_face, active, tb: Tables,
                best_t, best_i, best_bf, tri_rows, tri_row):
    """Spheres after the triangles (they win exact ties), then the winner's
    attributes."""
    best_t, best_i, best_bf = _sph_nearest(o, d, face, excl_prim, excl_face, active,
                                           tb, best_t, best_i, best_bf)
    return hit_attributes(o, d, active, tb, best_t, best_i, best_bf, tri_rows, tri_row)


def hit_attributes(o, d, active, tb: Tables, best_t, best_i, best_bf,
                   tri_rows, tri_row):
    """The winner's hit point, shading normal, uv and object, by gathers.
    best_t is BIG on a miss.  tri_rows[tri_row] is the winning triangle's
    packed row (the dense table by prim id, or the blocked table by blocked
    row).  Returns full_sweep's dict."""
    ox, oy, oz = o
    dx, dy, dz = d
    n_tri, n_sph = tb.n_tri, tb.n_sph
    valid = best_t < BIG
    t_hit = torch.where(valid, best_t, 0.0)
    px, py, pz = ox + t_hit * dx, oy + t_hit * dy, oz + t_hit * dz
    zero = torch.zeros_like(px)
    nx, ny, nz, u, v, obj = zero, zero, zero, zero, zero, zero

    if n_tri > 0:
        is_tri = (best_i >= 0) & (best_i < n_tri)
        row = _gather_rows(tri_rows, tri_row, is_tri)
        col = lambda c: row[:, c]
        area2 = col(31)
        inv_a2 = 1.0 / torch.where(area2 != 0.0, area2, 1.0)
        for e in range(3):
            bary = (col(4 + 3 * e) * px + col(5 + 3 * e) * py
                    + col(6 + 3 * e) * pz + col(13 + e)) * inv_a2
            nx = nx + bary * col(16 + 3 * e)
            ny = ny + bary * col(17 + 3 * e)
            nz = nz + bary * col(18 + 3 * e)
            u = u + bary * col(25 + 2 * e)
            v = v + bary * col(26 + 2 * e)
        flip = torch.where(best_bf, -1.0, 1.0)
        nx, ny, nz = nx * flip, ny * flip, nz * flip
        obj = col(32)

    if n_sph > 0:
        is_sph = best_i >= n_tri if n_tri > 0 else valid
        row = _gather_rows(tb.sph, best_i - n_tri, is_sph)
        sx, sy, sz = normalize3(px - row[:, 0], py - row[:, 1], pz - row[:, 2])
        sflip = torch.where(best_bf, -1.0, 1.0)
        sx, sy, sz = sx * sflip, sy * sflip, sz * sflip
        su = torch.acos(torch.clamp(sy, -1.0, 1.0)) * _INV_PI
        sv = torch.atan2(sz, sx) * _HALF_INV_PI + 0.5
        nx = torch.where(is_sph, sx, nx)
        ny = torch.where(is_sph, sy, ny)
        nz = torch.where(is_sph, sz, nz)
        u = torch.where(is_sph, su, u)
        v = torch.where(is_sph, sv, v)
        obj = torch.where(is_sph, row[:, 4], obj)

    valid = valid & active
    return dict(
        valid=valid,
        t=torch.where(valid, best_t, BIG),
        prim=best_i,
        obj=(obj + 0.5).to(torch.int32),
        backface=best_bf & valid,
        px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz, u=u, v=v,
    )


# ---------------------------------------------------------------------------
# Material evaluation
# ---------------------------------------------------------------------------


def eval_material(tb: Tables, textures, obj, u, v):
    """Per-lane material sample from the packed [O, 16] table + textures
    (kernel_common.eval_material :400); a gather by object id."""
    row = tb.mat[obj.long()]
    col = lambda c: row[:, c]
    out = dict(
        dr=col(0), dg=col(1), db=col(2), shiness=col(3),
        sr=col(4), sg=col(5), sb=col(6), smoothness=col(7),
        transparency=col(8), refraction=col(9), decay=col(10),
        tnx=col(11), tny=col(12), tnz=col(13),
    )
    tex = (col(14) + 0.5).to(torch.int32)
    for k in range(1, len(textures)):
        sel = tex == k
        tr, tg, tbl = textures[k].diffuse_rows(u, v)
        nxr, nyr, nzr = textures[k].normal_rows(u, v)
        for key, val in (("dr", tr), ("dg", tg), ("db", tbl),
                         ("tnx", nxr), ("tny", nyr), ("tnz", nzr)):
            out[key] = torch.where(sel, val, out[key])
    return out


# ---------------------------------------------------------------------------
# Direct shading with shadow sweeps
# ---------------------------------------------------------------------------


class _ShadowSweep:
    """Shadow any-hit for rays that share their origin (the shading point),
    kernel_common._ShadowSweep :446.

    Triangles use the FACTORED-TARGET algebra: with the unnormalized
    direction d = L - p (position lights, s=1) or d = -light_dir
    (directional, s=0), every direction-dependent dot product factors
    through per-triangle constants of the target t = (tx, ty, tz):

        no_d = c_fn - s * o_fn,    c_fn = fn.t
        edge_e: ogh_e + t * (c_g_e - s * ogh_e) >= 0,  c_g_e = g_e.t + s h_e
        t    = (dpl - o_fn) / no_d, occluder iff t in (0, tlim)

    with tlim = 1 for position lights (scaled units) and the real limit
    for directional ones.  Spheres use the normalized direction and the
    real-unit limit."""

    def __init__(self, px, py, pz, self_prim, tb: Tables):
        self.tb = tb
        self.px, self.py, self.pz = px, py, pz
        dev = px.device
        if tb.n_tri > 0:
            tri = tb.tri
            fn0, fn1, fn2 = _col(tri, 0), _col(tri, 1), _col(tri, 2)
            self.o_fn = fn0 * px + fn1 * py + fn2 * pz
            self.num = _col(tri, 3) - self.o_fn
            self.num_pos = self.num > 0.0
            self.ogh = [
                _col(tri, 4 + 3 * e) * px + _col(tri, 5 + 3 * e) * py
                + _col(tri, 6 + 3 * e) * pz + _col(tri, 13 + e)
                for e in range(3)
            ]
            prim = torch.arange(tb.n_tri, dtype=torch.int32, device=dev)[:, None]
            self.not_self_tri = self_prim != prim
        self.sph = _SphShadow(px, py, pz, self_prim, tb)

    def _tri_blocked(self, lt):
        tri = self.tb.tri
        s, tx, ty, tz = lt["s"], lt["tx"], lt["ty"], lt["tz"]
        c_fn = _col(tri, 0) * tx + _col(tri, 1) * ty + _col(tri, 2) * tz
        no_d = c_fn - s * self.o_fn
        t = self.num / no_d
        ok = (no_d > 0.0) & self.num_pos & self.not_self_tri
        for e in range(3):
            c_g = (_col(tri, 4 + 3 * e) * tx + _col(tri, 5 + 3 * e) * ty
                   + _col(tri, 6 + 3 * e) * tz + s * _col(tri, 13 + e))
            ok = ok & (self.ogh[e] + t * (c_g - s * self.ogh[e]) >= 0.0)
        ok = ok & lt["act"] & torch.isfinite(t) & (t < lt["tlim"])
        return ok.any(dim=0)

    def blocked(self, lt):
        if self.tb.n_tri == 0:
            return self.sph.blocked(lt, lt["act"])
        tri = self._tri_blocked(lt)
        return tri | self.sph.blocked(lt, lt["act"] & ~tri)


class _SphShadow:
    """The spheres' part of a shadow sweep from shared origins p (dense
    and blocked scenes alike): normalized direction, real-unit limit."""

    def __init__(self, px, py, pz, self_prim, tb: Tables):
        self.tb = tb
        self.p = (px, py, pz)
        self.self_j = (self_prim - tb.n_tri).long()
        self.none = torch.zeros_like(px, dtype=torch.bool)

    def blocked(self, lt, tested):
        """Lanes of `tested` whose shadow ray toward light `lt` a sphere
        occludes.  tested: the lanes that the kernels sweep the spheres for
        (the ray considered and no triangle occluding it), counted where
        count_sph_tests is counting: the spheres in row order, the shading
        point's own left out, up to the first occluder, where the lane
        leaves the sweep."""
        nd = (lt["ndx"], lt["ndy"], lt["ndz"])
        found = self.none
        for rows, ids, enter in _sph_blocks(self.tb, self.p, nd, lambda: lt["slim"],
                                            lambda: tested & ~found):
            dist2, tc, kk = _sph_terms(rows, self.p, nd)
            t = tc + kk  # shadow rays are Back-face rays: far shell
            own = (ids >= 0) & (ids == self.self_j)
            ok = ((dist2 <= _col(rows, 3)) & (t > 0.0) & ~own & torch.isfinite(t)
                  & (t < lt["slim"]) & enter)
            occluded = ok.any(dim=0)
            if _sph_log is not None:
                end = torch.where(occluded, ok.to(torch.int8).argmax(dim=0) + 1,
                                  (ids >= 0).sum())
                local = torch.arange(rows.shape[0], device=ok.device)[:, None]
                _sph_tests(enter, end - (own & (local < end)).any(dim=0).long())
            found = found | occluded
        return found


def get_shade(m, geom, px, py, pz, nax, nay, naz, vdx, vdy, vdz,
              active, self_prim):
    """Direct radiance at a hit batch (kernel_common.get_shade :564).

    m: eval_material output; geom: a DenseGeom / BlockedGeom (Scene.geom);
    (nax, nay, naz): the bump-ADJUSTED normal; (vdx, vdy, vdz):
    view = -ray_d.  Returns (r, g, b, count) with count the per-lane
    number of shadow rays cast."""
    tb = geom.tb
    r = torch.zeros_like(px)
    g = torch.zeros_like(px)
    b = torch.zeros_like(px)
    count = torch.zeros(px.shape, dtype=torch.int32, device=px.device)
    sweep = geom.shadow_sweep(px, py, pz, self_prim)

    e = 1.0 / (m["smoothness"] + F32_EPS)
    energy = (e + 8.0) / _EIGHT_PI

    with _shared_pass():  # the lights of one shading point share their chunks
        for li in range(tb.n_light):
            L = tb.lights[li]
            ltype = L[0]
            LOX, LOY, LOZ = L[1], L[2], L[3]
            LDX, LDY, LDZ = L[4], L[5], L[6]
            LCR, LCG, LCB = L[7], L[8], L[9]
            ANGLE, SOFT, HAS_O = L[10], L[11], L[12]

            # approximate_into_directional (lights.rs:44-93)
            offx, offy, offz = px - LOX, py - LOY, pz - LOZ
            mag = torch.sqrt(offx * offx + offy * offy + offz * offz)
            inv_mag = 1.0 / torch.clamp_min(mag, 1e-30)
            odx, ody, odz = offx * inv_mag, offy * inv_mag, offz * inv_mag
            cos_ang = (LDX * offx + LDY * offy + LDZ * offz) * inv_mag
            angle = torch.abs(torch.acos(torch.clamp(cos_ang, -1.0, 1.0)))
            in_cone = angle <= ANGLE
            ang_att = powf(torch.clamp_min(1.0 - angle / torch.clamp_min(ANGLE, 1e-30), 0.0),
                           SOFT + F32_EPS)
            dist_att = 1.0 / (mag + F32_EPS)

            is_dir = ltype == 0.0
            is_spot = ltype == 1.0
            att = torch.where(is_dir, 1.0, torch.where(is_spot, ang_att * dist_att, dist_att))
            ldx = torch.where(is_dir, LDX, odx)
            ldy = torch.where(is_dir, LDY, ody)
            ldz = torch.where(is_dir, LDZ, odz)
            lvalid = ~is_spot | in_cone

            cosine = -(ldx * nax + ldy * nay + ldz * naz)
            consider = active & lvalid & (cosine > 0.0)
            limit = torch.where(HAS_O > 0.5, mag, BIG)
            s = torch.where(is_dir, 0.0, 1.0)
            occ = dict(
                s=s,
                tx=torch.where(is_dir, -LDX, LOX),
                ty=torch.where(is_dir, -LDY, LOY),
                tz=torch.where(is_dir, -LDZ, LOZ),
                tlim=torch.where(is_dir, limit, 1.0),
                ndx=-ldx, ndy=-ldy, ndz=-ldz,
                slim=limit, act=consider,
            )
            count = count + consider.to(torch.int32)
            lit = consider & ~sweep.blocked(occ)

            # get_diffuse / get_specular (materials.rs:46-66)
            lam = cosine
            refx = 2.0 * lam * nax + ldx
            refy = 2.0 * lam * nay + ldy
            refz = 2.0 * lam * naz + ldz
            amount = powf(torch.clamp_min(refx * vdx + refy * vdy + refz * vdz, 0.0), e) * energy
            dterm = lam * (1.0 - m["shiness"])
            sterm = amount * m["shiness"]
            r = r + torch.where(lit, (m["dr"] * dterm + m["sr"] * sterm) * LCR * att, 0.0)
            g = g + torch.where(lit, (m["dg"] * dterm + m["sg"] * sterm) * LCG * att, 0.0)
            b = b + torch.where(lit, (m["db"] * dterm + m["sb"] * sterm) * LCB * att, 0.0)

    return r, g, b, count


# ---------------------------------------------------------------------------
# Interior march (get_refract)
# ---------------------------------------------------------------------------


def back_sweep_with_normal(px, py, pz, dx, dy, dz, active, tb: Tables):
    """Back-face nearest sweep + interior shading normal
    (kernel_common.back_sweep_with_normal :680).  No exclusion (a provable
    no-op for interior rays).  Returns (t [R] BIG on miss, prim, hx, hy,
    hz, nx, ny, nz) with the flipped, unnormalized interpolated normal."""
    R = px.shape[0]
    dev = px.device
    best_t = torch.full((R,), BIG, device=dev)
    best_i = torch.full((R,), -1, dtype=torch.int32, device=dev)

    if tb.n_tri > 0:
        tri = tb.tri
        fn0, fn1, fn2 = _col(tri, 0), _col(tri, 1), _col(tri, 2)
        no_d = fn0 * dx + fn1 * dy + fn2 * dz
        t = (_col(tri, 3) - (fn0 * px + fn1 * py + fn2 * pz)) / no_d
        ok = (no_d > 0.0) & (t > 0.0)
        for e in range(3):
            g0, g1, g2 = _col(tri, 4 + 3 * e), _col(tri, 5 + 3 * e), _col(tri, 6 + 3 * e)
            og = g0 * px + g1 * py + g2 * pz
            dg = g0 * dx + g1 * dy + g2 * dz
            ok = ok & (og + _col(tri, 13 + e) + t * dg >= 0.0)
        ok = ok & active & torch.isfinite(t)
        prim = torch.arange(tb.n_tri, dtype=torch.int32, device=dev)[:, None]
        t_min, win = _winner(torch.where(ok, t, BIG), prim)
        found = t_min < BIG
        best_t = torch.where(found, t_min, best_t)
        best_i = torch.where(found, win, best_i)
    return _finish_back((px, py, pz), (dx, dy, dz), active, tb, best_t, best_i,
                        tb.tri, best_i)


def _finish_back(p, d, active, tb: Tables, best_t, best_i, tri_rows, tri_row):
    """Spheres' far shells after the triangles, then the hit point and the
    flipped interior normal (tri_rows[tri_row] is the winner's row)."""
    px, py, pz = p
    dx, dy, dz = d
    n_tri, n_sph = tb.n_tri, tb.n_sph
    for rows, ids, enter in _sph_blocks(tb, p, d, lambda: best_t, lambda: active):
        _sph_tests(enter, (ids >= 0).sum())
        dist2, tc, kk = _sph_terms(rows, p, d)
        t = tc + kk  # Back rays take the far shell (main.rs:273-281)
        ok = enter & (dist2 <= _col(rows, 3)) & (t > 0.0) & torch.isfinite(t)
        t_min, win = _winner(torch.where(ok, t, BIG), n_tri + ids)
        better = (t_min < BIG) & ((t_min < best_t) | ((t_min == best_t) & (win > best_i)))
        best_t = torch.where(better, t_min, best_t)
        best_i = torch.where(better, win, best_i)

    hx, hy, hz = px + best_t * dx, py + best_t * dy, pz + best_t * dz
    zero = torch.zeros_like(px)
    nx, ny, nz = zero, zero, zero

    if n_tri > 0:
        is_tri = (best_i >= 0) & (best_i < n_tri)
        row = _gather_rows(tri_rows, tri_row, is_tri)
        col = lambda c: row[:, c]
        area2 = col(31)
        inv_a2 = 1.0 / torch.where(area2 != 0.0, area2, 1.0)
        for e in range(3):
            bary = (col(4 + 3 * e) * hx + col(5 + 3 * e) * hy
                    + col(6 + 3 * e) * hz + col(13 + e)) * inv_a2
            nx = nx + bary * col(16 + 3 * e)
            ny = ny + bary * col(17 + 3 * e)
            nz = nz + bary * col(18 + 3 * e)
        nx, ny, nz = -nx, -ny, -nz  # backface hit: flipped

    if n_sph > 0:
        is_sph = best_i >= n_tri if n_tri > 0 else best_i >= 0
        row = _gather_rows(tb.sph, best_i - n_tri, is_sph)
        wx, wy, wz = hx - row[:, 0], hy - row[:, 1], hz - row[:, 2]
        inv = torch.rsqrt(torch.clamp_min(wx * wx + wy * wy + wz * wz, 1e-30))
        nx = torch.where(is_sph, -wx * inv, nx)
        ny = torch.where(is_sph, -wy * inv, ny)
        nz = torch.where(is_sph, -wz * inv, nz)

    return best_t, best_i, hx, hy, hz, nx, ny, nz


def march_rows(px, py, pz, nx0, ny0, nz0, dx0, dy0, dz0, k, want,
               geom, max_distance: float, max_retries: int):
    """The whole get_refract march (src/main.rs:343-405,
    kernel_common.march_rows :783): entry refraction, the interior
    reflective bounce loop (bounded by retries and distance budget), exit
    refraction.  Returns dict(escaped, travel, ex, ey, ez, odx, ody, odz,
    prim, iters) — iters counts casts incl. the entry cast.  Misses inside
    the dielectric and trapped rays give escaped=False.  geom: a DenseGeom
    / BlockedGeom (Scene.geom)."""
    rx, ry, rz, ok_in = refract3(nx0, ny0, nz0, dx0, dy0, dz0, k)
    active0 = want & ok_in  # TIR at entry -> Trapped (main.rs:354-358)
    t, prim, hx, hy, hz, nix, niy, niz = geom.back(px, py, pz, rx, ry, rz, active0)
    alive = active0 & (t < BIG)  # miss -> Infinite -> dead
    travel = torch.where(alive, t, 0.0)
    ox, oy, oz, has_out = refract3(nix, niy, niz, rx, ry, rz, 1.0 / k)
    has_out = alive & has_out
    s = dict(cx=hx, cy=hy, cz=hz, nx=nix, ny=niy, nz=niz, dx=rx, dy=ry, dz=rz,
             ox=ox, oy=oy, oz=oz, prim=prim, travel=travel)
    retry = torch.zeros_like(prim)
    iters = torch.zeros_like(prim)

    def pending():
        return alive & ~has_out & (s["travel"] <= max_distance) & (retry < max_retries)

    p = pending()
    while bool(p.any()):
        # get_reflect on the interior hit (main.rs:380)
        fx, fy, fz = reflect3(s["dx"], s["dy"], s["dz"], s["nx"], s["ny"], s["nz"])
        t2, prim2, hx2, hy2, hz2, nx2, ny2, nz2 = geom.back(
            s["cx"], s["cy"], s["cz"], fx, fy, fz, p)
        step_alive = p & (t2 < BIG)
        travel2 = s["travel"] + torch.where(step_alive, t2, 0.0)
        ox2, oy2, oz2, ok2 = refract3(nx2, ny2, nz2, fx, fy, fz, 1.0 / k)
        new = dict(cx=hx2, cy=hy2, cz=hz2, nx=nx2, ny=ny2, nz=nz2, dx=fx, dy=fy,
                   dz=fz, ox=ox2, oy=oy2, oz=oz2, prim=prim2, travel=travel2)
        s = {key: torch.where(step_alive, new[key], s[key]) for key in s}
        alive = (p & step_alive) | (~p & alive)
        has_out = (step_alive & ok2) | (~step_alive & has_out)
        retry = retry + p.to(torch.int32)
        iters = iters + p.to(torch.int32)
        p = pending()

    return dict(
        escaped=alive & has_out, travel=s["travel"],
        ex=s["cx"], ey=s["cy"], ez=s["cz"],
        odx=s["ox"], ody=s["oy"], odz=s["oz"],
        prim=s["prim"], iters=iters + active0.to(torch.int32),
    )


def shade_at(geom, m, px, py, pz, nx, ny, nz, rdx, rdy, rdz,
             active, self_prim):
    """get_shade at a hit with its material sample: bump-adjust the normal,
    view = -ray direction."""
    nax, nay, naz = rotate_from_z(nx, ny, nz, m["tnx"], m["tny"], m["tnz"])
    return get_shade(m, geom, px, py, pz, nax, nay, naz, -rdx, -rdy, -rdz,
                     active, self_prim)


# ---------------------------------------------------------------------------
# Blocked large-mesh sweeps (kernel_common.py:978-1707)
# ---------------------------------------------------------------------------


def slab(box, ox, oy, oz, ix, iy, iz, tmax):
    """Ray-AABB slab test per lane (kernel_common._slab_rows :978).

    box: an [8] row (min xyz 0:3, max xyz 3:6); (ix, iy, iz) = 1/d, +-inf
    on axis-parallel rays; bounded by tmax (the lane's current best hit or
    shadow limit), inclusive, so an equal-t hit in a later chunk can still
    win.  minimum/maximum propagate NaN, so a ray lying in a box face's
    plane with a zero direction component (0 * inf) misses, as in
    ops/intersect_bvh.py:97-102."""
    return slab_from(box, (ox, oy, oz), (ox, oy, oz), (ix, iy, iz), tmax)


def slab_from(box, lo, hi, inv, tmax):
    """slab() measuring the box's min faces from origin `lo` and its max
    faces from `hi`: with lo = o + w and hi = o - w, the box widened by w
    (the sphere gate's slack, _sph_gate)."""
    (lx, ly, lz), (hx, hy, hz), (ix, iy, iz) = lo, hi, inv
    t0x, t1x = (box[0] - lx) * ix, (box[3] - hx) * ix
    t0y, t1y = (box[1] - ly) * iy, (box[4] - hy) * iy
    t0z, t1z = (box[2] - lz) * iz, (box[5] - hz) * iz
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    return (tn <= torch.minimum(tf, torch.as_tensor(tmax, device=tf.device))) & (tf >= 0.0)


class ChunkLog:
    """What the blocked plain sweeps of R lanes entered while it was the
    active log (count_chunks): the plain version of the kernels' two
    traversal counters (utils/kernels.py WORK_ROWS).

    lane [R]: per lane, the chunks whose rows one of its rays tested (a
    shading point's rays to several lights count one each): `chunk`.
    group[g] [ceil(R / g)]: per g consecutive lanes, the chunks that any of
    their rays entered in one pass: with g = 32, what a warp of the
    cooperative kernels stages, `wchunk`.  A pass is one nearest or interior
    sweep, or the shadow sweeps to all lights of one shading point."""

    def __init__(self, n_lanes: int, device, groups=(32,)):
        self.lane = torch.zeros(n_lanes, dtype=torch.int64, device=device)
        self.group = {g: torch.zeros(-(-n_lanes // g), dtype=torch.int64, device=device)
                      for g in groups}
        self._pass = None  # chunk -> lanes that entered it in the open pass

    def enter(self, c: int, lanes: torch.Tensor) -> None:
        self.lane += lanes
        if self._pass is None:
            self._staged(lanes)
        else:
            self._pass[c] = self._pass[c] | lanes if c in self._pass else lanes

    def _staged(self, lanes: torch.Tensor) -> None:
        for g, acc in self.group.items():
            pad = acc.shape[0] * g - lanes.shape[0]
            acc += torch.nn.functional.pad(lanes, (0, pad)).view(-1, g).any(dim=1)

    @contextlib.contextmanager
    def one_pass(self):
        """Sweeps inside share their chunks: each chunk counts once a group."""
        self._pass = {}
        try:
            yield
        finally:
            for lanes in self._pass.values():
                self._staged(lanes)
            self._pass = None


_chunk_log: ChunkLog | None = None


@contextlib.contextmanager
def count_chunks(n_lanes: int, device="cpu", groups=(32,)):
    """Log the chunks that the blocked plain sweeps enter inside the block
    -> the ChunkLog.  Every sweep inside must run on these n_lanes lanes."""
    global _chunk_log
    log = _chunk_log = ChunkLog(n_lanes, device, groups)
    try:
        yield log
    finally:
        _chunk_log = None


_sph_log: tuple | None = None  # count_sph_tests' per-lane counts: tests, box tests


@contextlib.contextmanager
def count_sph_tests(n_lanes: int, device="cpu"):
    """Count the sphere tests of the plain sweeps of n_lanes lanes inside
    the block, as the MC kernel counts them (csrc/common.cuh SphCount; the
    `sph` and `box` rows of WORK_ROWS) -> (tests, boxes), int64 [n_lanes]
    each, each lane's.  A linear sweep: each nearest or interior sweep
    tests every sphere for each of its active lanes; a shadow ray tests none
    when a triangle occludes it, else every sphere up to its first
    occluder, the shading point's own left out.  A gated sweep (a scene with
    the sphere chunk table) tests the spheres of the chunks its ray enters,
    by the same rules, and counts its box tests: every supergroup's, and
    each chunk's of the supergroups it enters, up to a shadow ray's first
    occluder.  Every sweep inside must run on these n_lanes lanes."""
    global _sph_log
    lanes = _sph_log = tuple(torch.zeros(n_lanes, dtype=torch.int64, device=device)
                             for _ in range(2))
    try:
        yield lanes
    finally:
        _sph_log = None


def _sph_tests(lanes: torch.Tensor, tests, kind: int = 0) -> None:
    """Add `tests` (a number, or [R]) to each lane of mask `lanes`, where
    count_sph_tests is counting: sphere tests (kind 0) or box tests (1)."""
    if _sph_log is not None:
        _sph_log[kind].add_(torch.where(lanes, torch.as_tensor(tests, dtype=torch.int64), 0))


def _sph_gate(o):
    """The origins a sphere gate measures a box's min and max faces from:
    o moved SPH_PAD |o|inf outward past each (scene/blocked.py SPH_PAD)."""
    ox, oy, oz = o
    w = SPH_PAD * torch.maximum(torch.maximum(ox.abs(), oy.abs()), oz.abs())
    return (ox + w, oy + w, oz + w), (ox - w, oy - w, oz - w)


def _sph_chunks(tb: Tables, o, d, tmax_fn, gate):
    """The sphere chunk table's two gate tiers for lanes `gate`: yields
    (chunk index, [R] mask of lanes whose ray enters the supergroup's and
    the chunk's box within tmax_fn()).  tmax_fn and gate are read at each
    test, so a hit found in one chunk prunes the next, and a shadow ray
    leaves at its occluder, as in the kernels; each box test is counted."""
    lo, hi = _sph_gate(o)
    inv = (1.0 / d[0], 1.0 / d[1], 1.0 / d[2])
    n = tb.sph_box.shape[0]
    for s in range(tb.sph_sup.shape[0]):
        lanes = gate()
        _sph_tests(lanes, 1, 1)
        in_sup = slab_from(tb.sph_sup[s], lo, hi, inv, tmax_fn()) & lanes
        if not bool(in_sup.any()):
            continue
        for c in range(s * SPH_SUP, min((s + 1) * SPH_SUP, n)):
            lanes = in_sup & gate()
            _sph_tests(lanes, 1, 1)
            enter = slab_from(tb.sph_box[c], lo, hi, inv, tmax_fn()) & lanes
            if bool(enter.any()):
                yield c, enter


def _shared_pass():
    """One pass for the sweeps inside, where a ChunkLog is active."""
    return _chunk_log.one_pass() if _chunk_log is not None else contextlib.nullcontext()


def _chunks(bt: BlkTables, o, inv, tmax_fn, gate):
    """Walk the two gate tiers for lanes `gate`: yields (chunk index, [R]
    mask of lanes whose ray enters the supergroup's and the chunk's box
    within tmax_fn()); tmax_fn is read at each test, so hits found in one
    chunk prune the next as in the kernels."""
    for s in range(bt.sup.shape[0]):
        c0 = s * SUP_CHUNKS
        if c0 >= bt.n_chunks:
            break
        in_sup = slab(bt.sup[s], *o, *inv, tmax_fn()) & gate()
        if not bool(in_sup.any()):
            continue
        for c in range(c0, min(c0 + SUP_CHUNKS, bt.n_chunks)):
            enter = slab(bt.box[c], *o, *inv, tmax_fn()) & in_sup & gate()
            if bool(enter.any()):
                if _chunk_log is not None:
                    _chunk_log.enter(c, enter)
                yield c, enter


def _blocked_nearest_tris(o, d, face, excl_prim, excl_face, active,
                          bt: BlkTables, back_only: bool):
    """Nearest triangle over the blocked table -> (best_t, best_id
    (original triangle id), best_row (blocked row), best_bf).  Equal t goes
    to the larger ORIGINAL id, whatever the visit order
    (kernel_common.py:1234-1242): the dense scan's last-wins rule."""
    ox, oy, oz = o
    dx, dy, dz = d
    R = ox.shape[0]
    dev = ox.device
    inv = (1.0 / dx, 1.0 / dy, 1.0 / dz)
    st = dict(t=torch.full((R,), BIG, device=dev),
              id=torch.full((R,), -1, dtype=torch.int32, device=dev),
              row=torch.zeros((R,), dtype=torch.int64, device=dev),
              bf=torch.zeros((R,), dtype=torch.bool, device=dev))
    local = torch.arange(BLK_CHUNK, device=dev)[:, None]
    for c, enter in _chunks(bt, o, inv, lambda: st["t"], lambda: active):
        rows = bt.tri[c * BLK_CHUNK:(c + 1) * BLK_CHUNK]
        ids = _col(rows, BLK_ID).to(torch.int32)
        fn0, fn1, fn2 = _col(rows, 0), _col(rows, 1), _col(rows, 2)
        no_d = fn0 * dx + fn1 * dy + fn2 * dz
        backface = no_d > 0.0
        t = (_col(rows, 3) - (fn0 * ox + fn1 * oy + fn2 * oz)) / no_d
        if back_only:  # interior rays hit backfaces only, no exclusion
            ok = backface & (t > 0.0)
        else:
            cull = (backface & (face == FACE_FRONT)) | (~backface & (face == FACE_BACK))
            excl = (excl_prim == ids) & _excl_crit(excl_face, backface)
            ok = ~cull & ~excl & (t > 0.0)
        for e in range(3):
            g0, g1, g2 = _col(rows, 4 + 3 * e), _col(rows, 5 + 3 * e), _col(rows, 6 + 3 * e)
            og = g0 * ox + g1 * oy + g2 * oz
            dg = g0 * dx + g1 * dy + g2 * dz
            ok = ok & (og + _col(rows, 13 + e) + t * dg >= 0.0)
        ok = ok & torch.isfinite(t) & (ids >= 0) & enter
        tm = torch.where(ok, t, BIG)
        t_min = tm.min(dim=0).values
        win = torch.where(tm == t_min, ids, -1).max(dim=0).values
        loc = torch.where(ids == win, local, -1).max(dim=0).values.clamp(min=0)
        better = (t_min < BIG) & ((t_min < st["t"]) | ((t_min == st["t"]) & (win > st["id"])))
        st["t"] = torch.where(better, t_min, st["t"])
        st["id"] = torch.where(better, win, st["id"])
        st["row"] = torch.where(better, c * BLK_CHUNK + loc, st["row"])
        st["bf"] = torch.where(better, torch.gather(backface, 0, loc[None])[0], st["bf"])
    return st["t"], st["id"], st["row"], st["bf"]


def blocked_full_sweep(o, d, face, excl_prim, excl_face, active, tb: Tables,
                       bt: BlkTables):
    """Nearest hit with attributes over the blocked layout
    (kernel_common.blocked_full_sweep :1175); same contract as
    full_sweep."""
    t, i, row, bf = _blocked_nearest_tris(o, d, face, excl_prim, excl_face,
                                          active, bt, back_only=False)
    return _finish_hit(o, d, face, excl_prim, excl_face, active, tb, t, i, bf,
                       bt.tri, row)


def blocked_back_sweep(px, py, pz, dx, dy, dz, active, tb: Tables, bt: BlkTables):
    """Back-face nearest sweep + interior normal over the blocked layout
    (kernel_common.blocked_back_sweep :1562); contract of
    back_sweep_with_normal."""
    p, d = (px, py, pz), (dx, dy, dz)
    t, i, row, _ = _blocked_nearest_tris(p, d, None, None, None, active, bt,
                                         back_only=True)
    return _finish_back(p, d, active, tb, t, i, bt.tri, row)


class _BlockedShadowSweep:
    """Shadow any-hit over the blocked layout, one gated traversal per light
    (_BlockedShadowSweep :1383).  Triangles: the per-lane unnormalized
    direction d = target - s p toward the light (blocked_multi :1499-1511),
    t in scaled units below tlim (1 for position lights, whose scaled
    limit is |L - p| / |L - p|), the same d and tlim in the slab tests.  A
    lane leaves the traversal once an occluder is found.  Spheres as the
    dense sweep.  The TPU tests all lights in one pass over a tile's
    chunks to load each chunk once; per lane the answer is the same."""

    def __init__(self, px, py, pz, self_prim, tb: Tables, bt: BlkTables):
        self.p = (px, py, pz)
        self.self_prim = self_prim
        self.bt = bt
        self.sph = _SphShadow(px, py, pz, self_prim, tb)

    def blocked(self, lt):
        px, py, pz = self.p
        s = lt["s"]
        dx, dy, dz = lt["tx"] - s * px, lt["ty"] - s * py, lt["tz"] - s * pz
        lim = lt["tlim"]
        hit = torch.zeros_like(lt["act"])
        pending = lambda: lt["act"] & ~hit
        for c, enter in _chunks(self.bt, self.p, (1.0 / dx, 1.0 / dy, 1.0 / dz),
                                lambda: lim, pending):
            rows = self.bt.tri[c * BLK_CHUNK:(c + 1) * BLK_CHUNK]
            ids = _col(rows, BLK_ID).to(torch.int32)
            fn0, fn1, fn2 = _col(rows, 0), _col(rows, 1), _col(rows, 2)
            num = _col(rows, 3) - (fn0 * px + fn1 * py + fn2 * pz)
            no_d = fn0 * dx + fn1 * dy + fn2 * dz
            t = num / no_d
            ok = (no_d > 0.0) & (t > 0.0) & (self.self_prim != ids) & (ids >= 0)
            for e in range(3):
                g0, g1, g2 = _col(rows, 4 + 3 * e), _col(rows, 5 + 3 * e), _col(rows, 6 + 3 * e)
                ogh = g0 * px + g1 * py + g2 * pz + _col(rows, 13 + e)
                ok = ok & (ogh + t * (g0 * dx + g1 * dy + g2 * dz) >= 0.0)
            ok = ok & torch.isfinite(t) & (t < lim) & enter
            hit = hit | ok.any(dim=0)
        return hit | self.sph.blocked(lt, lt["act"] & ~hit)


class DenseGeom:
    """Dense strategy (kernel_common.DenseGeom :1715): every sweep tests the
    whole [T, 34] table."""

    blocked = False

    def __init__(self, tb: Tables):
        self.tb = tb

    def nearest(self, o, d, face, excl_prim, excl_face, active):
        return full_sweep(o, d, face, excl_prim, excl_face, active, self.tb)

    def shadow_sweep(self, px, py, pz, self_prim):
        return _ShadowSweep(px, py, pz, self_prim, self.tb)

    def back(self, px, py, pz, dx, dy, dz, active):
        return back_sweep_with_normal(px, py, pz, dx, dy, dz, active, self.tb)


class BlockedGeom:
    """Blocked strategy for large meshes (kernel_common.BlockedGeom :1739):
    per-lane, two-tier gated sweeps over the permuted table."""

    blocked = True

    def __init__(self, tb: Tables, bt: BlkTables):
        self.tb, self.bt = tb, bt

    def nearest(self, o, d, face, excl_prim, excl_face, active):
        return blocked_full_sweep(o, d, face, excl_prim, excl_face, active,
                                  self.tb, self.bt)

    def shadow_sweep(self, px, py, pz, self_prim):
        return _BlockedShadowSweep(px, py, pz, self_prim, self.tb, self.bt)

    def back(self, px, py, pz, dx, dy, dz, active):
        return blocked_back_sweep(px, py, pz, dx, dy, dz, active, self.tb, self.bt)


def check_tables(tb: Tables, device, bt: BlkTables | None = None) -> None:
    """Raise unless the tables are what the CUDA kernels read."""
    for name, t, w in (("tri", tb.tri, TRI_COLS), ("sph", tb.sph, SPH_COLS),
                       ("mat", tb.mat, MAT_COLS), ("lights", tb.lights, LIGHT_COLS)):
        check(name, t, torch.float32, (t.shape[0], w), device)
    if tb.hot is not None:  # the dense staged walks' rows, copied 16 bytes at a time
        check("hot", tb.hot, torch.float32, (tb.n_tri, HOT_COLS), device)
        if tb.hot.data_ptr() % 16:
            raise ValueError("hot must be 16-byte aligned")
    if tb.sph_rows is not None:  # the sphere chunk table, rows read as float4s
        nch = tb.sph_box.shape[0]
        check("sph_rows", tb.sph_rows, torch.float32, (nch * SPH_CHUNK, SPH_COLS), device)
        check("sph_box", tb.sph_box, torch.float32, (nch, 8), device)
        check("sph_sup", tb.sph_sup, torch.float32, (-(-nch // SPH_SUP), 8), device)
        if nch != -(-tb.n_sph // SPH_CHUNK) or tb.sph_rows.data_ptr() % 16:
            raise ValueError("the sphere chunk table does not fit the scene")
    if bt is not None:
        nch = bt.box.shape[0]
        check("blk_tri", bt.tri, torch.float32, (nch * BLK_CHUNK, BLK_COLS), device)
        check("blk_box", bt.box, torch.float32, (nch, 8), device)
        check("blk_sup", bt.sup, torch.float32, (nch // SUP_CHUNKS, 8), device)
        if nch % SUP_CHUNKS or bt.n_chunks != -(-tb.n_tri // BLK_CHUNK):
            raise ValueError("blocked tables do not fit the scene")
        if bt.hot is not None:  # the cooperative walks' tables (pack_hot)
            check("blk_hot", bt.hot, torch.float32, (nch * BLK_CHUNK, HOT_COLS), device)
            check("blk_ids", bt.ids, torch.int32, (nch * BLK_CHUNK,), device)
            check("blk_live", bt.live, torch.int32, (nch,), device)
            check("blk_row_of_tri", bt.row_of_tri, torch.int32, (tb.n_tri,), device)
            if bt.hot.data_ptr() % 16 or bt.ids.data_ptr() % 16:  # copied 16 bytes at a time
                raise ValueError("blk_hot and blk_ids must be 16-byte aligned")


def kernel_geometry(tb: Tables, bt: BlkTables | None = None, hot: bool = False,
                    sph_chunks: bool = False) -> tuple:
    """The scene arguments of a kernel's C entry (utils/kernels.py
    SIGNATURES): the dense tables and their counts, then, for a blocked
    instantiation, the blocked rows, chunk and supergroup boxes and the
    chunk count, then, for a warp-cooperative one (`hot`), the hot rows,
    their ids, the chunks' live row counts and the triangles' rows; for a
    dense staged walk (`hot`, no blocked tables), the dense hot rows.  Last,
    for an entry that gates its sphere sweeps (`sph_chunks`), the sphere
    chunk rows, chunk and supergroup boxes and the chunk count (None and 0
    on a scene without the table)."""
    geo = (tb.tri, tb.n_tri, tb.sph, tb.n_sph, tb.mat, tb.mat.shape[0],
           tb.lights, tb.n_light)
    if bt is not None:
        geo += (bt.tri, bt.box, bt.sup, bt.n_chunks)
    if hot and bt is None:
        if tb.hot is None:
            raise ValueError("the staged dense kernels need the hot rows (pack_tables)")
        geo += (tb.hot,)
    elif hot:
        if bt.hot is None:
            raise ValueError("the cooperative kernels need the hot tables (pack_blocked)")
        geo += (bt.hot, bt.ids, bt.live, bt.row_of_tri)
    if sph_chunks:
        n = 0 if tb.sph_box is None else tb.sph_box.shape[0]
        geo += (tb.sph_rows, tb.sph_box, tb.sph_sup, n)
    return geo
