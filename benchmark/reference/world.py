"""The plain reference renderer: the reference program's algorithm in plain
PyTorch, vectorised over rays.

An independent implementation of /src/main.rs of the reference program
(World::cast 180-326, reflect 328-341, refract 343-405, get_shade 407-464,
ray_trace 466-519, distributed_ray_trace 521-614) and of its materials,
lights and textures (materials.rs, lights.rs, main.rs:848-863,
1019-1025), written from those semantics and not from the port: every cast
tests every triangle, every sphere and every cone (no BVH, no blocked
tables, no kernels), a hit's attributes are recomputed for its winner, the Whitted
recursion runs as a queue of rays a level, the Monte-Carlo walk as one
masked loop over bounces.  It reads only a RawScene (plain arrays) and
imports nothing of the port.

A cone is NFF's open truncated cone (a cylinder where its radii are equal),
which the reference program does not have: `_cone` is written from NFF's
semantics, as the surface |rho| = r(h) between the base (h = 0) and the
apex (h = L), rho the point's part off the axis, r(h) = r0 + s h.

`dtype` is the arithmetic's precision: float32 is what the configurations
state; the lower-precision control runs the same code in bfloat16.
Matrix products run with TF32 off (`tf32_off`).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

FRONT, BACK, BOTH = 0, 1, 2
THRESHOLD = 0.001  # main.rs:467
F32_EPS = float(np.finfo(np.float32).eps)
F32_TINY = float(np.finfo(np.float32).tiny)
PAIRS_PER_CHUNK = 1 << 24  # ray x triangle (or ray x cone) pairs a cast holds at once


@contextlib.contextmanager
def tf32_off():
    """Plain float32 matrix products on the card for the block inside."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def dot(a, b):
    return (a * b).sum(-1)


def unit(a):
    return a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)


def _is_face(sel, back):
    """[R, n]: whether each hit's face (back [R, n]) is the face sel [R] names."""
    return torch.where((sel == FRONT)[:, None], ~back,
                       torch.where((sel == BACK)[:, None], back, True))


class Hit(NamedTuple):
    valid: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R]
    prim: torch.Tensor  # [R] int64: triangles 0..T-1, spheres T..T+S-1, cones T+S..T+S+C-1
    obj: torch.Tensor  # [R] int64
    pos: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3] interpolated, not renormalised, flipped on a back face
    uv: torch.Tensor  # [R, 2]
    backface: torch.Tensor  # [R] bool


class World:
    """A RawScene's arrays on `device` in `dtype`."""

    def __init__(self, raw, device, dtype=torch.float32):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
        self.device, self.dtype = torch.device(device), dtype
        v = t(raw.tri_v)
        self.T, self.S = int(v.shape[0]), int(raw.sph_c.shape[0])
        self.v0, self.v1, self.v2 = v[:, 0], v[:, 1], v[:, 2]
        self.fn = unit(torch.linalg.cross(self.v1 - self.v0, self.v2 - self.v1))
        self.fn_d = dot(self.fn, self.v0)
        # the edge tests' area_i = ((e_i x (p - a_i)) . fn) = (p - a_i) . (fn x e_i)
        edges = (self.v2 - self.v1, self.v0 - self.v2, self.v1 - self.v0)
        self.anchor = (self.v1, self.v2, self.v0)
        self.m = [torch.linalg.cross(self.fn, e) for e in edges]
        self.m_a = [dot(m, a) for m, a in zip(self.m, self.anchor)]
        self.area2 = dot(torch.linalg.cross(self.v1 - self.v0, self.v2 - self.v0), self.fn)
        self.tri_n, self.tri_uv = t(raw.tri_n), t(raw.tri_uv)
        self.obj_of = torch.cat([torch.as_tensor(raw.tri_obj, device=device).long(),
                                 torch.as_tensor(raw.sph_obj, device=device).long(),
                                 torch.as_tensor(raw.cone_obj, device=device).long()])
        self.sph_c, self.sph_r = t(raw.sph_c).reshape(-1, 3), t(raw.sph_r)
        # a cone: base B, unit axis a towards the apex, length L, radius
        # r(h) = r0 + s h at height h along it
        self.C = int(raw.cone_base.shape[0])
        self.cone_b = t(raw.cone_base).reshape(-1, 3)
        axis = t(raw.cone_apex).reshape(-1, 3) - self.cone_b
        self.cone_len = torch.linalg.vector_norm(axis, dim=-1)
        self.cone_a = axis / self.cone_len[:, None]
        self.cone_r0 = t(raw.cone_base_r)
        self.cone_s = (t(raw.cone_apex_r) - self.cone_r0) / self.cone_len
        mats = raw.materials
        col = lambda k: t([m[k] for m in mats])
        self.mat = {k: col(k) for k in ("diffuse_color", "shiness", "specular_color",
                                        "smoothness", "transparency", "refraction_index",
                                        "opaque_decay", "normal")}
        self.mat_tex = [m["texture"] for m in mats]
        self.lights = raw.lights
        self.light_t = [{k: t(l[k]) for k in ("origin", "direction", "color", "angle",
                                              "softness")} for l in raw.lights]

    def zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # --- World::cast (main.rs:180-326) --------------------------------------
    def _tri_t(self, o, d, face, excl_prim, excl_face, lo, hi):
        """t [R, hi-lo] of rays against triangles lo..hi-1 (inf where missed)."""
        fn = self.fn[lo:hi]
        dn = d @ fn.T
        backface = dn > 0.0
        keep = torch.where((face == FRONT)[:, None], ~backface,
                           torch.where((face == BACK)[:, None], backface, True))
        ids = torch.arange(lo, hi, device=self.device)
        ex_face = torch.where((excl_face == FRONT)[:, None], ~backface,
                              torch.where((excl_face == BACK)[:, None], backface, True))
        keep &= ~((excl_prim[:, None] == ids[None, :]) & ex_face)
        t = (self.fn_d[lo:hi][None, :] - o @ fn.T) / dn
        keep &= torch.isfinite(t) & (t > 0.0)
        for m, ma in zip(self.m, self.m_a):
            area = (o @ m[lo:hi].T - ma[lo:hi][None, :]) + t * (d @ m[lo:hi].T)
            keep &= area >= 0.0
        return torch.where(keep, t, torch.inf)

    def _sph(self, o, d, face):
        """(t [R, S], backface [R, S]) against every sphere (inf where missed)."""
        w = self.sph_c[None, :, :] - o[:, None, :]
        dist = torch.linalg.vector_norm(torch.linalg.cross(w, d[:, None, :].expand_as(w)), dim=-1)
        r = self.sph_r[None, :]
        tc = dot(d[:, None, :], w)
        k = torch.sqrt(torch.clamp_min(r * r - dist * dist, 0.0))
        f = face[:, None]
        back = torch.where(f == FRONT, False, torch.where(f == BACK, True, tc < k))
        t = torch.where(back, tc + k, tc - k)
        ok = (dist <= r) & (t > 0.0)
        return torch.where(ok, t, torch.inf), back

    def _cone(self, o, d, face, excl_prim, excl_face, lo, hi):
        """(t [R, hi-lo], backface [R, hi-lo]) against cones lo..hi-1 (inf
        where missed): of the roots of |rho(t)|^2 = r(h(t))^2 with t > 0 and
        0 <= h <= L, the nearest that `face` keeps and the exclusion leaves;
        the exclusion drops a root, not the cone, so a ray that leaves an
        open cylinder can meet its inside."""
        b, a, s, r0, length = (x[lo:hi][None] for x in (
            self.cone_b, self.cone_a, self.cone_s, self.cone_r0, self.cone_len))
        w = o[:, None, :] - b
        wa, da = dot(w, a), d @ self.cone_a[lo:hi].T
        rho_w = w - wa[..., None] * a
        rho_d = d[:, None, :] - da[..., None] * a
        dd, wd = dot(rho_d, rho_d), dot(rho_w, rho_d)
        q = r0 + s * wa
        alpha = dd - s * s * da * da
        beta = wd - s * q * da
        gamma = dot(rho_w, rho_w) - q * q
        # the roots of alpha t^2 + 2 beta t + gamma = 0, each in the form
        # that does not cancel; where alpha = 0, k / alpha is not finite and
        # gamma / k is the one root -gamma / 2 beta (none where beta = 0 too)
        disc = beta * beta - alpha * gamma
        k = -(beta + torch.copysign(torch.sqrt(torch.clamp_min(disc, 0.0)), beta))
        roots = (k / alpha, gamma / k)
        ids = torch.arange(lo, hi, device=self.device)[None, :] + self.T + self.S
        kept = []
        for root in roots:
            h = wa + root * da
            # the outward normal's direction rho - s r(h) a, dotted with d
            back = (wd + root * dd) - s * (r0 + s * h) * da > 0.0
            keep = (disc >= 0.0) & torch.isfinite(root) & (root > 0.0)
            keep &= (h >= 0.0) & (h <= length)
            keep &= _is_face(face, back)
            keep &= ~((excl_prim[:, None] == ids) & _is_face(excl_face, back))
            kept.append((torch.where(keep, root, torch.inf), back))
        (t1, back1), (t2, back2) = kept
        second = t2 < t1
        return torch.where(second, t2, t1), torch.where(second, back2, back1)

    def cast(self, o, d, face, excl_prim, excl_face, active=None, limit=None):
        """Nearest hit of each ray (last wins a tie: spheres after triangles,
        cones after spheres).
        With `limit` ([R]): only whether some hit lies nearer (bool [R])."""
        R = o.shape[0]
        if active is None:
            active = torch.ones(R, dtype=torch.bool, device=self.device)
        best_t = torch.full((R,), torch.inf, dtype=self.dtype, device=self.device)
        best_i = torch.full((R,), -1, dtype=torch.long, device=self.device)
        best_back = torch.zeros((R,), dtype=torch.bool, device=self.device)
        chunk = max(1, PAIRS_PER_CHUNK // max(R, 1))
        for lo in range(0, self.T, chunk):
            hi = min(self.T, lo + chunk)
            t = self._tri_t(o, d, face, excl_prim, excl_face, lo, hi)
            tmin, _ = t.min(dim=1)
            ids = torch.arange(lo, hi, device=self.device)
            last = torch.where(t == tmin[:, None], ids[None, :], -1).max(dim=1).values
            take = torch.isfinite(tmin) & (tmin <= best_t)
            best_t = torch.where(take, tmin, best_t)
            best_i = torch.where(take, last, best_i)
        if self.S:
            ts, backs = self._sph(o, d, face)
            ids = torch.arange(self.T, self.T + self.S, device=self.device)
            excl = torch.where((excl_face == FRONT)[:, None], ~backs,
                               torch.where((excl_face == BACK)[:, None], backs, True))
            ts = torch.where((excl_prim[:, None] == ids[None, :]) & excl, torch.inf, ts)
            tmin, _ = ts.min(dim=1)
            last = torch.where(ts == tmin[:, None], ids[None, :], -1).max(dim=1).values
            take = torch.isfinite(tmin) & (tmin <= best_t)
            best_t = torch.where(take, tmin, best_t)
            best_i = torch.where(take, last, best_i)
            back_last = torch.gather(backs, 1, (last - self.T).clamp_min(0)[:, None])[:, 0]
            best_back = torch.where(take, back_last, best_back)
        first = self.T + self.S
        for lo in range(0, self.C, chunk):
            hi = min(self.C, lo + chunk)
            tc, backs = self._cone(o, d, face, excl_prim, excl_face, lo, hi)
            tmin, _ = tc.min(dim=1)
            ids = torch.arange(first + lo, first + hi, device=self.device)
            last = torch.where(tc == tmin[:, None], ids[None, :], -1).max(dim=1).values
            take = torch.isfinite(tmin) & (tmin <= best_t)
            best_t = torch.where(take, tmin, best_t)
            best_i = torch.where(take, last, best_i)
            back_last = torch.gather(backs, 1, (last - first - lo).clamp_min(0)[:, None])[:, 0]
            best_back = torch.where(take, back_last, best_back)
        valid = active & (best_i >= 0)
        if limit is not None:
            return valid & (best_t < limit)
        return self._attributes(o, d, valid, best_t, best_i, best_back)

    def _attributes(self, o, d, valid, t, idx, back):
        R = o.shape[0]
        t = torch.where(valid, t, 0.0)
        pos = o + d * t[:, None]
        is_tri = valid & (idx < self.T)
        ti = torch.where(is_tri, idx, 0).clamp_max(max(self.T - 1, 0))
        normal = self.zeros(R, 3)
        uv = self.zeros(R, 2)
        backface = torch.zeros(R, dtype=torch.bool, device=self.device)
        if self.T:
            fn = self.fn[ti]
            bf_t = dot(fn, d) > 0.0
            areas = torch.stack([dot(torch.linalg.cross(e, pos - a), fn) for e, a in (
                (self.v2[ti] - self.v1[ti], self.v1[ti]), (self.v0[ti] - self.v2[ti], self.v2[ti]),
                (self.v1[ti] - self.v0[ti], self.v0[ti]))], dim=1)
            bary = areas / self.area2[ti][:, None]
            n_t = (self.tri_n[ti] * bary[:, :, None]).sum(1)
            n_t = torch.where(bf_t[:, None], -n_t, n_t)
            uv_t = (self.tri_uv[ti] * bary[:, :, None]).sum(1)
            normal = torch.where(is_tri[:, None], n_t, normal)
            uv = torch.where(is_tri[:, None], uv_t, uv)
            backface = torch.where(is_tri, bf_t, backface)
        if self.S:
            is_sph = valid & (idx >= self.T) & (idx < self.T + self.S)
            si = torch.where(is_sph, idx - self.T, 0)
            c = self.sph_c[si]
            bf_s = back
            n_s = unit(pos - c)
            n_s = torch.where(bf_s[:, None], -n_s, n_s)
            uv_s = torch.stack([torch.acos(torch.clamp(n_s[:, 1], -1.0, 1.0)) / math.pi,
                                torch.atan2(n_s[:, 2], n_s[:, 0]) / (2.0 * math.pi) + 0.5], dim=1)
            normal = torch.where(is_sph[:, None], n_s, normal)
            uv = torch.where(is_sph[:, None], uv_s, uv)
            backface = torch.where(is_sph, bf_s, backface)
        if self.C:
            first = self.T + self.S
            is_cone = valid & (idx >= first)
            ci = torch.where(is_cone, idx - first, 0)
            a, s = self.cone_a[ci], self.cone_s[ci]
            p = pos - self.cone_b[ci]
            h = dot(p, a)
            n_c = unit(p - (h + s * (self.cone_r0[ci] + s * h))[:, None] * a)
            n_c = torch.where(back[:, None], -n_c, n_c)
            normal = torch.where(is_cone[:, None], n_c, normal)
            uv = torch.where(is_cone[:, None], 0.0, uv)
            backface = torch.where(is_cone, back, backface)
        return Hit(valid=valid, t=torch.where(valid, t, torch.inf), prim=torch.where(valid, idx, -1),
                   obj=self.obj_of[idx.clamp_min(0)], pos=pos, normal=normal, uv=uv,
                   backface=backface)

    # --- materials (materials.rs:20-66, main.rs:848-863, 1019-1025) --------
    def material(self, obj, uv):
        m = {k: v[obj] for k, v in self.mat.items()}
        u, v = uv[:, 0], uv[:, 1]
        for idx, name in enumerate(self.mat_tex):
            if name is None:
                continue
            sel = obj == idx
            if name == "stripes":
                band = (v * 20.0).to(torch.int32) % 2 == 0
                r = torch.where(band, 1.0, 0.5).to(self.dtype)
                diffuse = torch.stack([r, r, torch.ones_like(r)], dim=1)
                angle = u * 10.0 * 2.0 * math.pi
                s, c = torch.sin(angle), torch.cos(angle)
                flip = torch.where(c <= 0.0, -1.0, 1.0).to(self.dtype)
                normal = torch.stack([s * flip, torch.zeros_like(s), c * flip], dim=1)
                m["normal"] = torch.where(sel[:, None], normal, m["normal"])
            else:  # checker
                band = ((u + v) * 10.0).to(torch.int32) % 2 == 0
                diffuse = torch.stack([torch.where(band, 1.0, 0.1), torch.full_like(u, 0.1),
                                       torch.where(band, 0.1, 1.0)], dim=1).to(self.dtype)
            m["diffuse_color"] = torch.where(sel[:, None], diffuse, m["diffuse_color"])
        return m


def rotate_from_z(n, v):
    """The rotation taking +z onto n applied to v (cgmath Quaternion::from_arc;
    by pi about -y when n is near -z)."""
    qw = 1.0 + n[:, 2]
    qv = torch.stack([-n[:, 1], n[:, 0], torch.zeros_like(qw)], dim=1)
    q2 = qw * qw + dot(qv, qv)
    t = torch.linalg.cross(qv, v) + qw[:, None] * v
    out = v + (2.0 / q2)[:, None] * torch.linalg.cross(qv, t)
    flipped = torch.stack([-v[:, 0], v[:, 1], -v[:, 2]], dim=1)
    return torch.where((n[:, 2] < -1.0 + 1e-6)[:, None], flipped, out)


def get_diffuse(m, normal, light_dir):
    cosine = dot(light_dir, normal)
    return torch.where((cosine > 0.0)[:, None], m["diffuse_color"] * cosine[:, None], 0.0)


def get_specular(m, normal, light_dir, view_dir):
    cosine = dot(light_dir, normal)
    reflected = 2.0 * cosine[:, None] * normal - light_dir
    e = 1.0 / (m["smoothness"] + F32_EPS)
    energy = (e + 8.0) / (8.0 * math.pi)
    amount = torch.pow(torch.clamp_min(dot(reflected, view_dir), 0.0), e) * energy
    return torch.where((cosine > 0.0)[:, None], m["specular_color"] * amount[:, None], 0.0)


def invert(face):
    return torch.where(face == FRONT, BACK, torch.where(face == BACK, FRONT, BOTH))


def get_shade(w: World, hit: Hit, ray_d, active):
    """Direct light at the hits (main.rs:407-464) -> [R, 3]; inactive lanes 0."""
    R = ray_d.shape[0]
    m = w.material(hit.obj, hit.uv)
    normal = rotate_from_z(hit.normal, m["normal"])
    total = w.zeros(R, 3)
    back = torch.full((R,), BACK, dtype=torch.long, device=w.device)
    for light, lt in zip(w.lights, w.light_t):
        if light["type"] == "directional":
            direction = lt["direction"].expand(R, 3)
            color = lt["color"].expand(R, 3)
            ok = active
            limit = torch.full((R,), torch.inf, dtype=w.dtype, device=w.device)
        else:
            offset = hit.pos - lt["origin"]
            mag = torch.linalg.vector_norm(offset, dim=-1)
            direction = offset / mag[:, None]
            limit = mag
            if light["type"] == "spot":
                ldir = lt["direction"]
                cosang = dot(ldir.expand(R, 3), offset) / (torch.linalg.vector_norm(ldir) * mag)
                angle = torch.abs(torch.acos(torch.clamp(cosang, -1.0, 1.0)))
                spread = lt["angle"]
                ok = active & (angle <= spread)
                att = torch.pow(torch.clamp_min(1.0 - angle / spread, 0.0),
                                lt["softness"] + F32_EPS) / (mag + F32_EPS)
            else:
                ok = active
                att = 1.0 / (mag + F32_EPS)
            color = lt["color"][None, :] * att[:, None]
        cosine = -dot(direction, normal)
        ok = ok & (cosine > 0.0)
        blocked = w.cast(hit.pos, -direction, back, hit.prim, back, active=ok, limit=limit)
        lit = ok & ~blocked
        ldir = -direction
        diffuse = get_diffuse(m, normal, ldir) * color
        specular = get_specular(m, normal, ldir, -ray_d) * color
        shine = m["shiness"][:, None]
        total = total + torch.where(lit[:, None], diffuse * (1.0 - shine) + specular * shine, 0.0)
    return total


def _reflect_ray(hit: Hit, ray_d, ray_face):
    """get_reflect (main.rs:328-341) -> (o, d, face, excl_prim, excl_face)."""
    refl = unit(ray_d - 2.0 * dot(ray_d, hit.normal)[:, None] * hit.normal)
    excl_face = invert(torch.where(hit.backface, BACK, FRONT))
    return hit.pos, refl, ray_face, hit.prim, excl_face


def _refract(n, l, k):
    """(unit refracted direction, ok) of Snell's law as main.rs:344-352 writes it."""
    cos = -dot(l, n)
    sin2 = 1.0 - cos * cos
    ok = k * k >= sin2
    v = (l + n * cos[:, None]) / k[:, None] \
        - n * torch.sqrt(torch.clamp_min(1.0 - sin2 / (k * k), 0.0))[:, None]
    return unit(v), ok


class Escape(NamedTuple):
    ok: torch.Tensor  # [R] bool: Refraction::Escaped
    travel: torch.Tensor
    pos: torch.Tensor
    dir: torch.Tensor
    prim: torch.Tensor


def get_refract(w: World, hit: Hit, ray_d, k, want, max_distance=100.0, retries=10):
    """World::get_refract (main.rs:343-405): in through the surface, on
    through the interior, reflecting inside up to `retries` times while the
    way out is a total internal reflection."""
    R = ray_d.shape[0]
    rin, ok = _refract(hit.normal, ray_d, k)
    ok = want & ok
    back = torch.full((R,), BACK, dtype=torch.long, device=w.device)
    front = torch.full((R,), FRONT, dtype=torch.long, device=w.device)
    inner = w.cast(hit.pos, rin, back, hit.prim, front, active=ok)
    ok = ok & inner.valid
    travel = torch.where(ok, torch.linalg.vector_norm(inner.pos - hit.pos, dim=-1), 0.0)
    cur, cur_d = inner, rin
    rout, out_ok = _refract(cur.normal, cur_d, 1.0 / k)
    out_ok = out_ok & ok
    for _ in range(retries):
        again = ok & ~out_ok & (travel <= max_distance)
        if not bool(again.any()):
            break
        o2, d2, f2, p2, e2 = _reflect_ray(cur, cur_d, back)
        nxt = w.cast(o2, d2, f2, p2, e2, active=again)
        ok = ok & (~again | nxt.valid)
        step = torch.linalg.vector_norm(nxt.pos - cur.pos, dim=-1)
        travel = torch.where(again & nxt.valid, travel + step, travel)
        cur = Hit(*[torch.where(again[:, None] if a.dim() == 2 else again, a, b)
                    for a, b in zip(nxt, cur)])
        cur_d = torch.where(again[:, None], d2, cur_d)
        r2, ok2 = _refract(cur.normal, cur_d, 1.0 / k)
        rout = torch.where(again[:, None], r2, rout)
        out_ok = torch.where(again, ok2 & nxt.valid, out_ok)
    ok = ok & out_ok
    return Escape(ok=ok, travel=travel, pos=cur.pos, dir=rout, prim=cur.prim)


def whitted(w: World, o, d, depth: int = 5):
    """ray_trace (main.rs:466-519) of each primary ray -> colour [R, 3]: the
    recursion as a queue of rays a level, each carrying its pixel, its
    contribution and the weight its radiance enters the pixel with."""
    R = o.shape[0]
    color = w.zeros(R, 3)
    pix = torch.arange(R, device=w.device)
    weight = w.zeros(R) + 1.0
    contrib = w.zeros(R) + 1.0
    face = torch.full((R,), FRONT, dtype=torch.long, device=w.device)
    excl_p = torch.full((R,), -1, dtype=torch.long, device=w.device)
    excl_f = face.clone()
    for level in range(depth, -1, -1):
        if pix.numel() == 0:
            break
        active = contrib >= THRESHOLD
        hit = w.cast(o, d, face, excl_p, excl_f, active=active)
        m = w.material(hit.obj, hit.uv)
        shine, transp = m["shiness"], m["transparency"]
        shade_c = (1.0 - shine) * (1.0 - transp)
        do_shade = hit.valid & (contrib * shade_c >= THRESHOLD)
        shade = get_shade(w, hit, d, do_shade)
        gain = weight if level == 0 else weight * shade_c
        color.index_add_(0, pix, torch.where(do_shade[:, None], shade * gain[:, None], 0.0))
        if level == 0:
            break
        refl_c = shine * (1.0 - transp)
        want_r = hit.valid & (contrib * refl_c >= THRESHOLD)
        ro, rd, rf, rp, re = _reflect_ray(hit, d, face)
        want_t = hit.valid & (contrib * transp > THRESHOLD)
        esc = get_refract(w, hit, d, m["refraction_index"], want_t)
        decay = torch.pow(m["opaque_decay"], esc.travel)
        take = lambda *xs: torch.cat(xs)
        keep_r, keep_t = want_r, esc.ok
        n_t = int(keep_t.sum())
        pix = take(pix[keep_r], pix[keep_t])
        weight = take((weight * refl_c)[keep_r], (weight * transp * decay)[keep_t])
        contrib = take((contrib * refl_c)[keep_r], (contrib * transp)[keep_t])
        o = take(ro[keep_r], esc.pos[keep_t])
        d = take(rd[keep_r], esc.dir[keep_t])
        face = take(rf[keep_r], torch.full((n_t,), FRONT, dtype=torch.long, device=w.device))
        excl_p = take(rp[keep_r], esc.prim[keep_t])
        excl_f = take(re[keep_r], torch.full((n_t,), BACK, dtype=torch.long, device=w.device))
    return color


def _scatter(u_phi, theta, axis, exponent):
    phi = torch.acos(torch.pow(1.0 - u_phi, exponent))
    sph = torch.stack([torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta),
                       torch.cos(phi)], dim=1)
    return rotate_from_z(unit(axis), sph)


def distributed(w: World, o, d, unifs, depth: int = 5):
    """One photon of each primary ray (main.rs:1150-1160 and
    distributed_ray_trace 521-614), the draws unifs [depth, 3, R] (roulette
    u, lobe u, lobe angle in [-pi, pi)) taken a bounce at a time, then the
    is_normal filter -> photon [R, 3].  The recursion ret = A + B * ret' is
    unrolled forward: a bounce adds scale * A and multiplies scale by B."""
    R = o.shape[0]
    front = torch.full((R,), FRONT, dtype=torch.long, device=w.device)
    back = torch.full((R,), BACK, dtype=torch.long, device=w.device)
    hit = w.cast(o, d, front, torch.full((R,), -1, dtype=torch.long, device=w.device), front)
    hit_d, hit_face = d, front
    alive = hit.valid
    accum = w.zeros(R, 3)
    scale = w.zeros(R, 3) + 1.0
    for step in range(depth):
        m = w.material(hit.obj, hit.uv)
        shine, transp = m["shiness"], m["transparency"]
        w0, w1 = (1.0 - shine) * (1.0 - transp), shine * (1.0 - transp)
        r = unifs[step, 0] * (w0 + w1 + transp)
        sel = torch.where(r < w0, 0, torch.where(r < w0 + w1, 1, 2))
        diffuse = sel == 0
        refract = sel == 2
        axis = torch.where(diffuse[:, None], -hit.normal, hit_d)
        exponent = torch.where(diffuse, 1.0, m["smoothness"]).to(w.dtype)
        sdir = _scatter(unifs[step, 1], unifs[step, 2], axis, exponent)
        live = alive & (-dot(hit.normal, sdir) > 0.0)
        # diffuse / reflect: the scattered ray mirrored about the normal
        ro, rd, rf, rp, re = _reflect_ray(hit, sdir, hit_face)
        # refract: through the interior from the scattered hit
        esc = get_refract(w, hit, sdir, m["refraction_index"], live & refract)
        nd = torch.where(refract[:, None], esc.dir, rd)
        go = live & (~refract | esc.ok)
        nxt = w.cast(torch.where(refract[:, None], esc.pos, ro), nd,
                     torch.where(refract, front, rf),
                     torch.where(refract, esc.prim, rp), torch.where(refract, back, re),
                     active=go)
        # the terminal of a reflect-branch miss shades the scattered hit itself
        miss_self = go & ~nxt.valid & ~refract
        shade_next = get_shade(w, nxt, nd, go & nxt.valid)
        shade_self = get_shade(w, hit, sdir, miss_self)
        brdf = torch.where(diffuse[:, None], get_diffuse(m, hit.normal, rd),
                           get_specular(m, hit.normal, rd, -hit_d))
        decay = torch.pow(m["opaque_decay"], esc.travel)[:, None]
        hitv = nxt.valid[:, None]
        A = torch.where(refract[:, None], decay * shade_next,
                        torch.where(hitv, 0.5 * shade_next, shade_self))
        B = torch.where(refract[:, None], decay, torch.where(hitv, 0.5 * brdf, 0.0))
        accum = accum + torch.where(go[:, None], scale * A, 0.0)
        scale = torch.where(go[:, None], scale * B, 0.0)
        alive = go & nxt.valid
        hit, hit_d = nxt, nd
        hit_face = torch.where(refract, front, rf)
    last = get_shade(w, hit, hit_d, alive)
    photon = accum + torch.where(alive[:, None], scale * last, 0.0)
    photon = photon.float()
    normal = torch.isfinite(photon) & (photon.abs() >= F32_TINY)
    return torch.where(normal.all(dim=1, keepdim=True), photon, 0.0)
