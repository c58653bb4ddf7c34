// Dense building blocks shared by the level kernel and the MC kernel.
//
// __device__ counterparts of raytracer_tpu/ops/kernel_common.py:105-894
// (full_sweep, eval_material, _ShadowSweep + get_shade,
// back_sweep_with_normal, march_rows, rotate_from_z, reflect3, refract3,
// normalize3), one thread per ray.  The plain PyTorch versions the kernels
// are tested against are raytracer_tpu_torch/ops/kernel_common.py.
//
// The TPU workarounds are not carried over: acosf/atan2f/sinf/cosf/powf
// replace the Mosaic polynomials, the winner's attributes are read by
// index instead of a one-hot matrix product, and ints stay ints.
// Semantics kept exactly: face culling, exclusion by (prim, face),
// last-wins ties with spheres scanned after triangles (update on <=),
// non-finite t is a miss, the 3e38 sentinel, kpowf's "0 for base <= 0",
// and the factored-target shadow algebra.
//
// Scene tables are read straight from global memory (the demo's are
// under 10 KB and stay in L1).  Build without --use_fast_math: the photon
// filter needs subnormals, and division/sqrt must stay IEEE.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt {

constexpr float BIG = 3.0e38f;
constexpr float F32_EPS = 1.1920928955078125e-07f;
constexpr float INV_PI = 0.31830987f;       // float32(1/pi)
constexpr float HALF_INV_PI = 0.15915494f;  // float32(0.5/pi)
constexpr float EIGHT_PI = 25.132742f;      // float32(8 pi)
constexpr float PI_F = 3.1415927f;          // float32(pi)

constexpr int FACE_FRONT = 0;
constexpr int FACE_BACK = 1;

constexpr int TRI_COLS = 34;
constexpr int SPH_COLS = 8;
constexpr int MAT_COLS = 16;
constexpr int LIGHT_COLS = 16;

struct Tables {
  const float* __restrict__ tri;     // [n_tri, 34]
  const float* __restrict__ sph;     // [n_sph, 8]
  const float* __restrict__ mat;     // [n_obj, 16]
  const float* __restrict__ lights;  // [n_light, 16]
  int n_tri, n_sph, n_obj, n_light;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ float dot3p(const float* __restrict__ r, V3 b) {
  return r[0] * b.x + r[1] * b.y + r[2] * b.z;
}

__device__ __forceinline__ V3 normalize3(V3 a) {
  float inv = rsqrtf(fmaxf(a.x * a.x + a.y * a.y + a.z * a.z, 1e-30f));
  return V3{a.x * inv, a.y * inv, a.z * inv};
}

// base**expo with kernel_common.powf's rule: 0 wherever base <= 0.
__device__ __forceinline__ float kpowf(float base, float expo) {
  return base <= 0.0f ? 0.0f : powf(fmaxf(base, 1e-37f), expo);
}

// Rotation taking +z onto n, applied to v (cgmath Quaternion::from_arc;
// antiparallel fallback v -> (-v.x, v.y, -v.z)).
__device__ __forceinline__ V3 rotate_from_z(V3 n, V3 v) {
  if (n.z < -1.0f + 1e-6f) return V3{-v.x, v.y, -v.z};
  float qw = 1.0f + n.z, qx = -n.y, qy = n.x;
  float q2 = fmaxf(qw * qw + qx * qx + qy * qy, 1e-12f);
  float tx = qy * v.z + qw * v.x;
  float ty = -qx * v.z + qw * v.y;
  float tz = qx * v.y - qy * v.x + qw * v.z;
  float s = 2.0f / q2;
  return V3{v.x + s * (qy * tz), v.y + s * (-(qx * tz)), v.z + s * (qx * ty - qy * tx)};
}

// l - 2 (l.n) n, normalized (main.rs:329).
__device__ __forceinline__ V3 reflect3(V3 d, V3 n) {
  float dn = dot3(d, n);
  return normalize3(V3{d.x - 2.0f * dn * n.x, d.y - 2.0f * dn * n.y, d.z - 2.0f * dn * n.z});
}

// Snell refraction (src/main.rs:344-352); ok=false is total internal
// reflection.
__device__ __forceinline__ V3 refract3(V3 n, V3 d, float k, bool& ok) {
  float cs = -(d.x * n.x + d.y * n.y + d.z * n.z);
  float sin2 = 1.0f - cs * cs;
  ok = k * k >= sin2;
  float root = sqrtf(fmaxf(1.0f - sin2 / (k * k), 0.0f));
  return normalize3(V3{(d.x + n.x * cs) / k - n.x * root, (d.y + n.y * cs) / k - n.y * root,
                       (d.z + n.z * cs) / k - n.z * root});
}

__device__ __forceinline__ bool excl_crit(int excl_face, bool backface) {
  bool is_front = excl_face == FACE_FRONT, is_back = excl_face == FACE_BACK;
  return (is_front && !backface) || (is_back && backface) || (!is_front && !is_back);
}

// ---------------------------------------------------------------------------
// Nearest sweep with attributes (World::cast, kernel_common.full_sweep)
// ---------------------------------------------------------------------------

struct Hit {
  bool valid, back;
  int prim, obj;
  float t, u, v;
  V3 p, n;
};

__device__ inline Hit full_sweep(const Tables& tb, V3 o, V3 d, int face, int excl_prim, int excl_face,
                          bool active) {
  float best_t = BIG;
  int best_i = -1;
  bool best_bf = false;
  if (active) {
    for (int i = 0; i < tb.n_tri; ++i) {
      const float* r = tb.tri + i * TRI_COLS;
      float no_d = dot3p(r, d);
      bool bf = no_d > 0.0f;
      if ((bf && face == FACE_FRONT) || (!bf && face == FACE_BACK)) continue;  // culled
      if (excl_prim == i && excl_crit(excl_face, bf)) continue;
      float t = (r[3] - dot3p(r, o)) / no_d;
      if (!(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
      bool inside = true;
      for (int e = 0; e < 3; ++e) {
        const float* g = r + 4 + 3 * e;
        inside = inside && (dot3p(g, o) + r[13 + e] + t * dot3p(g, d) >= 0.0f);
      }
      if (inside && t <= best_t) {
        best_t = t;
        best_i = i;
        best_bf = bf;
      }
    }
    for (int j = 0; j < tb.n_sph; ++j) {
      const float* s = tb.sph + j * SPH_COLS;
      V3 w = v3(s[0] - o.x, s[1] - o.y, s[2] - o.z);
      float qx = w.y * d.z - w.z * d.y, qy = w.z * d.x - w.x * d.z, qz = w.x * d.y - w.y * d.x;
      float dist2 = qx * qx + qy * qy + qz * qz;
      float tc = d.x * w.x + d.y * w.y + d.z * w.z;
      float kk = sqrtf(fmaxf(s[3] - dist2, 0.0f));
      bool bf = face == FACE_BACK || (face != FACE_FRONT && tc < kk);
      float t = bf ? tc + kk : tc - kk;
      int prim = tb.n_tri + j;
      if (excl_prim == prim && excl_crit(excl_face, bf)) continue;
      if (!(dist2 <= s[3]) || !(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
      if (t <= best_t) {  // spheres win exact ties with triangles
        best_t = t;
        best_i = prim;
        best_bf = bf;
      }
    }
  }
  Hit h;
  bool valid = best_t < BIG;
  float t_hit = valid ? best_t : 0.0f;
  h.p = v3(o.x + t_hit * d.x, o.y + t_hit * d.y, o.z + t_hit * d.z);
  h.n = v3(0.0f, 0.0f, 0.0f);
  h.u = 0.0f;
  h.v = 0.0f;
  float obj = 0.0f;
  if (best_i >= 0 && best_i < tb.n_tri) {
    const float* r = tb.tri + best_i * TRI_COLS;
    float area2 = r[31];
    float inv_a2 = 1.0f / (area2 != 0.0f ? area2 : 1.0f);
    for (int e = 0; e < 3; ++e) {
      float bary = (dot3p(r + 4 + 3 * e, h.p) + r[13 + e]) * inv_a2;
      h.n.x += bary * r[16 + 3 * e];
      h.n.y += bary * r[17 + 3 * e];
      h.n.z += bary * r[18 + 3 * e];
      h.u += bary * r[25 + 2 * e];
      h.v += bary * r[26 + 2 * e];
    }
    if (best_bf) h.n = neg(h.n);
    obj = r[32];
  } else if (best_i >= tb.n_tri) {
    const float* s = tb.sph + (best_i - tb.n_tri) * SPH_COLS;
    V3 sn = normalize3(v3(h.p.x - s[0], h.p.y - s[1], h.p.z - s[2]));
    if (best_bf) sn = neg(sn);
    h.n = sn;
    h.u = acosf(fminf(fmaxf(sn.y, -1.0f), 1.0f)) * INV_PI;
    h.v = atan2f(sn.z, sn.x) * HALF_INV_PI + 0.5f;
    obj = s[4];
  }
  h.valid = valid && active;
  h.t = h.valid ? best_t : BIG;
  h.prim = best_i;
  h.obj = (int)(obj + 0.5f);
  h.back = best_bf && h.valid;
  return h;
}

// ---------------------------------------------------------------------------
// Material evaluation with the demo textures (scene/textures.py)
// ---------------------------------------------------------------------------

struct Mat {
  V3 diffuse, specular, tn;
  float shiness, smoothness, transparency, refraction, decay;
};

// `(x as i32) % 2 == 0`: truncation toward zero, low bit.
__device__ __forceinline__ bool parity_even(float x) { return (((int)x) & 1) == 0; }

__device__ inline Mat eval_material(const Tables& tb, int obj, float u, float v) {
  Mat m;
  if (obj < 0 || obj >= tb.n_obj) {  // no such object: an all-zero row
    m.diffuse = m.specular = m.tn = v3(0.0f, 0.0f, 0.0f);
    m.shiness = m.smoothness = m.transparency = m.refraction = m.decay = 0.0f;
    return m;
  }
  const float* r = tb.mat + obj * MAT_COLS;
  m.diffuse = v3(r[0], r[1], r[2]);
  m.shiness = r[3];
  m.specular = v3(r[4], r[5], r[6]);
  m.smoothness = r[7];
  m.transparency = r[8];
  m.refraction = r[9];
  m.decay = r[10];
  m.tn = v3(r[11], r[12], r[13]);
  switch ((int)(r[14] + 0.5f)) {
    case 1: {  // stripes (src/main.rs:848-863)
      float c = parity_even(v * 20.0f) ? 1.0f : 0.5f;
      m.diffuse = v3(c, c, 1.0f);
      float angle = u * 10.0f * 2.0f * PI_F;
      float sx = sinf(angle), cz = cosf(angle);
      float flip = cz <= 0.0f ? -1.0f : 1.0f;
      m.tn = v3(sx * flip, 0.0f, cz * flip);
      break;
    }
    case 2: {  // diagonal checker (src/main.rs:1019-1025)
      bool band = parity_even((u + v) * 10.0f);
      m.diffuse = v3(band ? 1.0f : 0.1f, 0.1f, band ? 0.1f : 1.0f);
      m.tn = v3(0.0f, 0.0f, 1.0f);
      break;
    }
    default:
      break;
  }
  return m;
}

// ---------------------------------------------------------------------------
// Shadows and direct shading (kernel_common._ShadowSweep + get_shade)
// ---------------------------------------------------------------------------

// Any occluder between p and the light?  Triangles: factored-target
// algebra with target `tg` (light origin, s=1, scaled t limit 1; or the
// negated direction, s=0, real limit).  Spheres: the normalized direction
// `nd` toward the light and the real-unit limit `slim`.
__device__ inline bool shadow_blocked(const Tables& tb, V3 p, int self_prim, float s, V3 tg,
                               float tlim, V3 nd, float slim) {
  for (int i = 0; i < tb.n_tri; ++i) {
    if (i == self_prim) continue;
    const float* r = tb.tri + i * TRI_COLS;
    float o_fn = dot3p(r, p);
    float num = r[3] - o_fn;
    if (!(num > 0.0f)) continue;
    float no_d = dot3p(r, tg) - s * o_fn;
    if (!(no_d > 0.0f)) continue;
    float t = num / no_d;
    if (!isfinite(t) || !(t < tlim)) continue;
    bool inside = true;
    for (int e = 0; e < 3; ++e) {
      const float* g = r + 4 + 3 * e;
      float ogh = dot3p(g, p) + r[13 + e];
      float c_g = dot3p(g, tg) + s * r[13 + e];
      inside = inside && (ogh + t * (c_g - s * ogh) >= 0.0f);
    }
    if (inside) return true;
  }
  for (int j = 0; j < tb.n_sph; ++j) {
    if (tb.n_tri + j == self_prim) continue;
    const float* sp = tb.sph + j * SPH_COLS;
    V3 w = v3(sp[0] - p.x, sp[1] - p.y, sp[2] - p.z);
    float qx = w.y * nd.z - w.z * nd.y, qy = w.z * nd.x - w.x * nd.z, qz = w.x * nd.y - w.y * nd.x;
    float dist2 = qx * qx + qy * qy + qz * qz;
    float tc = nd.x * w.x + nd.y * w.y + nd.z * w.z;
    float t = tc + sqrtf(fmaxf(sp[3] - dist2, 0.0f));  // far shell
    if (dist2 <= sp[3] && t > 0.0f && isfinite(t) && t < slim) return true;
  }
  return false;
}

// Direct radiance at p (get_shade): na = bump-ADJUSTED normal, vd = view
// (-ray direction).  Adds the shadow rays cast to `count`.
__device__ inline V3 get_shade(const Tables& tb, const Mat& m, V3 p, V3 na, V3 vd, bool active,
                        int self_prim, int& count) {
  V3 out = v3(0.0f, 0.0f, 0.0f);
  if (!active) return out;
  float e = 1.0f / (m.smoothness + F32_EPS);
  float energy = (e + 8.0f) / EIGHT_PI;
  for (int li = 0; li < tb.n_light; ++li) {
    const float* L = tb.lights + li * LIGHT_COLS;
    bool is_dir = L[0] == 0.0f, is_spot = L[0] == 1.0f;
    V3 lo = v3(L[1], L[2], L[3]), ldir = v3(L[4], L[5], L[6]);
    // approximate_into_directional (lights.rs:44-93)
    V3 off = v3(p.x - lo.x, p.y - lo.y, p.z - lo.z);
    float mag = sqrtf(off.x * off.x + off.y * off.y + off.z * off.z);
    float inv_mag = 1.0f / fmaxf(mag, 1e-30f);
    float cos_ang = dot3(ldir, off) * inv_mag;
    float angle = fabsf(acosf(fminf(fmaxf(cos_ang, -1.0f), 1.0f)));
    bool in_cone = angle <= L[10];
    float ang_att = kpowf(fmaxf(1.0f - angle / fmaxf(L[10], 1e-30f), 0.0f), L[11] + F32_EPS);
    float dist_att = 1.0f / (mag + F32_EPS);
    float att = is_dir ? 1.0f : (is_spot ? ang_att * dist_att : dist_att);
    V3 ld = is_dir ? ldir : v3(off.x * inv_mag, off.y * inv_mag, off.z * inv_mag);
    float cosine = -(ld.x * na.x + ld.y * na.y + ld.z * na.z);
    if (!((!is_spot || in_cone) && cosine > 0.0f)) continue;
    ++count;
    float limit = L[12] > 0.5f ? mag : BIG;
    if (shadow_blocked(tb, p, self_prim, is_dir ? 0.0f : 1.0f, is_dir ? neg(ldir) : lo,
                       is_dir ? limit : 1.0f, neg(ld), limit))
      continue;
    // get_diffuse / get_specular (materials.rs:46-66)
    float lam = cosine;
    V3 ref = v3(2.0f * lam * na.x + ld.x, 2.0f * lam * na.y + ld.y, 2.0f * lam * na.z + ld.z);
    float amount = kpowf(fmaxf(ref.x * vd.x + ref.y * vd.y + ref.z * vd.z, 0.0f), e) * energy;
    float dterm = lam * (1.0f - m.shiness);
    float sterm = amount * m.shiness;
    out.x += (m.diffuse.x * dterm + m.specular.x * sterm) * L[7] * att;
    out.y += (m.diffuse.y * dterm + m.specular.y * sterm) * L[8] * att;
    out.z += (m.diffuse.z * dterm + m.specular.z * sterm) * L[9] * att;
  }
  return out;
}

// Shade a hit with its material: bump-adjust the normal, view = -ray.
__device__ __forceinline__ V3 shade_at(const Tables& tb, const Mat& m, V3 p, V3 n, V3 ray_d,
                                       bool active, int self_prim, int& count) {
  return get_shade(tb, m, p, rotate_from_z(n, m.tn), neg(ray_d), active, self_prim, count);
}

// ---------------------------------------------------------------------------
// Interior march (get_refract, kernel_common.march_rows)
// ---------------------------------------------------------------------------

struct BackHit {
  float t;  // BIG on a miss
  int prim;
  V3 h, n;  // hit point p + t d, flipped unnormalized interior normal
};

// Back-face-only nearest sweep + interior normal; no exclusion.
__device__ inline BackHit back_sweep(const Tables& tb, V3 p, V3 d) {
  float best_t = BIG;
  int best_i = -1;
  for (int i = 0; i < tb.n_tri; ++i) {
    const float* r = tb.tri + i * TRI_COLS;
    float no_d = dot3p(r, d);
    if (!(no_d > 0.0f)) continue;  // Back rays only hit backfaces
    float t = (r[3] - dot3p(r, p)) / no_d;
    if (!(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
    bool inside = true;
    for (int e = 0; e < 3; ++e) {
      const float* g = r + 4 + 3 * e;
      inside = inside && (dot3p(g, p) + r[13 + e] + t * dot3p(g, d) >= 0.0f);
    }
    if (inside && t <= best_t) {
      best_t = t;
      best_i = i;
    }
  }
  for (int j = 0; j < tb.n_sph; ++j) {
    const float* s = tb.sph + j * SPH_COLS;
    V3 w = v3(s[0] - p.x, s[1] - p.y, s[2] - p.z);
    float qx = w.y * d.z - w.z * d.y, qy = w.z * d.x - w.x * d.z, qz = w.x * d.y - w.y * d.x;
    float dist2 = qx * qx + qy * qy + qz * qz;
    float tc = d.x * w.x + d.y * w.y + d.z * w.z;
    float t = tc + sqrtf(fmaxf(s[3] - dist2, 0.0f));  // far shell (main.rs:273-281)
    if (!(dist2 <= s[3]) || !(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
    if (t <= best_t) {
      best_t = t;
      best_i = tb.n_tri + j;
    }
  }
  BackHit b;
  b.t = best_t;
  b.prim = best_i;
  b.h = v3(p.x + best_t * d.x, p.y + best_t * d.y, p.z + best_t * d.z);
  b.n = v3(0.0f, 0.0f, 0.0f);
  if (best_i >= 0 && best_i < tb.n_tri) {
    const float* r = tb.tri + best_i * TRI_COLS;
    float area2 = r[31];
    float inv_a2 = 1.0f / (area2 != 0.0f ? area2 : 1.0f);
    for (int e = 0; e < 3; ++e) {
      float bary = (dot3p(r + 4 + 3 * e, b.h) + r[13 + e]) * inv_a2;
      b.n.x += bary * r[16 + 3 * e];
      b.n.y += bary * r[17 + 3 * e];
      b.n.z += bary * r[18 + 3 * e];
    }
    b.n = neg(b.n);
  } else if (best_i >= tb.n_tri) {
    const float* s = tb.sph + (best_i - tb.n_tri) * SPH_COLS;
    V3 w = v3(b.h.x - s[0], b.h.y - s[1], b.h.z - s[2]);
    float inv = rsqrtf(fmaxf(w.x * w.x + w.y * w.y + w.z * w.z, 1e-30f));
    b.n = v3(-w.x * inv, -w.y * inv, -w.z * inv);
  }
  return b;
}

struct March {
  bool escaped;
  float travel;
  V3 e, od;  // escape origin and direction
  int prim;  // primitive to exclude (on its BACK face) from the exit ray
  int iters;  // casts, incl. the entry cast
};

// The whole get_refract march (src/main.rs:343-405): entry refraction, the
// interior reflective bounce loop (retries and distance budget), exit
// refraction.  Misses inside the dielectric and trapped rays do not escape.
__device__ inline March march(const Tables& tb, V3 p, V3 n0, V3 d0, float k, bool want,
                       float max_distance, int max_retries) {
  March mm;
  mm.escaped = false;
  mm.travel = 0.0f;
  mm.e = p;
  mm.od = d0;
  mm.prim = -1;
  mm.iters = 0;
  if (!want) return mm;
  bool ok_in;
  V3 r = refract3(n0, d0, k, ok_in);
  if (!ok_in) return mm;  // TIR at entry -> Trapped (main.rs:354-358)
  mm.iters = 1;
  float inv_k = 1.0f / k;
  BackHit b = back_sweep(tb, p, r);
  bool alive = b.t < BIG;  // miss -> Infinite
  bool has_out;
  V3 out = refract3(b.n, r, inv_k, has_out);
  has_out = alive && has_out;
  V3 c = b.h, n = b.n, d = r;
  int prim = b.prim;
  float travel = alive ? b.t : 0.0f;
  int retry = 0;
  while (alive && !has_out && travel <= max_distance && retry < max_retries) {
    V3 f = reflect3(d, n);  // get_reflect on the interior hit (main.rs:380)
    BackHit b2 = back_sweep(tb, c, f);
    ++retry;
    ++mm.iters;
    if (!(b2.t < BIG)) {
      alive = false;
      break;
    }
    bool ok2;
    V3 out2 = refract3(b2.n, f, inv_k, ok2);
    c = b2.h;
    n = b2.n;
    d = f;
    out = out2;
    prim = b2.prim;
    travel = travel + b2.t;
    has_out = ok2;
  }
  mm.escaped = alive && has_out;
  mm.travel = travel;
  mm.e = c;
  mm.od = out;
  mm.prim = prim;
  return mm;
}

}  // namespace rt
