// Building blocks shared by the level, MC and binned MC kernels and by the
// standalone nearest-hit, any-hit, shadow and march kernels.
//
// __device__ counterparts of raytracer_tpu/ops/kernel_common.py:105-894
// (full_sweep, eval_material, _ShadowSweep + get_shade,
// back_sweep_with_normal, march_rows, rotate_from_z, reflect3, refract3,
// normalize3) and :978-1786 (the blocked large-mesh sweeps and the
// DenseGeom / BlockedGeom switch), one thread per ray.  The plain PyTorch
// versions the kernels are tested against are
// raytracer_tpu_torch/ops/kernel_common.py.
//
// The TPU workarounds are not carried over: acosf/atan2f/sinf/cosf/powf
// replace the Mosaic polynomials, the winner's attributes are read by
// index instead of a one-hot matrix product, and ints stay ints.
// Semantics kept exactly: face culling, exclusion by (prim, face),
// last-wins ties with spheres scanned after triangles (update on <=),
// non-finite t is a miss, the 3e38 sentinel, kpowf's "0 for base <= 0",
// and the factored-target shadow algebra.
//
// Geometry is a policy type (DenseGeom, BlockedGeom) the kernels are
// templated on.  DenseGeom tests the whole [T, 34] table per sweep.
// BlockedGeom walks the blocked layout (scene/blocked.py): per lane, a
// supergroup's box, then each of its chunks' boxes, bounded by the lane's
// current best hit (or shadow limit), then the chunk's 128 rows; ties go
// to the larger ORIGINAL triangle id, so the visit order cannot change a
// winner.  The TPU's per-tile gates, supergroup visit order and HBM chunk
// streaming are not ported: the permuted table stays in global memory.
//
// Every sweep reports the tests it runs to a counter policy W (Work or
// NoWork, below); chip_smoke.py derives each kernel's operation bound from
// what Work counts.
//
// Scene tables are read straight from global memory.  Build without
// --use_fast_math: the photon filter needs subnormals, and division/sqrt
// must stay IEEE.
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

// Blocked layout (scene/blocked.py, ops/kernel_common.py BLK_COLS)
constexpr int BLK_CHUNK = 128;
constexpr int SUP_CHUNKS = 8;
constexpr int BLK_COLS = 36;
constexpr int BLK_ID = 34;  // original triangle id, as float (-1 = pad row)

struct Tables {
  const float* __restrict__ tri;     // [n_tri, 34]
  const float* __restrict__ sph;     // [n_sph, 8]
  const float* __restrict__ mat;     // [n_obj, 16]
  const float* __restrict__ lights;  // [n_light, 16]
  int n_tri, n_sph, n_obj, n_light;
};

// The blocked tables of a large mesh.
struct Blk {
  const float* __restrict__ tri;  // [NCH * 128, 36] rows in BVH leaf order
  const float* __restrict__ box;  // [NCH, 8] chunk AABBs (min 0:3, max 3:6)
  const float* __restrict__ sup;  // [NCH / 8, 8] supergroup AABBs
  int n_chunks;                   // chunks that hold a triangle
};

// Tests one thread ran, by how far each got, so that an operation bound
// can charge each kind its own cost: triangle tests begun (one dot product
// and its rejection test), those that went on to the plane's t, edge tests
// evaluated, sphere tests and box (slab) tests.  Counting is chosen at
// compile time: the main path's instantiations take NoWork, whose calls
// compile to nothing; a launch given a `work` output takes Work.
constexpr int WORK_ROWS = 5;

struct Work {
  int tri, plane, edge, sph, box;
  __device__ __forceinline__ void tri_test() { ++tri; }
  __device__ __forceinline__ void plane_test() { ++plane; }
  __device__ __forceinline__ void edge_test() { ++edge; }
  __device__ __forceinline__ void sph_test() { ++sph; }
  __device__ __forceinline__ void box_test() { ++box; }
  // into rows of out [WORK_ROWS, n], in the order above
  __device__ __forceinline__ void put(int* __restrict__ out, int n, int lane) const {
    out[lane] = tri;
    out[n + lane] = plane;
    out[2 * n + lane] = edge;
    out[3 * n + lane] = sph;
    out[4 * n + lane] = box;
  }
};

struct NoWork {
  __device__ __forceinline__ void tri_test() {}
  __device__ __forceinline__ void plane_test() {}
  __device__ __forceinline__ void edge_test() {}
  __device__ __forceinline__ void sph_test() {}
  __device__ __forceinline__ void box_test() {}
  __device__ __forceinline__ void put(int*, int, int) const {}
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

// Lane `lane` of an [n, 3] array, and one torch.bool element.
typedef unsigned char u8;

__device__ __forceinline__ V3 load3(const float* __restrict__ a, int lane) {
  return v3(a[3 * lane], a[3 * lane + 1], a[3 * lane + 2]);
}

__device__ __forceinline__ void store3(float* __restrict__ a, int lane, V3 x) {
  a[3 * lane] = x.x;
  a[3 * lane + 1] = x.y;
  a[3 * lane + 2] = x.z;
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

// Signed-area edge tests of triangle row r at o + t d (main.rs:218-227).
template <class W>
__device__ __forceinline__ bool inside_tri(const float* __restrict__ r, V3 o, V3 d, float t,
                                           W& w) {
  bool inside = true;
  for (int e = 0; e < 3; ++e) {
    const float* g = r + 4 + 3 * e;
    if (inside) w.edge_test();
    inside = inside && (dot3p(g, o) + r[13 + e] + t * dot3p(g, d) >= 0.0f);
  }
  return inside;
}

// Ray-AABB slab test (kernel_common._slab_rows :978): box b (min 0:3, max
// 3:6), inv = 1/d (+-inf on axis-parallel rays), inclusive against tmax.
// A NaN (0 * inf: a ray in a box face's plane with a zero direction
// component) is a miss, as torch.minimum/maximum propagate it in the plain
// version; fminf/fmaxf alone would drop it.
__device__ __forceinline__ bool slab(const float* __restrict__ b, V3 o, V3 inv, float tmax) {
  float t0x = (b[0] - o.x) * inv.x, t1x = (b[3] - o.x) * inv.x;
  float t0y = (b[1] - o.y) * inv.y, t1y = (b[4] - o.y) * inv.y;
  float t0z = (b[2] - o.z) * inv.z, t1z = (b[5] - o.z) * inv.z;
  if (isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) || isnan(t0z) || isnan(t1z))
    return false;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tn <= fminf(tf, tmax) && tf >= 0.0f;
}

__device__ __forceinline__ V3 inv3(V3 d) { return V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z}; }

// ---------------------------------------------------------------------------
// Nearest sweep with attributes (World::cast, kernel_common.full_sweep)
// ---------------------------------------------------------------------------

struct Hit {
  bool valid, back;
  int prim, obj;
  float t, u, v;
  V3 p, n;
};

// Spheres after the triangles: update on <=, so a sphere wins an exact tie.
template <class W>
__device__ inline void sph_nearest(const Tables& tb, V3 o, V3 d, int face, int excl_prim,
                                   int excl_face, float& best_t, int& best_i, bool& best_bf,
                                   W& w) {
  for (int j = 0; j < tb.n_sph; ++j) {
    w.sph_test();
    const float* s = tb.sph + j * SPH_COLS;
    V3 c = v3(s[0] - o.x, s[1] - o.y, s[2] - o.z);
    float qx = c.y * d.z - c.z * d.y, qy = c.z * d.x - c.x * d.z, qz = c.x * d.y - c.y * d.x;
    float dist2 = qx * qx + qy * qy + qz * qz;
    float tc = d.x * c.x + d.y * c.y + d.z * c.z;
    float kk = sqrtf(fmaxf(s[3] - dist2, 0.0f));
    bool bf = face == FACE_BACK || (face != FACE_FRONT && tc < kk);
    float t = bf ? tc + kk : tc - kk;
    int prim = tb.n_tri + j;
    if (excl_prim == prim && excl_crit(excl_face, bf)) continue;
    if (!(dist2 <= s[3]) || !(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
    if (t <= best_t) {
      best_t = t;
      best_i = prim;
      best_bf = bf;
    }
  }
}

// The winner's hit point, shading normal, uv and object.  `row` is the
// winning triangle's packed row (dense or blocked table), or null.
__device__ inline Hit finish_hit(const Tables& tb, const float* __restrict__ row, V3 o, V3 d,
                                 float best_t, int best_i, bool best_bf, bool active) {
  Hit h;
  bool valid = best_t < BIG;
  float t_hit = valid ? best_t : 0.0f;
  h.p = v3(o.x + t_hit * d.x, o.y + t_hit * d.y, o.z + t_hit * d.z);
  h.n = v3(0.0f, 0.0f, 0.0f);
  h.u = 0.0f;
  h.v = 0.0f;
  float obj = 0.0f;
  if (best_i >= 0 && best_i < tb.n_tri) {
    const float* r = row;
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

// Triangles in index order: update on <=, so the last of equal t's wins.
template <class W>
__device__ inline void tri_nearest(const Tables& tb, V3 o, V3 d, int face, int excl_prim,
                                   int excl_face, float& best_t, int& best_i, bool& best_bf,
                                   W& w) {
  for (int i = 0; i < tb.n_tri; ++i) {
    w.tri_test();
    const float* r = tb.tri + i * TRI_COLS;
    float no_d = dot3p(r, d);
    bool bf = no_d > 0.0f;
    if ((bf && face == FACE_FRONT) || (!bf && face == FACE_BACK)) continue;  // culled
    if (excl_prim == i && excl_crit(excl_face, bf)) continue;
    w.plane_test();
    float t = (r[3] - dot3p(r, o)) / no_d;
    if (!(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
    if (inside_tri(r, o, d, t, w) && t <= best_t) {
      best_t = t;
      best_i = i;
      best_bf = bf;
    }
  }
}

template <class W>
__device__ inline Hit full_sweep(const Tables& tb, V3 o, V3 d, int face, int excl_prim,
                                 int excl_face, bool active, W& w) {
  float best_t = BIG;
  int best_i = -1;
  bool best_bf = false;
  if (active) {
    tri_nearest(tb, o, d, face, excl_prim, excl_face, best_t, best_i, best_bf, w);
    sph_nearest(tb, o, d, face, excl_prim, excl_face, best_t, best_i, best_bf, w);
  }
  const float* row = (best_i >= 0 && best_i < tb.n_tri) ? tb.tri + best_i * TRI_COLS : nullptr;
  return finish_hit(tb, row, o, d, best_t, best_i, best_bf, active);
}

// Nearest triangle over the blocked table (blocked_full_sweep :1175 /
// blocked_back_sweep :1562).  BACK_ONLY: interior rays, backfaces only and
// no exclusion.  (t, original id) compared lexicographically: equal t goes
// to the larger id, the dense scan's last-wins rule in any visit order.
struct TriBest {
  float t;
  int id, row;
  bool bf;
};

template <bool BACK_ONLY, class W>
__device__ inline void blocked_tris(const Blk& bk, V3 o, V3 d, int face, int excl_prim,
                                    int excl_face, TriBest& b, W& w) {
  V3 inv = inv3(d);
  for (int c0 = 0; c0 < bk.n_chunks; c0 += SUP_CHUNKS) {
    w.box_test();
    if (!slab(bk.sup + (c0 / SUP_CHUNKS) * 8, o, inv, b.t)) continue;
    int c1 = c0 + SUP_CHUNKS < bk.n_chunks ? c0 + SUP_CHUNKS : bk.n_chunks;
    for (int c = c0; c < c1; ++c) {
      w.box_test();
      if (!slab(bk.box + c * 8, o, inv, b.t)) continue;
      const float* r = bk.tri + (size_t)c * BLK_CHUNK * BLK_COLS;
      for (int k = 0; k < BLK_CHUNK; ++k, r += BLK_COLS) {
        int id = (int)r[BLK_ID];
        if (id < 0) break;  // pad rows fill the last chunk's tail
        w.tri_test();
        float no_d = dot3p(r, d);
        bool bf = no_d > 0.0f;
        if (BACK_ONLY) {
          if (!bf) continue;
        } else {
          if ((bf && face == FACE_FRONT) || (!bf && face == FACE_BACK)) continue;
          if (excl_prim == id && excl_crit(excl_face, bf)) continue;
        }
        w.plane_test();
        float t = (r[3] - dot3p(r, o)) / no_d;
        if (!(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
        if (inside_tri(r, o, d, t, w) && (t < b.t || (t == b.t && id > b.id))) {
          b.t = t;
          b.id = id;
          b.row = c * BLK_CHUNK + k;
          b.bf = bf;
        }
      }
    }
  }
}

template <class W>
__device__ inline Hit blocked_full_sweep(const Tables& tb, const Blk& bk, V3 o, V3 d, int face,
                                         int excl_prim, int excl_face, bool active, W& w) {
  TriBest b{BIG, -1, 0, false};
  if (active) {
    blocked_tris<false>(bk, o, d, face, excl_prim, excl_face, b, w);
    sph_nearest(tb, o, d, face, excl_prim, excl_face, b.t, b.id, b.bf, w);
  }
  const float* row =
      (b.id >= 0 && b.id < tb.n_tri) ? bk.tri + (size_t)b.row * BLK_COLS : nullptr;
  return finish_hit(tb, row, o, d, b.t, b.id, b.bf, active);
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
// Shadow any-hit (kernel_common._ShadowSweep / _BlockedShadowSweep)
// ---------------------------------------------------------------------------

// Dense triangles, factored-target algebra: target `tg` (light origin, s=1,
// scaled t limit 1; or the negated direction, s=0, real limit).
template <class W>
__device__ inline bool tri_occluded(const Tables& tb, V3 p, int self_prim, float s, V3 tg,
                                    float tlim, W& w) {
  for (int i = 0; i < tb.n_tri; ++i) {
    if (i == self_prim) continue;
    w.tri_test();
    const float* r = tb.tri + i * TRI_COLS;
    float o_fn = dot3p(r, p);
    float num = r[3] - o_fn;
    if (!(num > 0.0f)) continue;
    w.plane_test();
    float no_d = dot3p(r, tg) - s * o_fn;
    if (!(no_d > 0.0f)) continue;
    float t = num / no_d;
    if (!isfinite(t) || !(t < tlim)) continue;
    bool inside = true;
    for (int e = 0; e < 3; ++e) {
      const float* g = r + 4 + 3 * e;
      float ogh = dot3p(g, p) + r[13 + e];
      float c_g = dot3p(g, tg) + s * r[13 + e];
      if (inside) w.edge_test();
      inside = inside && (ogh + t * (c_g - s * ogh) >= 0.0f);
    }
    if (inside) return true;
  }
  return false;
}

// Blocked triangles: the per-lane unnormalized direction dd = tg - s p
// toward the light (blocked_multi :1499-1511), t in the same units below
// tlim, and the same dd and tlim in the slab tests.  Returns at the first
// occluder.  The TPU tests all lights in one pass over a tile's chunks to
// load each chunk once; per lane the answer is the same.
template <class W>
__device__ inline bool blocked_tri_occluded(const Blk& bk, V3 p, int self_prim, float s, V3 tg,
                                            float tlim, W& w) {
  V3 dd = v3(tg.x - s * p.x, tg.y - s * p.y, tg.z - s * p.z);
  V3 inv = inv3(dd);
  for (int c0 = 0; c0 < bk.n_chunks; c0 += SUP_CHUNKS) {
    w.box_test();
    if (!slab(bk.sup + (c0 / SUP_CHUNKS) * 8, p, inv, tlim)) continue;
    int c1 = c0 + SUP_CHUNKS < bk.n_chunks ? c0 + SUP_CHUNKS : bk.n_chunks;
    for (int c = c0; c < c1; ++c) {
      w.box_test();
      if (!slab(bk.box + c * 8, p, inv, tlim)) continue;
      const float* r = bk.tri + (size_t)c * BLK_CHUNK * BLK_COLS;
      for (int k = 0; k < BLK_CHUNK; ++k, r += BLK_COLS) {
        int id = (int)r[BLK_ID];
        if (id < 0) break;
        if (id == self_prim) continue;
        w.tri_test();
        float num = r[3] - dot3p(r, p);
        float no_d = dot3p(r, dd);
        float t = num / no_d;
        if (!(no_d > 0.0f) || !(t > 0.0f)) continue;
        w.plane_test();
        bool inside = true;
        for (int e = 0; e < 3; ++e) {
          const float* g = r + 4 + 3 * e;
          float ogh = dot3p(g, p) + r[13 + e];
          if (inside) w.edge_test();
          inside = inside && (ogh + t * dot3p(g, dd) >= 0.0f);
        }
        if (inside && isfinite(t) && t < tlim) return true;
      }
    }
  }
  return false;
}

// Spheres: the normalized direction `nd` toward the light and the
// real-unit limit `slim`; shadow rays take the far shell.
template <class W>
__device__ inline bool sph_occluded(const Tables& tb, V3 p, int self_prim, V3 nd, float slim,
                                    W& w) {
  for (int j = 0; j < tb.n_sph; ++j) {
    if (tb.n_tri + j == self_prim) continue;
    w.sph_test();
    const float* sp = tb.sph + j * SPH_COLS;
    V3 c = v3(sp[0] - p.x, sp[1] - p.y, sp[2] - p.z);
    float qx = c.y * nd.z - c.z * nd.y, qy = c.z * nd.x - c.x * nd.z, qz = c.x * nd.y - c.y * nd.x;
    float dist2 = qx * qx + qy * qy + qz * qz;
    float tc = nd.x * c.x + nd.y * c.y + nd.z * c.z;
    float t = tc + sqrtf(fmaxf(sp[3] - dist2, 0.0f));  // far shell
    if (dist2 <= sp[3] && t > 0.0f && isfinite(t) && t < slim) return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// Interior back-face sweep (back_sweep_with_normal / blocked_back_sweep)
// ---------------------------------------------------------------------------

struct BackHit {
  float t;  // BIG on a miss
  int prim;
  V3 h, n;  // hit point p + t d, flipped unnormalized interior normal
};

// Spheres' far shells after the triangles, then the hit point and normal.
template <class W>
__device__ inline BackHit finish_back(const Tables& tb, const float* __restrict__ row, V3 p,
                                      V3 d, float best_t, int best_i, W& w) {
  for (int j = 0; j < tb.n_sph; ++j) {
    w.sph_test();
    const float* s = tb.sph + j * SPH_COLS;
    V3 c = v3(s[0] - p.x, s[1] - p.y, s[2] - p.z);
    float qx = c.y * d.z - c.z * d.y, qy = c.z * d.x - c.x * d.z, qz = c.x * d.y - c.y * d.x;
    float dist2 = qx * qx + qy * qy + qz * qz;
    float tc = d.x * c.x + d.y * c.y + d.z * c.z;
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
    const float* r = row;
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
    V3 c = v3(b.h.x - s[0], b.h.y - s[1], b.h.z - s[2]);
    float inv = rsqrtf(fmaxf(c.x * c.x + c.y * c.y + c.z * c.z, 1e-30f));
    b.n = v3(-c.x * inv, -c.y * inv, -c.z * inv);
  }
  return b;
}

// Back-face-only nearest sweep + interior normal; no exclusion.
template <class W>
__device__ inline BackHit back_sweep(const Tables& tb, V3 p, V3 d, W& w) {
  float best_t = BIG;
  int best_i = -1;
  for (int i = 0; i < tb.n_tri; ++i) {
    w.tri_test();
    const float* r = tb.tri + i * TRI_COLS;
    float no_d = dot3p(r, d);
    if (!(no_d > 0.0f)) continue;  // Back rays only hit backfaces
    w.plane_test();
    float t = (r[3] - dot3p(r, p)) / no_d;
    if (!(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
    if (inside_tri(r, p, d, t, w) && t <= best_t) {
      best_t = t;
      best_i = i;
    }
  }
  const float* row = (best_i >= 0) ? tb.tri + best_i * TRI_COLS : nullptr;
  return finish_back(tb, row, p, d, best_t, best_i, w);
}

template <class W>
__device__ inline BackHit blocked_back_sweep(const Tables& tb, const Blk& bk, V3 p, V3 d, W& w) {
  TriBest b{BIG, -1, 0, false};
  blocked_tris<true>(bk, p, d, FACE_BACK, -1, FACE_BACK, b, w);
  const float* row = (b.id >= 0) ? bk.tri + (size_t)b.row * BLK_COLS : nullptr;
  return finish_back(tb, row, p, d, b.t, b.id, w);
}

// ---------------------------------------------------------------------------
// Geometry policies (kernel_common.DenseGeom :1715 / BlockedGeom :1739)
// ---------------------------------------------------------------------------

struct DenseGeom {
  Tables tb;
  template <class W>
  __device__ Hit nearest(V3 o, V3 d, int face, int excl_prim, int excl_face, bool active,
                         W& w) const {
    return full_sweep(tb, o, d, face, excl_prim, excl_face, active, w);
  }
  template <class W>
  __device__ bool tri_occluded(V3 p, int self_prim, float s, V3 tg, float tlim, W& w) const {
    return rt::tri_occluded(tb, p, self_prim, s, tg, tlim, w);
  }
  template <class W>
  __device__ BackHit back(V3 p, V3 d, W& w) const { return back_sweep(tb, p, d, w); }
};

struct BlockedGeom {
  Tables tb;  // spheres, materials, lights (tb.tri is not read)
  Blk bk;
  template <class W>
  __device__ Hit nearest(V3 o, V3 d, int face, int excl_prim, int excl_face, bool active,
                         W& w) const {
    return blocked_full_sweep(tb, bk, o, d, face, excl_prim, excl_face, active, w);
  }
  template <class W>
  __device__ bool tri_occluded(V3 p, int self_prim, float s, V3 tg, float tlim, W& w) const {
    return blocked_tri_occluded(bk, p, self_prim, s, tg, tlim, w);
  }
  template <class W>
  __device__ BackHit back(V3 p, V3 d, W& w) const { return blocked_back_sweep(tb, bk, p, d, w); }
};

// ---------------------------------------------------------------------------
// Direct shading (kernel_common.get_shade)
// ---------------------------------------------------------------------------

// Direct radiance at p (get_shade): na = bump-ADJUSTED normal, vd = view
// (-ray direction).  Adds the shadow rays cast to `count`.
template <class G, class W>
__device__ inline V3 get_shade(const G& g, const Mat& m, V3 p, V3 na, V3 vd, bool active,
                               int self_prim, int& count, W& w) {
  const Tables& tb = g.tb;
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
    // position lights: target L, scaled t limit 1 (= |L - p| / |L - p|);
    // directional: target -dir, real limit
    if (g.tri_occluded(p, self_prim, is_dir ? 0.0f : 1.0f, is_dir ? neg(ldir) : lo,
                       is_dir ? limit : 1.0f, w) ||
        sph_occluded(tb, p, self_prim, neg(ld), limit, w))
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
template <class G, class W>
__device__ __forceinline__ V3 shade_at(const G& g, const Mat& m, V3 p, V3 n, V3 ray_d,
                                       bool active, int self_prim, int& count, W& w) {
  return get_shade(g, m, p, rotate_from_z(n, m.tn), neg(ray_d), active, self_prim, count, w);
}

// ---------------------------------------------------------------------------
// Interior march (get_refract, kernel_common.march_rows)
// ---------------------------------------------------------------------------

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
template <class G, class W>
__device__ inline March march(const G& g, V3 p, V3 n0, V3 d0, float k, bool want,
                              float max_distance, int max_retries, W& w) {
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
  BackHit b = g.back(p, r, w);
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
    BackHit b2 = g.back(c, f, w);
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

// Compiled attributes of kernel `fn` (host): out = {registers per thread,
// local (spill + stack) bytes per thread, static shared bytes, max threads
// per block}.
inline int attrs_of(const void* fn, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace rt
