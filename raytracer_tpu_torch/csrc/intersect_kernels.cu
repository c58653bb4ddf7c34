// Standalone sweep kernels of the unfused path: nearest hit, any hit and
// the multi-light shadow any-hit.
//
// Replace the TPU kernels of raytracer_tpu/ops/intersect_pallas.py:
//   :172 `_kernel`        (wrapper `nearest_hit` :269)    -> nearest_kernel
//   :212 `_any_kernel`    (wrapper `any_hit` :302)        -> any_kernel
//   :335 `_shadow_kernel` (wrapper `shadow_any_hit` :438) -> shadow_kernel
// Plain versions: raytracer_tpu_torch/ops/intersect_kernel.py
// (`nearest_hit_plain`, `any_hit_plain`, `shadow_any_hit_plain`).
//
// One thread per ray scans the dense tables (all triangles, then all
// spheres) in index order.  The serial scan gives the reference's
// tie-break for free: update on t <= best, so the last of equal t's wins
// and a sphere beats a triangle at equal t.  The any-hit and shadow scans
// return at the first occluder.  Rays arrive as the unfused path holds
// them, [N, 3] rows, int32 fields and bool masks (one byte each), and the
// results leave in the form the callers read (t = +inf and idx = -1 on a
// miss, bool flags), so no pack / unpack pass runs around a launch.  The
// TPU's layout is not carried over: no [4, N] int32 meta block, no
// [prims x lanes] candidate matrix with its min / one-hot reductions, no
// lane padding to a tile.
//
// The shadow kernel takes what ops/shade.get_shade has per (light, lane):
// the normalised direction to the light and the real-unit limit (spheres),
// the mask of considered lanes, and the scene's light table, from which it
// reads each light's target itself.  Triangles use the factored-target
// algebra of common.cuh `tri_occluded` (the same device function the level
// and MC kernels shade with): target = the light's origin and s = 1 for a
// position light, target = -direction and s = 0 for a directional one.
// The triangles' limit in the scaled parameter is DERIVED, limit / |L - p|
// (1 when the caller's limit is the light's distance), where the TPU
// wrapper hard-codes 1.0 (intersect_pallas.py:471).  The TPU kernel shares
// the origin terms (fn.o, the edge terms) between lights through [T, R]
// arrays; one thread has no room for 64 triangles' terms, so each light's
// scan recomputes them, and stops at its first occluder instead.
//
// What bounds them on an H100: instruction issue over the 64 + 4
// primitive tests per ray (a shadow lane runs up to three scans), far above
// the bytes (37-67 B in, 1-10 B out per lane); lanes of a warp leave the
// any-hit scans at different primitives.  128 threads per block, tables
// through const __restrict__ global pointers.  W is the test counter
// (common.cuh): NoWork on the main path, Work when the caller asks for the
// per-lane test counts.
#include "common.cuh"

namespace rt {

// #3: nearest t, primitive and backface per ray.
template <class W>
__global__ void __launch_bounds__(128)
nearest_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
               const int* __restrict__ face, const int* __restrict__ excl_prim,
               const int* __restrict__ excl_face, const u8* __restrict__ active, Tables tb,
               float* __restrict__ t_out, int* __restrict__ idx_out, u8* __restrict__ bf_out,
               u8* __restrict__ valid_out, int* __restrict__ work_out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  W w{};
  float best_t = BIG;
  int best_i = -1;
  bool best_bf = false;
  if (active[lane]) {
    V3 o = load3(ray_o, lane), d = load3(ray_d, lane);
    int f = face[lane], ep = excl_prim[lane], ef = excl_face[lane];
    tri_nearest<false>(TriRows{tb.tri}, tb.n_tri, o, d, f, ep, ef, best_t, best_i, best_bf, w);
    sph_nearest(tb, o, d, f, ep, ef, best_t, best_i, best_bf, w);
  }
  bool valid = best_t < BIG;
  t_out[lane] = valid ? best_t : INFINITY;
  idx_out[lane] = best_i;
  bf_out[lane] = best_bf ? 1 : 0;
  valid_out[lane] = valid ? 1 : 0;
  w.put(work_out, n, lane);
}

// Any valid triangle candidate with t < limit (limit <= BIG)?
template <class W>
__device__ inline bool tri_any(const Tables& tb, V3 o, V3 d, int face, int excl_prim,
                               int excl_face, float limit, W& w) {
  for (int i = 0; i < tb.n_tri; ++i) {
    w.tri_test();
    const float* r = tb.tri + i * TRI_COLS;
    float no_d = dot3p(r, d);
    bool bf = no_d > 0.0f;
    if ((bf && face == FACE_FRONT) || (!bf && face == FACE_BACK)) continue;  // culled
    if (excl_prim == i && excl_crit(excl_face, bf)) continue;
    w.plane_test();
    float t = (r[3] - dot3p(r, o)) / no_d;
    if (!(t > 0.0f) || !isfinite(t) || !(t < limit)) continue;
    if (inside_tri(r, o, d, t, w)) return true;
  }
  return false;
}

template <class W>
__device__ inline bool sph_any(const Tables& tb, V3 o, V3 d, int face, int excl_prim,
                               int excl_face, float limit, W& w) {
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
    if (excl_prim == tb.n_tri + j && excl_crit(excl_face, bf)) continue;
    if (dist2 <= s[3] && t > 0.0f && isfinite(t) && t < limit) return true;
  }
  return false;
}

// #4: occlusion under a per-ray limit.
template <class W>
__global__ void __launch_bounds__(128)
any_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
           const int* __restrict__ face, const int* __restrict__ excl_prim,
           const int* __restrict__ excl_face, const u8* __restrict__ active,
           const float* __restrict__ limit, Tables tb, u8* __restrict__ blocked_out,
           int* __restrict__ work_out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  W w{};
  bool blocked = false;
  if (active[lane]) {
    V3 o = load3(ray_o, lane), d = load3(ray_d, lane);
    int f = face[lane], ep = excl_prim[lane], ef = excl_face[lane];
    float lim = fminf(limit[lane], BIG);
    blocked = tri_any(tb, o, d, f, ep, ef, lim, w) || sph_any(tb, o, d, f, ep, ef, lim, w);
  }
  blocked_out[lane] = blocked ? 1 : 0;
  w.put(work_out, n, lane);
}

// #5: shadow any-hit for every light from one origin per lane.
template <class W>
__global__ void __launch_bounds__(128)
shadow_kernel(const float* __restrict__ pos, const float* __restrict__ dirs,
              const int* __restrict__ excl_prim, const float* __restrict__ limits,
              const u8* __restrict__ actives, Tables tb, u8* __restrict__ blocked_out,
              int* __restrict__ work_out, int n, int n_light) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  W w{};
  V3 p = load3(pos, lane);
  int self_prim = excl_prim[lane];
  for (int l = 0; l < n_light; ++l) {
    size_t at = (size_t)l * n + lane;
    bool blocked = false;
    if (actives[at]) {
      const float* L = tb.lights + l * LIGHT_COLS;
      bool is_dir = L[0] == 0.0f;
      V3 lo = v3(L[1], L[2], L[3]), ldir = v3(L[4], L[5], L[6]);
      float lim = fminf(limits[at], BIG);
      float tlim = lim;
      if (!is_dir) {  // the light sits at scaled t = 1 along L - p
        V3 off = v3(p.x - lo.x, p.y - lo.y, p.z - lo.z);
        tlim = lim / sqrtf(off.x * off.x + off.y * off.y + off.z * off.z);
      }
      V3 nd = load3(dirs + (size_t)l * n * 3, lane);
      blocked = tri_occluded(TriRows{tb.tri}, tb.n_tri, p, self_prim, is_dir ? 0.0f : 1.0f,
                             is_dir ? neg(ldir) : lo, tlim, w) ||
                sph_occluded(tb, p, self_prim, nd, lim, w);
    }
    blocked_out[at] = blocked ? 1 : 0;
  }
  w.put(work_out, n, lane);
}

inline Tables geometry(const float* tri, int n_tri, const float* sph, int n_sph) {
  return Tables{tri, sph, nullptr, nullptr, n_tri, n_sph, 0, 0};
}

}  // namespace rt

extern "C" {

// ray_o, ray_d: [n, 3] float32; face, excl_prim, excl_face: [n] int32;
// active: [n] bool; t: [n] (+inf on a miss); idx: [n] (-1); bf, valid: [n]
// bool; work: [WORK_ROWS, n] or null (null runs the instantiation that
// counts nothing).
int rt_nearest_hit(const float* ray_o, const float* ray_d, const int* face,
                   const int* excl_prim, const int* excl_face, const unsigned char* active,
                   const float* tri, int n_tri, const float* sph, int n_sph, float* t, int* idx,
                   unsigned char* bf, unsigned char* valid, int* work, int n, void* stream) {
  rt::Tables tb = rt::geometry(tri, n_tri, sph, n_sph);
  auto kernel = work ? &rt::nearest_kernel<rt::Work> : &rt::nearest_kernel<rt::NoWork>;
  kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      ray_o, ray_d, face, excl_prim, excl_face, active, tb, t, idx, bf, valid, work, n);
  return (int)cudaGetLastError();
}

// As rt_nearest_hit, plus limit: [n] float32 (min(limit, 3e38) applies);
// blocked: [n] bool.
int rt_any_hit(const float* ray_o, const float* ray_d, const int* face, const int* excl_prim,
               const int* excl_face, const unsigned char* active, const float* limit,
               const float* tri, int n_tri, const float* sph, int n_sph, unsigned char* blocked,
               int* work, int n, void* stream) {
  rt::Tables tb = rt::geometry(tri, n_tri, sph, n_sph);
  auto kernel = work ? &rt::any_kernel<rt::Work> : &rt::any_kernel<rt::NoWork>;
  kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      ray_o, ray_d, face, excl_prim, excl_face, active, limit, tb, blocked, work, n);
  return (int)cudaGetLastError();
}

// pos: [n, 3]; dirs: [n_light, n, 3] normalised, toward each light;
// excl_prim: [n] the shaded primitive; limits: [n_light, n] real-unit
// limits; actives: [n_light, n] bool; lights: [n_light, 16] (pack_lights);
// blocked: [n_light, n] bool.
int rt_shadow_any_hit(const float* pos, const float* dirs, const int* excl_prim,
                      const float* limits, const unsigned char* actives, const float* tri,
                      int n_tri, const float* sph, int n_sph, const float* lights, int n_light,
                      unsigned char* blocked, int* work, int n, void* stream) {
  rt::Tables tb{tri, sph, nullptr, lights, n_tri, n_sph, 0, n_light};
  auto kernel = work ? &rt::shadow_kernel<rt::Work> : &rt::shadow_kernel<rt::NoWork>;
  kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      pos, dirs, excl_prim, limits, actives, tb, blocked, work, n, n_light);
  return (int)cudaGetLastError();
}

// Compiled attributes of the main path's instantiation `which` (0 nearest,
// 1 any, 2 shadow), layout as rt_level_attrs.
int rt_intersect_attrs(int which, int* out) {
  const void* fn = which == 0   ? (const void*)rt::nearest_kernel<rt::NoWork>
                   : which == 1 ? (const void*)rt::any_kernel<rt::NoWork>
                                : (const void*)rt::shadow_kernel<rt::NoWork>;
  return rt::attrs_of(fn, out);
}

}  // extern "C"
