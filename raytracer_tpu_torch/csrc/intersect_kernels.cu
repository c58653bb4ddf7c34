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
// algebra of common.cuh `tri_occluded` (the same device functions the
// level and MC kernels shade with): target = the light's origin and s = 1
// for a position light, target = -direction and s = 0 for a directional
// one.  The triangles' limit in the scaled parameter is DERIVED, limit /
// |L - p| (1 when the caller's limit is the light's distance), where the
// TPU wrapper hard-codes 1.0 (intersect_pallas.py:471).
//
// What bounds them on an H100: instruction issue over the 64 + 4
// primitive tests per ray (a shadow lane runs up to three scans), far above
// the bytes (37-67 B in, 1-10 B out per lane); lanes of a warp leave the
// any-hit scans at different primitives.  The nearest and any-hit kernels
// run one thread per lane, 128 threads per block, tables through const
// __restrict__ global pointers.  The shadow kernel is redesigned for the
// batches the unfused MC walk hands it, in which 8-81 % of the lanes have
// a light to test: those lanes are listed first (common.cuh list_lanes)
// and the launch's first threads take them, 32 to a warp, while every
// other thread writes its own lane's falses and leaves; the blocks that
// test stage the dense table's hot rows in their shared memory and test a
// lane's lights in ONE pass over them (common.cuh DenseRowsGeom<true>
// occluded, as the TPU kernel shares the origin's terms fn.o and the edge
// terms between lights through [T, R] arrays), each light under its own
// limit and leaving the pass at its first occluder.  The one-pass test
// holds every light's target: registers that the MC kernel, which fills
// the card with one walk, could not spare, but a kernel that holds no walk
// state can.  shadow_thread_kernel is the kernel before that design (one
// thread per lane in lane order, one scan per light out of global memory),
// kept as the yardstick chip_smoke.py holds rt_shadow_any_hit against
// (rt_shadow_any_hit_thread); no wrapper of the main path launches it.  W
// is the test counter (common.cuh): NoWork on the main path, Work when the
// caller asks for the test counts (a column a lane; the listed shadow
// kernel: a column a thread, the lane it tested).
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

// The light's shadow ray from p, as common.cuh tri_occluded takes it: the
// factored target (the light's origin, s = 1; or minus its direction, s =
// 0) and the triangles' limit in the scaled parameter, DERIVED from the
// real-unit limit `lim` (<= BIG): lim / |L - p| for a position light, lim
// for a directional one.
struct ShadowRay {
  float s, tlim;
  V3 tg;
};

__device__ __forceinline__ ShadowRay shadow_ray(const float* __restrict__ L, V3 p, float lim) {
  bool is_dir = L[0] == 0.0f;
  V3 lo = v3(L[1], L[2], L[3]), ldir = v3(L[4], L[5], L[6]);
  float tlim = lim;
  if (!is_dir) {  // the light sits at scaled t = 1 along L - p
    V3 off = v3(p.x - lo.x, p.y - lo.y, p.z - lo.z);
    tlim = lim / sqrtf(off.x * off.x + off.y * off.y + off.z * off.z);
  }
  return ShadowRay{is_dir ? 0.0f : 1.0f, tlim, is_dir ? neg(ldir) : lo};
}

// #5: shadow any-hit for every light from one origin per lane.  lanes: the
// lanes with an active light listed (list_lanes), their count at
// lanes[n].  The first threads take the listed lanes; every thread whose
// own lane has no active light writes that lane's `false`s (coalesced).  A
// GROUPED geometry (DenseRowsGeom<true>) tests a lane's active lights in
// groups of LIGHT_GROUP, each group in one pass over the staged rows that
// shares the origin's terms between lights and ends when every light of
// the group has met its first occluder; otherwise (DenseGeom, a table too
// large to stage) one scan per light.  Spheres follow, light by light, for
// the lights no triangle occluded.
template <class G, class W>
__global__ void __launch_bounds__(128)
shadow_kernel(const float* __restrict__ pos, const float* __restrict__ dirs,
              const int* __restrict__ excl_prim, const float* __restrict__ limits,
              const u8* __restrict__ actives, G g, const int* __restrict__ lanes,
              u8* __restrict__ blocked_out, int* __restrict__ work_out, int n) {
  const Tables& tb = g.tb;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int listed = lanes[n];
  W w{};
  if (t < n) {  // a lane with no light to test: its falses, from its own position
    bool any = false;
    for (int l = 0; l < tb.n_light; ++l) any = any || actives[(size_t)l * n + t] != 0;
    if (!any)
      for (int l = 0; l < tb.n_light; ++l) blocked_out[(size_t)l * n + t] = 0;
  }
  if ((int)(blockIdx.x * blockDim.x) < listed) {  // the block holds a listed lane
    g.stage();
    if (t < listed) {
      const int lane = lanes[t];
      const V3 p = load3(pos, lane);
      const int self_prim = excl_prim[lane];
      for (int base = 0; base < tb.n_light; base += LIGHT_GROUP) {
        const int group = min(LIGHT_GROUP, tb.n_light - base);
        unsigned pending = 0, hit = 0;
        float slim[LIGHT_GROUP];
        ShadowGroup sg;
#pragma unroll
        for (int l = 0; l < LIGHT_GROUP; ++l) {
          sg.tg[l] = v3(0.0f, 0.0f, 0.0f);
          sg.s[l] = sg.tlim[l] = slim[l] = 0.0f;
          if (l >= group) continue;
          const size_t at = (size_t)(base + l) * n + lane;
          if (!actives[at]) continue;
          pending |= 1u << l;
          slim[l] = fminf(limits[at], BIG);
          ShadowRay r = shadow_ray(tb.lights + (base + l) * LIGHT_COLS, p, slim[l]);
          sg.s[l] = r.s;
          sg.tg[l] = r.tg;
          sg.tlim[l] = r.tlim;
        }
        if constexpr (G::GROUPED) {
          if (pending) hit = g.occluded(p, self_prim, sg, pending, w);
        } else {
#pragma unroll
          for (int l = 0; l < LIGHT_GROUP; ++l)
            if (((pending >> l) & 1) && g.tri_occluded(p, self_prim, sg.s[l], sg.tg[l],
                                                       sg.tlim[l], w))
              hit |= 1u << l;
        }
#pragma unroll
        for (int l = 0; l < LIGHT_GROUP; ++l) {
          if (l >= group) continue;
          const size_t at = (size_t)(base + l) * n + lane;
          bool blocked = ((hit >> l) & 1) != 0;
          if (((pending >> l) & 1) && !blocked)
            blocked = sph_occluded(tb, p, self_prim, load3(dirs + (size_t)(base + l) * n * 3, lane),
                                   slim[l], w);
          blocked_out[at] = blocked ? 1 : 0;
        }
      }
    }
  }
  if (t < n) w.put(work_out, n, t);
}

// The kernel before the design above: one thread per lane, in lane order,
// one scan per active light over the [T, 34] table in global memory.
template <class W>
__global__ void __launch_bounds__(128)
shadow_thread_kernel(const float* __restrict__ pos, const float* __restrict__ dirs,
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
      float lim = fminf(limits[at], BIG);
      ShadowRay r = shadow_ray(tb.lights + l * LIGHT_COLS, p, lim);
      V3 nd = load3(dirs + (size_t)l * n * 3, lane);
      blocked = tri_occluded(TriRows{tb.tri}, tb.n_tri, p, self_prim, r.s, r.tg, r.tlim, w) ||
                sph_occluded(tb, p, self_prim, nd, lim, w);
    }
    blocked_out[at] = blocked ? 1 : 0;
  }
  w.put(work_out, n, lane);
}

// The shadow walk out of the block's shared memory, all lights of a group
// in one pass.
using ShadowRows = DenseRowsGeom<true>;

template <class G>
int launch_shadow(const float* pos, const float* dirs, const int* excl_prim, const float* limits,
                  const u8* actives, G g, const int* lanes, u8* blocked, int* work, int n,
                  cudaStream_t stream) {
  auto kernel = work ? &shadow_kernel<G, Work> : &shadow_kernel<G, NoWork>;
  int shared = g.smem(128);
  if (shared) {
    int err = coop_opt_in((const void*)kernel, shared);
    if (err) return err;
  }
  kernel<<<(n + 127) / 128, 128, shared, stream>>>(pos, dirs, excl_prim, limits, actives, g,
                                                    lanes, blocked, work, n);
  return (int)cudaGetLastError();
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
// limits; actives: [n_light, n] bool; hot: the [n_tri, 16] hot rows (a
// table too large to stage, DenseRowsGeom::fits, is walked from the
// [n_tri, 34] table); lights: [n_light, 16] (pack_lights); lanes: [n + 1]
// int32 scratch (the listed lanes and their count); blocked: [n_light, n]
// bool.
int rt_shadow_any_hit(const float* pos, const float* dirs, const int* excl_prim,
                      const float* limits, const unsigned char* actives, const float* tri,
                      int n_tri, const float* sph, int n_sph, const float* hot,
                      const float* lights, int n_light, int* lanes, unsigned char* blocked,
                      int* work, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = rt::launch_list_lanes(actives, n_light, n, lanes, st);
  if (err) return err;
  rt::Tables tb{tri, sph, nullptr, lights, n_tri, n_sph, 0, n_light};
  if (rt::ShadowRows::fits(n_tri))
    return rt::launch_shadow(pos, dirs, excl_prim, limits, actives,
                             rt::ShadowRows{tb, (const float4*)hot}, lanes, blocked, work, n, st);
  return rt::launch_shadow(pos, dirs, excl_prim, limits, actives, rt::DenseGeom{tb}, lanes,
                           blocked, work, n, st);
}

// The same test with one thread per lane and one scan per light over the
// table in global memory: what rt_shadow_any_hit is held against.
// Arguments as rt_shadow_any_hit without hot and lanes.
int rt_shadow_any_hit_thread(const float* pos, const float* dirs, const int* excl_prim,
                             const float* limits, const unsigned char* actives, const float* tri,
                             int n_tri, const float* sph, int n_sph, const float* lights,
                             int n_light, unsigned char* blocked, int* work, int n,
                             void* stream) {
  rt::Tables tb{tri, sph, nullptr, lights, n_tri, n_sph, 0, n_light};
  auto kernel = work ? &rt::shadow_thread_kernel<rt::Work> : &rt::shadow_thread_kernel<rt::NoWork>;
  kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      pos, dirs, excl_prim, limits, actives, tb, blocked, work, n, n_light);
  return (int)cudaGetLastError();
}

// Compiled attributes of the main path's instantiation `which` (0 nearest,
// 1 any, 2 shadow, staging the rows of a table of n_tri triangles; 3 the
// shadow kernel's per-thread yardstick), layout as rt_level_attrs.
int rt_intersect_attrs(int which, int n_tri, int* out) {
  using rt::NoWork;
  switch (which) {
    case 0:
      return rt::attrs_of((const void*)rt::nearest_kernel<NoWork>, out);
    case 1:
      return rt::attrs_of((const void*)rt::any_kernel<NoWork>, out);
    case 2:
      return rt::attrs_of((const void*)rt::shadow_kernel<rt::ShadowRows, NoWork>, out,
                          rt::ShadowRows::smem_bytes(n_tri));
    default:
      return rt::attrs_of((const void*)rt::shadow_thread_kernel<NoWork>, out);
  }
}

}  // extern "C"
