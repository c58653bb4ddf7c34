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
// any-hit scans at different primitives; and, in the batches the unfused
// path hands them, idle lanes: the advance casts of an MC walk and the
// Whitted ladder's casts test only the lanes still alive, the shadow test
// only the lanes with a light, and in lane order a warp runs as long as
// its longest lane.  So all three kernels list the lanes with work first
// (common.cuh list_lanes: the active lanes; for the shadow kernel, the
// lanes with an active light), and the launch's first threads take them,
// 32 to a warp, while every other thread writes its own lane's empty
// result (a miss, a false) and leaves: whole blocks past the list at once.
// The blocks that test stage the dense table's 64-byte hot rows in their
// shared memory and sweep them as broadcast float4s (common.cuh
// DenseRowsGeom; a table too large to stage, DenseRowsGeom::fits, is
// walked by DenseGeom out of global memory: the same kernels under another
// geometry policy).  The nearest-hit and any-hit sweeps (tri_nearest,
// tri_any) take either row source, so a listed lane and the same lane in
// its per-thread yardstick make the same tests in the same order: equal
// results and test counts.  The shadow kernel tests a lane's lights in ONE
// pass over the rows (common.cuh DenseRowsGeom<true> occluded, as the TPU
// kernel shares the origin's terms fn.o and the edge terms between lights
// through [T, R] arrays), each light under its own limit and leaving the
// pass at its first occluder.  The one-pass test holds every light's
// target: registers that the MC kernel, which fills the card with one
// walk, could not spare, but a kernel that holds no walk state can.
// nearest_thread_kernel, any_thread_kernel and shadow_thread_kernel are
// the kernels before that design (one thread per lane in lane order over
// the [T, 34] table in global memory; the shadow test one scan per light),
// kept as the yardsticks chip_smoke.py holds the main path's kernels
// against (rt_nearest_hit_thread, rt_any_hit_thread,
// rt_shadow_any_hit_thread); no wrapper of the main path launches them.  W
// is the test counter (common.cuh): NoWork on the main path, Work when the
// caller asks for the test counts (the listed kernels: a column a thread,
// the lane it tested; the yardsticks: a column a lane).
#include "common.cuh"

namespace rt {

// The rows a dense sweep reads: a geometry's hot rows staged in the block's
// shared memory, or the [T, 34] table in global memory.
__device__ __forceinline__ TriRows rows_of(const DenseGeom& g) { return TriRows{g.tb.tri}; }
__device__ __forceinline__ HotRows rows_of(const DenseRowsGeom<false>& g) { return g.staged(); }

// A lane's nearest hit: t (BIG on a miss), primitive (-1) and backface.
struct Nearest {
  float t;
  int i;
  bool bf;
};

__device__ __forceinline__ void put_nearest(int lane, Nearest b, float* __restrict__ t_out,
                                            int* __restrict__ idx_out, u8* __restrict__ bf_out,
                                            u8* __restrict__ valid_out) {
  bool valid = b.t < BIG;
  t_out[lane] = valid ? b.t : INFINITY;
  idx_out[lane] = b.i;
  bf_out[lane] = b.bf ? 1 : 0;
  valid_out[lane] = valid ? 1 : 0;
}

// One lane's nearest hit over rows `rows` (TriRows or HotRows), then the
// spheres.
template <class R, class W>
__device__ __forceinline__ Nearest nearest_lane(R rows, const Tables& tb, int lane,
                                                const float* __restrict__ ray_o,
                                                const float* __restrict__ ray_d,
                                                const int* __restrict__ face,
                                                const int* __restrict__ excl_prim,
                                                const int* __restrict__ excl_face, W& w) {
  Nearest b{BIG, -1, false};
  V3 o = load3(ray_o, lane), d = load3(ray_d, lane);
  int f = face[lane], ep = excl_prim[lane], ef = excl_face[lane];
  tri_nearest<false>(rows, tb.n_tri, o, d, f, ep, ef, b.t, b.i, b.bf, w);
  sph_nearest(tb, o, d, f, ep, ef, b.t, b.i, b.bf, w);
  return b;
}

// #3: nearest t, primitive and backface per ray.  lanes: the active lanes
// listed (list_lanes), their count at lanes[n].  The first threads take the
// listed lanes; every thread whose own lane is not active writes that
// lane's miss (coalesced), and blocks past the list leave at once.
template <class G, class W>
__global__ void __launch_bounds__(128)
nearest_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
               const int* __restrict__ face, const int* __restrict__ excl_prim,
               const int* __restrict__ excl_face, const u8* __restrict__ active, G g,
               const int* __restrict__ lanes, float* __restrict__ t_out,
               int* __restrict__ idx_out, u8* __restrict__ bf_out, u8* __restrict__ valid_out,
               int* __restrict__ work_out, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int listed = lanes[n];
  W w{};
  if (t < n && !active[t]) put_nearest(t, Nearest{BIG, -1, false}, t_out, idx_out, bf_out,
                                       valid_out);
  if ((int)(blockIdx.x * blockDim.x) < listed) {  // the block holds a listed lane
    g.stage();
    if (t < listed) {
      const int lane = lanes[t];
      put_nearest(lane,
                  nearest_lane(rows_of(g), g.tb, lane, ray_o, ray_d, face, excl_prim,
                               excl_face, w),
                  t_out, idx_out, bf_out, valid_out);
    }
  }
  if (t < n) w.put(work_out, n, t);
}

// The kernel before the design above: one thread per lane, in lane order,
// over the [T, 34] table in global memory.
template <class W>
__global__ void __launch_bounds__(128)
nearest_thread_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                      const int* __restrict__ face, const int* __restrict__ excl_prim,
                      const int* __restrict__ excl_face, const u8* __restrict__ active,
                      Tables tb, float* __restrict__ t_out, int* __restrict__ idx_out,
                      u8* __restrict__ bf_out, u8* __restrict__ valid_out,
                      int* __restrict__ work_out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  W w{};
  Nearest b{BIG, -1, false};
  if (active[lane])
    b = nearest_lane(TriRows{tb.tri}, tb, lane, ray_o, ray_d, face, excl_prim, excl_face, w);
  put_nearest(lane, b, t_out, idx_out, bf_out, valid_out);
  w.put(work_out, n, lane);
}

// Any valid triangle candidate with t < limit (limit <= BIG), over rows
// `rows` in index order; returns at the first.
template <class R, class W>
__device__ inline bool tri_any(R rows, int n_tri, V3 o, V3 d, int face, int excl_prim,
                               int excl_face, float limit, W& w) {
  for (int i = 0; i < n_tri; ++i) {
    w.tri_test();
    Plane a = rows.plane(i);
    float no_d = dot3_sep(a.fn, d);
    bool bf = no_d > 0.0f;
    if ((bf && face == FACE_FRONT) || (!bf && face == FACE_BACK)) continue;  // culled
    if (excl_prim == i && excl_crit(excl_face, bf)) continue;
    w.plane_test();
    float t = (a.d - dot3_sep(a.fn, o)) / no_d;
    if (!(t > 0.0f) || !isfinite(t) || !(t < limit)) continue;
    HotEdges eg = rows.edges(i);
    bool inside = true;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      if (inside) w.edge_test();
      inside = inside && edge_in(dot3_sep(eg.g[e], o) + eg.h[e], t, dot3_sep(eg.g[e], d));
    }
    if (inside) return true;
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

// One lane's occlusion under its limit over rows `rows`, then the spheres.
template <class R, class W>
__device__ __forceinline__ bool any_lane(R rows, const Tables& tb, int lane,
                                         const float* __restrict__ ray_o,
                                         const float* __restrict__ ray_d,
                                         const int* __restrict__ face,
                                         const int* __restrict__ excl_prim,
                                         const int* __restrict__ excl_face,
                                         const float* __restrict__ limit, W& w) {
  V3 o = load3(ray_o, lane), d = load3(ray_d, lane);
  int f = face[lane], ep = excl_prim[lane], ef = excl_face[lane];
  float lim = fminf(limit[lane], BIG);
  return tri_any(rows, tb.n_tri, o, d, f, ep, ef, lim, w) ||
         sph_any(tb, o, d, f, ep, ef, lim, w);
}

// #4: occlusion under a per-ray limit; lanes and the lanes' roles as in
// nearest_kernel.
template <class G, class W>
__global__ void __launch_bounds__(128)
any_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
           const int* __restrict__ face, const int* __restrict__ excl_prim,
           const int* __restrict__ excl_face, const u8* __restrict__ active,
           const float* __restrict__ limit, G g, const int* __restrict__ lanes,
           u8* __restrict__ blocked_out, int* __restrict__ work_out, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int listed = lanes[n];
  W w{};
  if (t < n && !active[t]) blocked_out[t] = 0;
  if ((int)(blockIdx.x * blockDim.x) < listed) {  // the block holds a listed lane
    g.stage();
    if (t < listed) {
      const int lane = lanes[t];
      blocked_out[lane] =
          any_lane(rows_of(g), g.tb, lane, ray_o, ray_d, face, excl_prim, excl_face, limit, w)
              ? 1 : 0;
    }
  }
  if (t < n) w.put(work_out, n, t);
}

// The kernel before the design above: one thread per lane, in lane order,
// over the [T, 34] table in global memory.
template <class W>
__global__ void __launch_bounds__(128)
any_thread_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                  const int* __restrict__ face, const int* __restrict__ excl_prim,
                  const int* __restrict__ excl_face, const u8* __restrict__ active,
                  const float* __restrict__ limit, Tables tb, u8* __restrict__ blocked_out,
                  int* __restrict__ work_out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  W w{};
  bool blocked = active[lane] && any_lane(TriRows{tb.tri}, tb, lane, ray_o, ray_d, face,
                                          excl_prim, excl_face, limit, w);
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

// The nearest-hit and any-hit sweeps out of the block's shared memory, and
// the shadow walk, all lights of a group in one pass.
using SweepRows = DenseRowsGeom<false>;
using ShadowRows = DenseRowsGeom<true>;

// (host) Launch `kernel` over n lanes, 128 threads a block, with the dynamic
// shared bytes that geometry g stages (opted in first) -> CUDA error.
template <class G, class... P, class... A>
int launch_lanes(void (*kernel)(P...), const G& g, int n, cudaStream_t stream, A... args) {
  int shared = g.smem(128);
  if (shared) {
    int err = coop_opt_in((const void*)kernel, shared);
    if (err) return err;
  }
  kernel<<<(n + 127) / 128, 128, shared, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <class G>
int launch_nearest(const float* ray_o, const float* ray_d, const int* face, const int* excl_prim,
                   const int* excl_face, const u8* active, G g, const int* lanes, float* t,
                   int* idx, u8* bf, u8* valid, int* work, int n, cudaStream_t stream) {
  auto kernel = work ? &nearest_kernel<G, Work> : &nearest_kernel<G, NoWork>;
  return launch_lanes(kernel, g, n, stream, ray_o, ray_d, face, excl_prim, excl_face, active, g,
                      lanes, t, idx, bf, valid, work, n);
}

template <class G>
int launch_any(const float* ray_o, const float* ray_d, const int* face, const int* excl_prim,
               const int* excl_face, const u8* active, const float* limit, G g,
               const int* lanes, u8* blocked, int* work, int n, cudaStream_t stream) {
  auto kernel = work ? &any_kernel<G, Work> : &any_kernel<G, NoWork>;
  return launch_lanes(kernel, g, n, stream, ray_o, ray_d, face, excl_prim, excl_face, active,
                      limit, g, lanes, blocked, work, n);
}

template <class G>
int launch_shadow(const float* pos, const float* dirs, const int* excl_prim, const float* limits,
                  const u8* actives, G g, const int* lanes, u8* blocked, int* work, int n,
                  cudaStream_t stream) {
  auto kernel = work ? &shadow_kernel<G, Work> : &shadow_kernel<G, NoWork>;
  return launch_lanes(kernel, g, n, stream, pos, dirs, excl_prim, limits, actives, g, lanes,
                      blocked, work, n);
}

inline Tables geometry(const float* tri, int n_tri, const float* sph, int n_sph) {
  return Tables{tri, sph, nullptr, nullptr, n_tri, n_sph, 0, 0};
}

}  // namespace rt

extern "C" {

// ray_o, ray_d: [n, 3] float32; face, excl_prim, excl_face: [n] int32;
// active: [n] bool; hot: the [n_tri, 16] hot rows (a table too large to
// stage, DenseRowsGeom::fits, is walked from the [n_tri, 34] table);
// lanes: [n + 1] int32 scratch (the listed active lanes and their count);
// t: [n] (+inf on a miss); idx: [n] (-1); bf, valid: [n] bool; work:
// [WORK_ROWS, n] or null (null runs the instantiation that counts nothing).
int rt_nearest_hit(const float* ray_o, const float* ray_d, const int* face,
                   const int* excl_prim, const int* excl_face, const unsigned char* active,
                   const float* tri, int n_tri, const float* sph, int n_sph, const float* hot,
                   int* lanes, float* t, int* idx, unsigned char* bf, unsigned char* valid,
                   int* work, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = rt::launch_list_lanes(active, 1, n, lanes, st);
  if (err) return err;
  rt::Tables tb = rt::geometry(tri, n_tri, sph, n_sph);
  if (rt::SweepRows::fits(n_tri))
    return rt::launch_nearest(ray_o, ray_d, face, excl_prim, excl_face, active,
                              rt::SweepRows{tb, (const float4*)hot}, lanes, t, idx, bf, valid,
                              work, n, st);
  return rt::launch_nearest(ray_o, ray_d, face, excl_prim, excl_face, active, rt::DenseGeom{tb},
                            lanes, t, idx, bf, valid, work, n, st);
}

// The same sweep with one thread per lane over the table in global memory:
// what rt_nearest_hit is held against.  Arguments as rt_nearest_hit
// without hot and lanes.
int rt_nearest_hit_thread(const float* ray_o, const float* ray_d, const int* face,
                          const int* excl_prim, const int* excl_face,
                          const unsigned char* active, const float* tri, int n_tri,
                          const float* sph, int n_sph, float* t, int* idx, unsigned char* bf,
                          unsigned char* valid, int* work, int n, void* stream) {
  rt::Tables tb = rt::geometry(tri, n_tri, sph, n_sph);
  auto kernel = work ? &rt::nearest_thread_kernel<rt::Work>
                     : &rt::nearest_thread_kernel<rt::NoWork>;
  kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      ray_o, ray_d, face, excl_prim, excl_face, active, tb, t, idx, bf, valid, work, n);
  return (int)cudaGetLastError();
}

// As rt_nearest_hit, plus limit: [n] float32 (min(limit, 3e38) applies);
// blocked: [n] bool.
int rt_any_hit(const float* ray_o, const float* ray_d, const int* face, const int* excl_prim,
               const int* excl_face, const unsigned char* active, const float* limit,
               const float* tri, int n_tri, const float* sph, int n_sph, const float* hot,
               int* lanes, unsigned char* blocked, int* work, int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = rt::launch_list_lanes(active, 1, n, lanes, st);
  if (err) return err;
  rt::Tables tb = rt::geometry(tri, n_tri, sph, n_sph);
  if (rt::SweepRows::fits(n_tri))
    return rt::launch_any(ray_o, ray_d, face, excl_prim, excl_face, active, limit,
                          rt::SweepRows{tb, (const float4*)hot}, lanes, blocked, work, n, st);
  return rt::launch_any(ray_o, ray_d, face, excl_prim, excl_face, active, limit,
                        rt::DenseGeom{tb}, lanes, blocked, work, n, st);
}

// The per-thread yardstick of rt_any_hit; arguments as rt_any_hit without
// hot and lanes.
int rt_any_hit_thread(const float* ray_o, const float* ray_d, const int* face,
                      const int* excl_prim, const int* excl_face, const unsigned char* active,
                      const float* limit, const float* tri, int n_tri, const float* sph,
                      int n_sph, unsigned char* blocked, int* work, int n, void* stream) {
  rt::Tables tb = rt::geometry(tri, n_tri, sph, n_sph);
  auto kernel = work ? &rt::any_thread_kernel<rt::Work> : &rt::any_thread_kernel<rt::NoWork>;
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

// Compiled attributes of the instantiation `which` that counts nothing: 0
// nearest, 1 any, 2 shadow (the main path's, staging the rows of a table of
// n_tri triangles); 3 shadow, 4 nearest, 5 any (the per-thread
// yardsticks); layout as rt_level_attrs.
int rt_intersect_attrs(int which, int n_tri, int* out) {
  using rt::NoWork;
  switch (which) {
    case 0:
      return rt::attrs_of((const void*)rt::nearest_kernel<rt::SweepRows, NoWork>, out,
                          rt::SweepRows::smem_bytes(n_tri));
    case 1:
      return rt::attrs_of((const void*)rt::any_kernel<rt::SweepRows, NoWork>, out,
                          rt::SweepRows::smem_bytes(n_tri));
    case 2:
      return rt::attrs_of((const void*)rt::shadow_kernel<rt::ShadowRows, NoWork>, out,
                          rt::ShadowRows::smem_bytes(n_tri));
    case 3:
      return rt::attrs_of((const void*)rt::shadow_thread_kernel<NoWork>, out);
    case 4:
      return rt::attrs_of((const void*)rt::nearest_thread_kernel<NoWork>, out);
    default:
      return rt::attrs_of((const void*)rt::any_thread_kernel<NoWork>, out);
  }
}

}  // extern "C"
