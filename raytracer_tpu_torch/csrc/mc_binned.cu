// Binned per-bounce Monte-Carlo kernels for blocked (large-mesh) scenes.
//
// Replace the TPU kernels raytracer_tpu/ops/mc_binned.py:131
// `_primary_kernel`, :157 `_bounce_kernel` and :190 `_terminal_kernel`
// (host loop `trace` :328), which run mc_pallas.py:232 `mc_step_deferred` and
// :414 `mc_terminal_deferred`.  Plain versions:
// raytracer_tpu_torch/ops/mc_binned.py `primary_plain`, `bounce_plain`,
// `terminal_plain`.
//
// The walk state lives in device memory between launches: sf [21, n]
// float32 and si [5, n] int32 (row layout in ops/mc_binned.py).  The
// wrapper sorts the lanes by the chunk of their current hit between
// bounces and gathers each bounce's uniforms by the lanes' slots, so
// neighbouring threads start their casts from the same leaf boxes.
//
//   rt_binned_primary:  primary cast -> walk state (slot = lane).
//   rt_binned_bounce:   one bounce; where a lane is alive, first the
//                       previous bounce's deferred hit-shade at the current
//                       hit (FIRST skips it: nothing is deferred on bounce
//                       0), then roulette, march and advance cast; advance
//                       misses shade their scattered self at once, hits
//                       defer df and the pre-update scale.  A dead lane's
//                       state is final: it is copied, which equals the
//                       TPU's dead-tile pass-through.
//   rt_binned_terminal: the last deferred shade and the terminal shade
//                       from one shadow sweep, both counted as casts.
//
// What bounds them on an H100: as the whole-walk kernel, issue throughput
// and load latency of the chunk traversal and warp divergence.  State I/O
// is 104 bytes in and out per lane per bounce.  128 threads per block.  The
// primary kernel traverses per thread, the blocked table read from global
// memory (BlockedGeom).  The bounce kernel, which makes nearly all of the
// walk's sweeps, and the terminal kernel walk the chunks warp by warp
// (common.cuh CoopGeom): a chunk that any of the 32 lanes enters is staged
// once in the warp's shared memory and its rows tested 32 at a time for one
// ray after the other, each shade makes one pass for all lights, and their
// control flow is the same in all lanes of a warp (dead lanes and the lanes
// past the end pass `false` down instead of leaving).  A launch lasts as
// long as its slowest warp, and the sort packs the lanes that march into
// neighbouring warps, so the wrapper deals the sorted lanes round-robin
// over the warps (ops/mc_binned.py deal_lanes): 0.26 ms a bounce launch on
// a mesh11k tile where the sorted order takes 1.2 and the per-thread walk
// 7.4 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  The per-thread
// instantiations of the bounce and the terminal kernel are kept as the
// yardsticks chip_smoke.py holds the cooperative ones against
// (rt_binned_bounce_thread, rt_binned_terminal_thread); no wrapper of the
// main path launches them.  W is the test counter (common.cuh): NoWork on
// the main path, Work when the caller asks for the per-lane test counts.
#include "mc_walk.cuh"

namespace rt {

constexpr int S_A = 0, S_S = 3, S_P = 6, S_N = 9, S_UV = 12, S_D = 14, S_DF = 17, S_PR = 18;
constexpr int S_ALIVE = 0, S_PRIM = 1, S_OBJ = 2, S_BACK = 3, S_SLOT = 4;

struct State {
  bool alive;
  V3 acc, scale, pre;  // pre: the pre-update scale of the deferred shade
  float df;            // the deferred shade's blend factor
  Cur c;
  int slot;
};

__device__ __forceinline__ V3 ld3(const float* __restrict__ a, int row, int n, int lane) {
  return v3(a[(size_t)row * n + lane], a[(size_t)(row + 1) * n + lane],
            a[(size_t)(row + 2) * n + lane]);
}

__device__ __forceinline__ void st3(float* __restrict__ a, int row, int n, int lane, V3 x) {
  a[(size_t)row * n + lane] = x.x;
  a[(size_t)(row + 1) * n + lane] = x.y;
  a[(size_t)(row + 2) * n + lane] = x.z;
}

__device__ inline State load_state(const float* __restrict__ sf, const int* __restrict__ si, int n,
                                   int lane) {
  State s;
  s.acc = ld3(sf, S_A, n, lane);
  s.scale = ld3(sf, S_S, n, lane);
  s.c.p = ld3(sf, S_P, n, lane);
  s.c.n = ld3(sf, S_N, n, lane);
  s.c.u = sf[(size_t)S_UV * n + lane];
  s.c.v = sf[(size_t)(S_UV + 1) * n + lane];
  s.c.d = ld3(sf, S_D, n, lane);
  s.df = sf[(size_t)S_DF * n + lane];
  s.pre = ld3(sf, S_PR, n, lane);
  s.alive = si[(size_t)S_ALIVE * n + lane] != 0;
  s.c.prim = si[(size_t)S_PRIM * n + lane];
  s.c.obj = si[(size_t)S_OBJ * n + lane];
  s.c.back = si[(size_t)S_BACK * n + lane] != 0;
  s.slot = si[(size_t)S_SLOT * n + lane];
  return s;
}

__device__ inline void store_state(float* __restrict__ sf, int* __restrict__ si, int n, int lane,
                                   const State& s) {
  st3(sf, S_A, n, lane, s.acc);
  st3(sf, S_S, n, lane, s.scale);
  st3(sf, S_P, n, lane, s.c.p);
  st3(sf, S_N, n, lane, s.c.n);
  sf[(size_t)S_UV * n + lane] = s.c.u;
  sf[(size_t)(S_UV + 1) * n + lane] = s.c.v;
  st3(sf, S_D, n, lane, s.c.d);
  sf[(size_t)S_DF * n + lane] = s.df;
  st3(sf, S_PR, n, lane, s.pre);
  si[(size_t)S_ALIVE * n + lane] = s.alive ? 1 : 0;
  si[(size_t)S_PRIM * n + lane] = s.c.prim;
  si[(size_t)S_OBJ * n + lane] = s.c.obj;
  si[(size_t)S_BACK * n + lane] = s.c.back ? 1 : 0;
  si[(size_t)S_SLOT * n + lane] = s.slot;
}

template <class W>
__global__ void __launch_bounds__(128)
binned_primary(const float* __restrict__ ray_o, const float* __restrict__ ray_d, BlockedGeom g,
               float* __restrict__ sf, int* __restrict__ si, int* __restrict__ casts_out,
               int* __restrict__ work_out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  W w{};
  V3 o = v3(ray_o[lane], ray_o[n + lane], ray_o[2 * n + lane]);
  V3 d = v3(ray_d[lane], ray_d[n + lane], ray_d[2 * n + lane]);
  Hit h = g.nearest(o, d, FACE_FRONT, -1, FACE_FRONT, true, w);  // main.rs:1150
  State s;
  s.alive = h.valid;
  s.acc = v3(0.0f, 0.0f, 0.0f);
  s.scale = v3(1.0f, 1.0f, 1.0f);
  s.pre = v3(0.0f, 0.0f, 0.0f);  // nothing deferred yet
  s.df = 0.0f;
  s.c = cur_of(h, d);
  s.slot = lane;
  store_state(sf, si, n, lane, s);
  casts_out[lane] = 1;
  w.put(work_out, n, lane);
}

constexpr int BOUNCE_THREADS = 128;

// Every lane runs every statement: `alive` (and what follows from it) is
// passed down to the sweeps, which a cooperative geometry makes warp by
// warp.  A lane past the end reads the last lane's state and stores nothing.
template <class G, bool FIRST, class W>
__global__ void __launch_bounds__(BOUNCE_THREADS)
binned_bounce(const float* __restrict__ sf, const int* __restrict__ si,
              const float* __restrict__ unifs, G g, float* __restrict__ out_f,
              int* __restrict__ out_i, int* __restrict__ casts_out, int* __restrict__ work_out,
              int n, float max_distance, int max_retries) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_tile = lane < n;
  if (!in_tile) lane = n - 1;
  W w{};
  State s = load_state(sf, si, n, lane);
  const bool alive = in_tile && s.alive;
  int casts = 0;
  const Cur c = s.c;
  Mat m = eval_material(g.tb, c.obj, c.u, c.v);
  V3 na = rotate_from_z(c.n, m.tn);  // the adjusted normal at the current hit
  if (!FIRST) {
    // the previous bounce's hit-shade, view = -incoming
    V3 sh = get_shade(g, m, c.p, na, neg(c.d), alive, c.prim, casts, w);
    if (alive) {
      s.acc.x += s.pre.x * (s.df * sh.x);
      s.acc.y += s.pre.y * (s.df * sh.y);
      s.acc.z += s.pre.z * (s.df * sh.z);
    }
  }
  Lobe lb = scatter(m, c, alive, unifs[lane], unifs[n + lane], unifs[2 * n + lane]);
  Advance a = advance(g, m, c, lb, max_distance, max_retries, casts, w);
  bool use_next = a.nx.valid;
  bool is_rb = !lb.sel_f;
  // advance misses shade the scattered self now (refract misses: black)
  bool ns_miss = a.active && !use_next && is_rb;
  V3 sh = get_shade(g, m, c.p, na, neg(lb.sd), ns_miss, c.prim, casts, w);
  if (alive) {  // a dead lane's state is final
    if (ns_miss) {
      s.acc.x += s.scale.x * sh.x;
      s.acc.y += s.scale.y * sh.y;
      s.acc.z += s.scale.z * sh.z;
    }
    V3 br = brdf(m, c, lb);
    float decay = kpowf(m.decay, a.mm.travel);
    float b_base = use_next ? 0.5f : 0.0f;
    V3 B = is_rb ? v3(b_base * br.x, b_base * br.y, b_base * br.z) : v3(decay, decay, decay);
    s.df = is_rb ? 0.5f : decay;
    s.pre = s.scale;
    s.scale.x = s.scale.x * (a.active ? B.x : 0.0f);
    s.scale.y = s.scale.y * (a.active ? B.y : 0.0f);
    s.scale.z = s.scale.z * (a.active ? B.z : 0.0f);
    s.alive = a.active && use_next;
    s.c = cur_of(a.nx, a.d);
  }
  if (in_tile) {
    store_state(out_f, out_i, n, lane, s);
    casts_out[lane] = casts;
    w.put(work_out, n, lane);
  }
  if constexpr (G::COOP) {
    __syncwarp();
    if (!in_tile) w.put_helped(work_out, n, n - 1);
  }
}

// As binned_bounce, every lane runs the shade: a dead lane and a lane past
// the end pass `false` down.
template <class G, bool FIRST, class W>
__global__ void __launch_bounds__(BOUNCE_THREADS)
binned_terminal(const float* __restrict__ sf, const int* __restrict__ si, G g,
                float* __restrict__ photon, int* __restrict__ casts_out,
                int* __restrict__ work_out, int n) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_tile = lane < n;
  if constexpr (G::COOP) {
    if (!in_tile) lane = n - 1;
  } else {
    if (!in_tile) return;
  }
  W w{};
  State s = load_state(sf, si, n, lane);
  const bool alive = in_tile && s.alive;
  int casts = 0;
  V3 out = s.acc;  // a dead lane's accumulation is its photon
  Mat m = eval_material(g.tb, s.c.obj, s.c.u, s.c.v);
  V3 sh = shade_at(g, m, s.c.p, s.c.n, s.c.d, alive, s.c.prim, casts, w);
  if (alive) {
    if (!FIRST) {
      out.x += s.pre.x * (s.df * sh.x);
      out.y += s.pre.y * (s.df * sh.y);
      out.z += s.pre.z * (s.df * sh.z);
      casts += casts;  // the deferred shade's shadow rays (same sweep)
    }
    out.x += s.scale.x * sh.x;
    out.y += s.scale.y * sh.y;
    out.z += s.scale.z * sh.z;
  }
  if (in_tile) {
    photon[lane] = out.x;
    photon[n + lane] = out.y;
    photon[2 * n + lane] = out.z;
    casts_out[lane] = casts;
    w.put(work_out, n, lane);
  }
  if constexpr (G::COOP) {
    __syncwarp();
    if (!in_tile) w.put_helped(work_out, n, n - 1);
  }
}

}  // namespace rt

namespace {

rt::BlockedGeom blocked_geom(const float* tri, int n_tri, const float* sph, int n_sph,
                             const float* mat, int n_obj, const float* lights, int n_light,
                             const float* btri, const float* box, const float* sup,
                             int n_chunks) {
  return rt::BlockedGeom{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light},
                         rt::Blk{btri, box, sup, n_chunks}};
}

// Launch set-up of the bounce and terminal kernels: a cooperative geometry
// asks for its staging buffers (dynamic shared memory) -> CUDA error.
template <class G>
int shared_for(const void* kernel, int& shared) {
  shared = G::COOP ? rt::coop_shared_bytes(rt::BOUNCE_THREADS) : 0;
  return shared ? rt::coop_opt_in(kernel, shared) : 0;
}

template <class G>
int launch_bounce(const float* st_f, const int* st_i, const float* unifs, G g, float* out_f,
                  int* out_i, int* casts, int* work, int n, int first, float max_distance,
                  int max_retries, void* stream) {
  using rt::NoWork;
  using rt::Work;
  auto kernel = first ? (work ? &rt::binned_bounce<G, true, Work>
                              : &rt::binned_bounce<G, true, NoWork>)
                      : (work ? &rt::binned_bounce<G, false, Work>
                              : &rt::binned_bounce<G, false, NoWork>);
  int shared;
  if (int err = shared_for<G>((const void*)kernel, shared)) return err;
  int blocks = (n + rt::BOUNCE_THREADS - 1) / rt::BOUNCE_THREADS;
  kernel<<<blocks, rt::BOUNCE_THREADS, shared, (cudaStream_t)stream>>>(
      st_f, st_i, unifs, g, out_f, out_i, casts, work, n, max_distance, max_retries);
  return (int)cudaGetLastError();
}

template <class G>
int launch_terminal(const float* st_f, const int* st_i, G g, float* photon, int* casts,
                    int* work, int n, int first, void* stream) {
  using rt::NoWork;
  using rt::Work;
  auto kernel = first ? (work ? &rt::binned_terminal<G, true, Work>
                              : &rt::binned_terminal<G, true, NoWork>)
                      : (work ? &rt::binned_terminal<G, false, Work>
                              : &rt::binned_terminal<G, false, NoWork>);
  int shared;
  if (int err = shared_for<G>((const void*)kernel, shared)) return err;
  int blocks = (n + rt::BOUNCE_THREADS - 1) / rt::BOUNCE_THREADS;
  kernel<<<blocks, rt::BOUNCE_THREADS, shared, (cudaStream_t)stream>>>(st_f, st_i, g, photon,
                                                                       casts, work, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ray_o, ray_d: [3, n]; st_f: [21, n]; st_i: [5, n]; casts: [n]; work:
// [WORK_ROWS, n] or null (null runs the instantiation that counts
// nothing).  Tables as rt_level_blk.
int rt_binned_primary(const float* ray_o, const float* ray_d, const float* tri, int n_tri,
                      const float* sph, int n_sph, const float* mat, int n_obj,
                      const float* lights, int n_light, const float* btri, const float* box,
                      const float* sup, int n_chunks, float* st_f, int* st_i, int* casts,
                      int* work, int n, void* stream) {
  rt::BlockedGeom g = blocked_geom(tri, n_tri, sph, n_sph, mat, n_obj, lights, n_light, btri,
                                   box, sup, n_chunks);
  auto kernel = work ? &rt::binned_primary<rt::Work> : &rt::binned_primary<rt::NoWork>;
  kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(ray_o, ray_d, g, st_f, st_i, casts,
                                                            work, n);
  return (int)cudaGetLastError();
}

// unifs: [3, n] this bounce's uniforms in the state's lane order.  The
// warp-cooperative walk: after the blocked tables, the hot rows
// [NCH * 128, 16], their ids [NCH * 128], the chunks' live row counts [NCH]
// and the triangles' rows [n_tri].
int rt_binned_bounce(const float* st_f, const int* st_i, const float* unifs, const float* tri,
                     int n_tri, const float* sph, int n_sph, const float* mat, int n_obj,
                     const float* lights, int n_light, const float* btri, const float* box,
                     const float* sup, int n_chunks, const float* hot, const int* ids,
                     const int* live, const int* row_of_tri, float* out_f, int* out_i,
                     int* casts, int* work, int n, int first, float max_distance,
                     int max_retries, void* stream) {
  rt::BlockedGeom bg = blocked_geom(tri, n_tri, sph, n_sph, mat, n_obj, lights, n_light, btri,
                                    box, sup, n_chunks);
  rt::CoopGeom g{bg.tb, bg.bk, rt::Hot{(const float4*)hot, ids, live, row_of_tri}};
  return launch_bounce(st_f, st_i, unifs, g, out_f, out_i, casts, work, n, first, max_distance,
                       max_retries, stream);
}

// The same bounce with every thread traversing the blocked table alone
// (BlockedGeom): what the cooperative walk is held against.
int rt_binned_bounce_thread(const float* st_f, const int* st_i, const float* unifs,
                            const float* tri, int n_tri, const float* sph, int n_sph,
                            const float* mat, int n_obj, const float* lights, int n_light,
                            const float* btri, const float* box, const float* sup, int n_chunks,
                            float* out_f, int* out_i, int* casts, int* work, int n, int first,
                            float max_distance, int max_retries, void* stream) {
  rt::BlockedGeom g = blocked_geom(tri, n_tri, sph, n_sph, mat, n_obj, lights, n_light, btri,
                                   box, sup, n_chunks);
  return launch_bounce(st_f, st_i, unifs, g, out_f, out_i, casts, work, n, first, max_distance,
                       max_retries, stream);
}

// photon: [3, n] in the state's lane order.  The warp-cooperative walk;
// tables as rt_binned_bounce.
int rt_binned_terminal(const float* st_f, const int* st_i, const float* tri, int n_tri,
                       const float* sph, int n_sph, const float* mat, int n_obj,
                       const float* lights, int n_light, const float* btri, const float* box,
                       const float* sup, int n_chunks, const float* hot, const int* ids,
                       const int* live, const int* row_of_tri, float* photon, int* casts,
                       int* work, int n, int first, void* stream) {
  rt::BlockedGeom bg = blocked_geom(tri, n_tri, sph, n_sph, mat, n_obj, lights, n_light, btri,
                                    box, sup, n_chunks);
  rt::CoopGeom g{bg.tb, bg.bk, rt::Hot{(const float4*)hot, ids, live, row_of_tri}};
  return launch_terminal(st_f, st_i, g, photon, casts, work, n, first, stream);
}

// The same terminal with every thread traversing the blocked table alone
// (BlockedGeom): what the cooperative walk is held against.
int rt_binned_terminal_thread(const float* st_f, const int* st_i, const float* tri, int n_tri,
                              const float* sph, int n_sph, const float* mat, int n_obj,
                              const float* lights, int n_light, const float* btri,
                              const float* box, const float* sup, int n_chunks, float* photon,
                              int* casts, int* work, int n, int first, void* stream) {
  rt::BlockedGeom g = blocked_geom(tri, n_tri, sph, n_sph, mat, n_obj, lights, n_light, btri,
                                   box, sup, n_chunks);
  return launch_terminal(st_f, st_i, g, photon, casts, work, n, first, stream);
}

// Compiled attributes of the instantiations that count nothing: which = 0
// primary, 1 bounce<first>, 2 bounce, 3 terminal<first>, 4 terminal (these
// four the cooperative walk), 5 the per-thread bounce, 6 the per-thread
// terminal (layout as rt_level_attrs).
int rt_binned_attrs(int which, int* out) {
  using rt::BlockedGeom;
  using rt::CoopGeom;
  using rt::NoWork;
  const void* fns[] = {(const void*)rt::binned_primary<NoWork>,
                       (const void*)rt::binned_bounce<CoopGeom, true, NoWork>,
                       (const void*)rt::binned_bounce<CoopGeom, false, NoWork>,
                       (const void*)rt::binned_terminal<CoopGeom, true, NoWork>,
                       (const void*)rt::binned_terminal<CoopGeom, false, NoWork>,
                       (const void*)rt::binned_bounce<BlockedGeom, false, NoWork>,
                       (const void*)rt::binned_terminal<BlockedGeom, false, NoWork>};
  if (which < 0 || which > 6) return -1;
  bool coop = which >= 1 && which <= 4;
  return rt::attrs_of(fns[which], out, coop ? rt::coop_shared_bytes(rt::BOUNCE_THREADS) : 0);
}

}  // extern "C"
