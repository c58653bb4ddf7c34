// Monte-Carlo whole-walk kernel: one stochastic sample per primary ray.
//
// Replaces the TPU kernel raytracer_tpu/ops/mc_pallas.py:474 `_mc_kernel`
// (wrapper `trace` :541; `mc_step` :58, `mc_terminal` :449), both of its
// branches: one instantiation per geometry policy (common.cuh
// DenseRowsGeom for a dense scene; CoopGeom for the large-mesh blocked
// layout, mc_pallas.py:485-487).  Plain version:
// raytracer_tpu_torch/ops/mc_kernel.py `trace_plain`.
//
// One thread per ray walks the whole path: the primary cast, `depth`
// roulette bounces (roulette, scatter lobe, interior TIR march, advance
// cast, merged next-hit shade with shadow sweeps, the accum += scale*A;
// scale *= B recurrence), then the depth-exhausted terminal shade.
//
// What bounds it on an H100: neither DRAM bytes (each ray reads 12 + 12 *
// depth bytes of rays and draws and writes 16) nor FLOP peak, but issue
// throughput and load latency over long, divergent, data-dependent loops
// — every bounce runs up to ~15 sweeps (advance cast, 3 lights' shadow
// rays, up to 11 march casts): all 64 triangles and 4 spheres on the dense
// demo scene, the entered chunks on a blocked mesh — and lanes of a warp
// take different roulette branches, march lengths and chunks; and a launch
// lasts as long as its slowest block.  So the card must be full: a launch
// of one 65,536-ray tile (512 blocks, on 660 places for them at 5 blocks an
// SM) left it under-filled for 58-62 % of its time, and an epoch on this
// route is ONE launch for the whole frame (render.epoch_frame).  Dense
// (DenseRowsGeom): every block stages the 64-byte hot rows in its shared
// memory and every sweep reads them as broadcast float4s, one light after
// the other (one pass for all lights, GROUPED, took 128 registers and a
// block an SM, and lost), 96 registers and 5 blocks of 128 threads an SM,
// the depth loop a runtime loop (not unrolled) to hold register pressure
// down, per-lane cast counts summed by the wrapper; on the frame's 1.2 M
// rays the sweeps take two fifths of a thread's cycles and the shading,
// materials and sampling (acosf, powf, sinf, cosf in IEEE form) the rest.
// Blocked: one thread alone pays a dependent global load for every row of
// every chunk it enters, and the launch waits for the warp with the longest
// chain of 128-row loops, so the blocked instantiation walks the chunks
// warp by warp (common.cuh CoopGeom): the 32 lanes stage each chunk that
// any of them enters once in the warp's shared memory and test 32 of its
// rows at a time for one ray after the other, a shading point's three
// shadow rays share one pass, and the kernel's control flow is the same in
// all lanes of a warp (a lane past the tile's end, a dead lane and a lane
// that does not march only pass `false` down); half of a warp's cycles are
// still row tests, a fifth box tests, each a chain of dependent
// instructions.  Times are in PERF.md.  The per-thread DenseGeom and
// BlockedGeom instantiations are kept as the yardsticks that chip_smoke.py
// holds the main path's walks against (rt_mc_trace_thread,
// rt_mc_trace_blk_thread); no wrapper of the main path launches them.  W is
// the test counter (common.cuh): NoWork on the main path; SphCount, the same
// walk counting its sphere tests alone, when the caller asks for them (a
// traced epoch's mc.sph_tests: each sweep adds its tests to one register at
// its end), so the untraced walk runs no counting instruction; Work when the
// caller asks for the per-lane test counts.
//
// On a scene of many spheres (the SPD sphereflake's 7,381) linear sphere
// sweeps test some 6,300 spheres a cast, nearly all of the dense walk's
// work.  A scene that carries the sphere chunk table (scene/blocked.py
// build_sph_chunks) is walked by the gated dense instantiations
// (common.cuh SphGatedGeom), which test a chunk's spheres only where the ray
// enters its box before its best hit or shadow limit, and give the linear
// sweeps' hits; every other scene, by the linear ones, as before.  (A branch
// at run time would make every scene's walk carry the gated loops'
// registers.)
#include <type_traits>

#include "mc_walk.cuh"

namespace rt {

constexpr int MC_THREADS = 128;

// The dense walk (common.cuh DenseRowsGeom): the hot rows out of shared
// memory; its spheres linear, or gated by the sphere chunk table.
using SharedDense = DenseRowsGeom<DENSE_MC_GROUPED>;
using SharedDenseGated = SphGatedGeom<SharedDense>;

// One MC sample a thread, the walk of mc_kernel and mc_kernel_staged.
template <class G, class W>
__device__ __forceinline__ void mc_walk(const float* __restrict__ ray_o,
                                        const float* __restrict__ ray_d,
                                        const float* __restrict__ unifs, G g,
                                        float* __restrict__ photon, int* __restrict__ casts_out,
                                        int* __restrict__ work_out,
                                        long long* __restrict__ sph_out, int n, int depth,
                                        float max_distance, int max_retries) {
  g.stage();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_tile = lane < n;
  if constexpr (G::COOP) {
    if (!in_tile) lane = n - 1;  // sweeps along with its warp, wants nothing, writes nothing
  } else {
    if (!in_tile) return;
  }
  const Tables& tb = g.tb;
  W w{};
  V3 o0 = v3(ray_o[lane], ray_o[n + lane], ray_o[2 * n + lane]);
  V3 d0 = v3(ray_d[lane], ray_d[n + lane], ray_d[2 * n + lane]);

  // primary cast (main.rs:1150)
  Hit h = g.nearest(o0, d0, FACE_FRONT, -1, FACE_FRONT, in_tile, w);
  int casts = 1;
  bool alive = h.valid;
  V3 acc = v3(0.0f, 0.0f, 0.0f), scale = v3(1.0f, 1.0f, 1.0f);
  Cur c = cur_of(h, d0);

#pragma unroll 1
  for (int step = 0; step < depth; ++step) {
    const float* u = unifs + (size_t)step * 3 * n + lane;
    Mat m = eval_material(tb, c.obj, c.u, c.v);
    Lobe lb = scatter(m, c, alive, u[0], u[n], u[2 * n]);
    Advance a = advance(g, m, c, lb, max_distance, max_retries, casts, w);
    bool use_next = a.nx.valid;

    // merged shade: the next hit where the advance cast hit, else the
    // scattered self-shade; refract lanes whose escape missed are black
    bool need_shade = a.active && (use_next || !lb.sel_f);
    Mat m2 = eval_material(tb, use_next ? a.nx.obj : c.obj, use_next ? a.nx.u : c.u,
                           use_next ? a.nx.v : c.v);
    V3 sh = shade_at(g, m2, sel(use_next, a.nx.p, c.p), sel(use_next, a.nx.n, c.n),
                     sel(use_next, a.d, lb.sd), need_shade, use_next ? a.nx.prim : c.prim,
                     casts, w);

    V3 br = brdf(m, c, lb);
    float decay = kpowf(m.decay, a.mm.travel);
    bool is_rb = !lb.sel_f;  // diffuse / reflect branch
    float hit_scale = use_next ? 0.5f : 1.0f;
    float b_base = use_next ? 0.5f : 0.0f;
    V3 A = is_rb ? v3(hit_scale * sh.x, hit_scale * sh.y, hit_scale * sh.z)
                 : v3(decay * sh.x, decay * sh.y, decay * sh.z);
    V3 B = is_rb ? v3(b_base * br.x, b_base * br.y, b_base * br.z) : v3(decay, decay, decay);
    acc.x += need_shade ? scale.x * A.x : 0.0f;
    acc.y += need_shade ? scale.y * A.y : 0.0f;
    acc.z += need_shade ? scale.z * A.z : 0.0f;
    scale.x = scale.x * (a.active ? B.x : 0.0f);
    scale.y = scale.y * (a.active ? B.y : 0.0f);
    scale.z = scale.z * (a.active ? B.z : 0.0f);

    alive = a.active && use_next;
    c = cur_of(a.nx, a.d);
  }

  // depth exhausted: terminate with shade(self) (main.rs:524-527)
  Mat m3 = eval_material(tb, c.obj, c.u, c.v);
  V3 sh = shade_at(g, m3, c.p, c.n, c.d, alive, c.prim, casts, w);
  if (in_tile) {
    photon[lane] = acc.x + (alive ? scale.x * sh.x : 0.0f);
    photon[n + lane] = acc.y + (alive ? scale.y * sh.y : 0.0f);
    photon[2 * n + lane] = acc.z + (alive ? scale.z * sh.z : 0.0f);
    casts_out[lane] = casts;
    w.put(work_out, n, lane);
    w.put_sph(sph_out, lane);
    if constexpr (G::Sph::GATED) w.put_sph_box(g.sph.box_tests, lane);
  }
  if constexpr (G::COOP) {
    __syncwarp();
    if (!in_tile) w.put_helped(work_out, n, n - 1);
  }
}

template <class G, class W>
__global__ void __launch_bounds__(MC_THREADS)
mc_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
          const float* __restrict__ unifs, G g, float* __restrict__ photon,
          int* __restrict__ casts_out, int* __restrict__ work_out,
          long long* __restrict__ sph_out, int n, int depth, float max_distance,
          int max_retries) {
  mc_walk<G, W>(ray_o, ray_d, unifs, g, photon, casts_out, work_out, sph_out, n, depth,
                max_distance, max_retries);
}

// The staged dense walk must fit 5 blocks an SM, which caps it at 96
// registers: left to itself, ptxas gave it 101 once the triangle tests
// rounded as written, 4 blocks fit, and a 1280x960 frame's launch took
// 6.24 ms against 5.46 with the cap (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6).  The other walks
// keep mc_kernel's bounds: a second argument of 1 there let ptxas give
// the cooperative walk 183 registers (2 blocks an SM, not 3).  G:
// SharedDense or SharedDenseGated.
template <class G, class W>
__global__ void __launch_bounds__(MC_THREADS, 5)
mc_kernel_staged(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                 const float* __restrict__ unifs, G g, float* __restrict__ photon,
                 int* __restrict__ casts_out, int* __restrict__ work_out,
                 long long* __restrict__ sph_out, int n, int depth, float max_distance,
                 int max_retries) {
  mc_walk<G, W>(ray_o, ray_d, unifs, g, photon, casts_out, work_out, sph_out, n, depth,
                max_distance, max_retries);
}

// The kernel of geometry G and counter W.
template <class G, class W>
constexpr auto mc_entry() {
  if constexpr (std::is_same<G, SharedDense>::value || std::is_same<G, SharedDenseGated>::value)
    return &mc_kernel_staged<G, W>;
  else
    return &mc_kernel<G, W>;
}

template <class G>
int launch_mc(const float* ray_o, const float* ray_d, const float* unifs, G g, float* photon,
              int* casts, int* work, long long* sph, int n, int depth, float max_distance,
              int max_retries, void* stream) {
  int blocks = (n + MC_THREADS - 1) / MC_THREADS;
  bool count_sph = sph;
  if constexpr (G::Sph::GATED) count_sph = count_sph || g.sph.box_tests;
  auto kernel = work        ? mc_entry<G, Work>()
                : count_sph ? mc_entry<G, SphCount>()
                            : mc_entry<G, NoWork>();
  int shared = g.smem(MC_THREADS);
  if (shared) {
    int err = coop_opt_in((const void*)kernel, shared);
    if (err) return err;
  }
  kernel<<<blocks, MC_THREADS, shared, (cudaStream_t)stream>>>(
      ray_o, ray_d, unifs, g, photon, casts, work, sph, n, depth, max_distance, max_retries);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" {

// ray_o, ray_d: [3, n]; unifs: [depth, 3, n]; photon: [3, n]; casts: [n];
// work: [WORK_ROWS, n] or null (null runs the instantiation that counts
// nothing, or with sph_tests given the one that counts sphere tests alone);
// sph_tests: [n] int64, each lane's sphere tests, or null; sph_box_tests:
// [n] int64, each lane's sphere gate box tests, or null; hot: the [n_tri,
// 16] hot rows; sph_rows, sph_box, sph_sup, n_sph_chunks: the sphere chunk
// table (null and 0: none), whose presence picks the gated instantiation.  A
// table too large to stage (DenseRowsGeom::fits) is walked per thread.
int rt_mc_trace(const float* ray_o, const float* ray_d, const float* unifs, const float* tri,
                int n_tri, const float* sph, int n_sph, const float* mat, int n_obj,
                const float* lights, int n_light, const float* hot, const float* sph_rows,
                const float* sph_box, const float* sph_sup, int n_sph_chunks, float* photon,
                int* casts, int* work, long long* sph_tests, long long* sph_box_tests, int n,
                int depth, float max_distance, int max_retries, void* stream) {
  rt::Tables tb{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light};
  rt::SphGated sg{sph_rows, sph_box, sph_sup, n_sph_chunks, sph_box_tests};
  const float4* rows = (const float4*)hot;
  if (rt::SharedDense::fits(n_tri)) {
    if (n_sph_chunks)
      return rt::launch_mc(ray_o, ray_d, unifs, rt::SharedDenseGated{{tb, rows}, sg}, photon,
                           casts, work, sph_tests, n, depth, max_distance, max_retries, stream);
    return rt::launch_mc(ray_o, ray_d, unifs, rt::SharedDense{tb, rows}, photon, casts, work,
                         sph_tests, n, depth, max_distance, max_retries, stream);
  }
  if (n_sph_chunks)
    return rt::launch_mc(ray_o, ray_d, unifs, rt::DenseGeomGated{{tb}, sg}, photon, casts, work,
                         sph_tests, n, depth, max_distance, max_retries, stream);
  return rt::launch_mc(ray_o, ray_d, unifs, rt::DenseGeom{tb}, photon, casts, work, sph_tests,
                       n, depth, max_distance, max_retries, stream);
}

// The same walk with every thread reading the dense table from global
// memory and sweeping once per light (DenseGeom, or DenseGeomGated on a
// scene with the sphere chunk table): what the staged walk is held against.
int rt_mc_trace_thread(const float* ray_o, const float* ray_d, const float* unifs,
                       const float* tri, int n_tri, const float* sph, int n_sph, const float* mat,
                       int n_obj, const float* lights, int n_light, const float* sph_rows,
                       const float* sph_box, const float* sph_sup, int n_sph_chunks,
                       float* photon, int* casts, int* work, long long* sph_tests,
                       long long* sph_box_tests, int n, int depth, float max_distance,
                       int max_retries, void* stream) {
  rt::DenseGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light}};
  if (n_sph_chunks)
    return rt::launch_mc(ray_o, ray_d, unifs,
                         rt::DenseGeomGated{{g},
                                            {sph_rows, sph_box, sph_sup, n_sph_chunks,
                                             sph_box_tests}},
                         photon, casts, work, sph_tests, n, depth, max_distance, max_retries,
                         stream);
  return rt::launch_mc(ray_o, ray_d, unifs, g, photon, casts, work, sph_tests, n, depth,
                       max_distance, max_retries, stream);
}

// The blocked instantiation: the warp-cooperative walk (tables as
// rt_level_blk, then the hot rows [NCH * 128, 16], their ids [NCH * 128],
// the chunks' live row counts [NCH] and the triangles' rows [n_tri]; then
// as rt_mc_trace).
int rt_mc_trace_blk(const float* ray_o, const float* ray_d, const float* unifs, const float* tri,
                    int n_tri, const float* sph, int n_sph, const float* mat, int n_obj,
                    const float* lights, int n_light, const float* btri, const float* box,
                    const float* sup, int n_chunks, const float* hot, const int* ids,
                    const int* live, const int* row_of_tri, float* photon, int* casts, int* work,
                    long long* sph_tests, int n, int depth, float max_distance, int max_retries,
                    void* stream) {
  rt::CoopGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light},
                 rt::Blk{btri, box, sup, n_chunks},
                 rt::Hot{(const float4*)hot, ids, live, row_of_tri}};
  return rt::launch_mc(ray_o, ray_d, unifs, g, photon, casts, work, sph_tests, n, depth,
                       max_distance, max_retries, stream);
}

// The same walk with every thread traversing the blocked table alone
// (BlockedGeom): what the cooperative walk is held against.
int rt_mc_trace_blk_thread(const float* ray_o, const float* ray_d, const float* unifs,
                           const float* tri, int n_tri, const float* sph, int n_sph,
                           const float* mat, int n_obj, const float* lights, int n_light,
                           const float* btri, const float* box, const float* sup, int n_chunks,
                           float* photon, int* casts, int* work, long long* sph_tests, int n,
                           int depth, float max_distance, int max_retries, void* stream) {
  rt::BlockedGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light},
                    rt::Blk{btri, box, sup, n_chunks}};
  return rt::launch_mc(ray_o, ray_d, unifs, g, photon, casts, work, sph_tests, n, depth,
                       max_distance, max_retries, stream);
}

// Compiled attributes of instantiation `which` (0 dense: the staged walk,
// holding the rows of a table of n_tri triangles; 1 blocked: the
// cooperative walk, 2 the per-thread blocked walk, 3 the per-thread dense
// walk; 4 and 5 the walks of 0 and 3 with gated sphere sweeps), layout as
// rt_level_attrs.
int rt_mc_attrs(int which, int n_tri, int* out) {
  using rt::NoWork;
  switch (which) {
    case 0:
      return rt::attrs_of((const void*)rt::mc_kernel_staged<rt::SharedDense, NoWork>, out,
                          rt::SharedDense::smem_bytes(n_tri));
    case 4:
      return rt::attrs_of((const void*)rt::mc_kernel_staged<rt::SharedDenseGated, NoWork>, out,
                          rt::SharedDenseGated::smem_bytes(n_tri));
    case 5:
      return rt::attrs_of((const void*)rt::mc_kernel<rt::DenseGeomGated, NoWork>, out);
    case 1:
      return rt::attrs_of((const void*)rt::mc_kernel<rt::CoopGeom, NoWork>, out,
                          rt::coop_shared_bytes(rt::MC_THREADS));
    case 2:
      return rt::attrs_of((const void*)rt::mc_kernel<rt::BlockedGeom, NoWork>, out);
    default:
      return rt::attrs_of((const void*)rt::mc_kernel<rt::DenseGeom, NoWork>, out);
  }
}

}  // extern "C"
