// Whitted bounce-level kernel: one wavefront level of the flattened
// ray_trace recursion (src/main.rs:466-519) per launch.
//
// Replaces the TPU kernel raytracer_tpu/ops/level_pallas.py:73
// `_level_kernel` / :127 `_level_body` (wrapper `process_level` :261),
// both of its branches: one instantiation per geometry policy
// (common.cuh DenseRowsGeom for a dense scene; CoopGeom for the large-mesh
// blocked layout).
// Plain version: raytracer_tpu_torch/ops/level_kernel.py
// `process_level_plain`.
//
// One thread per pool lane: nearest cast with attributes, direct shade
// with all shadow sweeps (threshold-gated), the reflect child, the refract
// child after the whole interior TIR march, and the pending-radiance carry
// or `contrib` delivery.  Pool layout: f [11, K] float32 (o, d, c, s,
// pending rgb) and i [5, K] int32 (face, excl_prim, excl_face, slot,
// alive); children come out in the same layout for the compaction in
// ops/trace.py.
//
// What bounds it on an H100: issue throughput of the sweeps (dense: 64
// triangles + 4 spheres per cast; blocked: the box tests and the 128-row
// chunks a ray enters; up to 3 shadow rays and 11 march casts per lane)
// and warp divergence between lanes that march and lanes that do not; the
// pool I/O is 128 bytes in and ~260 bytes out per lane.  A launch is one
// level of one tile (the compaction between levels works per tile), at
// most a wave of the card, so what counts is the latency of each lane's
// chain of sweeps.  Dense (DenseRowsGeom): every block stages the 64-byte
// hot rows in its shared memory, every sweep reads them as broadcast
// float4s, and a shading point's shadow rays to all lights make one pass
// over them (three independent chains a row where the per-thread walk has
// one; the primary level spent a third of its cycles in shadow tests), at
// 96 registers and 5 blocks of 128 threads an SM, with a per-lane early
// exit in place of the TPU's dead-tile skip — a lane that is not alive
// writes exactly what a dead TPU tile writes (children zero; pending
// delivered through contrib on direct levels, otherwise carried on the
// reflect child with its slot).
// Blocked: one thread alone pays a dependent global load for every row of
// every chunk it enters, its warp runs the 128-row loop once for every
// chunk that any lane enters, and a launch waits for its slowest warp (the
// lanes that march through the glass), so the blocked instantiation walks
// the chunks warp by warp (common.cuh CoopGeom, as mc_kernel.cu): a chunk
// is staged once in the warp's shared memory and its rows tested 32 at a
// time for one ray after the other, a shading point's shadow rays make one
// pass for all lights, and no lane of a warp leaves early.  The lanes that
// march, and the dead ones, come in runs in the pool, so the warps of a
// launch take its live lanes dealt round-robin, while each dead lane is
// written by the thread of its own position, coalesced (dealt, the dead
// lanes' writes touched 32 sectors a warp, and the nearly dead tail levels
// took 15 times the per-thread walk's time).  Times are in PERF.md.  The
// per-thread DenseGeom and BlockedGeom instantiations are kept as the
// yardsticks that chip_smoke.py holds the main path's walks against
// (rt_level_thread, rt_level_blk_thread); no wrapper of the main path
// launches them.  The TPU's 512-lane tiles, bit-cast int rows and
// one-hot attribute matmuls are gone.  W is the test counter (common.cuh):
// NoWork on the main path, Work when the caller asks for the test counts
// (a column a thread).  A scene with NFF cones takes one instantiation
// more, the staged dense walk with a linear cone sweep after its spheres
// (common.cuh ConeGeom), NoWork only.
#include "common.cuh"

namespace rt {

constexpr int F_PEND = 8;
constexpr int I_FACE = 0, I_EXCL_PRIM = 1, I_EXCL_FACE = 2, I_SLOT = 3, I_ALIVE = 4;

__device__ __forceinline__ void put_f(float* __restrict__ a, int row, int k, int lane, float x) {
  a[(size_t)row * k + lane] = x;
}
__device__ __forceinline__ void put_i(int* __restrict__ a, int row, int k, int lane, int x) {
  a[(size_t)row * k + lane] = x;
}

constexpr int LEVEL_THREADS = 128;

// The dense walk (common.cuh DenseRowsGeom): the hot rows out of shared
// memory.
using SharedDense = DenseRowsGeom<DENSE_LEVEL_GROUPED>;
using SharedDenseCones = ConeGeom<SharedDense>;

// Under a cooperative geometry every lane runs every statement that sweeps;
// the per-thread policies keep their early returns.  Its threads take the
// pool twice.  In pool order, thread t writes what pool lane t owes if that
// lane is dead (coalesced, as the per-thread walks write a dead lane).  Dealt
// round-robin over the launch's V = ceil(K / 32) warps (warp v takes pool
// lanes v, v + V, v + 2 V, ...), it runs the live lane it is dealt and
// writes that lane's outputs; a thread dealt a dead lane or none reads
// nothing more and passes `false` down to the sweeps (`mine`), and a warp
// dealt no live lane leaves at once.  The outputs keep the pool's order.
template <class G, class W>
__global__ void __launch_bounds__(LEVEL_THREADS)
level_kernel(const float* __restrict__ pf, const int* __restrict__ pi, G g,
             float* __restrict__ contrib, float* __restrict__ rf, int* __restrict__ ri,
             float* __restrict__ ff, int* __restrict__ fi, int* __restrict__ casts_out,
             int* __restrict__ work_out, int k, bool last, bool direct, float threshold,
             float max_distance, int max_retries) {
  g.stage();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  W w{};
  auto pend_at = [&](int at) {
    return v3(pf[(size_t)F_PEND * k + at], pf[(size_t)(F_PEND + 1) * k + at],
              pf[(size_t)(F_PEND + 2) * k + at]);
  };
  auto put_dead = [&](int at, V3 pend, int slot) {  // what a dead TPU tile gives
    for (int r = 0; r < 11; ++r) {
      put_f(rf, r, k, at, 0.0f);
      put_f(ff, r, k, at, 0.0f);
    }
    for (int r = 0; r < 5; ++r) {
      put_i(ri, r, k, at, 0);
      put_i(fi, r, k, at, 0);
    }
    V3 c = direct ? pend : v3(0.0f, 0.0f, 0.0f);
    put_f(contrib, 0, k, at, c.x);
    put_f(contrib, 1, k, at, c.y);
    put_f(contrib, 2, k, at, c.z);
    if (!direct) {  // pending rides the (dead) reflect child
      put_f(rf, F_PEND, k, at, pend.x);
      put_f(rf, F_PEND + 1, k, at, pend.y);
      put_f(rf, F_PEND + 2, k, at, pend.z);
      put_i(ri, I_SLOT, k, at, slot);
    }
    casts_out[at] = 0;
  };
  int lane = t;
  bool dealt = t < k;
  if constexpr (G::COOP) {
    if (t < k && pi[(size_t)I_ALIVE * k + t] == 0)
      put_dead(t, pend_at(t), pi[(size_t)I_SLOT * k + t]);
    const int warps = (k + WARP - 1) / WARP, warp = t / WARP;
    lane = (t % WARP) * warps + warp;
    dealt = lane < k && warp < warps;
    if (!dealt) lane = k - 1;  // reads nothing, writes nothing
  } else {
    if (!dealt) return;
  }
  // The thread's test counts: at its lane, or (cooperative) in its own
  // column, where a thread past the pool's end hands its tests (those of
  // the lane it was dealt, and rows it tested for other lanes' rays) to
  // the last column after that column's put.
  auto finish = [&] {
    if constexpr (G::COOP) {
      if (t < k) w.put(work_out, k, t);
      __syncwarp();
      if (t >= k) w.put_helped(work_out, k, k - 1);
    } else {
      w.put(work_out, k, lane);
    }
  };
  const bool mine = dealt && pi[(size_t)I_ALIVE * k + lane] != 0;
  if constexpr (G::COOP) {
    if (!G::any(mine)) {
      finish();
      return;
    }
  }
  const Tables& tb = g.tb;
  auto f_at = [&](int row) { return !G::COOP || mine ? pf[(size_t)row * k + lane] : 0.0f; };
  auto i_at = [&](int row) { return !G::COOP || mine ? pi[(size_t)row * k + lane] : 0; };
  V3 pend = v3(f_at(F_PEND), f_at(F_PEND + 1), f_at(F_PEND + 2));
  int slot = i_at(I_SLOT);
  if constexpr (!G::COOP) {
    if (!mine) {
      put_dead(lane, pend, slot);
      finish();
      return;
    }
  }

  V3 o = v3(f_at(0), f_at(1), f_at(2));
  V3 d = v3(f_at(3), f_at(4), f_at(5));
  float c = f_at(6), s = f_at(7);
  int face = i_at(I_FACE);

  Hit h = g.nearest(o, d, face, i_at(I_EXCL_PRIM), i_at(I_EXCL_FACE), mine, w);
  bool live = h.valid;
  int casts = 1;

  Mat m = eval_material(tb, h.obj, h.u, h.v);
  float shade_c = (1.0f - m.shiness) * (1.0f - m.transparency);
  float refl_c = m.shiness * (1.0f - m.transparency);
  float refr_c = m.transparency;

  // direct shade iff c*shade_c >= THRESHOLD (main.rs:482); at the last
  // level the local shade weight does not apply (488-490)
  bool need_shade = live && c * shade_c >= threshold;
  V3 sh = shade_at(g, m, h.p, h.n, d, need_shade, h.prim, casts, w);
  float coef = last ? s : s * shade_c;
  V3 p_new = v3(pend.x + (need_shade ? sh.x * coef : 0.0f),
                pend.y + (need_shade ? sh.y * coef : 0.0f),
                pend.z + (need_shade ? sh.z * coef : 0.0f));

  if (last) {  // final level (the same in every lane): no children, deliver pending + shade
    if (mine) {
      for (int r = 0; r < 11; ++r) {
        put_f(rf, r, k, lane, 0.0f);
        put_f(ff, r, k, lane, 0.0f);
      }
      for (int r = 0; r < 5; ++r) {
        put_i(ri, r, k, lane, 0);
        put_i(fi, r, k, lane, 0);
      }
      put_f(contrib, 0, k, lane, p_new.x);
      put_f(contrib, 1, k, lane, p_new.y);
      put_f(contrib, 2, k, lane, p_new.z);
      casts_out[lane] = casts;
    }
    finish();
    return;
  }

  // reflect child (main.rs:493-500, get_reflect 328-341)
  float c_r = c * refl_c;
  bool want_r = live && c_r >= threshold;
  if (mine) {
    V3 fr = reflect3(d, h.n);
    put_f(rf, 0, k, lane, h.p.x);
    put_f(rf, 1, k, lane, h.p.y);
    put_f(rf, 2, k, lane, h.p.z);
    put_f(rf, 3, k, lane, fr.x);
    put_f(rf, 4, k, lane, fr.y);
    put_f(rf, 5, k, lane, fr.z);
    put_f(rf, 6, k, lane, c_r);
    put_f(rf, 7, k, lane, s * refl_c);
    put_i(ri, I_FACE, k, lane, face);  // the child keeps the incoming face (341)
    put_i(ri, I_EXCL_PRIM, k, lane, h.prim);
    put_i(ri, I_EXCL_FACE, k, lane, h.back ? FACE_FRONT : FACE_BACK);
    put_i(ri, I_SLOT, k, lane, slot);
    put_i(ri, I_ALIVE, k, lane, want_r ? 1 : 0);
  }

  // refract child (main.rs:502-514): the whole interior march
  float c_f = c * refr_c;
  bool want_f = live && c_f > threshold;  // strict > (504)
  March mm = march(g, h.p, h.n, d, m.refraction, want_f, max_distance, max_retries, w);
  if (mine) {
    casts += mm.iters;
    float decay = kpowf(m.decay, mm.travel);  // opaque_decay^travel (508)
    bool alive_f = want_f && mm.escaped;
    put_f(ff, 0, k, lane, mm.e.x);
    put_f(ff, 1, k, lane, mm.e.y);
    put_f(ff, 2, k, lane, mm.e.z);
    put_f(ff, 3, k, lane, mm.od.x);
    put_f(ff, 4, k, lane, mm.od.y);
    put_f(ff, 5, k, lane, mm.od.z);
    put_f(ff, 6, k, lane, c_f);
    put_f(ff, 7, k, lane, s * refr_c * decay);
    put_i(fi, I_FACE, k, lane, FACE_FRONT);
    put_i(fi, I_EXCL_PRIM, k, lane, mm.prim);
    put_i(fi, I_EXCL_FACE, k, lane, FACE_BACK);
    put_i(fi, I_SLOT, k, lane, slot);
    put_i(fi, I_ALIVE, k, lane, alive_f ? 1 : 0);

    // radiance delivery: direct levels emit through contrib; pooled levels
    // carry p_new on exactly one child (reflect by default, refract when
    // only it lives)
    V3 zero = v3(0.0f, 0.0f, 0.0f);
    bool carrier_f = !want_r && alive_f;
    V3 out_c = direct ? p_new : zero;
    V3 out_r = (direct || carrier_f) ? zero : p_new;
    V3 out_f = (!direct && carrier_f) ? p_new : zero;
    put_f(contrib, 0, k, lane, out_c.x);
    put_f(contrib, 1, k, lane, out_c.y);
    put_f(contrib, 2, k, lane, out_c.z);
    put_f(rf, F_PEND, k, lane, out_r.x);
    put_f(rf, F_PEND + 1, k, lane, out_r.y);
    put_f(rf, F_PEND + 2, k, lane, out_r.z);
    put_f(ff, F_PEND, k, lane, out_f.x);
    put_f(ff, F_PEND + 1, k, lane, out_f.y);
    put_f(ff, F_PEND + 2, k, lane, out_f.z);
    casts_out[lane] = casts;
  }
  finish();
}

template <class G>
int launch_level(const float* pf, const int* pi, G g, float* contrib, float* rf, int* ri,
                 float* ff, int* fi, int* casts, int* work, int k, int last, int direct,
                 float threshold, float max_distance, int max_retries, void* stream) {
  int blocks = (k + LEVEL_THREADS - 1) / LEVEL_THREADS;
  auto kernel = &level_kernel<G, NoWork>;
  if constexpr (G::Cone::ON) {  // no Work instantiation casts cones
    if (work) return (int)cudaErrorNotSupported;
  } else {
    if (work) kernel = &level_kernel<G, Work>;
  }
  int shared = g.smem(LEVEL_THREADS);
  if (shared) {
    int err = coop_opt_in((const void*)kernel, shared);
    if (err) return err;
  }
  kernel<<<blocks, LEVEL_THREADS, shared, (cudaStream_t)stream>>>(
      pf, pi, g, contrib, rf, ri, ff, fi, casts, work, k, last != 0, direct != 0, threshold,
      max_distance, max_retries);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" {

// pf: [11, k] float32; pi: [5, k] int32; contrib: [3, k]; rf/ff: [11, k];
// ri/fi: [5, k]; casts: [k]; work: [WORK_ROWS, k] or null (null runs the
// instantiation that counts nothing).  hot: the [n_tri, 16] hot rows; a
// table too large to stage (DenseRowsGeom::fits) is walked per thread.
// cone, n_cone: the cone rows [n_cone, 12] (kernel_common.pack_cones; null
// and 0: none), whose presence picks the staged walk with cones (with work
// given, or a table too large to stage, cudaErrorNotSupported).
int rt_level(const float* pf, const int* pi, const float* tri, int n_tri, const float* sph,
             int n_sph, const float* mat, int n_obj, const float* lights, int n_light,
             const float* hot, const float* cone, int n_cone, float* contrib, float* rf,
             int* ri, float* ff, int* fi, int* casts, int* work, int k, int last, int direct,
             float threshold, float max_distance, int max_retries, void* stream) {
  rt::Tables tb{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light};
  const float4* rows = (const float4*)hot;
  if (n_cone) {
    if (!rt::SharedDense::fits(n_tri)) return (int)cudaErrorNotSupported;
    return rt::launch_level(pf, pi,
                            rt::SharedDenseCones{{tb, rows}, {(const float4*)cone, n_cone, nullptr}},
                            contrib, rf, ri, ff, fi, casts, work, k, last, direct, threshold,
                            max_distance, max_retries, stream);
  }
  if (rt::SharedDense::fits(n_tri))
    return rt::launch_level(pf, pi, rt::SharedDense{tb, rows}, contrib, rf, ri, ff, fi, casts,
                            work, k, last, direct, threshold, max_distance, max_retries, stream);
  return rt::launch_level(pf, pi, rt::DenseGeom{tb}, contrib, rf, ri, ff, fi, casts, work, k,
                          last, direct, threshold, max_distance, max_retries, stream);
}

// The same level with every thread reading the dense table from global
// memory and sweeping once per light (DenseGeom): what the staged walk is
// held against.
int rt_level_thread(const float* pf, const int* pi, const float* tri, int n_tri,
                    const float* sph, int n_sph, const float* mat, int n_obj,
                    const float* lights, int n_light, float* contrib, float* rf, int* ri,
                    float* ff, int* fi, int* casts, int* work, int k, int last, int direct,
                    float threshold, float max_distance, int max_retries, void* stream) {
  rt::DenseGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light}};
  return rt::launch_level(pf, pi, g, contrib, rf, ri, ff, fi, casts, work, k, last, direct,
                          threshold, max_distance, max_retries, stream);
}

// The blocked instantiation: the warp-cooperative walk.  btri [NCH*128,
// 36], box [NCH, 8], sup [NCH/8, 8], n_chunks = chunks that hold a
// triangle; then the hot rows [NCH * 128, 16], their ids [NCH * 128], the
// chunks' live row counts [NCH] and the triangles' rows [n_tri].
int rt_level_blk(const float* pf, const int* pi, const float* tri, int n_tri, const float* sph,
                 int n_sph, const float* mat, int n_obj, const float* lights, int n_light,
                 const float* btri, const float* box, const float* sup, int n_chunks,
                 const float* hot, const int* ids, const int* live, const int* row_of_tri,
                 float* contrib, float* rf, int* ri, float* ff, int* fi, int* casts, int* work,
                 int k, int last, int direct, float threshold, float max_distance,
                 int max_retries, void* stream) {
  rt::CoopGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light},
                 rt::Blk{btri, box, sup, n_chunks},
                 rt::Hot{(const float4*)hot, ids, live, row_of_tri}};
  return rt::launch_level(pf, pi, g, contrib, rf, ri, ff, fi, casts, work, k, last, direct,
                          threshold, max_distance, max_retries, stream);
}

// The same level with every thread traversing the blocked table alone
// (BlockedGeom): what the cooperative walk is held against.
int rt_level_blk_thread(const float* pf, const int* pi, const float* tri, int n_tri,
                        const float* sph, int n_sph, const float* mat, int n_obj,
                        const float* lights, int n_light, const float* btri, const float* box,
                        const float* sup, int n_chunks, float* contrib, float* rf, int* ri,
                        float* ff, int* fi, int* casts, int* work, int k, int last, int direct,
                        float threshold, float max_distance, int max_retries, void* stream) {
  rt::BlockedGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light},
                    rt::Blk{btri, box, sup, n_chunks}};
  return rt::launch_level(pf, pi, g, contrib, rf, ri, ff, fi, casts, work, k, last, direct,
                          threshold, max_distance, max_retries, stream);
}

// Compiled attributes of the instantiation `which` that counts nothing (0
// dense: the staged walk, holding the rows of a table of n_tri triangles;
// 1 blocked: the cooperative walk; 2 the per-thread blocked walk; 3 the
// per-thread dense walk; n_tri is read only by 0): out = {registers per
// thread, local (spill + stack) bytes per thread, static shared bytes, max
// threads per block, dynamic shared bytes per launch, blocks an SM holds}.
int rt_level_attrs(int which, int n_tri, int* out) {
  using rt::NoWork;
  switch (which) {
    case 0:
      return rt::attrs_of((const void*)rt::level_kernel<rt::SharedDense, NoWork>, out,
                          rt::SharedDense::smem_bytes(n_tri));
    case 1:
      return rt::attrs_of((const void*)rt::level_kernel<rt::CoopGeom, NoWork>, out,
                          rt::coop_shared_bytes(rt::LEVEL_THREADS));
    case 2:
      return rt::attrs_of((const void*)rt::level_kernel<rt::BlockedGeom, NoWork>, out);
    default:
      return rt::attrs_of((const void*)rt::level_kernel<rt::DenseGeom, NoWork>, out);
  }
}

}  // extern "C"
