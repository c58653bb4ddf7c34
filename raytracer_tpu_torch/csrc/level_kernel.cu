// Whitted bounce-level kernel: one wavefront level of the flattened
// ray_trace recursion (src/main.rs:466-519) per launch.
//
// Replaces the TPU kernel raytracer_tpu/ops/level_pallas.py:73
// `_level_kernel` / :127 `_level_body` (wrapper `process_level` :261),
// both of its branches: one instantiation per geometry policy
// (common.cuh DenseGeom, BlockedGeom for the large-mesh blocked layout).
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
// pool I/O is 128 bytes in and ~260 bytes out per lane.  On the blocked
// layout the lanes of a warp also diverge in which chunks they enter; the
// warp serialises their union (staging chunks in shared memory and
// warp-cooperative gating are later work).  The design: 128
// threads per block, scene tables through const __restrict__ global
// pointers (L1-resident), and a per-lane early exit in place of the TPU's
// dead-tile skip — a lane that is not alive writes exactly what a dead
// TPU tile writes (children zero; pending delivered through contrib on
// direct levels, otherwise carried on the reflect child with its slot).
// The TPU's 512-lane tiles, bit-cast int rows and one-hot attribute
// matmuls are gone.  W is the test counter (common.cuh): NoWork on the
// main path, Work when the caller asks for the per-lane test counts.
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

template <class G, class W>
__global__ void __launch_bounds__(128)
level_kernel(const float* __restrict__ pf, const int* __restrict__ pi, G g,
             float* __restrict__ contrib, float* __restrict__ rf, int* __restrict__ ri,
             float* __restrict__ ff, int* __restrict__ fi, int* __restrict__ casts_out,
             int* __restrict__ work_out, int k, bool last, bool direct, float threshold,
             float max_distance, int max_retries) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= k) return;
  const Tables& tb = g.tb;
  W w{};
  auto f_at = [&](int row) { return pf[(size_t)row * k + lane]; };
  auto i_at = [&](int row) { return pi[(size_t)row * k + lane]; };
  V3 pend = v3(f_at(F_PEND), f_at(F_PEND + 1), f_at(F_PEND + 2));
  int slot = i_at(I_SLOT);

  if (i_at(I_ALIVE) == 0) {  // what a dead TPU tile gives
    for (int r = 0; r < 11; ++r) {
      put_f(rf, r, k, lane, 0.0f);
      put_f(ff, r, k, lane, 0.0f);
    }
    for (int r = 0; r < 5; ++r) {
      put_i(ri, r, k, lane, 0);
      put_i(fi, r, k, lane, 0);
    }
    V3 c = direct ? pend : v3(0.0f, 0.0f, 0.0f);
    put_f(contrib, 0, k, lane, c.x);
    put_f(contrib, 1, k, lane, c.y);
    put_f(contrib, 2, k, lane, c.z);
    if (!direct) {  // pending rides the (dead) reflect child
      put_f(rf, F_PEND, k, lane, pend.x);
      put_f(rf, F_PEND + 1, k, lane, pend.y);
      put_f(rf, F_PEND + 2, k, lane, pend.z);
      put_i(ri, I_SLOT, k, lane, slot);
    }
    casts_out[lane] = 0;
    w.put(work_out, k, lane);
    return;
  }

  V3 o = v3(f_at(0), f_at(1), f_at(2));
  V3 d = v3(f_at(3), f_at(4), f_at(5));
  float c = f_at(6), s = f_at(7);
  int face = i_at(I_FACE);

  Hit h = g.nearest(o, d, face, i_at(I_EXCL_PRIM), i_at(I_EXCL_FACE), true, w);
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

  if (last) {  // final level: no children, deliver pending + shade
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
    w.put(work_out, k, lane);
    return;
  }

  // reflect child (main.rs:493-500, get_reflect 328-341)
  float c_r = c * refl_c;
  bool want_r = live && c_r >= threshold;
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

  // refract child (main.rs:502-514): the whole interior march
  float c_f = c * refr_c;
  bool want_f = live && c_f > threshold;  // strict > (504)
  March mm = march(g, h.p, h.n, d, m.refraction, want_f, max_distance, max_retries, w);
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
  w.put(work_out, k, lane);
}

template <class G>
int launch_level(const float* pf, const int* pi, G g, float* contrib, float* rf, int* ri,
                 float* ff, int* fi, int* casts, int* work, int k, int last, int direct,
                 float threshold, float max_distance, int max_retries, void* stream) {
  int blocks = (k + 127) / 128;
  auto kernel = work ? &level_kernel<G, Work> : &level_kernel<G, NoWork>;
  kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(pf, pi, g, contrib, rf, ri, ff, fi, casts,
                                                  work, k, last != 0, direct != 0, threshold,
                                                  max_distance, max_retries);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" {

// pf: [11, k] float32; pi: [5, k] int32; contrib: [3, k]; rf/ff: [11, k];
// ri/fi: [5, k]; casts: [k]; work: [WORK_ROWS, k] or null (null runs the
// instantiation that counts nothing).
int rt_level(const float* pf, const int* pi, const float* tri, int n_tri, const float* sph,
             int n_sph, const float* mat, int n_obj, const float* lights, int n_light,
             float* contrib, float* rf, int* ri, float* ff, int* fi, int* casts, int* work, int k,
             int last, int direct, float threshold, float max_distance, int max_retries,
             void* stream) {
  rt::DenseGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light}};
  return rt::launch_level(pf, pi, g, contrib, rf, ri, ff, fi, casts, work, k, last, direct,
                          threshold, max_distance, max_retries, stream);
}

// The blocked instantiation: btri [NCH*128, 36], box [NCH, 8], sup
// [NCH/8, 8], n_chunks = chunks that hold a triangle.
int rt_level_blk(const float* pf, const int* pi, const float* tri, int n_tri, const float* sph,
                 int n_sph, const float* mat, int n_obj, const float* lights, int n_light,
                 const float* btri, const float* box, const float* sup, int n_chunks,
                 float* contrib, float* rf, int* ri, float* ff, int* fi, int* casts, int* work,
                 int k, int last, int direct, float threshold, float max_distance,
                 int max_retries, void* stream) {
  rt::BlockedGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light},
                    rt::Blk{btri, box, sup, n_chunks}};
  return rt::launch_level(pf, pi, g, contrib, rf, ri, ff, fi, casts, work, k, last, direct,
                          threshold, max_distance, max_retries, stream);
}

// Compiled attributes of the main path's instantiation `which` (0 dense, 1
// blocked): out = {registers per thread, local (spill + stack) bytes per
// thread, static shared bytes, max threads per block}.
int rt_level_attrs(int which, int* out) {
  return rt::attrs_of(which ? (const void*)rt::level_kernel<rt::BlockedGeom, rt::NoWork>
                            : (const void*)rt::level_kernel<rt::DenseGeom, rt::NoWork>,
                      out);
}

}  // extern "C"
