// Standalone interior-march kernel of the unfused path.
//
// Replaces the TPU kernel raytracer_tpu/ops/march_pallas.py:164
// `_march_kernel` (wrapper `march` :291).  Plain version:
// raytracer_tpu_torch/ops/march_kernel.py `march_plain`.
//
// One thread per ray runs the whole get_refract march (src/main.rs:343-405)
// through common.cuh `march`, the device function the level and MC kernels
// call: entry refraction (total internal reflection at entry traps the
// ray), the first interior leg, then up to max_retries interior
// reflections under the distance budget, and the exit refraction.  An
// interior miss kills the lane; `escaped` = alive and refracted out;
// `iters` = the lane's casts (loop iterations + the entry cast).  A lane
// that never marched (not wanted, or trapped at entry) writes zeros, as a
// dead TPU tile does (march_pallas.py:186-190).
//
// The TPU kernel's while loop runs a 512-lane tile until its last lane is
// done and carries bool state as int32; here each thread leaves its own
// loop, and a warp runs as long as its longest lane.  What bounds it on an
// H100: instruction issue over up to 11 back-face sweeps of 64 triangles
// and 4 spheres per marching lane, and that divergence; bytes are 41 in
// and 37 out per lane, marching or not, which is the larger term of the
// roofline bound on a tile where under half the lanes march (a marching
// lane of the demo scene runs about 1.7 sweeps).  128 threads per block,
// tables through const __restrict__ global pointers.  W is the test
// counter (common.cuh): NoWork on the main path, Work when the caller asks
// for the per-lane test counts.
#include "common.cuh"

namespace rt {

template <class W>
__global__ void __launch_bounds__(128)
march_kernel(const float* __restrict__ pos, const float* __restrict__ nrm,
             const float* __restrict__ dir, const float* __restrict__ k,
             const u8* __restrict__ want, DenseGeom g, float* __restrict__ esc_o,
             float* __restrict__ esc_d, int* __restrict__ prim_out, u8* __restrict__ escaped_out,
             float* __restrict__ travel_out, int* __restrict__ iters_out,
             int* __restrict__ work_out, int n, float max_distance, int max_retries) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  W w{};
  March mm = march(g, load3(pos, lane), load3(nrm, lane), load3(dir, lane), k[lane],
                   want[lane] != 0, max_distance, max_retries, w);
  bool marched = mm.iters > 0;
  V3 zero = v3(0.0f, 0.0f, 0.0f);
  store3(esc_o, lane, marched ? mm.e : zero);
  store3(esc_d, lane, marched ? mm.od : zero);
  prim_out[lane] = marched ? mm.prim : 0;
  escaped_out[lane] = mm.escaped ? 1 : 0;
  travel_out[lane] = marched ? mm.travel : 0.0f;
  iters_out[lane] = mm.iters;
  w.put(work_out, n, lane);
}

}  // namespace rt

extern "C" {

// pos, nrm, dir: [n, 3] float32 (the entry hit, its shading normal, the
// incoming direction); k: [n] refraction index; want: [n] bool; esc_o,
// esc_d: [n, 3]; prim: [n] int32; escaped: [n] bool; travel: [n]; iters:
// [n] int32; work: [WORK_ROWS, n] or null (null runs the instantiation that
// counts nothing).
int rt_march(const float* pos, const float* nrm, const float* dir, const float* k,
             const unsigned char* want, const float* tri, int n_tri, const float* sph, int n_sph,
             float* esc_o, float* esc_d, int* prim, unsigned char* escaped, float* travel,
             int* iters, int* work, int n, float max_distance, int max_retries, void* stream) {
  rt::DenseGeom g{rt::Tables{tri, sph, nullptr, nullptr, n_tri, n_sph, 0, 0}};
  auto kernel = work ? &rt::march_kernel<rt::Work> : &rt::march_kernel<rt::NoWork>;
  kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      pos, nrm, dir, k, want, g, esc_o, esc_d, prim, escaped, travel, iters, work, n,
      max_distance, max_retries);
  return (int)cudaGetLastError();
}

// Compiled attributes of the main path's instantiation, layout as
// rt_level_attrs (`which` is 0).
int rt_march_attrs(int which, int* out) {
  (void)which;
  return rt::attrs_of((const void*)rt::march_kernel<rt::NoWork>, out);
}

}  // extern "C"
