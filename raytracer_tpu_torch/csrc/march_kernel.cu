// Standalone interior-march kernel of the unfused path.
//
// Replaces the TPU kernel raytracer_tpu/ops/march_pallas.py:164
// `_march_kernel` (wrapper `march` :291).  Plain version:
// raytracer_tpu_torch/ops/march_kernel.py `march_plain`.
//
// A thread runs a ray's whole get_refract march (src/main.rs:343-405)
// through common.cuh `march`, the device function the level and MC kernels
// call: entry refraction (total internal reflection at entry traps the
// ray), the first interior leg, then up to max_retries interior
// reflections under the distance budget, and the exit refraction.  An
// interior miss kills the lane; `escaped` = alive and refracted out;
// `iters` = the lane's casts (loop iterations + the entry cast).  A lane
// that never marched (not wanted, or trapped at entry) writes zeros, as a
// dead TPU tile does (march_pallas.py:186-190).
//
// What bounds it on an H100: instruction issue over the back-face sweeps
// (every row of the dense table, then the spheres, up to 11 times a lane)
// and, in the batches the unfused MC walk hands it, idle lanes: only the
// lanes that refract march (4-29 % of an epoch's lanes), and a warp runs
// as long as its longest lane, so in lane order over half the warps that
// hold a marching lane run mostly idle.  Bytes are 41 in and 37 out a lane.
// The design: the lanes that march are listed first (common.cuh
// list_lanes), and the first threads of the launch take them, 32 to a
// warp; every thread writes its own lane's zeros if that lane does not
// march (coalesced), and blocks past the listed lanes leave at once.  The
// blocks that march stage the dense table's 64-byte hot rows in their
// shared memory and sweep them as broadcast float4s (common.cuh
// DenseRowsGeom; a table too large to stage is walked by DenseGeom).  The
// unfused MC epoch calls it once for the whole frame (render.epoch_frame),
// which gives the launch enough lanes to fill the card.  The TPU kernel's
// 512-lane tiles and int32 bool state are gone.  The outputs keep the
// lanes' order.  march_thread_kernel is the kernel before this design, one
// thread per lane in lane order over the [T, 34] table in global memory:
// the yardstick chip_smoke.py holds the main path's kernel against
// (rt_march_thread); no wrapper of the main path launches it.  W is the
// test counter (common.cuh): NoWork on the main path, Work when the caller
// asks for the test counts (march_kernel: a column a thread, the lane it
// marched; march_thread_kernel: a column a lane).
#include "common.cuh"

namespace rt {

constexpr int MARCH_THREADS = 128;

// The dense walk out of the block's shared memory.
using MarchRows = DenseRowsGeom<false>;

__device__ __forceinline__ void put_march(const March& mm, int lane, float* __restrict__ esc_o,
                                          float* __restrict__ esc_d, int* __restrict__ prim_out,
                                          u8* __restrict__ escaped_out,
                                          float* __restrict__ travel_out,
                                          int* __restrict__ iters_out) {
  bool marched = mm.iters > 0;
  V3 zero = v3(0.0f, 0.0f, 0.0f);
  store3(esc_o, lane, marched ? mm.e : zero);
  store3(esc_d, lane, marched ? mm.od : zero);
  prim_out[lane] = marched ? mm.prim : 0;
  escaped_out[lane] = mm.escaped ? 1 : 0;
  travel_out[lane] = marched ? mm.travel : 0.0f;
  iters_out[lane] = mm.iters;
}

// lanes: the wanted lanes listed (list_lanes), their count at lanes[n].
template <class G, class W>
__global__ void __launch_bounds__(MARCH_THREADS)
march_kernel(const float* __restrict__ pos, const float* __restrict__ nrm,
             const float* __restrict__ dir, const float* __restrict__ k,
             const u8* __restrict__ want, G g, const int* __restrict__ lanes,
             float* __restrict__ esc_o, float* __restrict__ esc_d, int* __restrict__ prim_out,
             u8* __restrict__ escaped_out, float* __restrict__ travel_out,
             int* __restrict__ iters_out, int* __restrict__ work_out, int n, float max_distance,
             int max_retries) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int listed = lanes[n];
  W w{};
  if (t < n && !want[t]) {  // a lane that does not march: its zeros, from its own position
    March none{};
    put_march(none, t, esc_o, esc_d, prim_out, escaped_out, travel_out, iters_out);
  }
  if ((int)(blockIdx.x * blockDim.x) < listed) {  // the block holds a listed lane
    g.stage();
    if (t < listed) {
      const int lane = lanes[t];
      March mm = march(g, load3(pos, lane), load3(nrm, lane), load3(dir, lane), k[lane], true,
                       max_distance, max_retries, w);
      put_march(mm, lane, esc_o, esc_d, prim_out, escaped_out, travel_out, iters_out);
    }
  }
  if (t < n) w.put(work_out, n, t);
}

// The kernel before the design above: one thread per lane, in lane order.
template <class W>
__global__ void __launch_bounds__(MARCH_THREADS)
march_thread_kernel(const float* __restrict__ pos, const float* __restrict__ nrm,
                    const float* __restrict__ dir, const float* __restrict__ k,
                    const u8* __restrict__ want, DenseGeom g, float* __restrict__ esc_o,
                    float* __restrict__ esc_d, int* __restrict__ prim_out,
                    u8* __restrict__ escaped_out, float* __restrict__ travel_out,
                    int* __restrict__ iters_out, int* __restrict__ work_out, int n,
                    float max_distance, int max_retries) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  W w{};
  March mm = march(g, load3(pos, lane), load3(nrm, lane), load3(dir, lane), k[lane],
                   want[lane] != 0, max_distance, max_retries, w);
  put_march(mm, lane, esc_o, esc_d, prim_out, escaped_out, travel_out, iters_out);
  w.put(work_out, n, lane);
}

template <class G>
int launch_march(const float* pos, const float* nrm, const float* dir, const float* k,
                 const u8* want, G g, const int* lanes, float* esc_o, float* esc_d, int* prim,
                 u8* escaped, float* travel, int* iters, int* work, int n, float max_distance,
                 int max_retries, cudaStream_t stream) {
  auto kernel = work ? &march_kernel<G, Work> : &march_kernel<G, NoWork>;
  int shared = g.smem(MARCH_THREADS);
  if (shared) {
    int err = coop_opt_in((const void*)kernel, shared);
    if (err) return err;
  }
  kernel<<<(n + MARCH_THREADS - 1) / MARCH_THREADS, MARCH_THREADS, shared, stream>>>(
      pos, nrm, dir, k, want, g, lanes, esc_o, esc_d, prim, escaped, travel, iters, work, n,
      max_distance, max_retries);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" {

// pos, nrm, dir: [n, 3] float32 (the entry hit, its shading normal, the
// incoming direction); k: [n] refraction index; want: [n] bool; hot: the
// [n_tri, 16] hot rows (a table too large to stage, DenseRowsGeom::fits,
// is walked from the [n_tri, 34] table); lanes: [n + 1] int32 scratch (the
// listed lanes and their count); esc_o, esc_d: [n, 3]; prim: [n] int32;
// escaped: [n] bool; travel: [n]; iters: [n] int32; work: [WORK_ROWS, n] or
// null (null runs the instantiation that counts nothing).
int rt_march(const float* pos, const float* nrm, const float* dir, const float* k,
             const unsigned char* want, const float* tri, int n_tri, const float* sph, int n_sph,
             const float* hot, int* lanes, float* esc_o, float* esc_d, int* prim,
             unsigned char* escaped, float* travel, int* iters, int* work, int n,
             float max_distance, int max_retries, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = rt::launch_list_lanes(want, 1, n, lanes, st);
  if (err) return err;
  rt::Tables tb{tri, sph, nullptr, nullptr, n_tri, n_sph, 0, 0};
  if (rt::MarchRows::fits(n_tri))
    return rt::launch_march(pos, nrm, dir, k, want, rt::MarchRows{tb, (const float4*)hot}, lanes,
                            esc_o, esc_d, prim, escaped, travel, iters, work, n, max_distance,
                            max_retries, st);
  return rt::launch_march(pos, nrm, dir, k, want, rt::DenseGeom{tb}, lanes, esc_o, esc_d, prim,
                          escaped, travel, iters, work, n, max_distance, max_retries, st);
}

// The same march with one thread per lane over the table in global memory:
// what rt_march is held against.  Arguments as rt_march without hot and
// lanes.
int rt_march_thread(const float* pos, const float* nrm, const float* dir, const float* k,
                    const unsigned char* want, const float* tri, int n_tri, const float* sph,
                    int n_sph, float* esc_o, float* esc_d, int* prim, unsigned char* escaped,
                    float* travel, int* iters, int* work, int n, float max_distance,
                    int max_retries, void* stream) {
  rt::DenseGeom g{rt::Tables{tri, sph, nullptr, nullptr, n_tri, n_sph, 0, 0}};
  auto kernel = work ? &rt::march_thread_kernel<rt::Work> : &rt::march_thread_kernel<rt::NoWork>;
  kernel<<<(n + rt::MARCH_THREADS - 1) / rt::MARCH_THREADS, rt::MARCH_THREADS, 0,
           (cudaStream_t)stream>>>(pos, nrm, dir, k, want, g, esc_o, esc_d, prim, escaped, travel,
                                   iters, work, n, max_distance, max_retries);
  return (int)cudaGetLastError();
}

// Compiled attributes of the instantiation `which` that counts nothing (0:
// the main path's, staging the rows of a table of n_tri triangles; 1: the
// per-thread yardstick), layout as rt_level_attrs.
int rt_march_attrs(int which, int n_tri, int* out) {
  if (which == 0)
    return rt::attrs_of((const void*)rt::march_kernel<rt::MarchRows, rt::NoWork>, out,
                        rt::MarchRows::smem_bytes(n_tri));
  return rt::attrs_of((const void*)rt::march_thread_kernel<rt::NoWork>, out);
}

}  // extern "C"
