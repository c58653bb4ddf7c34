// Ordered radiance delivery of the Whitted ladder: each pool lane's
// radiance added into its pixel, the lanes of one pixel in lane order.
//
// A kernel of the port only: no TPU kernel stands behind it.  The JAX
// package delivers with XLA's scatter-add (raytracer_tpu/ops/trace.py:497, 513,
// 541, `img.at[slot].add`); the port's plain version is torch's index_add
// (raytracer_tpu_torch/ops/trace.py `deliver`), which on the CPU adds lane
// after lane: img[s] = ((img[s] + c_a) + c_b) + ...  On the card index_add
// adds with float atomics in no fixed order, so two renders of one frame
// parted in the last bit of a few thousand pixels.  This kernel gives the
// CPU's sum on the card.
//
// The wrapper sorts the lanes by slot with a stable sort, so each pixel's
// lanes form one run in lane order.  One thread takes each run: the
// thread at a run's first position reads the pixel, adds the run's
// contributions in order and writes the pixel once; every other thread
// leaves.  Runs are short (a pixel's chains end in at most 2^depth lanes),
// so the walk is a few loads a thread.  A lane whose radiance is all zeros
// adds nothing (x + 0 = x, but for -0, which compares equal to +0), and the
// pools' empty lanes, tens of thousands of them, all hold slot 0: the
// wrapper sorts them past the frame under the key NO_RADIANCE, whose run no
// thread walks.
//
// What bounds it on an H100: bytes, the pixels read and written and each
// lane's slot, position and radiance read once (a 65,536-ray tile's last
// pool: about 1.2 MB, under a microsecond at 3.35 TB/s); the launch
// itself costs more.  There is no multiply, so nvcc contracts nothing: the
// adds round as written, as the CPU's do.
#include <cuda_runtime.h>

namespace {

constexpr int DELIVER_THREADS = 256;
constexpr int NO_RADIANCE = 0x7FFFFFFF;  // ops/trace.py NO_RADIANCE

// img [n, 3] in place; slot [k] sorted ascending, lane [k] the pool lane of
// each sorted position (stable: lanes of one slot ascending); contrib
// [3, k] the pool's radiance rows.
__global__ void deliver_kernel(float* __restrict__ img, const int* __restrict__ slot,
                               const long long* __restrict__ lane,
                               const float* __restrict__ contrib, int n, int k) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  int s = slot[i];
  if (i > 0 && slot[i - 1] == s) return;  // not the first position of its run
  if (s == NO_RADIANCE) return;           // lanes that owe nothing
  if (s < 0 || s >= n) __trap();          // index_add raises on such a slot
  float r = img[3 * s], g = img[3 * s + 1], b = img[3 * s + 2];
  for (int j = i; j < k && slot[j] == s; ++j) {
    long long l = lane[j];
    r = r + contrib[l];
    g = g + contrib[k + l];
    b = b + contrib[2 * (long long)k + l];
  }
  img[3 * s] = r;
  img[3 * s + 1] = g;
  img[3 * s + 2] = b;
}

}  // namespace

extern "C" {

// img [n, 3] f32 (updated in place), slot [k] i32 sorted, lane [k] i64,
// contrib [3, k] f32, n, k, stream.  Returns cudaGetLastError().
int rt_deliver(float* img, const int* slot, const long long* lane, const float* contrib, int n,
               int k, void* stream) {
  deliver_kernel<<<(k + DELIVER_THREADS - 1) / DELIVER_THREADS, DELIVER_THREADS, 0,
                   (cudaStream_t)stream>>>(img, slot, lane, contrib, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
