// Building blocks shared by the level, MC and binned MC kernels and by the
// standalone nearest-hit, any-hit, shadow and march kernels.
//
// __device__ counterparts of raytracer_tpu/ops/kernel_common.py:105-894
// (full_sweep, eval_material, _ShadowSweep + get_shade,
// back_sweep_with_normal, march_rows, rotate_from_z, reflect3, refract3,
// normalize3) and :978-1786 (the blocked large-mesh sweeps and the
// DenseGeom / BlockedGeom switch), one thread per ray.  The plain PyTorch
// versions the kernels are tested against are
// raytracer_tpu_torch/ops/kernel_common.py.
//
// The TPU workarounds are not carried over: acosf/atan2f/sinf/cosf/powf
// replace the Mosaic polynomials, the winner's attributes are read by
// index instead of a one-hot matrix product, and ints stay ints.
// Semantics kept exactly: face culling, exclusion by (prim, face),
// last-wins ties with spheres scanned after triangles (update on <=),
// non-finite t is a miss, the 3e38 sentinel, kpowf's "0 for base <= 0",
// and the factored-target shadow algebra.
//
// Geometry is a policy type (DenseGeom, DenseRowsGeom, BlockedGeom,
// CoopGeom) the kernels are templated on.  DenseGeom tests the whole
// [T, 34] table per sweep, one thread alone out of global memory, and
// sweeps once per light of a shading point: the standalone kernels take it,
// and it is the yardstick of the dense level and MC kernels, which take
// DenseRowsGeom: the same sweeps (tri_nearest, tri_occluded, back_sweep
// are templated on where a row is read), but over the block's shared
// memory (the 64-byte hot rows, staged once per block, one broadcast
// float4 load where DenseGeom makes four scalar ones through L1), and, in
// the level kernel, all lights of a shading point in one pass over the
// rows; a table too large to stage is walked by DenseGeom.  On a dense
// scene a thread's time goes to chains of dependent loads and arithmetic
// over every row, and to shading math; what hides their latency is warps
// in flight, so registers decide (the MC kernel's one-pass shadow took 32
// more registers, a block an SM, and lost; the level kernel, a wave at
// most, gains from it).
// BlockedGeom walks the blocked layout (scene/blocked.py): per lane, a
// supergroup's box, then each of its chunks' boxes, bounded by the lane's
// current best hit (or shadow limit), then the chunk's 128 rows; ties go
// to the larger ORIGINAL triangle id, so the visit order cannot change a
// winner.  The TPU's per-tile gates, supergroup visit order and HBM chunk
// streaming are not ported: the permuted table stays in global memory.
//
// BlockedGeom is one thread alone: every row costs it a dependent load
// from a 144-byte row in global memory, a warp runs the 128-row loop once
// for every chunk that any of its lanes entered, and a launch lasts as
// long as its slowest warp's chain of such loops.  CoopGeom is the same
// walk made by the 32 lanes of a warp together (every blocked kernel takes
// it): each lane tests the boxes for its own ray,
// the warp ORs the lanes' chunk masks and copies each chunk of the union
// once into its own shared memory buffer (cp.async, 16 bytes a lane: the
// 64-byte hot rows of Hot, which hold only what decides a hit, and their
// ids).  Then the warp takes
// the rays of the lanes whose own box test admitted the chunk one by one,
// and its 32 lanes test 32 rows at once: 4 steps where one thread makes
// 128, the winner found by two warp reductions.  A shading point's
// shadow rays to all lights make one such pass.  Every ray meets exactly
// the tests of the per-thread walk, so hits, photons and the Work totals
// are those of BlockedGeom.  What it demands: all 32 lanes of a warp call a
// sweep together, each with a `want` flag, so the kernels that take it have
// no per-lane return, continue or loop around a sweep (G::COOP, G::any
// below).  Measured and left out (PERF.md): every lane testing the staged
// rows for its own ray (2.2x over BlockedGeom, against 9x), a second buffer
// that prefetches the next chunk, straight-line row tests, a supergroup's
// 32 box tests under one vote.
//
// Every sweep reports the tests it runs to a counter policy W (Work or
// NoWork, below); chip_smoke.py derives each kernel's operation bound from
// what Work counts.
//
// The sphere sweeps (sph_nearest, sph_occluded, finish_back) test every
// sphere in index order; their overloads given a SphGated walk the sphere
// chunk table (scene/blocked.py build_sph_chunks) as blocked_tris walks the
// blocked triangles: a supergroup's box, each of its chunks' boxes, bounded
// by the ray's best hit (or shadow limit), then the chunk's spheres.  Their
// hits are the linear sweeps': the least t, ties to the larger primitive
// id.  A geometry names its sweeps' policy (G::Sph): SphLinear, or SphGated
// for SphGatedGeom, which carries the table beside its base geometry's
// members; only the MC kernel's dense routes instantiate it, and its entry
// launches them on a scene that carries the table.
//
// NFF cones (open truncated cones, cylinders where both radii are equal)
// are a scene's third primitive, ids after the spheres'.  A geometry names
// its cone policy (G::Cone): ConeNone, or ConeLinear for ConeGeom<G>,
// which carries the cone table beside G's members and sweeps every cone
// after the spheres in its nearest, shadow and interior sweeps.  Only the
// staged dense MC walk (over SphGatedGeom) and the staged dense level
// kernel instantiate it, on scenes with cones; every other instantiation is
// the parent's code.
//
// Scene tables are read from global memory, but for what DenseRowsGeom
// and CoopGeom stage in shared memory.  Build without --use_fast_math: the
// photon filter needs subnormals, and division/sqrt must stay IEEE.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt {

constexpr float BIG = 3.0e38f;
constexpr float F32_EPS = 1.1920928955078125e-07f;
constexpr float INV_PI = 0.31830987f;       // float32(1/pi)
constexpr float HALF_INV_PI = 0.15915494f;  // float32(0.5/pi)
constexpr float EIGHT_PI = 25.132742f;      // float32(8 pi)
constexpr float PI_F = 3.1415927f;          // float32(pi)

constexpr int FACE_FRONT = 0;
constexpr int FACE_BACK = 1;

constexpr int TRI_COLS = 34;
constexpr int SPH_COLS = 8;
constexpr int MAT_COLS = 16;
constexpr int LIGHT_COLS = 16;

// Blocked layout (scene/blocked.py, ops/kernel_common.py BLK_COLS)
constexpr int BLK_CHUNK = 128;
constexpr int SUP_CHUNKS = 8;
constexpr int BLK_COLS = 36;
constexpr int BLK_ID = 34;  // original triangle id, as float (-1 = pad row)

// The sphere chunk table (scene/blocked.py, ops/kernel_common.py
// pack_sph_chunks): rows of SPH_COLS in chunk order, SPH_CHUNK a chunk.
constexpr int SPH_CHUNK = 16;
constexpr int SPH_SUP = 8;  // chunks per supergroup
constexpr int SPH_ID = 5;   // original sphere index, as float (-1 = pad row)
// The gate's slack, 2^-15 (scene/blocked.py SPH_PAD): a box is widened by
// SPH_PAD times the ray origin's largest coordinate magnitude (sph_gate),
// as the table widened it by SPH_PAD times the spheres' own.
constexpr float SPH_PAD = 3.0517578125e-05f;

// The lanes that sweep together (CoopGeom).  32 on the card; a host
// emulation that steps the threads one by one builds with 1: every thread
// is then a warp of its own, and the votes below are the identity.
#ifndef RT_WARP
#define RT_WARP 32
#endif
constexpr int WARP = RT_WARP;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HOT_F4 = 4;                     // float4 per hot row (16 floats)
constexpr int ROWS_F4 = BLK_CHUNK * HOT_F4;   // a staged chunk's rows: 8 KB
constexpr int STAGE_F4 = ROWS_F4 + BLK_CHUNK / 4;  // and its ids: 8.5 KB a warp
constexpr int LIGHT_GROUP = 4;                // lights per cooperative shadow pass

struct Tables {
  const float* __restrict__ tri;     // [n_tri, 34]
  const float* __restrict__ sph;     // [n_sph, 8]
  const float* __restrict__ mat;     // [n_obj, 16]
  const float* __restrict__ lights;  // [n_light, 16]
  int n_tri, n_sph, n_obj, n_light;
};

// The blocked tables of a large mesh.
struct Blk {
  const float* __restrict__ tri;  // [NCH * 128, 36] rows in BVH leaf order
  const float* __restrict__ box;  // [NCH, 8] chunk AABBs (min 0:3, max 3:6)
  const float* __restrict__ sup;  // [NCH / 8, 8] supergroup AABBs
  int n_chunks;                   // chunks that hold a triangle
};

// What the cooperative sweeps read of the same rows (kernel_common.pack_hot).
struct Hot {
  const float4* __restrict__ rows;     // [NCH * 128, 4]: columns 0:16 of Blk::tri
  const int* __restrict__ ids;         // [NCH * 128] original triangle id (-1 = pad row)
  const int* __restrict__ live;        // [NCH] live rows of each chunk (pad rows trail)
  const int* __restrict__ row_of_tri;  // [n_tri] blocked row of a triangle: a ray's
                                       // excluded triangle by row, not by id
};

// The low 32 bits of the card's nanosecond clock (%globaltimer), and of
// the SM's cycle counter.
__device__ __forceinline__ int timer_ns() {
#ifdef __CUDACC__
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (int)(unsigned)t;
#else
  return 0;
#endif
}

__device__ __forceinline__ int cycles() {
#ifdef __CUDACC__
  return (int)clock64();
#else
  return 0;
#endif
}

// Tests one thread ran, by how far each got, so that an operation bound
// can charge each kind its own cost: triangle tests begun (one dot product
// and its rejection test), those that went on to the plane's t, edge tests
// evaluated, sphere tests and box (slab) tests.  Then how the lanes of a
// warp diverge on a blocked mesh: the chunks whose rows one of the thread's
// rays tested, and the chunks its warp staged in shared memory (counted by
// the warp's first lane; 0 in the per-thread walks).  Then the card's
// clock when the thread began and when it wrote its counts, for the spread
// of block durations inside one launch.  Last, where a cooperative walk's
// cycles go: in its box tests and votes, in waiting for chunks to arrive in
// shared memory, in testing staged rows (with the shuffles and reductions
// around them), and from the thread's start to its end.  Last, the same
// cycles by phase of the walk, in any geometry: in nearest-hit sweeps, in
// shadow tests, and in interior marches (the rest of cyc_all is shading,
// materials, sampling and the state).  Counting is chosen at compile time:
// the main path's instantiations take NoWork, whose calls compile to
// nothing; an MC launch given a `sph_tests` output takes SphCount, which
// counts its sphere tests alone (below); a launch given a `work` output
// takes Work.  A sphere sweep also reports its tests in one call at its end
// (sph_tests: nothing in Work, which has counted each), and a gated one its
// box tests (sph_box_tests: in Work's box row).
constexpr int WORK_ROWS = 16;

struct Work {
  int tri, plane, edge, sph, box, chunks, staged, t_in;
  int cyc_box, cyc_stage, cyc_rows, cyc_in, cyc_near, cyc_shadow, cyc_march;
  __device__ __forceinline__ Work()
      : tri(0), plane(0), edge(0), sph(0), box(0), chunks(0), staged(0), t_in(timer_ns()),
        cyc_box(0), cyc_stage(0), cyc_rows(0), cyc_in(cycles()), cyc_near(0), cyc_shadow(0),
        cyc_march(0) {}
  // t = tic(); ...; box_cycles(t): the cycles since then go to that phase
  __device__ __forceinline__ int tic() const { return cycles(); }
  __device__ __forceinline__ void box_cycles(int t) { cyc_box += cycles() - t; }
  __device__ __forceinline__ void stage_cycles(int t) { cyc_stage += cycles() - t; }
  __device__ __forceinline__ void row_cycles(int t) { cyc_rows += cycles() - t; }
  __device__ __forceinline__ void near_cycles(int t) { cyc_near += cycles() - t; }
  __device__ __forceinline__ void shadow_cycles(int t) { cyc_shadow += cycles() - t; }
  __device__ __forceinline__ void march_cycles(int t) { cyc_march += cycles() - t; }
  __device__ __forceinline__ void tri_test() { ++tri; }
  __device__ __forceinline__ void plane_test() { ++plane; }
  __device__ __forceinline__ void edge_test() { ++edge; }
  __device__ __forceinline__ void sph_test() { ++sph; }
  __device__ __forceinline__ void sph_tests(int) {}
  __device__ __forceinline__ void box_test() { ++box; }
  __device__ __forceinline__ void box_tests(int n) { box += n; }
  __device__ __forceinline__ void sph_box_tests(int n) { box += n; }
  __device__ __forceinline__ void chunk(int n = 1) { chunks += n; }
  __device__ __forceinline__ void stage() { ++staged; }
  // Triangle tests kept apart until it is known whether they count (rows
  // that a warp tests at once, past a shadow ray's first occluder).
  struct Part {
    int tri = 0, plane = 0, edge = 0;
    __device__ __forceinline__ void tri_test() { ++tri; }
    __device__ __forceinline__ void plane_test() { ++plane; }
    __device__ __forceinline__ void edge_test() { ++edge; }
  };
  __device__ __forceinline__ void add(const Part& p) {
    tri += p.tri;
    plane += p.plane;
    edge += p.edge;
  }
  // into rows of out [WORK_ROWS, n], in the order above
  __device__ __forceinline__ void put(int* __restrict__ out, int n, int lane) const {
    out[lane] = tri;
    out[n + lane] = plane;
    out[2 * n + lane] = edge;
    out[3 * n + lane] = sph;
    out[4 * n + lane] = box;
    out[5 * n + lane] = chunks;
    out[6 * n + lane] = staged;
    out[7 * n + lane] = t_in;
    out[8 * n + lane] = timer_ns();
    out[9 * n + lane] = cyc_box;
    out[10 * n + lane] = cyc_stage;
    out[11 * n + lane] = cyc_rows;
    out[12 * n + lane] = cycles() - cyc_in;
    out[13 * n + lane] = cyc_near;
    out[14 * n + lane] = cyc_shadow;
    out[15 * n + lane] = cyc_march;
  }
  // A thread past the tile's end that tested rows for other lanes' rays
  // (or, in the level kernel, ran a lane dealt to it): its tests and the
  // chunks its ray entered go to column `lane` (the tile's last), after
  // that lane's put.
  __device__ __forceinline__ void put_helped(int* __restrict__ out, int n, int lane) const {
    atomicAdd(out + lane, tri);
    atomicAdd(out + n + lane, plane);
    atomicAdd(out + 2 * n + lane, edge);
    atomicAdd(out + 3 * n + lane, sph);
    atomicAdd(out + 4 * n + lane, box);
    atomicAdd(out + 5 * n + lane, chunks);
  }
  // the lane's sphere tests into out [n], if given (SphCount's output)
  __device__ __forceinline__ void put_sph(long long* __restrict__ out, int lane) const {
    if (out) out[lane] = sph;
  }
  // the lane's box tests (a gated walk's: its sphere gate's alone) into out
  // [n], if given (SphGated::box_tests)
  __device__ __forceinline__ void put_sph_box(long long* __restrict__ out, int lane) const {
    if (out) out[lane] = box;
  }
};

struct NoWork {
  __device__ __forceinline__ void tri_test() {}
  __device__ __forceinline__ void plane_test() {}
  __device__ __forceinline__ void edge_test() {}
  __device__ __forceinline__ void sph_test() {}
  __device__ __forceinline__ void sph_tests(int) {}
  __device__ __forceinline__ void box_test() {}
  __device__ __forceinline__ void box_tests(int) {}
  __device__ __forceinline__ void sph_box_tests(int) {}
  __device__ __forceinline__ void chunk(int = 1) {}
  __device__ __forceinline__ void stage() {}
  __device__ __forceinline__ int tic() const { return 0; }
  __device__ __forceinline__ void box_cycles(int) {}
  __device__ __forceinline__ void stage_cycles(int) {}
  __device__ __forceinline__ void row_cycles(int) {}
  __device__ __forceinline__ void near_cycles(int) {}
  __device__ __forceinline__ void shadow_cycles(int) {}
  __device__ __forceinline__ void march_cycles(int) {}
  struct Part {
    __device__ __forceinline__ void tri_test() {}
    __device__ __forceinline__ void plane_test() {}
    __device__ __forceinline__ void edge_test() {}
  };
  __device__ __forceinline__ void add(const Part&) {}
  __device__ __forceinline__ void put(int*, int, int) const {}
  __device__ __forceinline__ void put_helped(int*, int, int) const {}
  __device__ __forceinline__ void put_sph(long long*, int) const {}
  __device__ __forceinline__ void put_sph_box(long long*, int) const {}
  __device__ __forceinline__ void cone_tests(int) {}
  __device__ __forceinline__ void put_cone(long long*, int) const {}
};

// The MC walk's sphere counters (mc.sph_tests, mc.sph_box_tests): NoWork,
// but each sphere sweep adds the tests it made once, at its end, to one
// register, and a gated one its box tests to another, which put_sph and
// put_sph_box write out.  A lane past the tile's end tests no sphere, so no
// put_helped is needed.
struct SphCount : NoWork {
  int sph = 0, sph_box = 0;
  __device__ __forceinline__ void sph_tests(int k) { sph += k; }
  __device__ __forceinline__ void sph_box_tests(int k) { sph_box += k; }
  __device__ __forceinline__ void put_sph(long long* __restrict__ out, int lane) const {
    if (out) out[lane] = sph;
  }
  __device__ __forceinline__ void put_sph_box(long long* __restrict__ out, int lane) const {
    if (out) out[lane] = sph_box;
  }
};

// SphCount for a walk with cones (mc.cone_tests): each cone sweep adds the
// tests it made once, at its end, to a third register, which put_cone
// writes out.
struct ConeCount : SphCount {
  int cone = 0;
  __device__ __forceinline__ void cone_tests(int k) { cone += k; }
  __device__ __forceinline__ void put_cone(long long* __restrict__ out, int lane) const {
    if (out) out[lane] = cone;
  }
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ float dot3p(const float* __restrict__ r, V3 b) {
  return r[0] * b.x + r[1] * b.y + r[2] * b.z;
}

// The triangle tests (tri_nearest, tri_any, tri_occluded and their
// blocked, staged and cooperative forms) round every operation as
// written, as the plain versions do in PyTorch (kernel_common
// tri_candidates, _ShadowSweep): left alone, nvcc contracts a * b + c into
// one fused multiply-add, and a ray through the edge two triangles share
// then falls on the other side of it (on a 1,812-triangle dense table,
// 0.3 % of primary rays hit another triangle than the plain version's,
// and up to 0.16 % of shadow rays were blocked otherwise; with every
// operation rounded, none).  __fmul_rn / __fadd_rn are neither fused nor
// split.
__device__ __forceinline__ float dot3_sep(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
}

__device__ __forceinline__ float dot3p_sep(const float* __restrict__ r, V3 b) {
  return dot3_sep(V3{r[0], r[1], r[2]}, b);
}

// An edge test at o + t d: (g.o + h) + t (g.d) >= 0, given og_h = g.o + h
// and gd = g.d (a shadow test's gd is c_g - s (g.p + h), main.rs:218-227).
__device__ __forceinline__ bool edge_in(float og_h, float t, float gd) {
  return __fadd_rn(og_h, __fmul_rn(t, gd)) >= 0.0f;
}

// A shadow test's target terms: x - s y (s is 0 or 1).
__device__ __forceinline__ float minus_s(float x, float s, float y) {
  return __fsub_rn(x, __fmul_rn(s, y));
}

// Lane `lane` of an [n, 3] array, and one torch.bool element.
typedef unsigned char u8;

__device__ __forceinline__ V3 load3(const float* __restrict__ a, int lane) {
  return v3(a[3 * lane], a[3 * lane + 1], a[3 * lane + 2]);
}

__device__ __forceinline__ void store3(float* __restrict__ a, int lane, V3 x) {
  a[3 * lane] = x.x;
  a[3 * lane + 1] = x.y;
  a[3 * lane + 2] = x.z;
}

// The reflected and refracted directions below are rounded as written
// (__fmaf_rn / __fmul_rn, which the compiler neither fuses nor splits):
// left to nvcc, which fuses a multiply and an add wherever it sees fit, the
// same source rounded differently in a cooperative and a per-thread
// instantiation (the surrounding code decides what it shares), and the two
// walks of the level kernel parted by an ulp on a tenth of the lanes.
__device__ __forceinline__ float dot3_rn(V3 a, V3 b) {
  return __fmaf_rn(a.z, b.z, __fmaf_rn(a.y, b.y, __fmul_rn(a.x, b.x)));
}

__device__ __forceinline__ V3 normalize3(V3 a) {
  float inv = rsqrtf(fmaxf(dot3_rn(a, a), 1e-30f));
  return V3{__fmul_rn(a.x, inv), __fmul_rn(a.y, inv), __fmul_rn(a.z, inv)};
}

// base**expo with kernel_common.powf's rule: 0 wherever base <= 0.
__device__ __forceinline__ float kpowf(float base, float expo) {
  return base <= 0.0f ? 0.0f : powf(fmaxf(base, 1e-37f), expo);
}

// Rotation taking +z onto n, applied to v (cgmath Quaternion::from_arc;
// antiparallel fallback v -> (-v.x, v.y, -v.z)).
__device__ __forceinline__ V3 rotate_from_z(V3 n, V3 v) {
  if (n.z < -1.0f + 1e-6f) return V3{-v.x, v.y, -v.z};
  float qw = 1.0f + n.z, qx = -n.y, qy = n.x;
  float q2 = fmaxf(qw * qw + qx * qx + qy * qy, 1e-12f);
  float tx = qy * v.z + qw * v.x;
  float ty = -qx * v.z + qw * v.y;
  float tz = qx * v.y - qy * v.x + qw * v.z;
  float s = 2.0f / q2;
  return V3{v.x + s * (qy * tz), v.y + s * (-(qx * tz)), v.z + s * (qx * ty - qy * tx)};
}

// l - 2 (l.n) n, normalized (main.rs:329).
__device__ __forceinline__ V3 reflect3(V3 d, V3 n) {
  float dn2 = -2.0f * dot3_rn(d, n);  // exact: a power of two
  return normalize3(V3{__fmaf_rn(dn2, n.x, d.x), __fmaf_rn(dn2, n.y, d.y),
                       __fmaf_rn(dn2, n.z, d.z)});
}

// Snell refraction (src/main.rs:344-352); ok=false is total internal
// reflection.
__device__ __forceinline__ V3 refract3(V3 n, V3 d, float k, bool& ok) {
  float cs = -dot3_rn(d, n);
  float sin2 = __fmaf_rn(-cs, cs, 1.0f);
  float kk = __fmul_rn(k, k);
  ok = kk >= sin2;
  float root = sqrtf(fmaxf(1.0f - sin2 / kk, 0.0f));
  return normalize3(V3{__fmaf_rn(-n.x, root, __fmaf_rn(n.x, cs, d.x) / k),
                       __fmaf_rn(-n.y, root, __fmaf_rn(n.y, cs, d.y) / k),
                       __fmaf_rn(-n.z, root, __fmaf_rn(n.z, cs, d.z) / k)});
}

__device__ __forceinline__ bool excl_crit(int excl_face, bool backface) {
  bool is_front = excl_face == FACE_FRONT, is_back = excl_face == FACE_BACK;
  return (is_front && !backface) || (is_back && backface) || (!is_front && !is_back);
}

// Signed-area edge tests of triangle row r at o + t d (main.rs:218-227).
template <class W>
__device__ __forceinline__ bool inside_tri(const float* __restrict__ r, V3 o, V3 d, float t,
                                           W& w) {
  bool inside = true;
  for (int e = 0; e < 3; ++e) {
    const float* g = r + 4 + 3 * e;
    if (inside) w.edge_test();
    inside = inside && edge_in(dot3p_sep(g, o) + r[13 + e], t, dot3p_sep(g, d));
  }
  return inside;
}

// Ray-AABB slab test (kernel_common._slab_rows :978): box b (min 0:3, max
// 3:6), inv = 1/d (+-inf on axis-parallel rays), inclusive against tmax.
// A NaN (0 * inf: a ray in a box face's plane with a zero direction
// component) is a miss, as torch.minimum/maximum propagate it in the plain
// version; fminf/fmaxf alone would drop it.
__device__ __forceinline__ bool slab(const float* __restrict__ b, V3 o, V3 inv, float tmax) {
  float t0x = (b[0] - o.x) * inv.x, t1x = (b[3] - o.x) * inv.x;
  float t0y = (b[1] - o.y) * inv.y, t1y = (b[4] - o.y) * inv.y;
  float t0z = (b[2] - o.z) * inv.z, t1z = (b[5] - o.z) * inv.z;
  if (isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) || isnan(t0z) || isnan(t1z))
    return false;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tn <= fminf(tf, tmax) && tf >= 0.0f;
}

// slab with the min faces measured from origin lo and the max faces from
// hi: with lo = o + w and hi = o - w, the box widened by w (sph_gate;
// kernel_common.slab_from).
__device__ __forceinline__ bool slab_from(const float* __restrict__ b, V3 lo, V3 hi, V3 inv,
                                          float tmax) {
  float t0x = (b[0] - lo.x) * inv.x, t1x = (b[3] - hi.x) * inv.x;
  float t0y = (b[1] - lo.y) * inv.y, t1y = (b[4] - hi.y) * inv.y;
  float t0z = (b[2] - lo.z) * inv.z, t1z = (b[5] - hi.z) * inv.z;
  if (isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) || isnan(t0z) || isnan(t1z))
    return false;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tn <= fminf(tf, tmax) && tf >= 0.0f;
}

__device__ __forceinline__ V3 inv3(V3 d) { return V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z}; }

// ---------------------------------------------------------------------------
// The sphere policies and the sphere chunk table's gate
// ---------------------------------------------------------------------------

// SphLinear: every sphere, in index order (the geometries' own sweeps).
struct SphLinear {
  static constexpr bool GATED = false;
};
// SphGated: the sphere chunk table (scene/blocked.py build_sph_chunks,
// ops/kernel_common.py pack_sph_chunks), which a gated geometry
// (SphGatedGeom, below) carries beside its Tables, and where a counting
// walk writes each lane's box tests.
struct SphGated {
  static constexpr bool GATED = true;
  const float* __restrict__ rows;  // [NCH * SPH_CHUNK, 8] the sphere rows in chunk order
  const float* __restrict__ box;   // [NCH, 8] chunk AABBs (min 0:3, max 3:6)
  const float* __restrict__ sup;   // [ceil(NCH / SPH_SUP), 8] supergroup AABBs
  int n_chunks;                    // NCH
  long long* __restrict__ box_tests;  // [n] or null (W::put_sph_box)
};

// One sphere (centre c, squared radius r2) against the ray o + t d: the
// squared distance of c from the ray, the t of its closest approach and the
// half chord (main.rs:255-281), as every sphere sweep computes them.
struct SphRay {
  float dist2, tc, kk;
};

__device__ __forceinline__ SphRay sph_ray(V3 sc, float r2, V3 o, V3 d) {
  V3 c = v3(sc.x - o.x, sc.y - o.y, sc.z - o.z);
  float qx = c.y * d.z - c.z * d.y, qy = c.z * d.x - c.x * d.z, qz = c.x * d.y - c.y * d.x;
  float dist2 = qx * qx + qy * qy + qz * qz;
  float tc = d.x * c.x + d.y * c.y + d.z * c.z;
  return SphRay{dist2, tc, sqrtf(fmaxf(r2 - dist2, 0.0f))};
}

// What the gate of one ray measures boxes with: its direction's inverse,
// and the origins of the box tests' min and max faces, o moved SPH_PAD
// |o|inf outward past each.  The widening covers the rounding of both the
// f32 sphere test, which accepts a grazing ray up to some tens of units of
// 2^-24 of the ray's distance past the radius, and the f32 box test, off
// by as many units of 2^-24 of its t's: so a ray that the sphere test
// accepts always enters the box, at any distance from the origin.
struct SphGate {
  V3 lo, hi, inv;
};

__device__ __forceinline__ SphGate sph_gate(V3 o, V3 d) {
  float w = SPH_PAD * fmaxf(fmaxf(fabsf(o.x), fabsf(o.y)), fabsf(o.z));
  return SphGate{v3(o.x + w, o.y + w, o.z + w), v3(o.x - w, o.y - w, o.z - w), inv3(d)};
}

// The two gate tiers over the sphere chunk table for one ray: each
// supergroup's box, then each chunk's box of a supergroup it enters, within
// tmax() (read at each box test: a hit found in one chunk prunes the next),
// then row(s, j) for every sphere row s of a chunk it enters, j the
// sphere's original index, until a row returns true.  Adds the box tests
// made to `boxes`.
template <class TMax, class Row>
__device__ __forceinline__ void sph_chunks(const SphGated& sg, V3 o, V3 d, TMax&& tmax,
                                           int& boxes, Row&& row) {
  const SphGate g = sph_gate(o, d);
  for (int c0 = 0; c0 < sg.n_chunks; c0 += SPH_SUP) {
    ++boxes;
    if (!slab_from(sg.sup + (c0 / SPH_SUP) * 8, g.lo, g.hi, g.inv, tmax())) continue;
    int c1 = c0 + SPH_SUP < sg.n_chunks ? c0 + SPH_SUP : sg.n_chunks;
    for (int c = c0; c < c1; ++c) {
      ++boxes;
      if (!slab_from(sg.box + c * 8, g.lo, g.hi, g.inv, tmax())) continue;
      const float4* r = (const float4*)(sg.rows + (size_t)c * SPH_CHUNK * SPH_COLS);
      for (int k = 0; k < SPH_CHUNK; ++k, r += 2) {
        int j = (int)r[1].y;  // column SPH_ID
        if (j < 0) break;     // pad rows trail the last chunk's spheres
        if (row(r[0], j)) return;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The cone policies and the cone test (NFF `c`, kernel_common.cone_roots)
// ---------------------------------------------------------------------------

// A cone row (kernel_common.pack_cones), three float4s: base b and base
// radius r0; unit axis a and slope s = (r1 - r0) / L; axis length L and
// the object.
constexpr int CONE_F4 = 3;

// ConeNone: a geometry without cones.  ConeLinear: every cone in index
// order, and where a counting walk writes each lane's cone tests.
struct ConeNone {
  static constexpr bool ON = false;
};
struct ConeLinear {
  static constexpr bool ON = true;
  const float4* __restrict__ rows;  // [n_cone, CONE_F4]
  int n_cone;
  long long* __restrict__ tests;  // [n] or null (ConeCount::put_cone)
};

// One root of a cone's quadratic: its t, whether the ray meets the
// surface's back there, whether it counts (t > 0, 0 <= h <= L, a
// discriminant that is not negative).
struct ConeRoot {
  float t;
  bool back, kept;
};

// The cone c against the ray o + t d (reference/world.py `_cone`): with w =
// o - b, rho the part of a vector off the axis and r(h) = r0 + s h, the
// roots of alpha t^2 + 2 beta t + gamma = 0 (alpha = |rho_d|^2 - s^2
// (d.a)^2, beta = rho_w.rho_d - s q (d.a), gamma = |rho_w|^2 - q^2, q = r0 +
// s (w.a)), each in the form that does not cancel; a root faces by the sign
// of d.(rho - s r(h) a).  Every operation rounded as written, in
// kernel_common.cone_roots' order, so the plain version gives the same
// roots.
__device__ __forceinline__ void cone_ray(const float4* __restrict__ c, V3 o, V3 d,
                                         ConeRoot root[2]) {
  const float4 c0 = c[0], c1 = c[1];
  const float L = c[2].x;
  const V3 a = v3(c1.x, c1.y, c1.z);
  const float r0 = c0.w, s = c1.w;
  V3 w = v3(__fsub_rn(o.x, c0.x), __fsub_rn(o.y, c0.y), __fsub_rn(o.z, c0.z));
  float wa = dot3_sep(w, a), da = dot3_sep(d, a);
  V3 rw = v3(__fsub_rn(w.x, __fmul_rn(wa, a.x)), __fsub_rn(w.y, __fmul_rn(wa, a.y)),
             __fsub_rn(w.z, __fmul_rn(wa, a.z)));
  V3 rd = v3(__fsub_rn(d.x, __fmul_rn(da, a.x)), __fsub_rn(d.y, __fmul_rn(da, a.y)),
             __fsub_rn(d.z, __fmul_rn(da, a.z)));
  float dd = dot3_sep(rd, rd), wd = dot3_sep(rw, rd);
  float q = __fadd_rn(r0, __fmul_rn(s, wa));
  float alpha = __fsub_rn(dd, __fmul_rn(__fmul_rn(__fmul_rn(s, s), da), da));
  float beta = __fsub_rn(wd, __fmul_rn(__fmul_rn(s, q), da));
  float gamma = __fsub_rn(dot3_sep(rw, rw), __fmul_rn(q, q));
  float disc = __fsub_rn(__fmul_rn(beta, beta), __fmul_rn(alpha, gamma));
  float k = -__fadd_rn(beta, copysignf(__fsqrt_rn(fmaxf(disc, 0.0f)), beta));
  root[0].t = __fdiv_rn(k, alpha);
  root[1].t = __fdiv_rn(gamma, k);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = root[i].t;
    float h = __fadd_rn(wa, __fmul_rn(t, da));
    float rh = __fmul_rn(s, __fadd_rn(r0, __fmul_rn(s, h)));
    root[i].back = __fsub_rn(__fadd_rn(wd, __fmul_rn(t, dd)), __fmul_rn(rh, da)) > 0.0f;
    root[i].kept = disc >= 0.0f && isfinite(t) && t > 0.0f && h >= 0.0f && h <= L;
  }
}

// The outward normal of cone c at p on it: rho - s r(h) a, normalized.
__device__ __forceinline__ V3 cone_normal(const float4* __restrict__ c, V3 p) {
  const float4 c0 = c[0], c1 = c[1];
  const V3 a = v3(c1.x, c1.y, c1.z);
  V3 q = v3(__fsub_rn(p.x, c0.x), __fsub_rn(p.y, c0.y), __fsub_rn(p.z, c0.z));
  float h = dot3_sep(q, a);
  float m = __fadd_rn(h, __fmul_rn(c1.w, __fadd_rn(c0.w, __fmul_rn(c1.w, h))));
  return normalize3(v3(__fsub_rn(q.x, __fmul_rn(m, a.x)), __fsub_rn(q.y, __fmul_rn(m, a.y)),
                       __fsub_rn(q.z, __fmul_rn(m, a.z))));
}

// ---------------------------------------------------------------------------
// Nearest sweep with attributes (World::cast, kernel_common.full_sweep)
// ---------------------------------------------------------------------------

struct Hit {
  bool valid, back;
  int prim, obj;
  float t, u, v;
  V3 p, n;
};

// Spheres after the triangles: update on <=, so a sphere wins an exact tie.
template <class W>
__device__ inline void sph_nearest(const Tables& tb, V3 o, V3 d, int face, int excl_prim,
                                   int excl_face, float& best_t, int& best_i, bool& best_bf,
                                   W& w) {
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
    int prim = tb.n_tri + j;
    if (excl_prim == prim && excl_crit(excl_face, bf)) continue;
    if (!(dist2 <= s[3]) || !(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
    if (t <= best_t) {
      best_t = t;
      best_i = prim;
      best_bf = bf;
    }
  }
  w.sph_tests(tb.n_sph);
}

// The same sweep gated by the sphere chunk table, in chunk order: the least
// t, ties to the larger primitive id (a sphere's is above every
// triangle's), which is the same winner.
template <class W>
__device__ inline void sph_nearest(const Tables& tb, const SphGated& sg, V3 o, V3 d, int face,
                                   int excl_prim, int excl_face, float& best_t, int& best_i,
                                   bool& best_bf, W& w) {
  int tests = 0, boxes = 0;
  sph_chunks(sg, o, d, [&] { return best_t; }, boxes, [&](float4 s, int j) {
    ++tests;
    w.sph_test();
    SphRay r = sph_ray(v3(s.x, s.y, s.z), s.w, o, d);
    bool bf = face == FACE_BACK || (face != FACE_FRONT && r.tc < r.kk);
    float t = bf ? r.tc + r.kk : r.tc - r.kk;
    int prim = tb.n_tri + j;
    if (excl_prim == prim && excl_crit(excl_face, bf)) return false;
    if (!(r.dist2 <= s.w) || !(t > 0.0f) || !isfinite(t) || !(t < BIG)) return false;
    if (t < best_t || (t == best_t && prim > best_i)) {
      best_t = t;
      best_i = prim;
      best_bf = bf;
    }
    return false;
  });
  w.sph_tests(tests);
  w.sph_box_tests(boxes);
}

// o + t d rounded as written, a product and then a sum, as the plain
// versions and the reference round it.  A fused multiply-add gives the
// exact residual instead, whose sign is a coin toss for a point on a plane:
// a floor point on the seam of two coplanar triangles then lay below the
// neighbour's plane on half the seam's pixels, and its shadow rays hit the
// neighbour at t ~ 1e-7 (on an H100, the oracle presets' centre column).
__device__ __forceinline__ V3 ray_at(V3 o, V3 d, float t) {
  return V3{__fadd_rn(o.x, __fmul_rn(t, d.x)), __fadd_rn(o.y, __fmul_rn(t, d.y)),
            __fadd_rn(o.z, __fmul_rn(t, d.z))};
}

// The winner's hit point, shading normal, uv and object.  `row` is the
// winning triangle's packed row (dense or blocked table), or null.
__device__ inline Hit finish_hit(const Tables& tb, const float* __restrict__ row, V3 o, V3 d,
                                 float best_t, int best_i, bool best_bf, bool active) {
  Hit h;
  bool valid = best_t < BIG;
  float t_hit = valid ? best_t : 0.0f;
  h.p = ray_at(o, d, t_hit);
  h.n = v3(0.0f, 0.0f, 0.0f);
  h.u = 0.0f;
  h.v = 0.0f;
  float obj = 0.0f;
  if (best_i >= 0 && best_i < tb.n_tri) {
    const float* r = row;
    float area2 = r[31];
    float inv_a2 = 1.0f / (area2 != 0.0f ? area2 : 1.0f);
    for (int e = 0; e < 3; ++e) {
      float bary = (dot3p(r + 4 + 3 * e, h.p) + r[13 + e]) * inv_a2;
      h.n.x += bary * r[16 + 3 * e];
      h.n.y += bary * r[17 + 3 * e];
      h.n.z += bary * r[18 + 3 * e];
      h.u += bary * r[25 + 2 * e];
      h.v += bary * r[26 + 2 * e];
    }
    if (best_bf) h.n = neg(h.n);
    obj = r[32];
  } else if (best_i >= tb.n_tri) {
    const float* s = tb.sph + (best_i - tb.n_tri) * SPH_COLS;
    V3 sn = normalize3(v3(h.p.x - s[0], h.p.y - s[1], h.p.z - s[2]));
    if (best_bf) sn = neg(sn);
    h.n = sn;
    h.u = acosf(fminf(fmaxf(sn.y, -1.0f), 1.0f)) * INV_PI;
    h.v = atan2f(sn.z, sn.x) * HALF_INV_PI + 0.5f;
    obj = s[4];
  }
  h.valid = valid && active;
  h.t = h.valid ? best_t : BIG;
  h.prim = best_i;
  h.obj = (int)(obj + 0.5f);
  h.back = best_bf && h.valid;
  return h;
}

// Where a dense sweep reads triangle i's hit columns 0:16: the plane (fn,
// d), then inside_tri's vectors g0..g2 and offsets h.  TriRows: a row of
// the [T, 34] table, read float by float; HotRows: a 64-byte hot row
// (kernel_common.Tables.hot: the same 16 columns) as four float4 loads,
// wherever the rows lie (DenseRowsGeom: the block's shared memory).  Both
// give the sweeps below the same numbers, so a walk rounds alike over
// either.
struct Plane {
  V3 fn;
  float d;
};

// inside_tri's vectors from the last three quarters of a hot row: g0 =
// q1.xyz, g1 = (q1.w, q2.x, q2.y), g2 = (q2.z, q2.w, q3.x), h = q3.yzw.
struct HotEdges {
  V3 g[3];
  float h[3];
};

__device__ __forceinline__ HotEdges hot_edges(const float4* __restrict__ r) {
  float4 q1 = r[1], q2 = r[2], q3 = r[3];
  return HotEdges{{v3(q1.x, q1.y, q1.z), v3(q1.w, q2.x, q2.y), v3(q2.z, q2.w, q3.x)},
                  {q3.y, q3.z, q3.w}};
}

struct TriRows {
  const float* __restrict__ p;  // [n_tri, 34]
  __device__ __forceinline__ Plane plane(int i) const {
    const float* r = p + i * TRI_COLS;
    return Plane{v3(r[0], r[1], r[2]), r[3]};
  }
  __device__ __forceinline__ HotEdges edges(int i) const {
    const float* r = p + i * TRI_COLS + 4;
    return HotEdges{{v3(r[0], r[1], r[2]), v3(r[3], r[4], r[5]), v3(r[6], r[7], r[8])},
                    {r[9], r[10], r[11]}};
  }
};

struct HotRows {
  const float4* __restrict__ p;  // [n_tri, 4]
  __device__ __forceinline__ Plane plane(int i) const {
    float4 a = p[HOT_F4 * i];
    return Plane{v3(a.x, a.y, a.z), a.w};
  }
  __device__ __forceinline__ HotEdges edges(int i) const { return hot_edges(p + HOT_F4 * i); }
};

// Triangles in index order: update on <=, so the last of equal t's wins.
// BACK_ONLY: interior rays, backfaces only and no exclusion.
template <bool BACK_ONLY, class R, class W>
__device__ inline void tri_nearest(R rows, int n_tri, V3 o, V3 d, int face, int excl_prim,
                                   int excl_face, float& best_t, int& best_i, bool& best_bf,
                                   W& w) {
  for (int i = 0; i < n_tri; ++i) {
    w.tri_test();
    Plane a = rows.plane(i);
    float no_d = dot3_sep(a.fn, d);
    bool bf = no_d > 0.0f;
    if (BACK_ONLY) {
      if (!bf) continue;  // Back rays only hit backfaces
    } else {
      if ((bf && face == FACE_FRONT) || (!bf && face == FACE_BACK)) continue;  // culled
      if (excl_prim == i && excl_crit(excl_face, bf)) continue;
    }
    w.plane_test();
    float t = (a.d - dot3_sep(a.fn, o)) / no_d;
    if (!(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
    HotEdges eg = rows.edges(i);
    bool inside = true;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      if (inside) w.edge_test();
      inside = inside && edge_in(dot3_sep(eg.g[e], o) + eg.h[e], t, dot3_sep(eg.g[e], d));
    }
    if (inside && t <= best_t) {
      best_t = t;
      best_i = i;
      best_bf = bf;
    }
  }
}

template <class R, class W>
__device__ inline Hit full_sweep(const Tables& tb, R rows, V3 o, V3 d, int face, int excl_prim,
                                 int excl_face, bool active, W& w) {
  float best_t = BIG;
  int best_i = -1;
  bool best_bf = false;
  if (active) {
    tri_nearest<false>(rows, tb.n_tri, o, d, face, excl_prim, excl_face, best_t, best_i,
                       best_bf, w);
    sph_nearest(tb, o, d, face, excl_prim, excl_face, best_t, best_i, best_bf, w);
  }
  const float* row = (best_i >= 0 && best_i < tb.n_tri) ? tb.tri + best_i * TRI_COLS : nullptr;
  return finish_hit(tb, row, o, d, best_t, best_i, best_bf, active);
}

// The same with its spheres gated by the sphere chunk table (SphGatedGeom).
// The gated sweeps are overloads beside the linear ones, not folded into
// them: a shared body (a parameter pack, the interior loop in a helper)
// changed the linear kernels' SASS (PERF.md §6).
template <class R, class W>
__device__ inline Hit full_sweep(const Tables& tb, const SphGated& sg, R rows, V3 o, V3 d,
                                 int face, int excl_prim, int excl_face, bool active, W& w) {
  float best_t = BIG;
  int best_i = -1;
  bool best_bf = false;
  if (active) {
    tri_nearest<false>(rows, tb.n_tri, o, d, face, excl_prim, excl_face, best_t, best_i,
                       best_bf, w);
    sph_nearest(tb, sg, o, d, face, excl_prim, excl_face, best_t, best_i, best_bf, w);
  }
  const float* row = (best_i >= 0 && best_i < tb.n_tri) ? tb.tri + best_i * TRI_COLS : nullptr;
  return finish_hit(tb, row, o, d, best_t, best_i, best_bf, active);
}

// Nearest triangle over the blocked table (blocked_full_sweep :1175 /
// blocked_back_sweep :1562).  BACK_ONLY: interior rays, backfaces only and
// no exclusion.  (t, original id) compared lexicographically: equal t goes
// to the larger id, the dense scan's last-wins rule in any visit order.
struct TriBest {
  float t;
  int id, row;
  bool bf;
};

template <bool BACK_ONLY, class W>
__device__ inline void blocked_tris(const Blk& bk, V3 o, V3 d, int face, int excl_prim,
                                    int excl_face, TriBest& b, W& w) {
  V3 inv = inv3(d);
  for (int c0 = 0; c0 < bk.n_chunks; c0 += SUP_CHUNKS) {
    w.box_test();
    if (!slab(bk.sup + (c0 / SUP_CHUNKS) * 8, o, inv, b.t)) continue;
    int c1 = c0 + SUP_CHUNKS < bk.n_chunks ? c0 + SUP_CHUNKS : bk.n_chunks;
    for (int c = c0; c < c1; ++c) {
      w.box_test();
      if (!slab(bk.box + c * 8, o, inv, b.t)) continue;
      w.chunk();
      const float* r = bk.tri + (size_t)c * BLK_CHUNK * BLK_COLS;
      for (int k = 0; k < BLK_CHUNK; ++k, r += BLK_COLS) {
        int id = (int)r[BLK_ID];
        if (id < 0) break;  // pad rows fill the last chunk's tail
        w.tri_test();
        float no_d = dot3p_sep(r, d);
        bool bf = no_d > 0.0f;
        if (BACK_ONLY) {
          if (!bf) continue;
        } else {
          if ((bf && face == FACE_FRONT) || (!bf && face == FACE_BACK)) continue;
          if (excl_prim == id && excl_crit(excl_face, bf)) continue;
        }
        w.plane_test();
        float t = (r[3] - dot3p_sep(r, o)) / no_d;
        if (!(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
        if (inside_tri(r, o, d, t, w) && (t < b.t || (t == b.t && id > b.id))) {
          b.t = t;
          b.id = id;
          b.row = c * BLK_CHUNK + k;
          b.bf = bf;
        }
      }
    }
  }
}

template <class W>
__device__ inline Hit blocked_full_sweep(const Tables& tb, const Blk& bk, V3 o, V3 d, int face,
                                         int excl_prim, int excl_face, bool active, W& w) {
  TriBest b{BIG, -1, 0, false};
  if (active) {
    blocked_tris<false>(bk, o, d, face, excl_prim, excl_face, b, w);
    sph_nearest(tb, o, d, face, excl_prim, excl_face, b.t, b.id, b.bf, w);
  }
  const float* row =
      (b.id >= 0 && b.id < tb.n_tri) ? bk.tri + (size_t)b.row * BLK_COLS : nullptr;
  return finish_hit(tb, row, o, d, b.t, b.id, b.bf, active);
}

// ---------------------------------------------------------------------------
// Material evaluation with the demo textures (scene/textures.py)
// ---------------------------------------------------------------------------

struct Mat {
  V3 diffuse, specular, tn;
  float shiness, smoothness, transparency, refraction, decay;
};

// `(x as i32) % 2 == 0`: truncation toward zero, low bit.
__device__ __forceinline__ bool parity_even(float x) { return (((int)x) & 1) == 0; }

__device__ inline Mat eval_material(const Tables& tb, int obj, float u, float v) {
  Mat m;
  if (obj < 0 || obj >= tb.n_obj) {  // no such object: an all-zero row
    m.diffuse = m.specular = m.tn = v3(0.0f, 0.0f, 0.0f);
    m.shiness = m.smoothness = m.transparency = m.refraction = m.decay = 0.0f;
    return m;
  }
  const float* r = tb.mat + obj * MAT_COLS;
  m.diffuse = v3(r[0], r[1], r[2]);
  m.shiness = r[3];
  m.specular = v3(r[4], r[5], r[6]);
  m.smoothness = r[7];
  m.transparency = r[8];
  m.refraction = r[9];
  m.decay = r[10];
  m.tn = v3(r[11], r[12], r[13]);
  switch ((int)(r[14] + 0.5f)) {
    case 1: {  // stripes (src/main.rs:848-863)
      float c = parity_even(v * 20.0f) ? 1.0f : 0.5f;
      m.diffuse = v3(c, c, 1.0f);
      float angle = u * 10.0f * 2.0f * PI_F;
      float sx = sinf(angle), cz = cosf(angle);
      float flip = cz <= 0.0f ? -1.0f : 1.0f;
      m.tn = v3(sx * flip, 0.0f, cz * flip);
      break;
    }
    case 2: {  // diagonal checker (src/main.rs:1019-1025)
      bool band = parity_even((u + v) * 10.0f);
      m.diffuse = v3(band ? 1.0f : 0.1f, 0.1f, band ? 0.1f : 1.0f);
      m.tn = v3(0.0f, 0.0f, 1.0f);
      break;
    }
    default:
      break;
  }
  return m;
}

// ---------------------------------------------------------------------------
// Shadow any-hit (kernel_common._ShadowSweep / _BlockedShadowSweep)
// ---------------------------------------------------------------------------

// Dense triangles, factored-target algebra: target `tg` (light origin, s=1,
// scaled t limit 1; or the negated direction, s=0, real limit).
template <class R, class W>
__device__ inline bool tri_occluded(R rows, int n_tri, V3 p, int self_prim, float s, V3 tg,
                                    float tlim, W& w) {
  for (int i = 0; i < n_tri; ++i) {
    if (i == self_prim) continue;
    w.tri_test();
    Plane a = rows.plane(i);
    float o_fn = dot3_sep(a.fn, p);
    float num = a.d - o_fn;
    if (!(num > 0.0f)) continue;
    w.plane_test();
    float no_d = minus_s(dot3_sep(a.fn, tg), s, o_fn);
    if (!(no_d > 0.0f)) continue;
    float t = num / no_d;
    if (!isfinite(t) || !(t < tlim)) continue;
    HotEdges eg = rows.edges(i);
    bool inside = true;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      float ogh = dot3_sep(eg.g[e], p) + eg.h[e];
      float c_g = __fadd_rn(dot3_sep(eg.g[e], tg), __fmul_rn(s, eg.h[e]));
      if (inside) w.edge_test();
      inside = inside && edge_in(ogh, t, minus_s(c_g, s, ogh));
    }
    if (inside) return true;
  }
  return false;
}

// Blocked triangles: the per-lane unnormalized direction dd = tg - s p
// toward the light (blocked_multi :1499-1511), t in the same units below
// tlim, and the same dd and tlim in the slab tests.  Returns at the first
// occluder.  The TPU tests all lights in one pass over a tile's chunks to
// load each chunk once; per lane the answer is the same.
template <class W>
__device__ inline bool blocked_tri_occluded(const Blk& bk, V3 p, int self_prim, float s, V3 tg,
                                            float tlim, W& w) {
  V3 dd = v3(tg.x - s * p.x, tg.y - s * p.y, tg.z - s * p.z);
  V3 inv = inv3(dd);
  for (int c0 = 0; c0 < bk.n_chunks; c0 += SUP_CHUNKS) {
    w.box_test();
    if (!slab(bk.sup + (c0 / SUP_CHUNKS) * 8, p, inv, tlim)) continue;
    int c1 = c0 + SUP_CHUNKS < bk.n_chunks ? c0 + SUP_CHUNKS : bk.n_chunks;
    for (int c = c0; c < c1; ++c) {
      w.box_test();
      if (!slab(bk.box + c * 8, p, inv, tlim)) continue;
      w.chunk();
      const float* r = bk.tri + (size_t)c * BLK_CHUNK * BLK_COLS;
      for (int k = 0; k < BLK_CHUNK; ++k, r += BLK_COLS) {
        int id = (int)r[BLK_ID];
        if (id < 0) break;
        if (id == self_prim) continue;
        w.tri_test();
        float num = r[3] - dot3p_sep(r, p);
        float no_d = dot3p_sep(r, dd);
        float t = num / no_d;
        if (!(no_d > 0.0f) || !(t > 0.0f)) continue;
        w.plane_test();
        bool inside = true;
        for (int e = 0; e < 3; ++e) {
          const float* g = r + 4 + 3 * e;
          float ogh = dot3p_sep(g, p) + r[13 + e];
          if (inside) w.edge_test();
          inside = inside && edge_in(ogh, t, dot3p_sep(g, dd));
        }
        if (inside && isfinite(t) && t < tlim) return true;
      }
    }
  }
  return false;
}

// Spheres: the normalized direction `nd` toward the light and the
// real-unit limit `slim`; shadow rays take the far shell.  The tests made:
// every sphere up to the first occluder, the shading point's own left out.
template <class W>
__device__ inline bool sph_occluded(const Tables& tb, V3 p, int self_prim, V3 nd, float slim,
                                    W& w) {
  const int self_j = self_prim - tb.n_tri;  // in [0, n_sph) on a sphere's own point
  for (int j = 0; j < tb.n_sph; ++j) {
    if (j == self_j) continue;
    w.sph_test();
    const float* sp = tb.sph + j * SPH_COLS;
    V3 c = v3(sp[0] - p.x, sp[1] - p.y, sp[2] - p.z);
    float qx = c.y * nd.z - c.z * nd.y, qy = c.z * nd.x - c.x * nd.z, qz = c.x * nd.y - c.y * nd.x;
    float dist2 = qx * qx + qy * qy + qz * qz;
    float tc = nd.x * c.x + nd.y * c.y + nd.z * c.z;
    float t = tc + sqrtf(fmaxf(sp[3] - dist2, 0.0f));  // far shell
    if (dist2 <= sp[3] && t > 0.0f && isfinite(t) && t < slim) {
      w.sph_tests(j + 1 - (self_j >= 0 && self_j < j));
      return true;
    }
  }
  w.sph_tests(tb.n_sph - (self_j >= 0 && self_j < tb.n_sph));
  return false;
}

// The same sweep gated by the sphere chunk table: every sphere of the
// chunks the ray enters within slim, up to the first occluder.
template <class W>
__device__ inline bool sph_occluded(const Tables& tb, const SphGated& sg, V3 p, int self_prim,
                                    V3 nd, float slim, W& w) {
  const int self_j = self_prim - tb.n_tri;
  int tests = 0, boxes = 0;
  bool hit = false;
  sph_chunks(sg, p, nd, [&] { return slim; }, boxes, [&](float4 sp, int j) {
    if (j == self_j) return false;
    ++tests;
    w.sph_test();
    SphRay r = sph_ray(v3(sp.x, sp.y, sp.z), sp.w, p, nd);
    float t = r.tc + r.kk;  // far shell
    hit = r.dist2 <= sp.w && t > 0.0f && isfinite(t) && t < slim;
    return hit;
  });
  w.sph_tests(tests);
  w.sph_box_tests(boxes);
  return hit;
}

// ---------------------------------------------------------------------------
// Interior back-face sweep (back_sweep_with_normal / blocked_back_sweep)
// ---------------------------------------------------------------------------

struct BackHit {
  float t;  // BIG on a miss
  int prim;
  V3 h, n;  // hit point p + t d, flipped unnormalized interior normal
};

// Spheres' far shells after the triangles, then the hit point and normal.
template <class W>
__device__ inline BackHit finish_back(const Tables& tb, const float* __restrict__ row, V3 p,
                                      V3 d, float best_t, int best_i, W& w) {
  for (int j = 0; j < tb.n_sph; ++j) {
    w.sph_test();
    const float* s = tb.sph + j * SPH_COLS;
    V3 c = v3(s[0] - p.x, s[1] - p.y, s[2] - p.z);
    float qx = c.y * d.z - c.z * d.y, qy = c.z * d.x - c.x * d.z, qz = c.x * d.y - c.y * d.x;
    float dist2 = qx * qx + qy * qy + qz * qz;
    float tc = d.x * c.x + d.y * c.y + d.z * c.z;
    float t = tc + sqrtf(fmaxf(s[3] - dist2, 0.0f));  // far shell (main.rs:273-281)
    if (!(dist2 <= s[3]) || !(t > 0.0f) || !isfinite(t) || !(t < BIG)) continue;
    if (t <= best_t) {
      best_t = t;
      best_i = tb.n_tri + j;
    }
  }
  w.sph_tests(tb.n_sph);
  BackHit b;
  b.t = best_t;
  b.prim = best_i;
  b.h = ray_at(p, d, best_t);
  b.n = v3(0.0f, 0.0f, 0.0f);
  if (best_i >= 0 && best_i < tb.n_tri) {
    const float* r = row;
    float area2 = r[31];
    float inv_a2 = 1.0f / (area2 != 0.0f ? area2 : 1.0f);
    for (int e = 0; e < 3; ++e) {
      float bary = (dot3p(r + 4 + 3 * e, b.h) + r[13 + e]) * inv_a2;
      b.n.x += bary * r[16 + 3 * e];
      b.n.y += bary * r[17 + 3 * e];
      b.n.z += bary * r[18 + 3 * e];
    }
    b.n = neg(b.n);
  } else if (best_i >= tb.n_tri) {
    const float* s = tb.sph + (best_i - tb.n_tri) * SPH_COLS;
    V3 c = v3(b.h.x - s[0], b.h.y - s[1], b.h.z - s[2]);
    float inv = rsqrtf(fmaxf(c.x * c.x + c.y * c.y + c.z * c.z, 1e-30f));
    b.n = v3(-c.x * inv, -c.y * inv, -c.z * inv);
  }
  return b;
}

// Back-face-only nearest sweep + interior normal; no exclusion.
template <class R, class W>
__device__ inline BackHit back_sweep(const Tables& tb, R rows, V3 p, V3 d, W& w) {
  float best_t = BIG;
  int best_i = -1;
  bool bf = false;
  tri_nearest<true>(rows, tb.n_tri, p, d, FACE_BACK, -1, FACE_BACK, best_t, best_i, bf, w);
  const float* row = (best_i >= 0) ? tb.tri + best_i * TRI_COLS : nullptr;
  return finish_back(tb, row, p, d, best_t, best_i, w);
}

// finish_back with its spheres gated by the sphere chunk table (ties to the
// larger primitive id, as the gated sph_nearest), then finish_back's own
// hit point and normal: its loop over no sphere.
template <class W>
__device__ inline BackHit finish_back(const Tables& tb, const SphGated& sg,
                                      const float* __restrict__ row, V3 p, V3 d, float best_t,
                                      int best_i, W& w) {
  int tests = 0, boxes = 0;
  sph_chunks(sg, p, d, [&] { return best_t; }, boxes, [&](float4 s, int j) {
    ++tests;
    w.sph_test();
    SphRay r = sph_ray(v3(s.x, s.y, s.z), s.w, p, d);
    float t = r.tc + r.kk;  // far shell (main.rs:273-281)
    int prim = tb.n_tri + j;
    if (!(r.dist2 <= s.w) || !(t > 0.0f) || !isfinite(t) || !(t < BIG)) return false;
    if (t < best_t || (t == best_t && prim > best_i)) {
      best_t = t;
      best_i = prim;
    }
    return false;
  });
  w.sph_tests(tests);
  w.sph_box_tests(boxes);
  Tables none = tb;
  none.n_sph = 0;
  return finish_back(none, row, p, d, best_t, best_i, w);
}

// back_sweep with its spheres gated by the sphere chunk table.
template <class R, class W>
__device__ inline BackHit back_sweep(const Tables& tb, const SphGated& sg, R rows, V3 p, V3 d,
                                     W& w) {
  float best_t = BIG;
  int best_i = -1;
  bool bf = false;
  tri_nearest<true>(rows, tb.n_tri, p, d, FACE_BACK, -1, FACE_BACK, best_t, best_i, bf, w);
  const float* row = (best_i >= 0) ? tb.tri + best_i * TRI_COLS : nullptr;
  return finish_back(tb, sg, row, p, d, best_t, best_i, w);
}

template <class W>
__device__ inline BackHit blocked_back_sweep(const Tables& tb, const Blk& bk, V3 p, V3 d, W& w) {
  TriBest b{BIG, -1, 0, false};
  blocked_tris<true>(bk, p, d, FACE_BACK, -1, FACE_BACK, b, w);
  const float* row = (b.id >= 0) ? bk.tri + (size_t)b.row * BLK_COLS : nullptr;
  return finish_back(tb, row, p, d, b.t, b.id, w);
}

// ---------------------------------------------------------------------------
// The warp-cooperative walk over the blocked layout (CoopGeom)
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory without a register in between
// (cp.async), and the wait until the calling thread's copies have landed.
__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem) {
#ifdef __CUDACC__
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
#else
  *smem = *gmem;
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// The calling warp's staging buffer in the block's dynamic shared memory:
// a chunk's hot rows, then its ids.
__device__ __forceinline__ float4* warp_stage() {
  extern __shared__ float4 rt_stage[];
  return rt_stage + (threadIdx.x / WARP) * STAGE_F4;
}

// Dynamic shared bytes a cooperative kernel needs per block (host).
inline int coop_shared_bytes(int threads) {
  return threads / WARP * STAGE_F4 * (int)sizeof(float4);
}

// A chunk as the warp has it in shared memory.
struct Staged {
  const float4* __restrict__ rows;  // [nrows, 4]
  const int* __restrict__ ids;      // [nrows]
  int nrows, row0;                  // live rows, the first one's blocked row index
};

// body(j, chunk) for every set bit j of `chunks` (a mask over the supergroup
// that starts at chunk c0, the same in all lanes of the warp), in index
// order, with the live rows and ids of chunk c0 + j copied into the warp's
// shared memory, all lanes copying 16 bytes at a time.
template <class W, class Body>
__device__ __forceinline__ void for_staged_chunks(const Hot& hot, int c0, unsigned chunks, W& w,
                                                  Body&& body) {
  const int wl = threadIdx.x % WARP;
  float4* stage = warp_stage();
  for (; chunks; chunks &= chunks - 1) {
    int j = __ffs(chunks) - 1;
    int c = c0 + j;
    int nrows = hot.live[c];
    const float4* rows = hot.rows + (size_t)c * ROWS_F4;
    const float4* ids = (const float4*)(hot.ids + (size_t)c * BLK_CHUNK);
    int t0 = w.tic();
    __syncwarp();  // no lane still reads the buffer
    for (int i = wl; i < nrows * HOT_F4; i += WARP) cp_async16(stage + i, rows + i);
    for (int i = wl; i < (nrows + 3) / 4; i += WARP) cp_async16(stage + ROWS_F4 + i, ids + i);
    cp_async_wait_all();
    __syncwarp();  // every lane's part has landed
    w.stage_cycles(t0);
    if (wl == 0) w.stage();
    t0 = w.tic();
    body(j, Staged{stage, (const int*)(stage + ROWS_F4), nrows, c * BLK_CHUNK});
    w.row_cycles(t0);
  }
}

__device__ __forceinline__ V3 shfl3(V3 a, int src) {
  return v3(__shfl_sync(FULL, a.x, src), __shfl_sync(FULL, a.y, src), __shfl_sync(FULL, a.z, src));
}

// One staged row (at r, original id `id`, blocked row index `row`) against
// a ray: the body of blocked_tris' row loop.  excl_row: the excluded
// triangle's blocked row (-1: none).  C counts: a Work or a Work::Part.
// (Computing every term whether or not an earlier test failed, so that the
// rows of several steps and rays overlap, measured 17 % slower: most rows
// fail the first test in all 32 lanes.)
template <bool BACK_ONLY, class C>
__device__ __forceinline__ void nearest_row(const float4* __restrict__ r, int id, int row,
                                            int excl_row, V3 o, V3 d, int face, int excl_face,
                                            TriBest& b, C& w) {
  w.tri_test();
  float4 a = r[0];
  V3 fn = v3(a.x, a.y, a.z);
  float no_d = dot3_sep(fn, d);
  bool bf = no_d > 0.0f;
  if (BACK_ONLY) {
    if (!bf) return;
  } else {
    if ((bf && face == FACE_FRONT) || (!bf && face == FACE_BACK)) return;
    if (row == excl_row && excl_crit(excl_face, bf)) return;
  }
  w.plane_test();
  float t = (a.w - dot3_sep(fn, o)) / no_d;
  if (!(t > 0.0f) || !isfinite(t) || !(t < BIG)) return;
  HotEdges eg = hot_edges(r);
  bool inside = true;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    if (inside) w.edge_test();
    inside = inside && edge_in(dot3_sep(eg.g[e], o) + eg.h[e], t, dot3_sep(eg.g[e], d));
  }
  if (inside && (t < b.t || (t == b.t && id > b.id))) {
    b.t = t;
    b.id = id;
    b.row = row;
    b.bf = bf;
  }
}

// A staged chunk against the rays of the lanes `goers` of the warp: the
// warp takes the rays one by one, its lanes test 32 rows at a time (4 steps
// for a chunk, where one thread alone makes 128), and the winner by (t,
// larger id) goes back to the ray's lane.  Every lane of the warp calls it;
// the tests are those of blocked_tris' row loop, run (and counted) by the
// lanes that hold the rows.  (Two or four rays at a time measured the same.)
template <bool BACK_ONLY, class W>
__device__ __forceinline__ void rows_nearest(const Staged& ch, unsigned goers, int excl_row, V3 o,
                                             V3 d, int face, int excl_face, TriBest& b, W& w) {
  const int wl = threadIdx.x % WARP;
  for (unsigned rest = goers; rest; rest &= rest - 1) {
    int src = __ffs(rest) - 1;
    V3 ro = shfl3(o, src), rd = shfl3(d, src);
    int rface = __shfl_sync(FULL, face, src);
    int rexcl = __shfl_sync(FULL, excl_row, src);
    int rexcl_face = __shfl_sync(FULL, excl_face, src);
    TriBest lb{BIG, -1, 0, false};
    for (int k = wl; k < ch.nrows; k += WARP)  // (unrolled, it measured 35 % slower)
      nearest_row<BACK_ONLY>(ch.rows + HOT_F4 * k, ch.ids[k], ch.row0 + k, rexcl, ro, rd, rface,
                             rexcl_face, lb, w);
    // t > 0: its bits order as unsigned; BIG (no hit) is above every hit
    unsigned t_bits = __float_as_uint(lb.t);
    unsigned t_min = __reduce_min_sync(FULL, t_bits);
    int id = __reduce_max_sync(FULL, t_bits == t_min ? lb.id : -1);
    if (id < 0) continue;  // no lane hit a row
    int from = __ffs(__ballot_sync(FULL, t_bits == t_min && lb.id == id)) - 1;
    int row = __shfl_sync(FULL, lb.row, from);
    int bf = __shfl_sync(FULL, (int)lb.bf, from);
    float t = __uint_as_float(t_min);
    if (wl == src && (t < b.t || (t == b.t && id > b.id))) {
      b.t = t;
      b.id = id;
      b.row = row;
      b.bf = bf != 0;
    }
  }
}

// blocked_tris by a whole warp: every lane calls it, with its own ray and
// `want` (false: the lane only helps to copy and to test rows).
template <bool BACK_ONLY, class W>
__device__ inline void coop_tris(const Tables& tb, const Blk& bk, const Hot& hot, V3 o, V3 d,
                                 int face, int excl_prim, int excl_face, bool want, TriBest& b,
                                 W& w) {
  V3 inv = inv3(d);
  int excl_row = -1;
  if (!BACK_ONLY && want && excl_prim >= 0 && excl_prim < tb.n_tri)
    excl_row = hot.row_of_tri[excl_prim];
  for (int c0 = 0; c0 < bk.n_chunks; c0 += SUP_CHUNKS) {
    int t0 = w.tic();
    bool in_sup = false;
    if (want) {
      w.box_test();
      in_sup = slab(bk.sup + (c0 / SUP_CHUNKS) * 8, o, inv, b.t);
    }
    bool any_in = __any_sync(FULL, in_sup);
    w.box_cycles(t0);
    if (!any_in) continue;
    t0 = w.tic();
    int nc = bk.n_chunks - c0 < SUP_CHUNKS ? bk.n_chunks - c0 : SUP_CHUNKS;
    // the lane's chunks of this supergroup, against its best hit so far
    unsigned mine = 0;
    float t_seen = b.t;
    if (in_sup) {
      w.box_tests(nc);  // the per-thread walk tests each chunk's box once
      for (int j = 0; j < nc; ++j)
        if (slab(bk.box + (c0 + j) * 8, o, inv, b.t)) mine |= 1u << j;
    }
    unsigned chunks = __reduce_or_sync(FULL, mine);
    w.box_cycles(t0);
    for_staged_chunks(hot, c0, chunks, w, [&](int j, const Staged& ch) {
      bool go = (mine >> j) & 1;
      // the best hit moved since the masks were taken: test the box again,
      // as the per-thread walk tests it only now
      if (go && b.t != t_seen) go = slab(bk.box + (c0 + j) * 8, o, inv, b.t);
      if (go) w.chunk();
      rows_nearest<BACK_ONLY>(ch, __ballot_sync(FULL, go), excl_row, o, d, face, excl_face, b, w);
    });
  }
}

// One staged row (at r) against the shadow rays `act` (a bit per light of
// the group) of one shading point p, the body of blocked_tri_occluded's row
// loop -> the lights it occludes.  The terms of the origin are shared
// between the lights.  counter(l) counts light l's tests.
template <class Counter>
__device__ __forceinline__ unsigned shadow_row(const float4* __restrict__ r, V3 p,
                                               const V3 (&dd)[LIGHT_GROUP],
                                               const float (&tlim)[LIGHT_GROUP], unsigned act,
                                               Counter&& counter) {
  unsigned hit = 0;
  float4 a = r[0];
  V3 fn = v3(a.x, a.y, a.z);
  float num = a.w - dot3_sep(fn, p);
  HotEdges eg;
  bool have_edges = false;  // read for the first light that gets that far
#pragma unroll
  for (int l = 0; l < LIGHT_GROUP; ++l) {
    if (!((act >> l) & 1)) continue;
    auto& w = counter(l);
    w.tri_test();
    float no_d = dot3_sep(fn, dd[l]);
    float t = num / no_d;
    if (!(no_d > 0.0f) || !(t > 0.0f)) continue;
    w.plane_test();
    if (!have_edges) {
      eg = hot_edges(r);
      have_edges = true;
    }
    bool inside = true;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      float ogh = dot3_sep(eg.g[e], p) + eg.h[e];
      if (inside) w.edge_test();
      inside = inside && edge_in(ogh, t, dot3_sep(eg.g[e], dd[l]));
    }
    if (inside && isfinite(t) && t < tlim[l]) hit |= 1u << l;
  }
  return hit;
}

// A staged chunk against the shadow rays of the lanes `goers` of the warp
// (`act`: the calling lane's own lights in this chunk): the warp takes the
// shading points one by one and its lanes test 32 rows at a time -> the
// calling lane's lights that found an occluder.  A ray stops at its first
// occluder in row order, as alone: tests of rows past it, which the
// per-thread walk does not make, are not counted.  Every lane of the warp
// calls it.
template <class W>
__device__ __forceinline__ unsigned rows_shadow(const Staged& ch, unsigned goers, int self_row,
                                                V3 p, const V3 (&dd)[LIGHT_GROUP],
                                                const float (&tlim)[LIGHT_GROUP], unsigned act,
                                                W& w) {
  const int wl = threadIdx.x % WARP;
  unsigned mine = 0;
  for (unsigned rest = goers; rest; rest &= rest - 1) {
    int src = __ffs(rest) - 1;
    unsigned ract = __shfl_sync(FULL, act, src);
    V3 rp = shfl3(p, src);
    int rself = __shfl_sync(FULL, self_row, src);
    V3 rdd[LIGHT_GROUP];
    float rtlim[LIGHT_GROUP];
#pragma unroll
    for (int l = 0; l < LIGHT_GROUP; ++l) {
      rdd[l] = v3(0.0f, 0.0f, 0.0f);
      rtlim[l] = 0.0f;
      if (!((ract >> l) & 1)) continue;
      rdd[l] = shfl3(dd[l], src);
      rtlim[l] = __shfl_sync(FULL, tlim[l], src);
    }
    unsigned rhit = 0;
    for (int k0 = 0; k0 < ch.nrows && ract; k0 += WARP) {
      int k = k0 + wl;
      typename W::Part parts[LIGHT_GROUP];
      unsigned found = 0;
      if (k < ch.nrows && ch.row0 + k != rself)
        found = shadow_row(ch.rows + HOT_F4 * k, rp, rdd, rtlim, ract,
                           [&](int l) -> typename W::Part& { return parts[l]; });
      unsigned todo = ract;
#pragma unroll
      for (int l = 0; l < LIGHT_GROUP; ++l) {
        if (!((todo >> l) & 1)) continue;
        unsigned occluders = __ballot_sync(FULL, (found >> l) & 1);
        if (!occluders || wl <= __ffs(occluders) - 1) w.add(parts[l]);
        if (occluders) {
          rhit |= 1u << l;
          ract &= ~(1u << l);
        }
      }
    }
    if (wl == src) mine = rhit;
  }
  return mine;
}

// blocked_tri_occluded by a whole warp, for up to LIGHT_GROUP shadow rays
// of each lane's shading point p in ONE pass over the chunks: dd[l] and
// tlim[l] are light l's unnormalized direction and limit, `pending` the
// lights the lane wants tested (0: it only helps) -> the lights that are
// occluded.  A chunk is staged once for all lights of all lanes.
template <class W>
__device__ __forceinline__ unsigned coop_occluded(const Tables& tb, const Blk& bk, const Hot& hot,
                                                  V3 p, int self_prim,
                                                  const V3 (&dd)[LIGHT_GROUP],
                                                  const float (&tlim)[LIGHT_GROUP],
                                                  unsigned pending, W& w) {
  V3 inv[LIGHT_GROUP];
#pragma unroll
  for (int l = 0; l < LIGHT_GROUP; ++l) inv[l] = inv3(dd[l]);
  int self_row = -1;
  if (pending && self_prim >= 0 && self_prim < tb.n_tri) self_row = hot.row_of_tri[self_prim];
  unsigned hit = 0;
  for (int c0 = 0; c0 < bk.n_chunks; c0 += SUP_CHUNKS) {
    int t0 = w.tic();
    unsigned in_sup = 0;
#pragma unroll
    for (int l = 0; l < LIGHT_GROUP; ++l) {
      if (!((pending >> l) & 1)) continue;
      w.box_test();
      if (slab(bk.sup + (c0 / SUP_CHUNKS) * 8, p, inv[l], tlim[l])) in_sup |= 1u << l;
    }
    bool any_in = __any_sync(FULL, in_sup != 0);
    w.box_cycles(t0);
    if (!any_in) continue;
    t0 = w.tic();
    int nc = bk.n_chunks - c0 < SUP_CHUNKS ? bk.n_chunks - c0 : SUP_CHUNKS;
    // bit 8 l + j: light l's ray enters chunk j (a shadow limit does not move)
    unsigned m = 0;
#pragma unroll
    for (int l = 0; l < LIGHT_GROUP; ++l) {
      if (!((in_sup >> l) & 1)) continue;
      for (int j = 0; j < nc; ++j)
        if (slab(bk.box + (c0 + j) * 8, p, inv[l], tlim[l])) m |= 1u << (SUP_CHUNKS * l + j);
    }
    unsigned chunks = __reduce_or_sync(FULL, (m | (m >> 8) | (m >> 16) | (m >> 24)) & 0xffu);
    w.box_cycles(t0);
    for_staged_chunks(hot, c0, chunks, w, [&](int j, const Staged& ch) {
      unsigned act = 0;
#pragma unroll
      for (int l = 0; l < LIGHT_GROUP; ++l)
        if ((m >> (SUP_CHUNKS * l + j)) & (pending >> l) & 1) act |= 1u << l;
      w.chunk(__popc(act));
      unsigned got =
          rows_shadow(ch, __ballot_sync(FULL, act != 0), self_row, p, dd, tlim, act, w);
      // a ray that found its occluder in chunk j had tested j + 1 boxes
      w.box_tests((j + 1) * __popc(got));
      hit |= got;
      pending &= ~got;
    });
    w.box_tests(nc * __popc(in_sup & pending));  // the others tested every chunk's box
  }
  return hit;
}

// ---------------------------------------------------------------------------
// Geometry policies (kernel_common.DenseGeom :1715 / BlockedGeom :1739)
// ---------------------------------------------------------------------------

__device__ __forceinline__ BackHit no_back(V3 p) { return BackHit{BIG, -1, p, v3(0.0f, 0.0f, 0.0f)}; }

// The shadow rays of one shading point p to a group of lights, in both of
// the forms the sweeps take: light l's factored target tg (s = 1: the
// light's origin under the scaled limit 1; s = 0: the negated direction
// under the real limit), and the unnormalized direction dd = tg - s p.
struct ShadowGroup {
  V3 dd[LIGHT_GROUP], tg[LIGHT_GROUP];
  float s[LIGHT_GROUP], tlim[LIGHT_GROUP];
};

// COOP: do all lanes of a warp make every sweep together?  Sph: the policy
// of its sphere sweeps (SphLinear; SphGatedGeom's SphGated).  Cone: that of
// its cone sweeps (ConeNone; ConeGeom's ConeLinear).  any(x): does
// any lane that sweeps with this one hold x?  GROUPED: does a shading point
// test its shadow rays to all lights in one pass (occluded) or light by
// light (tri_occluded)?  stage(): called by every thread of a block before
// any of them leaves (nothing but for a staged DenseRowsGeom, which copies
// its rows to shared memory); smem(threads): the dynamic shared bytes a
// block of `threads` threads needs (host).
struct DenseGeom {
  static constexpr bool COOP = false, GROUPED = false;
  using Sph = SphLinear;
  using Cone = ConeNone;
  __device__ __forceinline__ void stage() const {}
  int smem(int) const { return 0; }
  Tables tb;
  static __device__ __forceinline__ bool any(bool x) { return x; }
  template <class W>
  __device__ Hit nearest(V3 o, V3 d, int face, int excl_prim, int excl_face, bool active,
                         W& w) const {
    int t0 = w.tic();
    Hit h = full_sweep(tb, TriRows{tb.tri}, o, d, face, excl_prim, excl_face, active, w);
    w.near_cycles(t0);
    return h;
  }
  template <class W>
  __device__ bool tri_occluded(V3 p, int self_prim, float s, V3 tg, float tlim, W& w) const {
    return rt::tri_occluded(TriRows{tb.tri}, tb.n_tri, p, self_prim, s, tg, tlim, w);
  }
  template <class W>
  __device__ BackHit back(V3 p, V3 d, bool want, W& w) const {
    if (!want) return no_back(p);
    return back_sweep(tb, TriRows{tb.tri}, p, d, w);
  }
};

struct BlockedGeom {
  static constexpr bool COOP = false, GROUPED = false;
  using Sph = SphLinear;
  using Cone = ConeNone;
  __device__ __forceinline__ void stage() const {}
  int smem(int) const { return 0; }
  Tables tb;  // spheres, materials, lights (tb.tri is not read)
  Blk bk;
  static __device__ __forceinline__ bool any(bool x) { return x; }
  template <class W>
  __device__ Hit nearest(V3 o, V3 d, int face, int excl_prim, int excl_face, bool active,
                         W& w) const {
    int t0 = w.tic();
    Hit h = blocked_full_sweep(tb, bk, o, d, face, excl_prim, excl_face, active, w);
    w.near_cycles(t0);
    return h;
  }
  template <class W>
  __device__ bool tri_occluded(V3 p, int self_prim, float s, V3 tg, float tlim, W& w) const {
    return blocked_tri_occluded(bk, p, self_prim, s, tg, tlim, w);
  }
  template <class W>
  __device__ BackHit back(V3 p, V3 d, bool want, W& w) const {
    if (!want) return no_back(p);
    return blocked_back_sweep(tb, bk, p, d, w);
  }
};

// The blocked layout walked by a warp together.  Every method is called by
// all 32 lanes of the warp; a lane whose flag (active, want, pending) is
// off gets a miss and runs no test.
struct CoopGeom {
  static constexpr bool COOP = true, GROUPED = true;
  using Sph = SphLinear;
  using Cone = ConeNone;
  __device__ __forceinline__ void stage() const {}
  int smem(int threads) const { return coop_shared_bytes(threads); }
  Tables tb;
  Blk bk;
  Hot hot;
  static __device__ __forceinline__ bool any(bool x) { return __any_sync(FULL, x); }
  template <class W>
  __device__ Hit nearest(V3 o, V3 d, int face, int excl_prim, int excl_face, bool active,
                         W& w) const {
    int t0 = w.tic();
    TriBest b{BIG, -1, 0, false};
    coop_tris<false>(tb, bk, hot, o, d, face, excl_prim, excl_face, active, b, w);
    if (active) sph_nearest(tb, o, d, face, excl_prim, excl_face, b.t, b.id, b.bf, w);
    const float* row =
        (b.id >= 0 && b.id < tb.n_tri) ? bk.tri + (size_t)b.row * BLK_COLS : nullptr;
    Hit h = finish_hit(tb, row, o, d, b.t, b.id, b.bf, active);
    w.near_cycles(t0);
    return h;
  }
  template <class W>
  __device__ __forceinline__ unsigned occluded(V3 p, int self_prim, const ShadowGroup& sg,
                                               unsigned pending, W& w) const {
    return coop_occluded(tb, bk, hot, p, self_prim, sg.dd, sg.tlim, pending, w);
  }
  template <class W>
  __device__ BackHit back(V3 p, V3 d, bool want, W& w) const {
    TriBest b{BIG, -1, 0, false};
    coop_tris<true>(tb, bk, hot, p, d, FACE_BACK, -1, FACE_BACK, want, b, w);
    if (!want) return no_back(p);
    const float* row = (b.id >= 0) ? bk.tri + (size_t)b.row * BLK_COLS : nullptr;
    return finish_back(tb, row, p, d, b.t, b.id, w);
  }
};

// ---------------------------------------------------------------------------
// The dense scene out of the block's shared memory (DenseRowsGeom)
// ---------------------------------------------------------------------------

// The whole dense table's hot rows, staged once per block in its shared
// memory (stage: every thread of the block copies its share from global
// memory first) and read there as broadcast float4s by the sweeps of
// DenseGeom: the same rows in the same order, the same early exits, so
// hits, photons, level outputs and the Work totals are DenseGeom's.
// GROUPED: a shading point's shadow rays to all lights make one pass over
// the rows, which ends when every light it tests has found an occluder
// (else one pass per light, as DenseGeom).  A table larger than
// DENSE_SMEM_MAX (fits) is walked by DenseGeom instead.
constexpr int DENSE_SMEM_MAX = 96 * 1024;  // bytes of staged rows a block may take

template <bool GROUP>
struct DenseRowsGeom {
  static constexpr bool COOP = false, GROUPED = GROUP;
  using Sph = SphLinear;
  using Cone = ConeNone;
  Tables tb;  // tb.tri: the winners' whole rows (finish_hit), spheres, materials, lights
  const float4* __restrict__ rows;  // [n_tri, 4] hot rows in global memory
  static __device__ __forceinline__ bool any(bool x) { return x; }
  static int smem_bytes(int n_tri) { return (int)sizeof(float4) * HOT_F4 * n_tri; }
  static bool fits(int n_tri) { return smem_bytes(n_tri) <= DENSE_SMEM_MAX; }
  int smem(int) const { return smem_bytes(tb.n_tri); }
  __device__ __forceinline__ void stage() const {
    extern __shared__ float4 rt_stage[];
    for (int i = threadIdx.x; i < HOT_F4 * tb.n_tri; i += blockDim.x) rt_stage[i] = rows[i];
    __syncthreads();
  }
  __device__ __forceinline__ HotRows staged() const {
    extern __shared__ float4 rt_stage[];
    return HotRows{rt_stage};
  }
  template <class W>
  __device__ Hit nearest(V3 o, V3 d, int face, int excl_prim, int excl_face, bool active,
                         W& w) const {
    int t0 = w.tic();
    Hit h = full_sweep(tb, staged(), o, d, face, excl_prim, excl_face, active, w);
    w.near_cycles(t0);
    return h;
  }
  template <class W>
  __device__ bool tri_occluded(V3 p, int self_prim, float s, V3 tg, float tlim, W& w) const {
    return rt::tri_occluded(staged(), tb.n_tri, p, self_prim, s, tg, tlim, w);
  }
  // tri_occluded for the lights `pending` of one group, in one pass: the
  // terms of the origin are shared, each light's are its own, and a light
  // leaves the pass at its first occluder (its tests counted up to there)
  // -> the lights occluded by a triangle.
  template <class W>
  __device__ unsigned occluded(V3 p, int self_prim, const ShadowGroup& sg, unsigned pending,
                               W& w) const {
    const HotRows rs = staged();
    unsigned hit = 0;
    for (int i = 0; i < tb.n_tri && pending; ++i) {
      if (i == self_prim) continue;
      Plane a = rs.plane(i);
      float o_fn = dot3_sep(a.fn, p);
      float num = a.d - o_fn;
#pragma unroll
      for (int l = 0; l < LIGHT_GROUP; ++l)
        if ((pending >> l) & 1) w.tri_test();
      if (!(num > 0.0f)) continue;
      HotEdges eg = rs.edges(i);
      float ogh[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) ogh[e] = dot3_sep(eg.g[e], p) + eg.h[e];
#pragma unroll
      for (int l = 0; l < LIGHT_GROUP; ++l) {
        if (!((pending >> l) & 1)) continue;
        w.plane_test();
        const float s = sg.s[l];
        float no_d = minus_s(dot3_sep(a.fn, sg.tg[l]), s, o_fn);
        if (!(no_d > 0.0f)) continue;
        float t = num / no_d;
        if (!isfinite(t) || !(t < sg.tlim[l])) continue;
        bool inside = true;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          float c_g = __fadd_rn(dot3_sep(eg.g[e], sg.tg[l]), __fmul_rn(s, eg.h[e]));
          if (inside) w.edge_test();
          inside = inside && edge_in(ogh[e], t, minus_s(c_g, s, ogh[e]));
        }
        if (inside) hit |= 1u << l;
      }
      pending &= ~hit;
    }
    return hit;
  }
  template <class W>
  __device__ BackHit back(V3 p, V3 d, bool want, W& w) const {
    if (!want) return no_back(p);
    return back_sweep(tb, staged(), p, d, w);
  }
};

// The level kernel's and the MC kernel's dense walks (PERF.md: the grouped
// shadow pass takes registers that the MC kernel, which fills the card,
// pays for in blocks per SM)
constexpr bool DENSE_LEVEL_GROUPED = true, DENSE_MC_GROUPED = false;

// The triangle rows a dense geometry's sweeps read: its hot rows staged in
// the block's shared memory, or the [T, 34] table in global memory.
__device__ __forceinline__ TriRows dense_rows(const DenseGeom& g) { return TriRows{g.tb.tri}; }
template <bool GROUP>
__device__ __forceinline__ HotRows dense_rows(const DenseRowsGeom<GROUP>& g) {
  return g.staged();
}

// Dense geometry G (DenseGeom, DenseRowsGeom) with its sphere sweeps gated
// by the sphere chunk table `sph`, which it carries after G's members: its
// nearest and interior sweeps are G's but for the spheres, and get_shade's
// shadow sweeps take the gate through Sph (sph_occluded_in).
template <class G>
struct SphGatedGeom : G {
  using Sph = SphGated;
  SphGated sph;
  template <class W>
  __device__ Hit nearest(V3 o, V3 d, int face, int excl_prim, int excl_face, bool active,
                         W& w) const {
    int t0 = w.tic();
    Hit h = full_sweep(this->tb, sph, dense_rows(*this), o, d, face, excl_prim, excl_face,
                       active, w);
    w.near_cycles(t0);
    return h;
  }
  template <class W>
  __device__ BackHit back(V3 p, V3 d, bool want, W& w) const {
    if (!want) return no_back(p);
    return back_sweep(this->tb, sph, dense_rows(*this), p, d, w);
  }
};

using DenseGeomGated = SphGatedGeom<DenseGeom>;

// ---------------------------------------------------------------------------
// The cone sweeps (ConeLinear) and the geometry that carries them (ConeGeom)
// ---------------------------------------------------------------------------

// Cones after the spheres, in index order: update on <=, so a cone wins an
// exact tie.  A cone's candidate is its nearer root on a face that `face`
// takes and that the exclusion leaves (the exclusion drops a root, not the
// cone), the first where both lie at one t.
template <class W>
__device__ inline void cone_nearest(const Tables& tb, const ConeLinear& cn, V3 o, V3 d, int face,
                                    int excl_prim, int excl_face, float& best_t, int& best_i,
                                    bool& best_bf, W& w) {
  const int first = tb.n_tri + tb.n_sph;
  for (int j = 0; j < cn.n_cone; ++j) {
    ConeRoot r[2];
    cone_ray(cn.rows + CONE_F4 * j, o, d, r);
    const int prim = first + j;
    float t = BIG;
    bool bf = false;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!r[i].kept || !excl_crit(face, r[i].back)) continue;
      if (excl_prim == prim && excl_crit(excl_face, r[i].back)) continue;
      if (r[i].t < t) {
        t = r[i].t;
        bf = r[i].back;
      }
    }
    if (t < BIG && t <= best_t) {
      best_t = t;
      best_i = prim;
      best_bf = bf;
    }
  }
  w.cone_tests(cn.n_cone);
}

// A shadow ray's cones: the normalized direction `nd`, the real-unit limit
// `slim`, back faces only; the shading point's own cone drops every back
// root (the exclusion), so it is left out.  The tests made: every cone up
// to the first occluder.
template <class W>
__device__ inline bool cone_occluded(const Tables& tb, const ConeLinear& cn, V3 p, int self_prim,
                                     V3 nd, float slim, W& w) {
  const int self_j = self_prim - tb.n_tri - tb.n_sph;  // in [0, n_cone) on a cone's own point
  for (int j = 0; j < cn.n_cone; ++j) {
    if (j == self_j) continue;
    ConeRoot r[2];
    cone_ray(cn.rows + CONE_F4 * j, p, nd, r);
    if ((r[0].kept && r[0].back && r[0].t < slim) || (r[1].kept && r[1].back && r[1].t < slim)) {
      w.cone_tests(j + 1 - (self_j >= 0 && self_j < j));
      return true;
    }
  }
  w.cone_tests(cn.n_cone - (self_j >= 0 && self_j < cn.n_cone));
  return false;
}

// An interior ray's cones after the spheres: back faces only, no exclusion.
template <class W>
__device__ inline void cone_back(const Tables& tb, const ConeLinear& cn, V3 p, V3 d,
                                 float& best_t, int& best_i, W& w) {
  for (int j = 0; j < cn.n_cone; ++j) {
    ConeRoot r[2];
    cone_ray(cn.rows + CONE_F4 * j, p, d, r);
    float t = BIG;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r[i].kept && r[i].back && r[i].t < t) t = r[i].t;
    if (t < BIG && t <= best_t) {
      best_t = t;
      best_i = tb.n_tri + tb.n_sph + j;
    }
  }
  w.cone_tests(cn.n_cone);
}

// finish_hit where the winner may be a cone: its outward normal, flipped on
// a back face; uv (0, 0) (a cone's object takes no texture).
__device__ inline Hit finish_hit(const Tables& tb, const ConeLinear& cn,
                                 const float* __restrict__ row, V3 o, V3 d, float best_t,
                                 int best_i, bool best_bf, bool active) {
  const int j = best_i - tb.n_tri - tb.n_sph;
  if (j < 0) return finish_hit(tb, row, o, d, best_t, best_i, best_bf, active);
  const float4* c = cn.rows + CONE_F4 * j;
  Hit h;
  h.p = ray_at(o, d, best_t);
  V3 n = cone_normal(c, h.p);
  h.n = best_bf ? neg(n) : n;
  h.u = 0.0f;
  h.v = 0.0f;
  h.valid = active;
  h.t = active ? best_t : BIG;
  h.prim = best_i;
  h.obj = (int)(c[2].y + 0.5f);
  h.back = best_bf && active;
  return h;
}

// Dense geometry G (DenseRowsGeom, or SphGatedGeom over it) with the cone
// table `cone` after G's members: its nearest sweep is G's triangles and
// spheres, then the cones, then the winner's attributes; its interior sweep
// G's, then the cones; get_shade's shadow sweeps take the cones after the
// spheres (sph_occluded_in).
template <class G>
struct ConeGeom : G {
  using Cone = ConeLinear;
  ConeLinear cone;
  template <class W>
  __device__ Hit nearest(V3 o, V3 d, int face, int excl_prim, int excl_face, bool active,
                         W& w) const {
    const Tables& tb = this->tb;
    int t0 = w.tic();
    float best_t = BIG;
    int best_i = -1;
    bool best_bf = false;
    if (active) {
      tri_nearest<false>(dense_rows(*this), tb.n_tri, o, d, face, excl_prim, excl_face, best_t,
                         best_i, best_bf, w);
      if constexpr (G::Sph::GATED)
        sph_nearest(tb, this->sph, o, d, face, excl_prim, excl_face, best_t, best_i, best_bf, w);
      else
        sph_nearest(tb, o, d, face, excl_prim, excl_face, best_t, best_i, best_bf, w);
      cone_nearest(tb, cone, o, d, face, excl_prim, excl_face, best_t, best_i, best_bf, w);
    }
    const float* row = (best_i >= 0 && best_i < tb.n_tri) ? tb.tri + best_i * TRI_COLS : nullptr;
    Hit h = finish_hit(tb, cone, row, o, d, best_t, best_i, best_bf, active);
    w.near_cycles(t0);
    return h;
  }
  template <class W>
  __device__ BackHit back(V3 p, V3 d, bool want, W& w) const {
    if (!want) return no_back(p);
    BackHit b = this->G::back(p, d, want, w);
    float t = b.t;
    int i = b.prim;
    cone_back(this->tb, cone, p, d, t, i, w);
    if (i != b.prim) {  // a cone's inside: its outward normal, flipped
      b.t = t;
      b.prim = i;
      b.h = ray_at(p, d, t);
      b.n = neg(cone_normal(cone.rows + CONE_F4 * (i - this->tb.n_tri - this->tb.n_sph), b.h));
    }
    return b;
  }
};

// ---------------------------------------------------------------------------
// The lanes that have work (the unfused path's standalone kernels)
// ---------------------------------------------------------------------------

// The unfused path hands its standalone kernels every lane of a batch of
// which few may have work (the lanes still alive; the lanes that refract;
// the lanes with a light to test), and a warp runs as long as its longest
// lane.  So a first launch lists the lanes with work, the kernel's first
// threads take them, 32 to a warp, and every other thread writes its own
// lane's empty result (coalesced) and leaves, whole blocks at once.
// list_lanes: list[0 : list[n]] <- every lane t < n with a nonzero flag in
// one of the `rows` rows of flags [rows, n].  Each warp ballots its 32
// lanes, the block adds up its warps' counts in shared memory, and its
// first thread reserves the block's room with ONE atomicAdd on the count
// list[n] (the adds on that one address are what a listing of a million
// lanes waits on, so a block of LIST_THREADS takes one); each set lane
// writes its index.  A block's lanes keep their order, blocks land in the
// order they arrive, and no lane's result depends on where it is listed.
// (A template in an unnamed namespace: the translation units that list no
// lanes compile none of it.)
constexpr int LIST_THREADS = 512;

namespace {
template <class Flag>
__global__ void __launch_bounds__(LIST_THREADS)
list_lanes(const Flag* __restrict__ flags, int rows, int n, int* __restrict__ list) {
  __shared__ int warp_at[LIST_THREADS / WARP];  // a warp's count, then its offset
  __shared__ int block_at;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  bool set = false;
  if (t < n)
    for (int r = 0; r < rows; ++r) set = set || flags[(size_t)r * n + t] != 0;
  const unsigned m = __ballot_sync(FULL, set);
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  if (lane == 0) warp_at[warp] = __popc(m);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < LIST_THREADS / WARP; ++i) {
      const int c = warp_at[i];
      warp_at[i] = total;
      total += c;
    }
    block_at = total ? atomicAdd(list + n, total) : 0;
  }
  __syncthreads();
  if (set) list[block_at + warp_at[warp] + __popc(m & ((1u << lane) - 1u))] = t;
}

// (host) The count to 0, then list the lanes, on `stream` -> CUDA error.
template <class Flag>
int launch_list_lanes(const Flag* flags, int rows, int n, int* list, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(list + n, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  list_lanes<Flag><<<(n + LIST_THREADS - 1) / LIST_THREADS, LIST_THREADS, 0, stream>>>(
      flags, rows, n, list);
  return (int)cudaGetLastError();
}
}  // namespace

// ---------------------------------------------------------------------------
// Direct shading (kernel_common.get_shade)
// ---------------------------------------------------------------------------

// One light seen from the shading point p with the adjusted normal na
// (approximate_into_directional, lights.rs:44-93).
struct LightTerm {
  bool consider, is_dir;  // consider: p in the cone and turned to the light
  float att, cosine, limit;  // attenuation, -ld.na, the shadow ray's limit
  V3 ld;                     // the light's direction at p
};

__device__ __forceinline__ LightTerm light_term(const float* __restrict__ L, V3 p, V3 na) {
  LightTerm t;
  t.is_dir = L[0] == 0.0f;
  bool is_spot = L[0] == 1.0f;
  V3 lo = v3(L[1], L[2], L[3]), ldir = v3(L[4], L[5], L[6]);
  V3 off = v3(p.x - lo.x, p.y - lo.y, p.z - lo.z);
  float mag = sqrtf(off.x * off.x + off.y * off.y + off.z * off.z);
  float inv_mag = 1.0f / fmaxf(mag, 1e-30f);
  float cos_ang = dot3(ldir, off) * inv_mag;
  float angle = fabsf(acosf(fminf(fmaxf(cos_ang, -1.0f), 1.0f)));
  bool in_cone = angle <= L[10];
  float ang_att = kpowf(fmaxf(1.0f - angle / fmaxf(L[10], 1e-30f), 0.0f), L[11] + F32_EPS);
  float dist_att = 1.0f / (mag + F32_EPS);
  t.att = t.is_dir ? 1.0f : (is_spot ? ang_att * dist_att : dist_att);
  t.ld = t.is_dir ? ldir : v3(off.x * inv_mag, off.y * inv_mag, off.z * inv_mag);
  t.cosine = -(t.ld.x * na.x + t.ld.y * na.y + t.ld.z * na.z);
  t.consider = (!is_spot || in_cone) && t.cosine > 0.0f;
  t.limit = L[12] > 0.5f ? mag : BIG;
  return t;
}

// The shadow ray's triangle test in the factored-target form: position
// lights aim at the light's origin (s = 1) under the scaled limit 1
// (= |L - p| / |L - p|), directional ones along -dir (s = 0) under the
// real limit.
__device__ __forceinline__ float shadow_s(const LightTerm& t) { return t.is_dir ? 0.0f : 1.0f; }
__device__ __forceinline__ V3 shadow_target(const float* __restrict__ L, const LightTerm& t) {
  return t.is_dir ? v3(-L[4], -L[5], -L[6]) : v3(L[1], L[2], L[3]);
}
__device__ __forceinline__ float shadow_tlim(const LightTerm& t) {
  return t.is_dir ? t.limit : 1.0f;
}

// get_diffuse / get_specular of an unoccluded light (materials.rs:46-66).
__device__ __forceinline__ void phong_add(V3& out, const Mat& m, const float* __restrict__ L,
                                          const LightTerm& t, V3 na, V3 vd, float e,
                                          float energy) {
  float lam = t.cosine;
  V3 ld = t.ld;
  V3 ref = v3(2.0f * lam * na.x + ld.x, 2.0f * lam * na.y + ld.y, 2.0f * lam * na.z + ld.z);
  float amount = kpowf(fmaxf(ref.x * vd.x + ref.y * vd.y + ref.z * vd.z, 0.0f), e) * energy;
  float dterm = lam * (1.0f - m.shiness);
  float sterm = amount * m.shiness;
  out.x += (m.diffuse.x * dterm + m.specular.x * sterm) * L[7] * t.att;
  out.y += (m.diffuse.y * dterm + m.specular.y * sterm) * L[8] * t.att;
  out.z += (m.diffuse.z * dterm + m.specular.z * sterm) * L[9] * t.att;
}

// The shadow sweep over the spheres in geometry G: gated by its sphere
// chunk table where G carries one (SphGatedGeom).
template <class G, class W>
__device__ __forceinline__ bool sph_occluded_in(const G& g, const Tables& tb, V3 p,
                                                int self_prim, V3 nd, float slim, W& w) {
  if constexpr (G::Sph::GATED)
    return sph_occluded(tb, g.sph, p, self_prim, nd, slim, w);
  else
    return sph_occluded(tb, p, self_prim, nd, slim, w);
}

// The same in a geometry with cones: the spheres, then the cones where no
// sphere occludes.
template <class G, class W>
__device__ __forceinline__ bool sph_occluded_in(const ConeGeom<G>& g, const Tables& tb, V3 p,
                                                int self_prim, V3 nd, float slim, W& w) {
  return sph_occluded_in(static_cast<const G&>(g), tb, p, self_prim, nd, slim, w) ||
         cone_occluded(tb, g.cone, p, self_prim, nd, slim, w);
}

// Direct radiance at p (get_shade): na = bump-ADJUSTED normal, vd = view
// (-ray direction).  Adds the shadow rays cast to `count`.  A geometry that
// is not GROUPED sweeps once per light; a GROUPED one takes the lights in
// groups of LIGHT_GROUP: each lane prepares its shadow rays, one pass over
// the rows (for a cooperative geometry: the warp's pass over the chunks)
// tests all of them, then the unoccluded lights' terms add up in the
// lights' order.
template <class G, class W>
__device__ inline V3 get_shade(const G& g, const Mat& m, V3 p, V3 na, V3 vd, bool active,
                               int self_prim, int& count, W& w) {
  const Tables& tb = g.tb;
  V3 out = v3(0.0f, 0.0f, 0.0f);
  if constexpr (!G::COOP) {
    if (!active) return out;
  }
  float e = 1.0f / (m.smoothness + F32_EPS);
  float energy = (e + 8.0f) / EIGHT_PI;
  if constexpr (G::GROUPED) {
    for (int base = 0; base < tb.n_light; base += LIGHT_GROUP) {
      unsigned pending = 0;
      ShadowGroup sg;
#pragma unroll
      for (int l = 0; l < LIGHT_GROUP; ++l) {
        sg.dd[l] = sg.tg[l] = v3(0.0f, 0.0f, 0.0f);
        sg.s[l] = sg.tlim[l] = 0.0f;
        if (!active || base + l >= tb.n_light) continue;
        const float* L = tb.lights + (base + l) * LIGHT_COLS;
        LightTerm t = light_term(L, p, na);
        if (!t.consider) continue;
        ++count;
        pending |= 1u << l;
        float s = shadow_s(t);
        V3 tg = shadow_target(L, t);
        sg.s[l] = s;
        sg.tg[l] = tg;
        sg.dd[l] = v3(tg.x - s * p.x, tg.y - s * p.y, tg.z - s * p.z);
        sg.tlim[l] = shadow_tlim(t);
      }
      int t0 = w.tic();
      unsigned lit = pending;
      if (G::COOP || pending) lit &= ~g.occluded(p, self_prim, sg, pending, w);
      w.shadow_cycles(t0);
#pragma unroll
      for (int l = 0; l < LIGHT_GROUP; ++l) {
        if (!((lit >> l) & 1)) continue;
        const float* L = tb.lights + (base + l) * LIGHT_COLS;
        LightTerm t = light_term(L, p, na);
        t0 = w.tic();
        bool behind_sphere = sph_occluded_in(g, tb, p, self_prim, neg(t.ld), t.limit, w);
        w.shadow_cycles(t0);
        if (behind_sphere) continue;
        phong_add(out, m, L, t, na, vd, e, energy);
      }
    }
  } else {
    for (int li = 0; li < tb.n_light; ++li) {
      const float* L = tb.lights + li * LIGHT_COLS;
      LightTerm t = light_term(L, p, na);
      if (!t.consider) continue;
      ++count;
      int t0 = w.tic();
      bool occluded =
          g.tri_occluded(p, self_prim, shadow_s(t), shadow_target(L, t), shadow_tlim(t), w) ||
          sph_occluded_in(g, tb, p, self_prim, neg(t.ld), t.limit, w);
      w.shadow_cycles(t0);
      if (occluded) continue;
      phong_add(out, m, L, t, na, vd, e, energy);
    }
  }
  return out;
}

// Shade a hit with its material: bump-adjust the normal, view = -ray.
template <class G, class W>
__device__ __forceinline__ V3 shade_at(const G& g, const Mat& m, V3 p, V3 n, V3 ray_d,
                                       bool active, int self_prim, int& count, W& w) {
  return get_shade(g, m, p, rotate_from_z(n, m.tn), neg(ray_d), active, self_prim, count, w);
}

// ---------------------------------------------------------------------------
// Interior march (get_refract, kernel_common.march_rows)
// ---------------------------------------------------------------------------

struct March {
  bool escaped;
  float travel;
  V3 e, od;  // escape origin and direction
  int prim;  // primitive to exclude (on its BACK face) from the exit ray
  int iters;  // casts, incl. the entry cast
};

// The whole get_refract march (src/main.rs:343-405): entry refraction, the
// interior reflective bounce loop (retries and distance budget), exit
// refraction.  Misses inside the dielectric and trapped rays do not escape.
// One thread leaves as soon as it has nothing to march; under a cooperative
// geometry every lane stays while any lane of its warp marches, and passes
// its own flag down to the sweeps.
template <class G, class W>
__device__ inline March march(const G& g, V3 p, V3 n0, V3 d0, float k, bool want,
                              float max_distance, int max_retries, W& w) {
  March mm;
  mm.escaped = false;
  mm.travel = 0.0f;
  mm.e = p;
  mm.od = d0;
  mm.prim = -1;
  mm.iters = 0;
  if constexpr (!G::COOP) {
    if (!want) return mm;
  }
  const int t0 = w.tic();
  bool ok_in;
  V3 r = refract3(n0, d0, k, ok_in);
  bool go = want && ok_in;  // TIR at entry -> Trapped (main.rs:354-358)
  if constexpr (!G::COOP) {
    if (!go) {
      w.march_cycles(t0);
      return mm;
    }
  }
  mm.iters = go ? 1 : 0;
  float inv_k = 1.0f / k;
  BackHit b = g.back(p, r, go, w);
  bool alive = go && b.t < BIG;  // miss -> Infinite
  bool has_out;
  V3 out = refract3(b.n, r, inv_k, has_out);
  has_out = alive && has_out;
  V3 c = b.h, n = b.n, d = r;
  int prim = b.prim;
  float travel = alive ? b.t : 0.0f;
  int retry = 0;
  for (;;) {
    bool run = alive && !has_out && travel <= max_distance && retry < max_retries;
    if (!G::any(run)) break;
    V3 f = reflect3(d, n);  // get_reflect on the interior hit (main.rs:380)
    BackHit b2 = g.back(c, f, run, w);
    if (!run) continue;
    ++retry;
    ++mm.iters;
    if (!(b2.t < BIG)) {
      alive = false;
      continue;
    }
    bool ok2;
    V3 out2 = refract3(b2.n, f, inv_k, ok2);
    c = b2.h;
    n = b2.n;
    d = f;
    out = out2;
    prim = b2.prim;
    travel = travel + b2.t;
    has_out = ok2;
  }
  if (go) {
    mm.escaped = alive && has_out;
    mm.travel = travel;
    mm.e = c;
    mm.od = out;
    mm.prim = prim;
  }
  w.march_cycles(t0);
  return mm;
}

// Compiled attributes of kernel `fn` (host): out = {registers per thread,
// local (spill + stack) bytes per thread, static shared bytes, max threads
// per block, the dynamic shared bytes `dynamic` its launches ask for, the
// blocks of `threads` threads that one SM holds at once with them}.
inline int attrs_of(const void* fn, int* out, int dynamic = 0, int threads = 128) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = dynamic;
  if (dynamic > 48 * 1024) {  // the occupancy query also wants the opt-in
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 5, fn, threads, dynamic);
}

// Launch set-up of a cooperative kernel (host): opt in to its dynamic
// shared memory (above 48 KB a launch is refused without) -> CUDA error.
inline int coop_opt_in(const void* fn, int shared_bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   shared_bytes);
}

}  // namespace rt
