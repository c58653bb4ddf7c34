// Monte-Carlo whole-walk kernel: one stochastic sample per primary ray.
//
// Replaces the TPU kernel raytracer_tpu/ops/mc_pallas.py:474 `_mc_kernel`
// (wrapper `trace` :541; `mc_step` :58, `mc_terminal` :449), both of its
// branches: one instantiation per geometry policy (common.cuh DenseGeom;
// BlockedGeom for the large-mesh blocked layout, mc_pallas.py:485-487).
// Plain version: raytracer_tpu_torch/ops/mc_kernel.py `trace_plain`.
//
// One thread per ray walks the whole path: the primary cast, `depth`
// roulette bounces (roulette, scatter lobe, interior TIR march, advance
// cast, merged next-hit shade with shadow sweeps, the accum += scale*A;
// scale *= B recurrence), then the depth-exhausted terminal shade.
//
// What bounds it on an H100: neither DRAM bytes (each ray reads 12 + 12 *
// depth bytes of rays and draws and writes 16) nor FLOP peak, but issue
// throughput over long, divergent, data-dependent loops — every bounce
// runs up to ~15 sweeps (advance cast, 3 lights' shadow rays, up to 11
// march casts): all 64 triangles and 4 spheres on the dense demo scene,
// the entered chunks on a blocked mesh — and lanes of a warp take
// different roulette branches, march lengths and chunks.  The design keeps
// it simple and correct first: 128 threads per block, the scene tables
// read from global memory through const __restrict__ pointers, the depth
// loop a runtime loop (not unrolled) to hold register pressure down,
// any-hit shadow loops that stop at the first occluder, and per-lane cast
// counts summed by the wrapper.  Staging tables or chunks in shared memory
// and regrouping lanes by branch are later work.  W is the test counter
// (common.cuh): NoWork on the main path, Work when the caller asks for
// the per-lane test counts.
#include "mc_walk.cuh"

namespace rt {

template <class G, class W>
__global__ void __launch_bounds__(128)
mc_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
          const float* __restrict__ unifs, G g, float* __restrict__ photon,
          int* __restrict__ casts_out, int* __restrict__ work_out, int n, int depth,
          float max_distance, int max_retries) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Tables& tb = g.tb;
  W w{};
  V3 o0 = v3(ray_o[lane], ray_o[n + lane], ray_o[2 * n + lane]);
  V3 d0 = v3(ray_d[lane], ray_d[n + lane], ray_d[2 * n + lane]);

  // primary cast (main.rs:1150)
  Hit h = g.nearest(o0, d0, FACE_FRONT, -1, FACE_FRONT, true, w);
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
  photon[lane] = acc.x + (alive ? scale.x * sh.x : 0.0f);
  photon[n + lane] = acc.y + (alive ? scale.y * sh.y : 0.0f);
  photon[2 * n + lane] = acc.z + (alive ? scale.z * sh.z : 0.0f);
  casts_out[lane] = casts;
  w.put(work_out, n, lane);
}

template <class G>
int launch_mc(const float* ray_o, const float* ray_d, const float* unifs, G g, float* photon,
              int* casts, int* work, int n, int depth, float max_distance, int max_retries,
              void* stream) {
  int blocks = (n + 127) / 128;
  auto kernel = work ? &mc_kernel<G, Work> : &mc_kernel<G, NoWork>;
  kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(ray_o, ray_d, unifs, g, photon, casts, work, n,
                                                  depth, max_distance, max_retries);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" {

// ray_o, ray_d: [3, n]; unifs: [depth, 3, n]; photon: [3, n]; casts: [n];
// work: [WORK_ROWS, n] or null (null runs the instantiation that counts
// nothing).
int rt_mc_trace(const float* ray_o, const float* ray_d, const float* unifs, const float* tri,
                int n_tri, const float* sph, int n_sph, const float* mat, int n_obj,
                const float* lights, int n_light, float* photon, int* casts, int* work, int n,
                int depth, float max_distance, int max_retries, void* stream) {
  rt::DenseGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light}};
  return rt::launch_mc(ray_o, ray_d, unifs, g, photon, casts, work, n, depth, max_distance,
                       max_retries, stream);
}

// The blocked instantiation (tables as rt_level_blk).
int rt_mc_trace_blk(const float* ray_o, const float* ray_d, const float* unifs, const float* tri,
                    int n_tri, const float* sph, int n_sph, const float* mat, int n_obj,
                    const float* lights, int n_light, const float* btri, const float* box,
                    const float* sup, int n_chunks, float* photon, int* casts, int* work, int n,
                    int depth, float max_distance, int max_retries, void* stream) {
  rt::BlockedGeom g{rt::Tables{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light},
                    rt::Blk{btri, box, sup, n_chunks}};
  return rt::launch_mc(ray_o, ray_d, unifs, g, photon, casts, work, n, depth, max_distance,
                       max_retries, stream);
}

// Compiled attributes of the main path's instantiation `which` (0 dense, 1
// blocked), layout as rt_level_attrs.
int rt_mc_attrs(int which, int* out) {
  return rt::attrs_of(which ? (const void*)rt::mc_kernel<rt::BlockedGeom, rt::NoWork>
                            : (const void*)rt::mc_kernel<rt::DenseGeom, rt::NoWork>,
                      out);
}

}  // extern "C"
