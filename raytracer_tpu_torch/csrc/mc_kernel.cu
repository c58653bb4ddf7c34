// Monte-Carlo whole-walk kernel: one stochastic sample per primary ray.
//
// Replaces the TPU kernel raytracer_tpu/ops/mc_pallas.py:474 `_mc_kernel`
// (wrapper `trace` :541; `mc_step` :58, `mc_terminal` :449).  Plain version:
// raytracer_tpu_torch/ops/mc_kernel.py `trace_plain`.
//
// One thread per ray walks the whole path: the primary cast, `depth`
// roulette bounces (roulette, scatter lobe, interior TIR march, advance
// cast, merged next-hit shade with shadow sweeps, the accum += scale*A;
// scale *= B recurrence), then the depth-exhausted terminal shade.
//
// What bounds it on an H100: neither DRAM bytes (each ray reads 12 + 12 *
// depth bytes of rays and draws and writes 16) nor FLOP peak, but issue
// throughput over long, divergent, data-dependent loops — every bounce
// sweeps all 64 triangles and 4 spheres up to ~15 times (advance cast, 3
// lights' shadow rays, up to 11 march casts), and lanes of a warp take
// different roulette branches and march lengths.  The design keeps it
// simple and correct first: 128 threads per block, the scene tables read
// from global memory through const __restrict__ pointers (under 10 KB, so
// they stay in L1), the depth loop a runtime loop (not unrolled) to hold
// register pressure down, any-hit shadow loops that stop at the first
// occluder, and per-lane cast counts summed by the wrapper.  Staging the
// tables in shared memory and regrouping lanes by branch are later work.
#include "common.cuh"

namespace rt {

__global__ void __launch_bounds__(128)
mc_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
          const float* __restrict__ unifs, Tables tb, float* __restrict__ photon,
          int* __restrict__ casts_out, int n, int depth, float max_distance, int max_retries) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  V3 o0 = v3(ray_o[lane], ray_o[n + lane], ray_o[2 * n + lane]);
  V3 d0 = v3(ray_d[lane], ray_d[n + lane], ray_d[2 * n + lane]);

  // primary cast (main.rs:1150)
  Hit h = full_sweep(tb, o0, d0, FACE_FRONT, -1, FACE_FRONT, true);
  int casts = 1;
  bool alive = h.valid;
  V3 acc = v3(0.0f, 0.0f, 0.0f), scale = v3(1.0f, 1.0f, 1.0f);
  V3 cp = h.p, cn = h.n, cd = d0;
  float cu = h.u, cv = h.v;
  int cprim = h.prim, cobj = h.obj;
  bool cback = h.back;

#pragma unroll 1
  for (int step = 0; step < depth; ++step) {
    const float* u = unifs + (size_t)step * 3 * n + lane;
    float u_sel = u[0], u_phi = u[n], theta = u[2 * n];

    Mat m = eval_material(tb, cobj, cu, cv);
    float w0 = (1.0f - m.shiness) * (1.0f - m.transparency);
    float w1 = m.shiness * (1.0f - m.transparency);
    float w2 = m.transparency;
    float r = u_sel * (w0 + w1 + w2);  // weighted_select (main.rs:652-666)
    bool sel_d = r < w0;
    bool sel_r = !sel_d && r < w0 + w1;
    bool sel_f = !sel_d && !sel_r;

    // scatter lobe (main.rs:539-554)
    float expo = sel_d ? 1.0f : m.smoothness;
    V3 ax = normalize3(sel_d ? neg(cn) : cd);
    float phi = acosf(kpowf(1.0f - u_phi, expo));
    float sp = sinf(phi);
    V3 sd = rotate_from_z(ax, v3(sp * cosf(theta), sp * sinf(theta), cosf(phi)));

    float cosine = -(cn.x * sd.x + cn.y * sd.y + cn.z * sd.z);
    bool live = alive && cosine > 0.0f;  // main.rs:560/579/598
    V3 f = reflect3(sd, cn);

    March mm = march(tb, cp, cn, sd, m.refraction, live && sel_f, max_distance, max_retries);
    casts += mm.iters;

    V3 adv_o = sel_f ? mm.e : cp;
    V3 adv_d = sel_f ? mm.od : f;
    int adv_excl_prim = sel_f ? mm.prim : cprim;
    int adv_excl_face = sel_f ? FACE_BACK : (cback ? FACE_FRONT : FACE_BACK);
    bool adv_active = live && (!sel_f || mm.escaped);

    Hit nx = full_sweep(tb, adv_o, adv_d, FACE_FRONT, adv_excl_prim, adv_excl_face, adv_active);
    casts += adv_active ? 1 : 0;
    bool use_next = nx.valid;

    // merged shade: the next hit where the advance cast hit, else the
    // scattered self-shade; refract lanes whose escape missed are black
    bool need_shade = adv_active && (use_next || !sel_f);
    Mat m2 = eval_material(tb, use_next ? nx.obj : cobj, use_next ? nx.u : cu,
                           use_next ? nx.v : cv);
    V3 sh = shade_at(tb, m2, sel(use_next, nx.p, cp), sel(use_next, nx.n, cn),
                     sel(use_next, adv_d, sd), need_shade, use_next ? nx.prim : cprim, casts);

    // BRDF against the unadjusted hit normal (566-570/585-589)
    float lam = f.x * cn.x + f.y * cn.y + f.z * cn.z;
    bool pos_lam = lam > 0.0f;
    float e = 1.0f / (m.smoothness + F32_EPS);
    float energy = (e + 8.0f) / EIGHT_PI;
    V3 rf = v3(2.0f * lam * cn.x - f.x, 2.0f * lam * cn.y - f.y, 2.0f * lam * cn.z - f.z);
    float amount = kpowf(fmaxf(-(rf.x * cd.x + rf.y * cd.y + rf.z * cd.z), 0.0f), e) * energy;
    V3 br = sel_d ? v3(pos_lam ? m.diffuse.x * lam : 0.0f, pos_lam ? m.diffuse.y * lam : 0.0f,
                       pos_lam ? m.diffuse.z * lam : 0.0f)
                  : v3(pos_lam ? m.specular.x * amount : 0.0f,
                       pos_lam ? m.specular.y * amount : 0.0f,
                       pos_lam ? m.specular.z * amount : 0.0f);
    float decay = kpowf(m.decay, mm.travel);
    bool is_rb = !sel_f;  // diffuse / reflect branch
    float hit_scale = use_next ? 0.5f : 1.0f;
    float b_base = use_next ? 0.5f : 0.0f;
    V3 A = is_rb ? v3(hit_scale * sh.x, hit_scale * sh.y, hit_scale * sh.z)
                 : v3(decay * sh.x, decay * sh.y, decay * sh.z);
    V3 B = is_rb ? v3(b_base * br.x, b_base * br.y, b_base * br.z) : v3(decay, decay, decay);
    acc.x += need_shade ? scale.x * A.x : 0.0f;
    acc.y += need_shade ? scale.y * A.y : 0.0f;
    acc.z += need_shade ? scale.z * A.z : 0.0f;
    scale.x = scale.x * (adv_active ? B.x : 0.0f);
    scale.y = scale.y * (adv_active ? B.y : 0.0f);
    scale.z = scale.z * (adv_active ? B.z : 0.0f);

    alive = adv_active && use_next;
    cp = nx.p;
    cn = nx.n;
    cu = nx.u;
    cv = nx.v;
    cprim = nx.prim;
    cobj = nx.obj;
    cback = nx.back;
    cd = adv_d;
  }

  // depth exhausted: terminate with shade(self) (main.rs:524-527)
  Mat m3 = eval_material(tb, cobj, cu, cv);
  V3 sh = shade_at(tb, m3, cp, cn, cd, alive, cprim, casts);
  photon[lane] = acc.x + (alive ? scale.x * sh.x : 0.0f);
  photon[n + lane] = acc.y + (alive ? scale.y * sh.y : 0.0f);
  photon[2 * n + lane] = acc.z + (alive ? scale.z * sh.z : 0.0f);
  casts_out[lane] = casts;
}

}  // namespace rt

extern "C" {

// ray_o, ray_d: [3, n]; unifs: [depth, 3, n]; photon: [3, n]; casts: [n].
int rt_mc_trace(const float* ray_o, const float* ray_d, const float* unifs, const float* tri,
                int n_tri, const float* sph, int n_sph, const float* mat, int n_obj,
                const float* lights, int n_light, float* photon, int* casts, int n, int depth,
                float max_distance, int max_retries, void* stream) {
  rt::Tables tb{tri, sph, mat, lights, n_tri, n_sph, n_obj, n_light};
  int blocks = (n + 127) / 128;
  rt::mc_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(ray_o, ray_d, unifs, tb, photon, casts,
                                                         n, depth, max_distance, max_retries);
  return (int)cudaGetLastError();
}

// Compiled attributes of the MC kernel (layout as rt_level_attrs).
int rt_mc_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, rt::mc_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
