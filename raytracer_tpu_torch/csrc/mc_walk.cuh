// Pieces of one Monte-Carlo bounce shared by the whole-walk kernel
// (mc_kernel.cu) and the binned per-bounce kernels (mc_binned.cu).
//
// __device__ counterparts of the parts of raytracer_tpu/ops/mc_pallas.py
// `mc_step` :58 and `mc_step_deferred` :232 that both walks run: the
// roulette select and lobe sample, the interior march and the advance
// cast, and the BRDF of the scale recurrence.  Plain versions:
// raytracer_tpu_torch/ops/mc_kernel.py `scatter`, `advance`, `brdf`.
#pragma once

#include "common.cuh"

namespace rt {

// The walk's current hit.
struct Cur {
  V3 p, n, d;  // hit point, shading normal, incoming direction
  float u, v;
  int prim, obj;
  bool back;
};

__device__ __forceinline__ Cur cur_of(const Hit& h, V3 d) {
  return Cur{h.p, h.n, d, h.u, h.v, h.prim, h.obj, h.back};
}

// Roulette select and scatter lobe (main.rs:539-554, 652-666).
struct Lobe {
  bool sel_d, sel_f, live;
  V3 sd, f;  // scattered direction, its reflection about the normal
};

__device__ __forceinline__ Lobe scatter(const Mat& m, const Cur& c, bool alive, float u_sel,
                                        float u_phi, float theta) {
  Lobe lb;
  float w0 = (1.0f - m.shiness) * (1.0f - m.transparency);
  float w1 = m.shiness * (1.0f - m.transparency);
  float w2 = m.transparency;
  float r = u_sel * (w0 + w1 + w2);  // weighted_select (main.rs:652-666)
  lb.sel_d = r < w0;
  bool sel_r = !lb.sel_d && r < w0 + w1;
  lb.sel_f = !lb.sel_d && !sel_r;
  // diffuse around -normal with exponent 1, glossy around the incoming
  // direction with exponent smoothness
  float expo = lb.sel_d ? 1.0f : m.smoothness;
  V3 ax = normalize3(lb.sel_d ? neg(c.n) : c.d);
  float phi = acosf(kpowf(1.0f - u_phi, expo));
  float sp = sinf(phi);
  lb.sd = rotate_from_z(ax, v3(sp * cosf(theta), sp * sinf(theta), cosf(phi)));
  float cosine = -(c.n.x * lb.sd.x + c.n.y * lb.sd.y + c.n.z * lb.sd.z);
  lb.live = alive && cosine > 0.0f;  // main.rs:560/579/598
  lb.f = reflect3(lb.sd, c.n);
  return lb;
}

// The interior march of refract lanes, then the advance cast.
struct Advance {
  March mm;
  V3 d;         // the advance direction
  bool active;  // the advance cast ran
  Hit nx;       // its hit
};

template <class G, class W>
__device__ __forceinline__ Advance advance(const G& g, const Mat& m, const Cur& c,
                                           const Lobe& lb, float max_distance, int max_retries,
                                           int& casts, W& w) {
  Advance a;
  a.mm = march(g, c.p, c.n, lb.sd, m.refraction, lb.live && lb.sel_f, max_distance, max_retries,
               w);
  casts += a.mm.iters;
  V3 o = lb.sel_f ? a.mm.e : c.p;
  a.d = lb.sel_f ? a.mm.od : lb.f;
  int excl_prim = lb.sel_f ? a.mm.prim : c.prim;
  int excl_face = lb.sel_f ? FACE_BACK : (c.back ? FACE_FRONT : FACE_BACK);
  a.active = lb.live && (!lb.sel_f || a.mm.escaped);
  a.nx = g.nearest(o, a.d, FACE_FRONT, excl_prim, excl_face, a.active, w);
  casts += a.active ? 1 : 0;
  return a;
}

// BRDF against the unadjusted hit normal (main.rs:566-570/585-589).
__device__ __forceinline__ V3 brdf(const Mat& m, const Cur& c, const Lobe& lb) {
  V3 f = lb.f, cn = c.n, cd = c.d;
  float lam = f.x * cn.x + f.y * cn.y + f.z * cn.z;
  if (!(lam > 0.0f)) return v3(0.0f, 0.0f, 0.0f);
  if (lb.sel_d) return v3(m.diffuse.x * lam, m.diffuse.y * lam, m.diffuse.z * lam);
  float e = 1.0f / (m.smoothness + F32_EPS);
  float energy = (e + 8.0f) / EIGHT_PI;
  V3 rf = v3(2.0f * lam * cn.x - f.x, 2.0f * lam * cn.y - f.y, 2.0f * lam * cn.z - f.z);
  float amount = kpowf(fmaxf(-(rf.x * cd.x + rf.y * cd.y + rf.z * cd.z), 0.0f), e) * energy;
  return v3(m.specular.x * amount, m.specular.y * amount, m.specular.z * amount);
}

}  // namespace rt
