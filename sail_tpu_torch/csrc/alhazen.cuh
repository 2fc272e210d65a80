// KA's per-thread work: the detached Alhazen solve of one (mirror sphere,
// sphere) pair, the centre and then one azimuth's radial root.  alhazen.cu
// launches it (the centre in each block's first warp, one thread an
// azimuth); csrc/host/edge_host.cpp runs it on the CPU.  The plain version
// is `ops/cuda/alhazen.py` `solve_plain` (the JAX package's
// `_mirror_sphere_silhouette_fn`, `sail_tpu/diff/boundary.py`), whose float32
// operations the code here follows one by one.
//
// The frame (`frame` there; detached): eye e, mirror centre m and radius R,
// sphere centre c and radius r, d_em = |e - m|, u1 = (e - m) / d_em, u2 in
// the plane of e, m and c (or any plane through the axis when they are in
// line), pn its normal.  The centre: the mirror point q(ψ) = m + (u1 cos ψ +
// u2 sin ψ) R whose reflected eye ray points at c is the root of
//
//   h(ψ) = (d_r × normalize(c - q)) · pn,  d_r the eye ray reflected at q,
//
// found on ψ in [1e-3, ψ_hi - 1e-3] by a 64-sample scan (the first sign
// change), 30 halvings and a central difference of step 1e-4; its ray
// a = normalize(q(ψ0 - h(ψ0)/h') - e) and frame e1 = normalize(ortho(a)),
// e2 = a × e1.  Each azimuth φ: the view ray v(β) = a cos β + (e1 cos φ +
// e2 sin φ) sin β hits the mirror at q, reflects, and
//
//   g(β) = |(c - q) × d_r| - r where it hits and reflects toward c, else 1e3,
//
// whose first positive sample of 48 up to β_max = 2.2 asin(R / d_em) brackets
// the silhouette; 30 halvings, the slope g', and the mask (a centre found,
// the eye outside the mirror, the bracket inside the mirror's rim).
//
// Transcendentals: the card's full-precision cosf, sinf, acosf and asinf,
// which torch's CUDA kernels also call; the host build takes them through
// double, correctly rounded, as tests/test_torch_alhazen.py makes torch's.
#pragma once

#include "path.cuh"

namespace {

// the frame's floats (e, m, R, c, r, d_em, u1, u2, pn), the centre scan's
// and the radial scan's samples, the halvings and the finite difference's
// step (boundary.py's FD_EPS)
constexpr int KA_FRAME = 21;
constexpr int KA_NS = 64;
constexpr int KA_NB = 48;
constexpr int KA_STEPS = 30;
constexpr double KA_FD_EPS = 1e-4;

#ifdef __CUDACC__
__device__ __forceinline__ float ka_cos(float x) { return cosf(x); }
__device__ __forceinline__ float ka_sin(float x) { return sinf(x); }
__device__ __forceinline__ float ka_acos(float x) { return acosf(x); }
__device__ __forceinline__ float ka_asin(float x) { return asinf(x); }
// (x) / (2 FD_EPS) as torch takes a tensor over a Python number: on the card
// the product with the number's reciprocal (ATen's div_true_kernel_cuda)
__device__ __forceinline__ float ka_over_2eps(float x) { return x * (F(1.0) / F(2.0 * KA_FD_EPS)); }
#else
inline float ka_cos(float x) { return (float)cos((double)x); }
inline float ka_sin(float x) { return (float)sin((double)x); }
inline float ka_acos(float x) { return (float)acos((double)x); }
inline float ka_asin(float x) { return (float)asin((double)x); }
// on the CPU a division
inline float ka_over_2eps(float x) { return x / F(2.0 * KA_FD_EPS); }
#endif

struct KAFrame {
  V3 e, m, c, u1, u2, pn;
  float R, r, d_em;
};

// What every azimuth reads of the centre solve.
struct KACenter {
  float psi0, dh;
  V3 a, e1, e2;
};

__device__ __forceinline__ KAFrame ka_frame(const float* p) {
  KAFrame f;
  f.e = V3{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
  f.m = V3{__ldg(p + 3), __ldg(p + 4), __ldg(p + 5)};
  f.R = __ldg(p + 6);
  f.c = V3{__ldg(p + 7), __ldg(p + 8), __ldg(p + 9)};
  f.r = __ldg(p + 10);
  f.d_em = __ldg(p + 11);
  f.u1 = V3{__ldg(p + 12), __ldg(p + 13), __ldg(p + 14)};
  f.u2 = V3{__ldg(p + 15), __ldg(p + 16), __ldg(p + 17)};
  f.pn = V3{__ldg(p + 18), __ldg(p + 19), __ldg(p + 20)};
  return f;
}

// R / max(d_em, R + 1e-6): cos ψ_hi, and sin of half the radial scan's range
__device__ __forceinline__ float ka_ratio(const KAFrame& f) {
  return f.R / fmaxf(f.d_em, f.R + F(1e-6));
}

// ψ_hi - 2e-3, the span of the centre scan
__device__ __forceinline__ float ka_psi_span(const KAFrame& f) {
  return ka_acos(clampf(ka_ratio(f), 0.f, F(1.0 - 1e-7))) - F(2e-3);
}

// the centre scan's sample k: linspace(1e-3, 1, 64)[k] · span + 1e-3
__device__ __forceinline__ float ka_psi(const float* lin, int k, float span) {
  return __ldg(lin + k) * span + F(1e-3);
}

__device__ __forceinline__ float ka_h(const KAFrame& f, float psi) {
  const V3 q = f.m + (f.u1 * ka_cos(psi) + f.u2 * ka_sin(psi)) * f.R;
  const V3 d_in = normalize(q - f.e);
  const V3 n_q = (q - f.m) * (F(1.0) / fmaxf(f.R, F(1e-9)));
  const V3 d_r = d_in - n_q * (F(2.0) * dot(d_in, n_q));
  const V3 cq = normalize(f.c - q);
  return dot(cross(d_r, cq), f.pn);
}

// |x| below `floor` moved out to ±floor, keeping its sign
__device__ __forceinline__ float ka_away_from_zero(float x, float floor) {
  return fabsf(x) < floor ? (x < 0.f ? -floor : floor) : x;
}

// The centre from the scan's bracket [lo, hi]: the halvings, ψ0, the slope
// h'(ψ0), and the ray and frame one Newton step from ψ0 gives.
__device__ __forceinline__ KACenter ka_center(const KAFrame& f, float lo, float hi) {
  float f_lo = ka_h(f, lo);
  for (int s = 0; s < KA_STEPS; ++s) {
    const float mid = F(0.5) * (lo + hi);
    const float f_mid = ka_h(f, mid);
    const bool same = f_mid * f_lo > 0.f;
    lo = same ? mid : lo;
    hi = same ? hi : mid;
    f_lo = same ? f_mid : f_lo;
  }
  KACenter c;
  c.psi0 = F(0.5) * (lo + hi);
  c.dh = ka_away_from_zero(
      ka_over_2eps(ka_h(f, c.psi0 + F(KA_FD_EPS)) - ka_h(f, c.psi0 - F(KA_FD_EPS))), F(1e-9));
  const float psi_live = c.psi0 - ka_h(f, c.psi0) / c.dh;
  const V3 q = f.m + (f.u1 * ka_cos(psi_live) + f.u2 * ka_sin(psi_live)) * f.R;
  c.a = normalize(q - f.e);
  c.e1 = normalize(ortho(c.a));
  c.e2 = cross(c.a, c.e1);
  return c;
}

// g(β) along the azimuth's direction `dir` = e1 cos φ + e2 sin φ; `ok`: the
// ray hits the mirror and reflects toward c.
__device__ __forceinline__ float ka_g(const KAFrame& f, const KACenter& c, V3 dir, float beta,
                                      bool& ok) {
  const V3 v = c.a * ka_cos(beta) + dir * ka_sin(beta);
  const V3 oc = f.e - f.m;
  const float B = dot(oc, v);
  const float disc = B * B - (dot(oc, oc) - f.R * f.R);
  const float t_hit = -B - sqrtf(fmaxf(disc, 0.f));
  const bool hitm = disc > 0.f && t_hit > F(1e-6);
  const V3 q = f.e + v * t_hit;
  const V3 n_q = (q - f.m) * (F(1.0) / fmaxf(f.R, F(1e-9)));
  const V3 d_r = v - n_q * (F(2.0) * dot(v, n_q));
  const V3 w = f.c - q;
  const bool toward = dot(w, d_r) > 0.f;
  const float dist = length(cross(w, d_r));
  ok = hitm && toward;
  return ok ? dist - f.r : F(1e3);
}

__device__ __forceinline__ float ka_g(const KAFrame& f, const KACenter& c, V3 dir, float beta) {
  bool ok;
  return ka_g(f, c, dir, beta, ok);
}

// One azimuth's radial solve: β0, g'(β0) and the mask.  `frac` holds the
// radial scan's 48 fractions of β_max ((k + 1) / 48).
__device__ __forceinline__ void ka_radial(const KAFrame& f, const KACenter& c, bool found_c,
                                          const float* frac, float cphi, float sphi, float& beta0,
                                          float& gp, bool& mask) {
  const float beta_max = F(2.2) * ka_asin(clampf(ka_ratio(f), 0.f, F(1.0)));
  const V3 dir = c.e1 * cphi + c.e2 * sphi;
  // the first positive sample (bidx 0 and ok_hi of sample 0 where none is)
  int bidx = 0;
  bool found_b = false, ok_hi = false;
  for (int k = 0; k < KA_NB; ++k) {
    bool ok;
    const float g = ka_g(f, c, dir, __ldg(frac + k) * beta_max, ok);
    if (k == 0) ok_hi = ok;
    if (g > 0.f) {
      bidx = k;
      found_b = true;
      ok_hi = ok;
      break;
    }
  }
  float lo = bidx > 0 ? __ldg(frac + bidx - 1) * beta_max : 0.f;
  float hi = __ldg(frac + bidx) * beta_max;
  float g_lo = ka_g(f, c, dir, lo);
  for (int s = 0; s < KA_STEPS; ++s) {
    const float mid = F(0.5) * (lo + hi);
    const float g_mid = ka_g(f, c, dir, mid);
    const bool same = g_mid * g_lo > 0.f;
    lo = same ? mid : lo;
    hi = same ? hi : mid;
    g_lo = same ? g_mid : g_lo;
  }
  beta0 = F(0.5) * (lo + hi);
  gp = ka_away_from_zero(ka_over_2eps(ka_g(f, c, dir, beta0 + F(KA_FD_EPS)) -
                                      ka_g(f, c, dir, beta0 - F(KA_FD_EPS))),
                         F(1e-6));
  mask = found_c && f.d_em > f.R * F(1.0 + 1e-4) && found_b && ok_hi && bidx > 0;
}

}  // namespace
