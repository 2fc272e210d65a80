// The hand-written adjoint of one path sample, for K2 (megakernel_grad.cu).
//
// `sample_grad` adds d(g . radiance)/d(params) of one sample of one pixel to
// a per-thread gradient G (the flat parameter vector's layout, `Grad`): a
// forward sweep with K1's code (path.cuh `bounce`) that stores each
// bounce's input state and its two discrete decisions (the closest hit's
// winner and the shadow ray's bit); then, from the last bounce to the first,
// the bounce is replayed from its stored state and decisions (recording
// every intermediate in a `Bounce`, without the closest-hit fold or the
// shadow scan) and its adjoint is applied; then the camera's adjoint.  This
// is the TPU kernel's "remat" mode (sail_tpu/ops/pallas/megakernel.py:
// 420-436), less the two searches, whose results carry no cotangent.
//
// The rules are those of the plain version (torch autograd through
// render/integrator.py), which are JAX's:
// - max/min/clip give 0.5 to each side where the value sits exactly on the
//   bound (jnp.maximum's rule; `max_adj`, `max_fac`);
// - a select gives the cotangent only to the side taken (the closest-hit
//   winner, front face, into, the skipped emission, the NEE mask);
// - discrete values (hit choice, occlusion, RNG, masks) carry none;
// - |x| has derivative sign(x), 0 at 0.
// A path that misses or dies leaves the loop: the masked JAX loop gives such
// lanes exactly zero cotangent from then on.  The radiance sum's cotangent is
// the pixel's g at every bounce (e' = e + thr . contrib), so e is not stored.
// A hit's u, v carry the cotangent the Bilerp and UV textures give them
// (`texture_adj`; the checkerboards go through floor and give none) into
// every shape's hit adjoint, through the fastmath atan2 and acos (`atan2_adj`,
// `acos_adj`).  Every shape category has its hit adjoint; the bound boxes and
// the cull are comparisons and take none.  Metal and glass samples take
// theirs by forward-mode tangents over bsdf.cuh's code (`material_adj`).
#pragma once

#include "path.cuh"

namespace {

constexpr int MAX_GRAD_BOUNCES = 8;  // bounce states a thread stores

// ------------------------------------------------------- rule helpers ----
// d fmaxf(x, c)/dx and d fminf(x, c)/dx for a bound c, ties split in half.
__device__ __forceinline__ float max_fac(float x, float c) {
  return x > c ? 1.f : (x == c ? F(0.5) : 0.f);
}
__device__ __forceinline__ float min_fac(float x, float c) {
  return x < c ? 1.f : (x == c ? F(0.5) : 0.f);
}
// d clampf(x, lo, hi)/dx (= fminf(fmaxf(x, lo), hi)).
__device__ __forceinline__ float clamp_fac(float x, float lo, float hi) {
  return max_fac(x, lo) * min_fac(fmaxf(x, lo), hi);
}
// Cotangent d of fmaxf(a, b) / fminf(a, b) onto a and b.
__device__ __forceinline__ void max_adj(float a, float b, float d, float& da, float& db) {
  if (a > b) da += d;
  else if (a < b) db += d;
  else { da += F(0.5) * d; db += F(0.5) * d; }
}
__device__ __forceinline__ void min_adj(float a, float b, float d, float& da, float& db) {
  max_adj(-a, -b, d, da, db);
}
__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

// A thread's gradient: parameter i at p[i * STRIDE].  K2 keeps it either in
// a local array (STRIDE 1) or in the thread's column of a block-wide array in
// shared memory (p = base + thread index, STRIDE = the block's threads), so
// the 32 lanes of a warp always add to 32 different banks.  Each slot has one
// owner: no atomics, and the adds land in the same order either way.
template <int STRIDE>
struct Grad {
  float* p;
};
template <int STRIDE>
__device__ __forceinline__ float& gref(Grad<STRIDE> G, int i) { return G.p[i * STRIDE]; }
template <int STRIDE>
__device__ __forceinline__ void gadd(Grad<STRIDE> G, int i, float d) { gref(G, i) += d; }
template <int STRIDE>
__device__ __forceinline__ void gadd3(Grad<STRIDE> G, int i, V3 d) {
  gref(G, i) += d.x;
  gref(G, i + 1) += d.y;
  gref(G, i + 2) += d.z;
}

// ---------------------------------------------------- vector adjoints ----
// c = cross(a, b): cotangent d of c onto a and b.
__device__ __forceinline__ void cross_adj(V3 a, V3 b, V3 d, V3& da, V3& db) {
  da = da + cross(b, d);
  db = db + cross(d, a);
}
// normalize(a) = a * (1 / sqrtf(fmaxf(a.a, 1e-20))).
__device__ __forceinline__ void normalize_adj(V3 a, V3 d, V3& da) {
  float m2 = dot(a, a);
  float s = sqrtf(fmaxf(m2, F(1e-20)));
  float inv = F(1.0) / s;
  float d_inv = dot(d, a);
  float d_m2 = -d_inv * inv * inv * (F(0.5) / s) * max_fac(m2, F(1e-20));
  da = da + d * inv + a * (F(2.0) * d_m2);
}
// length(a) = sqrtf(fmaxf(a.a, 1e-20)).
__device__ __forceinline__ void length_adj(V3 a, float d, V3& da) {
  float m2 = dot(a, a);
  da = da + a * (d * max_fac(m2, F(1e-20)) / sqrtf(fmaxf(m2, F(1e-20))));
}
// world_to_local(v, n, s, t) = (v.s, v.t, v.n): cotangent d onto v, n, s, t.
__device__ __forceinline__ void world_to_local_adj(V3 v, V3 n, V3 s, V3 t, V3 d, V3& dv, V3& dn,
                                                   V3& ds, V3& dt) {
  dv = dv + s * d.x + t * d.y + n * d.z;
  ds = ds + v * d.x;
  dt = dt + v * d.y;
  dn = dn + v * d.z;
}

// ---------------------------------------------------------- the BSDF ----
// sin_theta / cos_phi / sin_phi of w (path.cuh): cotangents of the three
// values onto w.
__device__ void trig_adj(V3 w, float d_st, float d_cphi, float d_sphi, V3& dw) {
  float st = sin_theta(w);
  if (!(fabsf(st) < F(1e-3))) {
    float den = st == 0.f ? F(1.0) : st;
    float xc = w.x / den, yc = w.y / den;
    float d_xc = d_cphi * clamp_fac(xc, F(-1.0), F(1.0));
    float d_yc = d_sphi * clamp_fac(yc, F(-1.0), F(1.0));
    dw.x += d_xc / den;
    dw.y += d_yc / den;
    d_st += -d_xc * xc / den - d_yc * yc / den;
  }
  // st = sqrtf(fmaxf(fmaxf(1 - z*z, 0), 1e-12))
  float m1 = F(1.0) - w.z * w.z;
  float m0 = fmaxf(m1, 0.f);
  dw.z += d_st * (F(0.5) / st) * max_fac(m0, F(1e-12)) * max_fac(m1, 0.f) * (F(-2.0) * w.z);
}

// matte_f(kd, sigma, sc, wo, wi): cotangent d_f onto every argument.
__device__ void matte_f_adj(float kd, float sigma, V3 sc, V3 wo, V3 wi, V3 d_f, float& d_kd,
                            float& d_sigma, V3& d_sc, V3& d_wo, V3& d_wi) {
  V3 r = sc * kd;
  V3 d_r;
  if (sigma < EPSILON) {
    d_r = d_f * F(INV_PI);
  } else {
    float s2 = sigma * sigma;
    float D = F(2.0) * (s2 + F(0.33)), qa = s2 / D;
    float a = F(1.0) - qa;
    float N = F(0.45) * s2, E = s2 + F(0.09), b = N / E;
    float sin_ti = sin_theta(wi), sin_to = sin_theta(wo);
    float cpi = cos_phi(wi), cpo = cos_phi(wo), spi = sin_phi(wi), spo = sin_phi(wo);
    float d_cos = cpi * cpo + spi * spo;
    bool cond = sin_ti > EPSILON && sin_to > EPSILON;
    float max_cos = cond ? fmaxf(d_cos, 0.f) : 0.f;
    float aci = fabsf(wi.z), aco = fabsf(wo.z);
    bool steeper = aci > aco;
    float sin_alpha = steeper ? sin_to : sin_ti;
    float m = steeper ? fmaxf(aci, F(1e-7)) : fmaxf(aco, F(1e-7));
    float tan_beta = (steeper ? sin_ti : sin_to) / m;
    float bm = b * max_cos, bms = bm * sin_alpha;
    float k = F(INV_PI) * (a + bms * tan_beta);
    d_r = d_f * k;
    float d_in = F(INV_PI) * dot(d_f, r);
    float d_tb = d_in * bms, d_bms = d_in * tan_beta;
    float d_sa = d_bms * bm, d_bm = d_bms * sin_alpha;
    float d_b = d_bm * max_cos, d_mc = d_bm * b;
    // a = 1 - s2 / (2 (s2 + 0.33)); b = 0.45 s2 / (s2 + 0.09)
    float d_qa = -d_in;
    float d_s2 = d_qa / D + F(2.0) * (-d_qa * qa / D);
    d_s2 += F(0.45) * (d_b / E) - d_b * b / E;
    d_sigma += F(2.0) * sigma * d_s2;
    float d_dcos = cond ? d_mc * max_fac(d_cos, 0.f) : 0.f;
    float d_sti = 0.f, d_sto = 0.f, d_aci = 0.f, d_aco = 0.f;
    float d_m = -d_tb * tan_beta / m;
    if (steeper) {
      d_sto += d_sa;
      d_sti += d_tb / m;
      d_aci += d_m * max_fac(aci, F(1e-7));
    } else {
      d_sti += d_sa;
      d_sto += d_tb / m;
      d_aco += d_m * max_fac(aco, F(1e-7));
    }
    trig_adj(wi, d_sti, d_dcos * cpo, d_dcos * spo, d_wi);
    trig_adj(wo, d_sto, d_dcos * cpi, d_dcos * spi, d_wo);
    d_wi.z += d_aci * sgn(wi.z);
    d_wo.z += d_aco * sgn(wo.z);
  }
  d_sc = d_sc + d_r * kd;
  d_kd += dot(d_r, sc);
}

// ------------------------------------------------------- scalar pieces ----
// quadratic(a, b, c) (path.cuh), discrim >= 0 as on every hit: the cotangent
// d_t of its high root (`high`) or its low root onto a, b and c.
__device__ void quadratic_adj(float a, float b, float c, bool high, float d_t, float& d_a,
                              float& d_b, float& d_c) {
  float discrim = b * b - F(4.0) * a * c;
  float root = sqrtf(fmaxf(discrim, F(1e-20)));
  float q = b < 0.f ? F(-0.5) * (b - root) : F(-0.5) * (b + root);
  float aa = a == 0.f ? F(1e-20) : a;
  float qq = q == 0.f ? F(1e-20) : q;
  float t0 = q / aa, t1 = c / qq;
  float d_t0 = 0.f, d_t1 = 0.f;
  if (high) max_adj(t0, t1, d_t, d_t0, d_t1);
  else min_adj(t0, t1, d_t, d_t0, d_t1);
  // t0 = q / aa; t1 = c / qq
  float d_q = d_t0 / aa;
  if (a != 0.f) d_a += -d_t0 * t0 / aa;
  d_c += d_t1 / qq;
  if (q != 0.f) d_q += -d_t1 * t1 / qq;
  d_b += F(-0.5) * d_q;
  float d_root = b < 0.f ? F(0.5) * d_q : F(-0.5) * d_q;
  float d_disc = d_root * (F(0.5) / root) * max_fac(discrim, F(1e-20));
  d_b += F(2.0) * b * d_disc;
  d_a += F(-4.0) * c * d_disc;
  d_c += F(-4.0) * a * d_disc;
}

// Which root clipped_quadratic (path.cuh) returned on a hit: the high one
// unless the low one is past EPSILON and its z lies in [zlo, zhi].
__device__ __forceinline__ bool clipped_root_is_high(V3 o, V3 d, float a, float b, float c2,
                                                     float zlo, float zhi) {
  float lo, hi;
  quadratic(a, b, c2, lo, hi);
  float t1c = lo < EPSILON ? hi : lo;
  float z1 = o.z + d.z * t1c;
  return !(z1 >= zlo && z1 <= zhi && !(lo < EPSILON));
}

// atan2_poly(y, x) (path.cuh): the cotangent d of its value onto y and x.
__device__ void atan2_adj(float y, float x, float d, float& d_y, float& d_x) {
  bool swap = fabsf(y) > fabsf(x);
  float num = swap ? x : y;
  float den0 = swap ? y : x;
  float den = den0 == 0.f ? F(1e-30) : den0;
  float t = num / den;
  // r = t * p5, p_k = p_(k-1) * t2 + c_k, p0 constant
  float t2 = t * t;
  float p0 = F(-0.0117212);
  float p1 = p0 * t2 + F(0.05265332);
  float p2 = p1 * t2 + F(-0.11643287);
  float p3 = p2 * t2 + F(0.19354346);
  float p4 = p3 * t2 + F(-0.33262347);
  float p5 = p4 * t2 + F(0.99997726);
  float d_r = swap ? -d : d;  // swap: s - r
  float d_t = d_r * p5, d_p = d_r * t;
  float d_t2 = d_p * p4;
  d_p = d_p * t2;
  d_t2 += d_p * p3;
  d_p = d_p * t2;
  d_t2 += d_p * p2;
  d_p = d_p * t2;
  d_t2 += d_p * p1;
  d_p = d_p * t2;
  d_t2 += d_p * p0;
  d_t += d_t2 * t + d_t2 * t;
  float d_num = d_t / den;
  float d_den = den0 == 0.f ? 0.f : -d_t * t / den;
  if (swap) {
    d_x += d_num;
    d_y += d_den;
  } else {
    d_y += d_num;
    d_x += d_den;
  }
}

// acos_poly(x) = atan2_poly(sqrtf(fmaxf(1 - c*c, 1e-20)), c), c = clamp(x,
// -1, 1): the cotangent d of its value onto x.
__device__ void acos_adj(float x, float d, float& d_x) {
  float c = clampf(x, F(-1.0), F(1.0));
  float m = F(1.0) - c * c;
  float sq = sqrtf(fmaxf(m, F(1e-20)));
  float d_s = 0.f, d_c = 0.f;
  atan2_adj(sq, c, d, d_s, d_c);
  d_c += d_s * (F(0.5) / sq) * max_fac(m, F(1e-20)) * (F(-2.0) * c);
  d_x += d_c * clamp_fac(x, F(-1.0), F(1.0));
}

// u = phi_of(x, y) / 2 pi (path.cuh): the cotangent d_u onto x and y.
__device__ __forceinline__ void phi_u_adj(float x, float y, float d_u, float& d_x, float& d_y) {
  if (d_u != 0.f) atan2_adj(y, x, d_u / F(TWO_PI), d_y, d_x);
}

// q = safe_div(num, den) (path.cuh): the cotangent d onto num and den.
__device__ __forceinline__ void safe_div_adj(float num, float den, float d, float& d_num, float& d_den) {
  const float eps = F(1e-12);
  bool small = fabsf(den) < eps;
  float den_s = small ? (den < 0.f ? -eps : eps) : den;
  d_num += d / den_s;
  if (!small) d_den += -d * (num / den_s) / den_s;
}

// o = to_object(ro - pos), d = to_object(rd): cotangents of o and d onto ro,
// rd and the object's position (offset `off`).
template <class GradT>
__device__ __forceinline__ void ray_to_object_adj(int off, V3 d_o, V3 d_d, V3& d_ro, V3& d_rd,
                                                  GradT G) {
  V3 dw = from_object(d_o);  // to_object's adjoint is from_object
  d_ro = d_ro + dw;
  gadd3(G, off, -dw);
  d_rd = d_rd + from_object(d_d);
}

// ------------------------------------------------------------ shapes ----
// Each hit adjoint takes the cotangents of the winner's hit point p,
// geometric normal ng, tangent dpdu and, with UV (a scene whose textures
// read them: path.cuh's MATS), texture coordinates u, v, and adds onto ro,
// rd and the object's parameters (offset `off`).  Without UV the u, v code
// is left out.  It recomputes the forward values with path.cuh's
// expressions.

template <bool UV, class GradT>
__device__ void sphere_hit_adj(const Scene& s, int off, V3 ro, V3 rd, V3 d_p, V3 d_ng,
                               V3 d_dpdu, float d_u, float d_v, V3& d_ro, V3& d_rd, GradT G) {
  V3 c = P3(s, off);
  float r = P(s, off + 3);
  V3 o = to_object(ro - c), d = to_object(rd);
  float a = dot(d, d);
  float b = F(2.0) * dot(o, d);
  float c2 = dot(o, o) - r * r;
  float lo, hi;
  quadratic(a, b, c2, lo, hi);
  bool far = lo < EPSILON;
  float t = far ? hi : lo;
  V3 h = o + d * t;
  bool pole = h.x == 0.f && h.y == 0.f;
  if (pole) h.x = F(1e-5) * r;
  float inv_r = F(1.0) / r;

  // p = from_object(h) + c; ng = from_object(h * inv_r);
  // dpdu = from_object((-2 pi h.y, 2 pi h.x, 0)).  from_object's adjoint is to_object.
  gadd3(G, off, d_p);
  V3 dh = to_object(d_p);
  V3 dng = to_object(d_ng);
  dh = dh + dng * inv_r;
  float d_r = -dot(dng, h) * inv_r * inv_r;
  V3 dt = to_object(d_dpdu);
  dh.y += F(-TWO_PI) * dt.x;
  dh.x += F(TWO_PI) * dt.y;
  // u = phi_of(h.x, h.y) / 2 pi; v = acos(clamp(h.z / r, -1 + 1e-6, 1 - 1e-6)) / pi
  if (UV) phi_u_adj(h.x, h.y, d_u, dh.x, dh.y);
  if (UV && d_v != 0.f) {
    float qz = h.z / r, d_ct = 0.f;
    acos_adj(clampf(qz, F(-1.0 + 1e-6), F(1.0 - 1e-6)), d_v / F(PI), d_ct);
    float d_qz = d_ct * clamp_fac(qz, F(-1.0 + 1e-6), F(1.0 - 1e-6));
    dh.z += d_qz / r;
    d_r += -d_qz * qz / r;
  }
  if (pole) {
    d_r += F(1e-5) * dh.x;
    dh.x = 0.f;
  }
  // h = o + d * t
  V3 d_o = dh, d_d = dh * t;
  float d_t = dot(dh, d);
  float d_a = 0.f, d_b = 0.f, d_c2 = 0.f;
  quadratic_adj(a, b, c2, far, d_t, d_a, d_b, d_c2);
  // a = d.d; b = 2 o.d; c2 = o.o - r*r
  d_d = d_d + d * (F(2.0) * d_a) + o * (F(2.0) * d_b);
  d_o = d_o + d * (F(2.0) * d_b) + o * (F(2.0) * d_c2);
  d_r += F(-2.0) * r * d_c2;
  gadd(G, off + 3, d_r);
  ray_to_object_adj(off, d_o, d_d, d_ro, d_rd, G);
}

// rect_frame(s, off): cotangents of ex, ey, n, ss, ts onto bmin and bmax.
template <class GradT>
__device__ void rect_frame_adj(int off, const RectFrame& f, V3 d_ex, V3 d_ey, V3 d_n, V3 d_ss,
                               V3 d_ts, GradT G) {
  cross_adj(f.n, f.ss, d_ts, d_n, d_ss);  // ts = cross(n, ss)
  // ss = ex * (1 / fmaxf(len_x, 1e-20)); len_x = length(ex)
  float mx = fmaxf(f.len_x, F(1e-20));
  float inv = F(1.0) / mx;
  d_ex = d_ex + d_ss * inv;
  float d_len = -dot(d_ss, f.ex) * inv * inv * max_fac(f.len_x, F(1e-20));
  length_adj(f.ex, d_len, d_ex);
  // n = normalize(cross(ex, ey))
  V3 d_cr = {0.f, 0.f, 0.f};
  normalize_adj(cross(f.ex, f.ey), d_n, d_cr);
  cross_adj(f.ex, f.ey, d_cr, d_ex, d_ey);
  // ex = (ext.x, 0, 0), ey = (0, ext.y, ext.z), ext = bmax - bmin
  V3 d_ext = {d_ex.x, d_ey.y, d_ey.z};
  gadd3(G, off + 3, d_ext);
  gadd3(G, off, -d_ext);
}

template <bool UV, class GradT>
__device__ void rect_hit_adj(const Scene& s, int off, V3 ro, V3 rd, V3 d_p, V3 d_ng, V3 d_dpdu,
                             float d_u, float d_v, V3& d_ro, V3& d_rd, GradT G) {
  RectFrame f = rect_frame(s, off);
  V3 w = ro - P3(s, off);
  V3 d_l = world_to_local(rd, f.n, f.ss, f.ts);
  V3 o_l = world_to_local(w, f.n, f.ss, f.ts);
  float t = -safe_div(o_l.z, d_l.z);  // |d_l.z| > 1e-12 on a hit
  V3 hl = o_l + d_l * t;
  V3 d_n = d_ng, d_ss = {0.f, 0.f, 0.f}, d_ts = {0.f, 0.f, 0.f}, d_ey = {0.f, 0.f, 0.f};
  V3 d_ex = d_dpdu;  // dpdu = ex
  // p = local_to_world(hl, n, ss, ts) + bmin
  gadd3(G, off, d_p);
  V3 d_hl = {dot(d_p, f.ss), dot(d_p, f.ts), dot(d_p, f.n)};
  d_ss = d_ss + d_p * hl.x;
  d_ts = d_ts + d_p * hl.y;
  d_n = d_n + d_p * hl.z;
  if (UV) {  // u = hl.x / fmaxf(len_x, 1e-20); v = hl.y / fmaxf(len_y, 1e-20)
    float mx = fmaxf(f.len_x, F(1e-20)), my = fmaxf(f.len_y, F(1e-20));
    d_hl.x += d_u / mx;
    d_hl.y += d_v / my;
    length_adj(f.ex, -d_u * (hl.x / mx) / mx * max_fac(f.len_x, F(1e-20)), d_ex);
    length_adj(f.ey, -d_v * (hl.y / my) / my * max_fac(f.len_y, F(1e-20)), d_ey);
  }
  // hl = o_l + d_l * t; t = -o_l.z / d_l.z
  V3 d_ol = d_hl, d_dl = d_hl * t;
  float d_t = dot(d_hl, d_l);
  d_ol.z += -d_t / d_l.z;
  d_dl.z += -d_t * t / d_l.z;
  V3 d_w = {0.f, 0.f, 0.f};
  world_to_local_adj(rd, f.n, f.ss, f.ts, d_dl, d_rd, d_n, d_ss, d_ts);
  world_to_local_adj(w, f.n, f.ss, f.ts, d_ol, d_w, d_n, d_ss, d_ts);
  d_ro = d_ro + d_w;
  gadd3(G, off, -d_w);
  rect_frame_adj(off, f, d_ex, d_ey, d_n, d_ss, d_ts, G);
}

// A box's (cube, Cornell box) normal, tangent and wall colors are constant
// where they are defined, so only p = ro + rd * t carries a cotangent: t is
// the slab test's tnear where a cube is hit from outside, else its tfar.
template <bool UV, class GradT>
__device__ void box_hit_adj(const Scene& s, int off, bool cube, V3 ro, V3 rd, V3 d_p, float d_u,
                            float d_v, V3& d_ro, V3& d_rd, GradT G) {
  V3 bmin = P3(s, off), bmax = P3(s, off + 3);
  if (UV && cube && (d_u != 0.f || d_v != 0.f)) {  // box_uv: rel = safe_div(p - bmin, bmax - bmin)
    V3 p = ro + rd * cube_t(s, off, ro, rd);
    V3 n = box_normal(p, bmin, bmax);
    bool on_x = fabsf(n.x) > F(0.5), on_y = fabsf(n.y) > F(0.5);
    V3 d_rel = {0.f, 0.f, 0.f};
    if (on_x) {
      d_rel.y += d_u;
      d_rel.z += d_v;
    } else {
      d_rel.x += d_u;
      if (on_y) d_rel.z += d_v;
      else d_rel.y += d_v;
    }
    V3 d_num = {0.f, 0.f, 0.f}, d_den = {0.f, 0.f, 0.f}, num = p - bmin, ext = bmax - bmin;
    safe_div_adj(num.x, ext.x, d_rel.x, d_num.x, d_den.x);
    safe_div_adj(num.y, ext.y, d_rel.y, d_num.y, d_den.y);
    safe_div_adj(num.z, ext.z, d_rel.z, d_num.z, d_den.z);
    d_p = d_p + d_num;
    gadd3(G, off, -(d_num + d_den));
    gadd3(G, off + 3, d_den);
  }
  V3 inv = {safe_div(F(1.0), rd.x), safe_div(F(1.0), rd.y), safe_div(F(1.0), rd.z)};
  V3 lo = bmin - ro, hi = bmax - ro;
  V3 tmin = lo * inv, tmax = hi * inv;
  // tnear = max(max(mn.x, mn.y), mn.z), mn = min(tmin, tmax); tfar likewise
  V3 mn = {fminf(tmin.x, tmax.x), fminf(tmin.y, tmax.y), fminf(tmin.z, tmax.z)};
  V3 mx = {fmaxf(tmin.x, tmax.x), fmaxf(tmin.y, tmax.y), fmaxf(tmin.z, tmax.z)};
  float n1 = fmaxf(mn.x, mn.y), tnear = fmaxf(n1, mn.z);
  float f1 = fminf(mx.x, mx.y), tfar = fminf(f1, mx.z);
  bool near = cube && tnear > EPSILON && tnear < tfar;
  float t = near ? tnear : tfar;
  d_ro = d_ro + d_p;
  d_rd = d_rd + d_p * t;
  float d_t = dot(d_p, rd);
  float d_1 = 0.f;
  V3 d_mn = {0.f, 0.f, 0.f}, d_mx = {0.f, 0.f, 0.f};
  if (near) {
    max_adj(n1, mn.z, d_t, d_1, d_mn.z);
    max_adj(mn.x, mn.y, d_1, d_mn.x, d_mn.y);
  } else {
    min_adj(f1, mx.z, d_t, d_1, d_mx.z);
    min_adj(mx.x, mx.y, d_1, d_mx.x, d_mx.y);
  }
  V3 d_tmin = {0.f, 0.f, 0.f}, d_tmax = {0.f, 0.f, 0.f};
  min_adj(tmin.x, tmax.x, d_mn.x, d_tmin.x, d_tmax.x);
  min_adj(tmin.y, tmax.y, d_mn.y, d_tmin.y, d_tmax.y);
  min_adj(tmin.z, tmax.z, d_mn.z, d_tmin.z, d_tmax.z);
  max_adj(tmin.x, tmax.x, d_mx.x, d_tmin.x, d_tmax.x);
  max_adj(tmin.y, tmax.y, d_mx.y, d_tmin.y, d_tmax.y);
  max_adj(tmin.z, tmax.z, d_mx.z, d_tmin.z, d_tmax.z);
  // tmin = (bmin - ro) * inv; tmax = (bmax - ro) * inv; inv = 1 / rd unless |rd| < 1e-12
  gadd3(G, off, d_tmin * inv);
  gadd3(G, off + 3, d_tmax * inv);
  d_ro = d_ro - (d_tmin + d_tmax) * inv;
  V3 d_inv = d_tmin * lo + d_tmax * hi;
  if (!(fabsf(rd.x) < F(1e-12))) d_rd.x += -d_inv.x * inv.x * inv.x;
  if (!(fabsf(rd.y) < F(1e-12))) d_rd.y += -d_inv.y * inv.y * inv.y;
  if (!(fabsf(rd.z) < F(1e-12))) d_rd.z += -d_inv.z * inv.z * inv.z;
}

// The quadrics' common tail (path.cuh quadric_tail): p = from_object(q) +
// pos, ng = from_object(normalize(cross(dpdu, dpdv))), dpdu =
// from_object((-2 pi q.y, 2 pi q.x, 0)).  Adds onto d_q and d_dpdv, and the
// position's share to G.
template <class GradT>
__device__ void quadric_tail_adj(int off, V3 q, V3 dpdv, V3 d_p, V3 d_ng, V3 d_dpdu, V3& d_q,
                                 V3& d_dpdv, GradT G) {
  gadd3(G, off, d_p);
  d_q = d_q + to_object(d_p);  // from_object's adjoint is to_object
  V3 dpdu = {F(-TWO_PI) * q.y, F(TWO_PI) * q.x, 0.f};
  V3 d_cr = {0.f, 0.f, 0.f}, d_du = to_object(d_dpdu);
  normalize_adj(cross(dpdu, dpdv), to_object(d_ng), d_cr);
  cross_adj(dpdu, dpdv, d_cr, d_du, d_dpdv);
  d_q.y += F(-TWO_PI) * d_du.x;
  d_q.x += F(TWO_PI) * d_du.y;
}

// cone / cylinder params: p[3], h, r.  t through the clipped quadratic; the
// cone's dpdv through v = q.z / h.
template <bool UV, class GradT>
__device__ void frustum_hit_adj(const Scene& s, int off, bool cone, V3 ro, V3 rd, V3 d_p, V3 d_ng,
                                V3 d_dpdu, float d_u, float d_vt, V3& d_ro, V3& d_rd, GradT G) {
  float hh = P(s, off + 3), r = P(s, off + 4);
  V3 o, d;
  float t = cone ? cone_t(s, off, ro, rd, o, d) : cylinder_t(s, off, ro, rd, o, d);
  float rh = r / hh, k = rh * rh, w = o.z - hh;
  float a, b, c2;
  if (cone) {
    a = d.x * d.x + d.y * d.y - k * d.z * d.z;
    b = F(2.0) * (d.x * o.x + d.y * o.y - k * d.z * w);
    c2 = o.x * o.x + o.y * o.y - k * w * w;
  } else {
    a = d.x * d.x + d.y * d.y;
    b = F(2.0) * (d.x * o.x + d.y * o.y);
    c2 = o.x * o.x + o.y * o.y - r * r;
  }
  bool high = clipped_root_is_high(o, d, a, b, c2, -EPSILON, hh);
  V3 q = o + d * t;
  float v = q.z / hh, den = F(1.0) - v, inv1mv = 0.f;
  V3 dpdv = {0.f, 0.f, hh};
  if (cone) {
    inv1mv = safe_div(F(1.0), den);
    dpdv.x = -q.x * inv1mv;
    dpdv.y = -q.y * inv1mv;
  }
  V3 d_q = {0.f, 0.f, 0.f}, d_dpdv = {0.f, 0.f, 0.f};
  quadric_tail_adj(off, q, dpdv, d_p, d_ng, d_dpdu, d_q, d_dpdv, G);
  if (UV) phi_u_adj(q.x, q.y, d_u, d_q.x, d_q.y);  // u = phi_of(q.x, q.y) / 2 pi
  float d_hh = d_dpdv.z, d_r = 0.f, d_v = UV ? d_vt : 0.f;
  if (cone) {  // dpdv.xy = -q.xy * inv1mv; inv1mv = 1 / (1 - v) unless |1 - v| < 1e-12
    d_q.x += -d_dpdv.x * inv1mv;
    d_q.y += -d_dpdv.y * inv1mv;
    float d_inv = -(d_dpdv.x * q.x + d_dpdv.y * q.y);
    d_v += fabsf(den) < F(1e-12) ? 0.f : d_inv * inv1mv * inv1mv;
  }
  if (UV || cone) {  // v = q.z / h
    d_q.z += d_v / hh;
    d_hh += -d_v * v / hh;
  }
  // q = o + d * t
  V3 d_o = d_q, d_d = d_q * t;
  float d_a = 0.f, d_b = 0.f, d_c = 0.f;
  quadratic_adj(a, b, c2, high, dot(d_q, d), d_a, d_b, d_c);
  float bb = F(2.0) * d_b;
  d_d.x += F(2.0) * d.x * d_a + bb * o.x;
  d_d.y += F(2.0) * d.y * d_a + bb * o.y;
  d_o.x += bb * d.x + F(2.0) * o.x * d_c;
  d_o.y += bb * d.y + F(2.0) * o.y * d_c;
  if (cone) {  // the k terms; w = o.z - h; k = (r / h)^2
    float d_k = -d_a * d.z * d.z - bb * d.z * w - d_c * w * w;
    d_d.z += F(-2.0) * k * d.z * d_a - bb * k * w;
    float d_w = -bb * k * d.z + F(-2.0) * k * w * d_c;
    d_o.z += d_w;
    d_hh -= d_w;
    float d_rh = F(2.0) * rh * d_k;
    d_r += d_rh / hh;
    d_hh += -d_rh * rh / hh;
  } else {
    d_r += F(-2.0) * r * d_c;
  }
  gadd(G, off + 3, d_hh);
  gadd(G, off + 4, d_r);
  ray_to_object_adj(off, d_o, d_d, d_ro, d_rd, G);
}

// disk params: p[3], r, inner_r.  The normal is constant; r and inner_r reach
// the hit's v.
template <bool UV, class GradT>
__device__ void disk_hit_adj(const Scene& s, int off, V3 ro, V3 rd, V3 d_p, V3 d_dpdu, float d_u,
                             float d_v, V3& d_ro, V3& d_rd, GradT G) {
  V3 o = to_object(ro - P3(s, off)), d = to_object(rd);
  float t = -safe_div(o.z, d.z);  // |d.z| > 1e-12 on a hit
  gadd3(G, off, d_p);
  V3 d_q = to_object(d_p), d_du = to_object(d_dpdu);
  d_q.y += F(-TWO_PI) * d_du.x;
  d_q.x += F(TWO_PI) * d_du.y;
  V3 q = o + d * t;
  if (UV) phi_u_adj(q.x, q.y, d_u, d_q.x, d_q.y);
  if (UV && d_v != 0.f) {  // v = 1 - safe_div(r_hit - inner_r, r - inner_r)
    float r = P(s, off + 3), ir = P(s, off + 4);
    float r_hit = sqrtf(q.x * q.x + q.y * q.y);
    float d_rh = 0.f, d_den = 0.f;
    safe_div_adj(r_hit - ir, r - ir, -d_v, d_rh, d_den);
    gadd(G, off + 3, d_den);
    gadd(G, off + 4, -d_rh - d_den);
    if (r_hit > 0.f) {
      d_q.x += d_rh * q.x / r_hit;
      d_q.y += d_rh * q.y / r_hit;
    }
  }
  // q = o + d * t; t = -o.z / d.z
  V3 d_o = d_q, d_d = d_q * t;
  float d_t = dot(d_q, d);
  d_o.z += -d_t / d.z;
  d_d.z += -d_t * t / d.z;
  ray_to_object_adj(off, d_o, d_d, d_ro, d_rd, G);
}

// hyperboloid params: p[3], p1[3], p2[3], ah, ch.  dpdv turns with
// phi = atan2 of the hit against the profile point pr = lerp(p1, p2, v).
template <bool UV, class GradT>
__device__ void hyperboloid_hit_adj(const Scene& s, int off, V3 ro, V3 rd, V3 d_p, V3 d_ng,
                                    V3 d_dpdu, float d_u, float d_vt, V3& d_ro, V3& d_rd,
                                    GradT G) {
  V3 p1 = P3(s, off + 3), p2 = P3(s, off + 6);
  float ah = P(s, off + 9), ch = P(s, off + 10);
  V3 o, d;
  float t = hyperboloid_t(s, off, ro, rd, o, d);
  float sxy = d.x * d.x + d.y * d.y, dxo = d.x * o.x + d.y * o.y, oxy = o.x * o.x + o.y * o.y;
  float a = ah * sxy - ch * d.z * d.z;
  float b = F(2.0) * (ah * dxo - ch * d.z * o.z);
  float c2 = ah * oxy - ch * o.z * o.z - F(1.0);
  bool high = clipped_root_is_high(o, d, a, b, c2, fminf(p1.z, p2.z), fmaxf(p1.z, p2.z));
  V3 q = o + d * t;
  float vden = p2.z - p1.z;
  bool vden_small = fabsf(vden) < F(1e-12);
  float vden_s = vden_small ? (vden < 0.f ? F(-1e-12) : F(1e-12)) : vden;
  float v = (q.z - p1.z) / vden_s;
  V3 pr = p1 * (F(1.0) - v) + p2 * v;
  float X = pr.x * q.x + pr.y * q.y, Y = pr.x * q.y - q.x * pr.y;
  float phi = phi_of(X, Y);
  float sp = sinf(phi), cp = cosf(phi);
  float dx = p2.x - p1.x, dy = p2.y - p1.y, dz = p2.z - p1.z;
  V3 dpdv = {dx * cp - dy * sp, dx * sp + dy * cp, dz};
  V3 d_q = {0.f, 0.f, 0.f}, d_dpdv = {0.f, 0.f, 0.f};
  quadric_tail_adj(off, q, dpdv, d_p, d_ng, d_dpdu, d_q, d_dpdv, G);
  V3 d_dd = {d_dpdv.x * cp + d_dpdv.y * sp, -d_dpdv.x * sp + d_dpdv.y * cp, d_dpdv.z};
  float d_cp = d_dpdv.x * dx + d_dpdv.y * dy, d_sp = -d_dpdv.x * dy + d_dpdv.y * dx;
  float d_X = 0.f, d_Y = 0.f;
  float d_phi = d_sp * cp - d_cp * sp;
  if (UV) d_phi += d_u / F(TWO_PI);  // u = phi / 2 pi
  atan2_adj(Y, X, d_phi, d_Y, d_X);
  // X = pr.x q.x + pr.y q.y; Y = pr.x q.y - q.x pr.y (pr.z feeds nothing)
  V3 d_pr = {d_X * q.x + d_Y * q.y, d_X * q.y - d_Y * q.x, 0.f};
  d_q.x += d_X * pr.x - d_Y * pr.y;
  d_q.y += d_X * pr.y + d_Y * pr.x;
  V3 d_p1 = d_pr * (F(1.0) - v) - d_dd, d_p2 = d_pr * v + d_dd;
  // v = (q.z - p1.z) / (p2.z - p1.z), the denominator kept off 0
  float d_v = dot(d_pr, p2) - dot(d_pr, p1);
  if (UV) d_v += d_vt;
  float d_num = d_v / vden_s;
  d_q.z += d_num;
  d_p1.z -= d_num;
  if (!vden_small) {
    float d_den = -d_v * v / vden_s;
    d_p2.z += d_den;
    d_p1.z -= d_den;
  }
  // q = o + d * t
  V3 d_o = d_q, d_d = d_q * t;
  float d_a = 0.f, d_b = 0.f, d_c = 0.f;
  quadratic_adj(a, b, c2, high, dot(d_q, d), d_a, d_b, d_c);
  float bb = F(2.0) * d_b;
  float d_ah = d_a * sxy + bb * dxo + d_c * oxy;
  float d_ch = -d_a * d.z * d.z - bb * d.z * o.z - d_c * o.z * o.z;
  d_d.x += F(2.0) * ah * d.x * d_a + bb * ah * o.x;
  d_d.y += F(2.0) * ah * d.y * d_a + bb * ah * o.y;
  d_d.z += F(-2.0) * ch * d.z * d_a - bb * ch * o.z;
  d_o.x += bb * ah * d.x + F(2.0) * ah * o.x * d_c;
  d_o.y += bb * ah * d.y + F(2.0) * ah * o.y * d_c;
  d_o.z += -bb * ch * d.z + F(-2.0) * ch * o.z * d_c;
  gadd3(G, off + 3, d_p1);
  gadd3(G, off + 6, d_p2);
  gadd(G, off + 9, d_ah);
  gadd(G, off + 10, d_ch);
  ray_to_object_adj(off, d_o, d_d, d_ro, d_rd, G);
}

// paraboloid params: p[3], z0, z1, r.  zmin/zmax take JAX's tie rule; k and
// dpdv read them.
template <bool UV, class GradT>
__device__ void paraboloid_hit_adj(const Scene& s, int off, V3 ro, V3 rd, V3 d_p, V3 d_ng,
                                   V3 d_dpdu, float d_u, float d_v, V3& d_ro, V3& d_rd, GradT G) {
  float z0 = P(s, off + 3), z1 = P(s, off + 4), r = P(s, off + 5);
  V3 o, d;
  float t = paraboloid_t(s, off, ro, rd, o, d);
  float zmin = fminf(z0, z1), zmax = fmaxf(z0, z1);
  float rr = r * r;
  bool rr_small = fabsf(rr) < F(1e-12);
  float rr_s = rr_small ? F(1e-12) : rr;  // r * r >= 0
  float k = zmax / rr_s;
  float sxy = d.x * d.x + d.y * d.y, dxo = d.x * o.x + d.y * o.y, oxy = o.x * o.x + o.y * o.y;
  float a = k * sxy, b = F(2.0) * k * dxo - d.z, c2 = k * oxy - o.z;
  bool high = clipped_root_is_high(o, d, a, b, c2, zmin, zmax);
  V3 q = o + d * t;
  bool hz_small = fabsf(q.z) < F(1e-8);
  float hz = hz_small ? F(1e-8) : q.z;
  float dz = zmax - zmin, den = F(2.0) * hz;
  V3 dpdv = {dz * q.x / den, dz * q.y / den, dz};
  V3 d_q = {0.f, 0.f, 0.f}, d_dpdv = {0.f, 0.f, 0.f};
  quadric_tail_adj(off, q, dpdv, d_p, d_ng, d_dpdu, d_q, d_dpdv, G);
  // dpdv.xy = dz q.xy / (2 hz)
  float ax = d_dpdv.x / den, ay = d_dpdv.y / den;
  float d_dz = d_dpdv.z + ax * q.x + ay * q.y;
  d_q.x += ax * dz;
  d_q.y += ay * dz;
  if (!hz_small) d_q.z += F(2.0) * -(ax * dpdv.x + ay * dpdv.y);
  float d_vnum = 0.f, d_vden = 0.f;
  if (UV) {  // u = phi_of(q.x, q.y) / 2 pi; v = safe_div(q.z - zmin, zmax - zmin)
    phi_u_adj(q.x, q.y, d_u, d_q.x, d_q.y);
    safe_div_adj(q.z - zmin, dz, d_v, d_vnum, d_vden);
    d_q.z += d_vnum;
  }
  // q = o + d * t
  V3 d_o = d_q, d_d = d_q * t;
  float d_a = 0.f, d_b = 0.f, d_c = 0.f;
  quadratic_adj(a, b, c2, high, dot(d_q, d), d_a, d_b, d_c);
  float kk = F(2.0) * k;
  float d_k = d_a * sxy + F(2.0) * d_b * dxo + d_c * oxy;
  d_d.x += F(2.0) * k * d.x * d_a + d_b * kk * o.x;
  d_d.y += F(2.0) * k * d.y * d_a + d_b * kk * o.y;
  d_d.z -= d_b;
  d_o.x += d_b * kk * d.x + F(2.0) * k * o.x * d_c;
  d_o.y += d_b * kk * d.y + F(2.0) * k * o.y * d_c;
  d_o.z -= d_c;
  // k = zmax / (r * r), the denominator kept off 0
  float d_zmax = d_dz + d_k / rr_s, d_zmin = -d_dz, d_r = 0.f;
  if (UV) {
    d_zmax += d_vden;
    d_zmin -= d_vnum + d_vden;
  }
  if (!rr_small) d_r += F(2.0) * r * (-d_k * k / rr_s);
  float d_z0 = 0.f, d_z1 = 0.f;
  max_adj(z0, z1, d_zmax, d_z0, d_z1);
  min_adj(z0, z1, d_zmin, d_z0, d_z1);
  gadd(G, off + 3, d_z0);
  gadd(G, off + 4, d_z1);
  gadd(G, off + 5, d_r);
  ray_to_object_adj(off, d_o, d_d, d_ro, d_rd, G);
}

// ------------------------------------------------- materials, textures ----
// The adjoint of a METAL or GLASS sample (bsdf.cuh sample_material_t): the
// cotangents d_w of its weight (before the clip) and d_wi of its direction
// onto wo, sc and the material's parameters.  Forward mode: the sample's
// inputs are seeded DUAL_N at a time as tangents of a `Dual` run of the same
// code, and each output tangent is contracted with its cotangent.  The
// uniforms and the lobe choices carry none.
template <class GradT>
__device__ void material_adj(const Scene& s, const Bounce& v, V3 d_w, V3 d_wi, V3& d_wo, V3& d_sc,
                             GradT G) {
  constexpr int MAX_IN = 6 + MAX_MAT_PARAMS;
  const int n_in = 6 + material_params(v.mcat);
  float x[MAX_IN], d_in[MAX_IN];
  x[0] = v.wo.x; x[1] = v.wo.y; x[2] = v.wo.z;
  x[3] = v.sc.x; x[4] = v.sc.y; x[5] = v.sc.z;
#pragma unroll
  for (int k = 6; k < MAX_IN; ++k) x[k] = k < n_in ? P(s, v.moff + k - 6) : 0.f;
#pragma unroll
  for (int k = 0; k < MAX_IN; ++k) d_in[k] = 0.f;
  // every index below is a constant once unrolled, so the tangents stay in
  // registers rather than local memory
  for (int c0 = 0; c0 < n_in; c0 += DUAL_N) {
    Dual in[MAX_IN];
#pragma unroll
    for (int k = 0; k < MAX_IN; ++k) {
      in[k].v = x[k];
#pragma unroll
      for (int j = 0; j < DUAL_N; ++j) in[k].d[j] = k == c0 + j ? 1.f : 0.f;
    }
    Vt<Dual> wo = {in[0], in[1], in[2]}, sc = {in[3], in[4], in[5]}, wi, w;
    sample_material_t<Dual>(v.mcat, v.kind, in + 6, sc, v.u1, v.u2, v.u_lobe, wo, v.into, wi, w);
#pragma unroll
    for (int j = 0; j < DUAL_N; ++j) {
      float t = d_wi.x * wi.x.d[j] + d_wi.y * wi.y.d[j] + d_wi.z * wi.z.d[j] + d_w.x * w.x.d[j] +
                d_w.y * w.y.d[j] + d_w.z * w.z.d[j];
#pragma unroll
      for (int k = 0; k < MAX_IN; ++k)
        if (k == c0 + j) d_in[k] = t;
    }
  }
  d_wo = d_wo + V3{d_in[0], d_in[1], d_in[2]};
  d_sc = d_sc + V3{d_in[3], d_in[4], d_in[5]};
#pragma unroll
  for (int k = 6; k < MAX_IN; ++k)
    if (k < n_in) gadd(G, v.moff + k - 6, d_in[k]);
}

// The adjoint of the surface color (bsdf.cuh texture_color): the cotangent
// d_sc onto the texture row's parameters and onto the hit's u and v.  The
// checkerboards go through floor (no u, v cotangent), and Checkerboard's
// colors are constants.
template <class GradT>
__device__ void texture_adj(const Scene& s, const Bounce& v, V3 d_sc, float& d_u, float& d_v,
                            GradT G) {
  const int off = v.tex_off;
  const float u = v.h.u, w = v.h.v;
  switch (v.tcat) {
    case CHECKERBOARD: return;
    case CHECKERBOARD2: {
      float size = P(s, off + 6);
      float m = fmodf(floorf(u / size) + floorf(w / size), F(2.0));
      if (m != 0.f && m < 0.f) m += F(2.0);
      gadd3(G, m < F(0.5) ? off : off + 3, d_sc);
      return;
    }
    case BILERP: {
      float a = (F(1.0) - u) * (F(1.0) - w), b = (F(1.0) - u) * w, c = u * (F(1.0) - w), d = u * w;
      gadd3(G, off, d_sc * a);
      gadd3(G, off + 3, d_sc * b);
      gadd3(G, off + 6, d_sc * c);
      gadd3(G, off + 9, d_sc * d);
      float g00 = dot(d_sc, P3(s, off)), g01 = dot(d_sc, P3(s, off + 3));
      float g10 = dot(d_sc, P3(s, off + 6)), g11 = dot(d_sc, P3(s, off + 9));
      d_u += -g00 * (F(1.0) - w) - g01 * w + g10 * (F(1.0) - w) + g11 * w;
      d_v += -g00 * (F(1.0) - u) + g01 * (F(1.0) - u) - g10 * u + g11 * u;
      return;
    }
    case MIXF: {  // c1 (1 - t) + c2 t
      float t = P(s, off + 6);
      gadd3(G, off, d_sc * (F(1.0) - t));
      gadd3(G, off + 3, d_sc * t);
      gadd(G, off + 6, dot(d_sc, P3(s, off + 3)) - dot(d_sc, P3(s, off)));
      return;
    }
    case SCALE:
      gadd3(G, off, d_sc * P3(s, off + 3));
      gadd3(G, off + 3, d_sc * P3(s, off));
      return;
    case UVF:  // (u - floor(u), v - floor(v), 0)
      d_u += d_sc.x;
      d_v += d_sc.y;
      return;
  }
  gadd3(G, off, d_sc);  // UNIFORM_COLOR
}

// ------------------------------------------------------------- lights ----
// The adjoints of path.cuh's light samples other than AREA over a RECTANGLE
// (LIGHTS builds).  The reverse sweep replays the bounce, so `v` holds the
// sample's outer values (to_l, d2, wl, cosines, pdf, fall); the samplers'
// inner values are recomputed here from lu1, lu2 and the parameters, as the
// forward computed them, so `Bounce` holds nothing more for them.

// The band of a z-revolution shape (path.cuh lateral_band): the cotangents
// of z, rho and rho' (d_z, d_rho, d_drho) and of the band's ends onto the
// shape's parameters.
template <class GradT>
__device__ void lateral_band_adj(const Scene& s, int cat, int off, float u2, const Band& b, float d_z,
                                 float d_rho, float d_drho, float d_zmin, float d_zmax, GradT G) {
  if (cat == CONE || cat == CYLINDER) {  // zmin = 0, zmax = h
    float h = P(s, off + 3), r = P(s, off + 4), d_r, d_h = 0.f;
    if (cat == CONE) {  // rho = r (1 - z / mh); drho = -r / mh + 0 z
      float mh = fmaxf(h, F(1e-9)), t = b.z / mh;
      float d_t = -d_rho * r;
      d_r = d_rho * (F(1.0) - t) - d_drho / mh;
      d_z += d_t / mh;
      float d_mh = -d_t * t / mh + d_drho * (r / mh) / mh;
      d_h += d_mh * max_fac(h, F(1e-9));
    } else {  // rho = r + 0 z
      d_r = d_rho;
    }
    d_zmax += d_z * u2;  // z = zmin + (zmax - zmin) u2
    gadd(G, off + 3, d_h + d_zmax);
    gadd(G, off + 4, d_r);
    return;
  }
  if (cat == PARABOLOID) {
    float z0 = P(s, off + 3), z1 = P(s, off + 4), r = P(s, off + 5);
    float zmin0 = fminf(z0, z1), zmax0 = fmaxf(z0, z1), rr = r * r, mrr = fmaxf(rr, F(1e-12));
    float k = zmax0 / mrr, mk = fmaxf(k, F(1e-12)), x = b.z / mk;
    // drho = 1 / fmaxf(2 k rho, 1e-9)
    float e = F(2.0) * k * b.rho;
    float d_e = -d_drho * b.drho * b.drho * max_fac(e, F(1e-9));
    float d_k = F(2.0) * d_e * b.rho;
    d_rho += d_e * (F(2.0) * k);
    // rho = sqrtf(fmaxf(x, 1e-12)), x = z / mk
    float d_x = d_rho * (F(0.5) / b.rho) * max_fac(x, F(1e-12));
    d_z += d_x / mk;
    d_k += -d_x * x / mk * max_fac(k, F(1e-12));
    d_zmin += d_z - d_z * u2;
    d_zmax += d_z * u2;
    // the band clamped to k's side, then k = zmax0 / mrr
    float d_zmax0 = k < 0.f ? d_zmax * min_fac(zmax0, 0.f) : d_zmax;
    float d_zmin0 = k > 0.f ? d_zmin * max_fac(zmin0, 0.f) : d_zmin;
    d_zmax0 += d_k / mrr;
    float d_r = F(2.0) * r * (-d_k * k / mrr) * max_fac(rr, F(1e-12));
    float d_z0 = 0.f, d_z1 = 0.f;
    max_adj(z0, z1, d_zmax0, d_z0, d_z1);
    min_adj(z0, z1, d_zmin0, d_z0, d_z1);
    gadd(G, off + 3, d_z0);
    gadd(G, off + 4, d_z1);
    gadd(G, off + 5, d_r);
    return;
  }
  // HYPERBOLOID: the band between p1.z and p2.z
  float a = P(s, off + 5), c = P(s, off + 8), ah = P(s, off + 9), ch = P(s, off + 10);
  float ma = fmaxf(ah, F(1e-12)), cz = ch * b.z, y = (F(1.0) + cz * b.z) / ma;
  // drho = cz / fmaxf(ah rho, 1e-9)
  float e = ah * b.rho, me = fmaxf(e, F(1e-9));
  float d_cz = d_drho / me;
  float d_e = -d_drho * b.drho / me * max_fac(e, F(1e-9));
  float d_ah = d_e * b.rho;
  d_rho += d_e * ah;
  // rho = sqrtf(fmaxf(y, 1e-12)), y = (1 + cz z) / ma
  float d_y = d_rho * (F(0.5) / b.rho) * max_fac(y, F(1e-12));
  float d_num = d_y / ma;
  d_ah += -d_y * y / ma * max_fac(ah, F(1e-12));
  d_cz += d_num * b.z;
  d_z += d_num * cz + d_cz * ch;
  float d_ch = d_cz * b.z;
  d_zmin += d_z - d_z * u2;
  d_zmax += d_z * u2;
  float d_a = 0.f, d_c = 0.f;
  max_adj(a, c, d_zmax, d_a, d_c);
  min_adj(a, c, d_zmin, d_a, d_c);
  gadd(G, off + 5, d_a);
  gadd(G, off + 8, d_c);
  gadd(G, off + 9, d_ah);
  gadd(G, off + 10, d_ch);
}

// path.cuh area_sample: the cotangents of the sampled point d_pl, its normal
// d_nl and the pdf d_pdf onto the shape's parameters (offset `off`).
template <class GradT>
__device__ void area_sample_adj(const Scene& s, int cat, int off, float u1, float u2, V3 d_pl,
                                V3 d_nl, float d_pdf, GradT G) {
  gadd3(G, off, d_pl);  // the position (a cube's bmin) adds to the point
  if (cat == SPHERE) {  // p = from_object(d r) + c; n = from_object(d) reverse
    V3 fd = from_object(uniform_sphere(u1, u2));
    float r = P(s, off + 3);
    float pdf = F(1.0) / (F(4.0 * PI) * (r * r));
    gadd(G, off + 3, dot(d_pl, fd) + F(2.0) * r * (-d_pdf * pdf * pdf * F(4.0 * PI)));
    gadd(G, off + 7, dot(d_nl, fd));
    return;
  }
  if (cat == DISK) {  // p = (c.x + dx r, c.y, c.z + dy r); pdf = 1 / (pi (r^2 - ir^2))
    float dx, dy;
    concentric_disk(u1, u2, dx, dy);
    float r = P(s, off + 3), ir = P(s, off + 4), area = F(PI) * (r * r - ir * ir);
    float pdf = F(1.0) / fmaxf(area, F(1e-12));
    float d_diff = -d_pdf * pdf * pdf * max_fac(area, F(1e-12)) * F(PI);
    gadd(G, off + 3, d_pl.x * dx + d_pl.z * dy + F(2.0) * r * d_diff);
    gadd(G, off + 4, -F(2.0) * ir * d_diff);
    gadd(G, off + 8, d_nl.y);
    return;
  }
  if (cat == CUBE) {  // p = bmin + ext f; f holds u1p, the face's rescaled u1
    CubeFace c = cube_face(s, off, u1, u2);
    V3 d_ext = d_pl * c.f;
    float d_u1p = c.face < 2 ? d_pl.y * c.ext.y : d_pl.x * c.ext.x;
    // u1p = clip(w, 0, 1), w = (r - flo) / fmaxf(ffa, 1e-12)
    float m = fmaxf(c.ffa, F(1e-12));
    float d_w = d_u1p * clamp_fac(c.w, 0.f, F(1.0));
    float d_r = d_w / m, d_flo = -d_w / m;
    float d_fa = -d_w * c.w / m * max_fac(c.ffa, F(1e-12));
    // flo = the cumulative area below the face (face 0: 0 r), ffa its area
    float d_ax = 0.f, d_ay = 0.f, d_az = 0.f;
    if (c.face >= 1) d_ax += c.face == 1 ? d_flo : F(2.0) * d_flo;
    if (c.face == 3 || c.face == 5) d_ay += c.face == 3 ? d_flo : F(2.0) * d_flo;
    if (c.face == 4) d_ay += F(2.0) * d_flo;
    if (c.face == 5) d_az += d_flo;
    if (c.face < 2) d_ax += d_fa;
    else if (c.face < 4) d_ay += d_fa;
    else d_az += d_fa;
    // r = u1 area; pdf = 1 / fmaxf(area, 1e-12); area = 2 (ax + ay + az)
    float pdf = F(1.0) / fmaxf(c.area, F(1e-12));
    float d_area = d_r * u1 - d_pdf * pdf * pdf * max_fac(c.area, F(1e-12));
    d_ax += F(2.0) * d_area;
    d_ay += F(2.0) * d_area;
    d_az += F(2.0) * d_area;
    d_ext.x += d_ay * c.ext.z + d_az * c.ext.y;
    d_ext.y += d_ax * c.ext.z + d_az * c.ext.x;
    d_ext.z += d_ax * c.ext.y + d_ay * c.ext.x;
    gadd3(G, off, -d_ext);
    gadd3(G, off + 3, d_ext);
    gadd(G, off + 9, dot(d_nl, c.n));
    return;
  }
  // the lateral surface
  float phi = F(TWO_PI) * u1;
  Band b = lateral_band(s, cat, off, u2);
  float cp = cosf(phi), sp = sinf(phi);
  // p = from_object((rho cp, rho sp, z)) + pos
  V3 d_local = to_object(d_pl);
  float d_rho = d_local.x * cp + d_local.y * sp, d_z = d_local.z;
  // n = from_object(normalize((cp, sp, -rho'))) reverse
  const int roff = off + emission_offset(cat) + 3;
  V3 nraw = {cp, sp, -b.drho}, d_nraw = {0.f, 0.f, 0.f};
  gadd(G, roff, dot(d_nl, from_object(normalize(nraw))));
  normalize_adj(nraw, to_object(d_nl * P(s, roff)), d_nraw);
  float d_drho = -d_nraw.z;
  // pdf = 1 / fmaxf(2 pi (zmax - zmin) jac, 1e-12), jac = rho sqrtf(1 + rho'^2)
  float sq = sqrtf(F(1.0) + b.drho * b.drho), jac = b.rho * sq;
  float tw = F(TWO_PI) * (b.zmax - b.zmin), den = tw * jac;
  float pdf = F(1.0) / fmaxf(den, F(1e-12));
  float d_den = -d_pdf * pdf * pdf * max_fac(den, F(1e-12));
  float d_jac = d_den * tw, d_span = d_den * jac * F(TWO_PI);
  d_rho += d_jac * sq;
  d_drho += d_jac * b.rho * (b.drho / sq);
  lateral_band_adj(s, cat, off, u2, b, d_z, d_rho, d_drho, -d_span, d_span, G);
}

// The adjoint of light_sample_other from the cotangents of its radiance
// d_rad and of the light direction in the shading frame d_wll: onto the hit
// point d_p, the shading frame (d_n, d_ss, d_ts) and the light's and its
// shape's parameters.
template <class GradT>
__device__ void light_adj(const Scene& s, const Bounce& v, V3 d_rad, V3 d_wll, V3& d_p, V3& d_n,
                          V3& d_ss, V3& d_ts, GradT G) {
  const float nl = (float)s.n_light;
  const int cat = v.lcat;
  const float d_q = dot(d_rad, P3(s, v.lem)) * nl;
  float d_cos_s, d_d2, d_cos_l = 0.f, d_pdf = 0.f;
  V3 d_wl = {0.f, 0.f, 0.f};
  if (cat == AREA) {  // rad = E (cos_l cos_s / (d2 pdf_a) n_light)
    float num = v.cos_l * v.cos_s, den = v.d2 * v.pdf_a, qv = num / den;
    gadd3(G, v.lem, d_rad * (qv * nl));
    float d_num = d_q / den, d_den = -d_q * qv / den;
    d_d2 = d_den * v.pdf_a;
    d_pdf = d_den * v.d2;
    d_cos_l = d_num * v.cos_s;
    d_cos_s = d_num * v.cos_l;
  } else if (cat == POINT) {  // rad = E (cos_s / d2 n_light)
    float qv = v.cos_s / v.d2;
    gadd3(G, v.lem, d_rad * (qv * nl));
    d_cos_s = d_q / v.d2;
    d_d2 = -d_q * qv / v.d2;
  } else {  // SPOT: rad = E (fall cos_s / d2 n_light)
    float fc = v.fall * v.cos_s, qv = fc / v.d2;
    gadd3(G, v.lem, d_rad * (qv * nl));
    float d_fc = d_q / v.d2;
    d_d2 = -d_q * qv / v.d2;
    d_cos_s = d_fc * v.fall;
    float ctw = P(s, v.loff + 3), cfs = P(s, v.loff + 4), cos_t = v.wl.y;
    if (!(cos_t < ctw) && !(cos_t >= cfs)) {  // inside the band: fall = delta^4
      float span = cfs - ctw, den = fmaxf(span, F(1e-7)), delta = (cos_t - ctw) / den;
      float d_delta = F(4.0) * (delta * delta) * delta * (d_fc * v.cos_s);
      float d_num = d_delta / den;
      float d_span = -d_delta * delta / den * max_fac(span, F(1e-7));
      d_wl.y += d_num;  // cos_t = wl.y
      gadd(G, v.loff + 3, -d_num - d_span);
      gadd(G, v.loff + 4, d_span);
    }
  }
  // cos_s = fmaxf(wl . n, 0); cos_l = fmaxf(n_l . -wl, 0)
  float d_ds = d_cos_s * max_fac(dot(v.wl, v.n), 0.f);
  d_wl = d_wl + v.n * d_ds;
  d_n = d_n + v.wl * d_ds;
  V3 d_nl = {0.f, 0.f, 0.f};
  if (cat == AREA) {
    float d_dl = d_cos_l * max_fac(dot(v.n_l, -v.wl), 0.f);
    d_nl = -v.wl * d_dl;
    d_wl = d_wl - v.n_l * d_dl;
  }
  // wl = to_l * (1 / sqrtf(d2)); d2 = fmaxf(to_l . to_l, 1e-12)
  float sq = sqrtf(v.d2), inv = F(1.0) / sq;
  V3 d_tol = d_wl * inv;
  d_d2 += -dot(d_wl, v.to_l) * inv * inv * (F(0.5) / sq);
  d_tol = d_tol + v.to_l * (F(2.0) * d_d2 * max_fac(dot(v.to_l, v.to_l), F(1e-12)));
  // wl_local = world_to_local(wsh, n, ss, ts)
  V3 d_wsh = {0.f, 0.f, 0.f};
  world_to_local_adj(v.wsh, v.n, v.ss, v.ts, d_wll, d_wsh, d_n, d_ss, d_ts);
  // wsh = to_l * (1 / fmaxf(dist, 1e-12)); dist = length(to_l)
  float md = fmaxf(v.dist, F(1e-12)), inv2 = F(1.0) / md;
  d_tol = d_tol + d_wsh * inv2;
  length_adj(v.to_l, -dot(d_wsh, v.to_l) * inv2 * inv2 * max_fac(v.dist, F(1e-12)), d_tol);
  // to_l = p_l - p
  d_p = d_p - d_tol;
  if (cat == AREA) {
    area_sample_adj(s, v.lgcat, v.loff, v.lu1, v.lu2, d_tol, d_nl, d_pdf, G);
  } else {  // p_l = origin (+ uniform_sphere(lu1, lu2) radius, POINT)
    gadd3(G, v.loff, d_tol);
    if (cat == POINT) gadd(G, v.loff + 6, dot(d_tol, uniform_sphere(v.lu1, v.lu2)));
  }
}

// ------------------------------------------------------------ bounce ----
// Adjoint of `bounce` from input state `st` (whose record is `v`): takes the
// cotangents of the output ro, rd, thr in d_ro, d_rd, d_thr and replaces them
// with those of the input; adds the parameters' share to G.  MATS as in
// path.cuh: without it the scene has only matte, mirror and uniform colors;
// LIGHTS as in light_sample: with it a light other than AREA over a
// RECTANGLE takes light_adj.
template <bool MATS, bool ALL = true, bool LIGHTS = false, class GradT>
__device__ void bounce_adj(const Scene& s, const PathState& st, const Bounce& v, V3 g, V3& d_ro,
                           V3& d_rd, V3& d_thr, GradT G) {
  // e' = e + thr * contrib; thr' = thr * weight
  V3 d_contrib = g * st.thr;
  V3 d_weight = d_thr * st.thr;
  d_thr = d_thr * v.weight + g * v.contrib;
  // ro' = p + n * offs; rd' = local_to_world(wi, n, ss, ts)
  V3 d_p = d_ro, d_n = d_ro * v.offs;
  V3 d_ss = d_rd * v.wi.x, d_ts = d_rd * v.wi.y;
  d_n = d_n + d_rd * v.wi.z;
  V3 d_wi = world_to_local(d_rd, v.n, v.ss, v.ts);
  V3 d_wo = {0.f, 0.f, 0.f}, d_sc = {0.f, 0.f, 0.f}, unused = {0.f, 0.f, 0.f};
  d_ro = {0.f, 0.f, 0.f};
  d_rd = {0.f, 0.f, 0.f};

  // weight = clip01(weight_raw)
  V3 d_wr = {d_weight.x * clamp_fac(v.weight_raw.x, 0.f, F(1.0)),
             d_weight.y * clamp_fac(v.weight_raw.y, 0.f, F(1.0)),
             d_weight.z * clamp_fac(v.weight_raw.z, 0.f, F(1.0))};
  if (v.is_matte) {  // weight_raw = matte_f(kd, sigma, sc, wo, wi) * cw; wi from the RNG
    float d_kd = 0.f, d_sigma = 0.f;
    matte_f_adj(v.kd, v.sigma, v.sc, v.wo, v.wi, d_wr * v.cw, d_kd, d_sigma, d_sc, d_wo, unused);
    if (v.nee_on) {  // contrib += rad * f_light (an unoccluded light sample)
      V3 d_rad = d_contrib * v.f_light;
      V3 d_wll = {0.f, 0.f, 0.f};
      matte_f_adj(v.kd, v.sigma, v.sc, v.wo, v.wl_local, d_contrib * v.rad, d_kd, d_sigma, d_sc,
                  d_wo, d_wll);
      do {  // a LIGHTS build hands any light but AREA over a RECTANGLE to light_adj
        if constexpr (LIGHTS) {
          if (v.lcat != AREA || v.lgcat != RECTANGLE) {
            light_adj(s, v, d_rad, d_wll, d_p, d_n, d_ss, d_ts, G);
            break;
          }
        }
        // rad = E * (cos_l * cos_s / (d2 * pdf_a) * n_light)
        float nl = (float)s.n_light;
        float num = v.cos_l * v.cos_s, den = v.d2 * v.pdf_a, qv = num / den;
        gadd3(G, v.lem, d_rad * (qv * nl));
        float d_q = dot(d_rad, P3(s, v.lem)) * nl;
        float d_num = d_q / den, d_den = -d_q * qv / den;
        float d_d2 = d_den * v.pdf_a, d_pdf = d_den * v.d2;
        // cos_l = fmaxf(n_l . -wl, 0); cos_s = fmaxf(wl . n, 0)
        float d_dl = d_num * v.cos_s * max_fac(dot(v.n_l, -v.wl), 0.f);
        float d_ds = d_num * v.cos_l * max_fac(dot(v.wl, v.n), 0.f);
        V3 d_nl = -v.wl * d_dl;
        V3 d_wl = -v.n_l * d_dl + v.n * d_ds;
        d_n = d_n + v.wl * d_ds;
        // wl = to_l * (1 / sqrtf(d2)); d2 = fmaxf(to_l . to_l, 1e-12)
        float sq = sqrtf(v.d2), inv = F(1.0) / sq;
        V3 d_tol = d_wl * inv;
        d_d2 += -dot(d_wl, v.to_l) * inv * inv * (F(0.5) / sq);
        d_tol = d_tol + v.to_l * (F(2.0) * d_d2 * max_fac(dot(v.to_l, v.to_l), F(1e-12)));
        // wl_local = world_to_local(wsh, n, ss, ts)
        V3 d_wsh = {0.f, 0.f, 0.f};
        world_to_local_adj(v.wsh, v.n, v.ss, v.ts, d_wll, d_wsh, d_n, d_ss, d_ts);
        // wsh = to_l * (1 / fmaxf(dist, 1e-12)); dist = length(to_l)
        float md = fmaxf(v.dist, F(1e-12)), inv2 = F(1.0) / md;
        d_tol = d_tol + d_wsh * inv2;
        length_adj(v.to_l, -dot(d_wsh, v.to_l) * inv2 * inv2 * max_fac(v.dist, F(1e-12)), d_tol);
        // to_l = p_l - p; p_l = bmin + ex * lu1 + ey * lu2
        d_p = d_p - d_tol;
        gadd3(G, v.loff, d_tol);
        V3 d_ex = d_tol * v.lu1, d_ey = d_tol * v.lu2;
        // pdf_a = 1 / fmaxf(length(ex) * length(ey), 1e-12)
        float lx = length(v.lf.ex), ly = length(v.lf.ey), pr = lx * ly;
        float d_pr = -d_pdf * v.pdf_a * v.pdf_a * max_fac(pr, F(1e-12));
        length_adj(v.lf.ex, d_pr * ly, d_ex);
        length_adj(v.lf.ey, d_pr * lx, d_ey);
        // n_l = frame n * reverse
        gadd(G, v.loff + 9, dot(d_nl, v.lf.n));
        V3 zero = {0.f, 0.f, 0.f};
        rect_frame_adj(v.loff, v.lf, d_ex, d_ey, d_nl * P(s, v.loff + 9), zero, zero, G);
      } while (false);
    }
    gadd(G, v.moff, d_kd);
    gadd(G, v.moff + 1, d_sigma);
  } else if (!MATS || v.mcat == MIRROR) {  // weight_raw = sc * kr; wi = (-wo.x, -wo.y, wo.z)
    float kr = P(s, v.moff);
    d_sc = d_sc + d_wr * kr;
    gadd(G, v.moff, dot(d_wr, v.sc));
    d_wo = d_wo + V3{-d_wi.x, -d_wi.y, d_wi.z};
  } else {
    material_adj(s, v, d_wr, d_wi, d_wo, d_sc, G);
  }
  if (v.emit_on) gadd3(G, v.eoff, d_contrib);
  float d_u = 0.f, d_v = 0.f;
  if (!v.h.use_sc) {  // Cornell walls: constant color
    if (MATS) texture_adj(s, v, d_sc, d_u, d_v, G);
    else gadd3(G, v.tex_off, d_sc);
  }

  // wo = world_to_local(-rd, n, ss, ts)
  V3 d_mrd = {0.f, 0.f, 0.f};
  world_to_local_adj(-st.rd, v.n, v.ss, v.ts, d_wo, d_mrd, d_n, d_ss, d_ts);
  d_rd = d_rd - d_mrd;
  // ts = cross(n, ss); ss = normalize(ss2); ss2 = ss1 - n (ss1 . n); ss1 = normalize(a)
  cross_adj(v.n, v.ss, d_ts, d_n, d_ss);
  V3 d_ss2 = {0.f, 0.f, 0.f}, d_a = {0.f, 0.f, 0.f};
  normalize_adj(v.ss2, d_ss, d_ss2);
  float kk = dot(v.ss1, v.n), d_kk = -dot(d_ss2, v.n);
  V3 d_ss1 = d_ss2 + v.n * d_kk;
  d_n = d_n - d_ss2 * kk + v.ss1 * d_kk;
  normalize_adj(v.a, d_ss1, d_a);
  V3 d_dpdu = {0.f, 0.f, 0.f};
  if (v.dpdu_ok) {
    d_dpdu = d_a;
  } else if (fabsf(v.n.x) > F(1e-5) || fabsf(v.n.y) > F(1e-5)) {  // ortho(n) = (n.y, -n.x, 0)
    d_n.y += d_a.x;
    d_n.x -= d_a.y;
  } else {  // ortho(n) = (0, n.z, -n.y)
    d_n.z += d_a.y;
    d_n.y -= d_a.z;
  }
  V3 d_ng = v.into ? d_n : -d_n;  // n = into ? ng : -ng

  const int cat = obj_cat(s, v.obj);
  const V3 ro = st.ro, rd = st.rd;
  if constexpr (!ALL) {  // path.cuh's ALL: the benchmark scenes' three shapes
    if (cat == SPHERE)
      sphere_hit_adj<MATS>(s, v.off, ro, rd, d_p, d_ng, d_dpdu, d_u, d_v, d_ro, d_rd, G);
    else if (cat == RECTANGLE)
      rect_hit_adj<MATS>(s, v.off, ro, rd, d_p, d_ng, d_dpdu, d_u, d_v, d_ro, d_rd, G);
    else
      box_hit_adj<MATS>(s, v.off, false, ro, rd, d_p, d_u, d_v, d_ro, d_rd, G);
    return;
  }
  switch (cat) {
    case SPHERE: sphere_hit_adj<MATS>(s, v.off, ro, rd, d_p, d_ng, d_dpdu, d_u, d_v, d_ro, d_rd, G); break;
    case RECTANGLE: rect_hit_adj<MATS>(s, v.off, ro, rd, d_p, d_ng, d_dpdu, d_u, d_v, d_ro, d_rd, G); break;
    case CUBE: case CORNELLBOX:
      box_hit_adj<MATS>(s, v.off, cat == CUBE, ro, rd, d_p, d_u, d_v, d_ro, d_rd, G);
      break;
    case CONE: case CYLINDER:
      frustum_hit_adj<MATS>(s, v.off, cat == CONE, ro, rd, d_p, d_ng, d_dpdu, d_u, d_v, d_ro, d_rd, G);
      break;
    case DISK: disk_hit_adj<MATS>(s, v.off, ro, rd, d_p, d_dpdu, d_u, d_v, d_ro, d_rd, G); break;
    case HYPERBOLOID:
      hyperboloid_hit_adj<MATS>(s, v.off, ro, rd, d_p, d_ng, d_dpdu, d_u, d_v, d_ro, d_rd, G);
      break;
    case PARABOLOID:
      paraboloid_hit_adj<MATS>(s, v.off, ro, rd, d_p, d_ng, d_dpdu, d_u, d_v, d_ro, d_rd, G);
      break;
  }
}

// ------------------------------------------------------------- pixel ----
// What the forward sweep records of a bounce besides its input state: the
// discrete decisions of the closest-hit fold and the shadow scan, which carry
// no cotangent (8 bytes).  The reverse sweep replays them (path.cuh `bounce`
// with REPLAY): it never runs `closest` or `occluded`.
struct Decision {
  int obj;   // the winner's table row
  bool occ;  // the shadow ray was blocked
};

// The phases a profiling build of K2 strips (csrc/profile_grad.cu), a bit mask
// and a template parameter of `sample_grad`, 0 in K2.  GRAD_NO_ADJOINT: the
// reverse sweep replays each bounce and applies no adjoint; GRAD_NO_REPLAY
// (with it): no reverse sweep at all.  A stripped build adds to G[0] the
// sample's g . radiance from the forward sweep; without the adjoint, the
// replay adds to G[1] the replayed bounces whose output state is not the
// recorded one (0 when replay holds), and to G[2] g . radiance again from the
// replayed bounces (thr . contrib, last bounce first), so that no part of a
// replayed bounce is dead code.
constexpr int GRAD_NO_ADJOINT = 1, GRAD_NO_REPLAY = 2;

__device__ __forceinline__ bool same_state(const PathState& a, const PathState& b) {
  return a.ro.x == b.ro.x && a.ro.y == b.ro.y && a.ro.z == b.ro.z && a.rd.x == b.rd.x &&
         a.rd.y == b.rd.y && a.rd.z == b.rd.z && a.thr.x == b.thr.x && a.thr.y == b.thr.y &&
         a.thr.z == b.thr.z && a.skip_emission == b.skip_emission;
}

// camera: ro = eye; rd = normalize(dir), dir = right sx + up sy - back,
// sx = ndc_x tan_half aspect, sy = ndc_y tan_half (camera_dir).
template <class GradT>
__device__ __forceinline__ void camera_adj(const Scene& s, const Camera& c, V3 dir, float ndc_x,
                                           float ndc_y, float sx, float sy, V3 d_ro, V3 d_rd,
                                           GradT G) {
  const int cam = s.cam;
  gadd3(G, cam, d_ro);
  V3 d_dir = {0.f, 0.f, 0.f};
  normalize_adj(dir, d_rd, d_dir);
  gadd3(G, cam + 3, d_dir * sx);
  gadd3(G, cam + 6, d_dir * sy);
  gadd3(G, cam + 9, -d_dir);
  float d_sx = dot(d_dir, c.right), d_sy = dot(d_dir, c.up);
  gadd(G, cam + 12, d_sx * ndc_x * c.aspect + d_sy * ndc_y);
  gadd(G, cam + 13, d_sx * (ndc_x * c.tan_half));
}

// Adds d(g . radiance)/d(params) of one sample of pixel (row, col) to G.
// The forward sweep runs K1's bounce and stores each bounce's input state and
// decisions; the reverse sweep replays bounce b from them (the same values as
// the forward sweep's, bit for bit) and applies its adjoint; then the
// camera's.  Every thread of the block calls it (`inside` false past the
// image's edge: such a thread traces nothing and adds nothing), and both
// sweeps step their bounces in lock step across the block: a barrier
// (__syncthreads_or) before each bounce, which also ends a sweep once no
// thread of the block has a bounce left.  The warps then run the same phase
// of the same bounce together, so they share the instruction cache; left to
// drift apart over a pixel's samples, they ran K2 at a third of this speed
// on configs 2 and 3 (an H100).  A thread's own values and the order of its
// adds do not depend on the barriers.
template <bool MATS, int STRIP = 0, bool ALL = true, bool LIGHTS = false, class GradT>
__device__ void sample_grad(const Scene& s, const Camera& c, V3 g, uint32_t seed, uint32_t sample,
                            int max_bounces, uint32_t row, uint32_t col, float sx_scale,
                            float sy_scale, bool inside, GradT G) {
  const float fcol = (float)col, frow = (float)(int)row;
  PathState states[MAX_GRAD_BOUNCES];
  Decision decided[MAX_GRAD_BOUNCES];
  float jx, jy, unused, ndc_x, ndc_y, sx, sy;
  uniform3(stream_id(seed, sample, 0, TAG_PIXEL_JITTER), row, col, jx, jy, unused);
  V3 dir = camera_dir(c, fcol, frow, jx, jy, sx_scale, sy_scale, ndc_x, ndc_y, sx, sy);
  PathState st;
  st.rd = normalize(dir);
  st.ro = c.eye;
  st.thr = {1.f, 1.f, 1.f};
  st.skip_emission = false;
  V3 e = {0.f, 0.f, 0.f};
  int nb = 0;  // bounces that hit: the ones with a share in the radiance
  bool alive = inside;
  for (int b = 0; b < max_bounces; ++b) {
    if (!__syncthreads_or(alive)) break;
    if (!alive) continue;
    states[b] = st;
    Bounce v;
    if (!bounce<ALL, true, MATS, 0, false, LIGHTS>(s, st, e, seed, sample, b, row, col, v)) {
      alive = false;  // a miss
      continue;
    }
    decided[b] = {v.obj, v.occ};
    nb = b + 1;
    alive = max_component(st.thr) > 0.f;  // a dead path adds nothing more
  }
  if constexpr (STRIP != 0) gadd(G, 0, dot(g, e));
  if constexpr ((STRIP & GRAD_NO_REPLAY) != 0) return;
  // Nothing after the last hit bounce reads its output state.
  V3 d_ro = {0.f, 0.f, 0.f}, d_rd = {0.f, 0.f, 0.f}, d_thr = {0.f, 0.f, 0.f};
  for (int b = max_bounces - 1; b >= 0; --b) {
    if (!__syncthreads_or(b < nb) || b >= nb) continue;
    PathState again = states[b];
    Bounce v;
    v.obj = decided[b].obj;
    v.occ = decided[b].occ;
    bounce<ALL, true, MATS, 0, true, LIGHTS>(s, again, e, seed, sample, b, row, col, v);
    if constexpr ((STRIP & GRAD_NO_ADJOINT) != 0) {
      gadd(G, 1, same_state(again, b + 1 < nb ? states[b + 1] : st) ? 0.f : F(1.0));
      gadd(G, 2, dot(g, states[b].thr * v.contrib));
    } else {
      bounce_adj<MATS, ALL, LIGHTS>(s, states[b], v, g, d_ro, d_rd, d_thr, G);
    }
  }
  if constexpr (STRIP == 0)
    if (inside) camera_adj(s, c, dir, ndc_x, ndc_y, sx, sy, d_ro, d_rd, G);
}

}  // namespace
