// KP's per-pixel work: the penumbra edge term of one pixel, its detached
// coefficients and the adjoint of its curve points, in registers.
// penumbra.cu launches it one thread a pixel; csrc/host/edge_host.cpp runs
// it on the CPU.  The plain version is `ops/cuda/penumbra.py`
// `penumbra_scalar_plain` (the JAX package's
// `sail_tpu/diff/boundary.py:773` `shadow_boundary_term`), whose float32
// operations the forward here follows one by one.
//
// For receiver r at the pixel (its point x), occluding sphere (c, radius)
// and rectangle light (bmin, frame ex, ey, n_l), sample k of K on the
// sphere's tangent circle seen from x projects onto the light's plane at
//
//   w = c - x, d = |w|, ŵ = w / max(d, 1e-9),
//   ratio = clip(radius / max(d, 1e-9), 0, 1 - 1e-6),
//   ρ = radius · sqrt(max(1 - ratio², 1e-12)), m = c - ŵ · (radius · ratio),
//   e1 = normalize(ortho(ŵ)), e2 = ŵ × e1,
//   s_k = m + (e1 cos φ_k + e2 sin φ_k) · ρ,
//   λ_k = ((bmin - x)·n_l) / guard((s_k - x)·n_l), y_k = x + (s_k - x) λ_k
//
// (`curve_points`).  The term is Σ coeff_k · (n̂_k · y_k) with coeff_k and
// n̂_k detached: coeff_k = -(h_k · dl_k) where the sample is valid (the
// receiver a matte surface, y_k on the light, in front of both, the sphere
// not the receiver and x outside it), h_k the unoccluded NEE integrand
// times the loss adjoint, dl_k half the length of y_{k+1} - y_{k-1}, and
// n̂_k the light-plane normal of that tangent, turned away from the
// sphere's center projected from x.  Its gradient with respect to c,
// radius and x is the adjoint of y_k, written out below: per sample, then
// once per (pixel, receiver, pair) for what the samples share.  It follows
// autograd's rules at the three places where they choose: a clip at a tie
// passes half the gradient (torch.maximum / minimum, JAX's jnp.clip), the
// |denominator| < 1e-9 guard passes none, and `ortho`'s branch is taken as
// the value took it.
#pragma once

#include "path.cuh"

namespace {

// floats per receiver plane set (n, ss, ts, wo, surface color, tint) and per
// light (bmin, ex, ey, n_l, n_l · reverse, emission, max(|ex|², 1e-12),
// max(|ey|², 1e-12))
constexpr int KP_PLANES = 18;
constexpr int KP_LIGHT = 20;

struct KPIn {
  const float* x;          // (R, 3, hw) receiver points
  const float* planes;     // (R, KP_PLANES, hw)
  const int* ints;         // (R, 2, hw): material row (-1: no receiver), object id
  const float* dl;         // (3, hw) loss adjoint
  const float* mats;       // (n_mat, 2): kd, sigma
  const float* spheres;    // (S, 4): center, radius
  const int* sphere_obj;   // (S) scene index
  const float* lights;     // (L, KP_LIGHT)
  const int* light_obj;    // (L) the light's rectangle's scene index
  const float* cs;         // (2, K): cos φ_k, sin φ_k
  int R, S, L, K;
  long long hw;
};

// d clip(x, lo) / dx and d clip(x, lo, hi) / dx as autograd takes them
// through maximum and minimum: half at a tie.
__device__ __forceinline__ float max_grad(float x, float lo) {
  return x > lo ? F(1.0) : (x == lo ? F(0.5) : 0.f);
}
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  const float m = fmaxf(x, lo);
  return max_grad(x, lo) * (m < hi ? F(1.0) : (m == hi ? F(0.5) : 0.f));
}

__device__ __forceinline__ V3 ld3(const float* p, long long stride) {
  return {__ldg(p), __ldg(p + stride), __ldg(p + 2 * stride)};
}

// What the samples of one (pixel, receiver, sphere) share, with what its
// adjoint reads.
struct Occluder {
  V3 w, w_hat, o, e1, e2, m;
  float d, dc, rr, ratio, qq, sq, rho, inv_o, oo;
  bool big;
};

__device__ __forceinline__ Occluder occluder(V3 c, float radius, V3 x) {
  Occluder g;
  g.w = c - x;
  g.d = length(g.w);
  g.dc = fmaxf(g.d, F(1e-9));
  g.w_hat = g.w * (F(1.0) / g.dc);
  g.rr = radius / g.dc;
  g.ratio = clampf(g.rr, 0.f, F(1.0 - 1e-6));
  g.qq = F(1.0) - g.ratio * g.ratio;
  g.sq = sqrtf(fmaxf(g.qq, F(1e-12)));
  g.rho = radius * g.sq;
  g.m = c - g.w_hat * (radius * g.ratio);
  g.big = fabsf(g.w_hat.x) > F(1e-5) || fabsf(g.w_hat.y) > F(1e-5);
  g.o = ortho(g.w_hat);
  g.oo = dot(g.o, g.o);
  g.inv_o = F(1.0) / sqrtf(fmaxf(g.oo, F(1e-20)));
  g.e1 = g.o * g.inv_o;
  g.e2 = cross(g.w_hat, g.e1);
  return g;
}

// One curve point y_k and what its adjoint reads.
struct CurvePt {
  V3 s, y;
  float lam, den;
  bool guard;
};

__device__ __forceinline__ CurvePt curve_pt(const Occluder& g, float ck, float sk, V3 x, V3 nl,
                                            float num) {
  CurvePt q;
  q.s = g.m + (g.e1 * ck + g.e2 * sk) * g.rho;
  const float denom = dot(q.s - x, nl);
  q.guard = fabsf(denom) < F(1e-9);
  q.den = q.guard ? F(1e-9) : denom;
  q.lam = num / q.den;
  q.y = x + (q.s - x) * q.lam;
  return q;
}

// The per-pixel term: for each receiver, sphere and light, the K samples.
// Adds the pixel's share of Σ coeff · (n̂ · y) to acc[0] and its gradient
// with respect to sphere j's center and radius to acc[1 + 4 j ...]
// (acc[i * stride]), and writes its gradient with respect to each
// receiver's point to gx (R, 3, hw) at pixel p.
__device__ __forceinline__ void penumbra_pixel(const KPIn& in, long long p, float* acc,
                                               int stride, float* gx) {
  const long long hw = in.hw;
  const V3 dl = ld3(in.dl + p, hw);
  for (int r = 0; r < in.R; ++r) {
    V3 xb = {0.f, 0.f, 0.f};
    const int mat = __ldg(in.ints + (2LL * r) * hw + p);
    if (mat >= 0) {
      const int obj = __ldg(in.ints + (2LL * r + 1) * hw + p);
      const V3 x = ld3(in.x + 3LL * r * hw + p, hw);
      const float* pl = in.planes + (long long)KP_PLANES * r * hw + p;
      const V3 n = ld3(pl, hw), ss = ld3(pl + 3 * hw, hw), ts = ld3(pl + 6 * hw, hw),
               wo = ld3(pl + 9 * hw, hw), sc = ld3(pl + 12 * hw, hw),
               tint = ld3(pl + 15 * hw, hw);
      const float kd = __ldg(in.mats + 2 * mat), sigma = __ldg(in.mats + 2 * mat + 1);
      for (int j = 0; j < in.S; ++j) {
        const int sobj = __ldg(in.sphere_obj + j);
        const V3 c = ld3(in.spheres + 4 * j, 1);
        const float radius = __ldg(in.spheres + 4 * j + 3);
        const Occluder g = occluder(c, radius, x);
        const bool pair_ok = obj != sobj && g.d > radius * F(1.0 + 1e-4);
        float value = 0.f, rho_b = 0.f;
        V3 m_b = {0.f, 0.f, 0.f}, e1_b = m_b, e2_b = m_b, x_b = m_b;
        bool any = false;
        for (int l = 0; l < in.L && pair_ok; ++l) {
          if (__ldg(in.light_obj + l) == sobj) continue;  // a light does not shadow itself
          const float* lp = in.lights + KP_LIGHT * l;
          const V3 bmin = ld3(lp, 1), ex = ld3(lp + 3, 1), ey = ld3(lp + 6, 1),
                   nl = ld3(lp + 9, 1), nrev = ld3(lp + 12, 1), le = ld3(lp + 15, 1);
          const float exl2 = __ldg(lp + 18), eyl2 = __ldg(lp + 19);
          const float num = dot(bmin - x, nl);
          // the sphere's center projected from x: the side n̂ turns from
          const float den_c = dot(c - x, nl);
          const float lam_c = num / (fabsf(den_c) < F(1e-9) ? F(1e-9) : den_c);
          const V3 y_c = x + (c - x) * lam_c;
          const int K = in.K;
          CurvePt prev = curve_pt(g, __ldg(in.cs + K - 1), __ldg(in.cs + 2 * K - 1), x, nl, num);
          CurvePt cur = curve_pt(g, __ldg(in.cs), __ldg(in.cs + K), x, nl, num);
          const V3 y0 = cur.y;
          float num_b = 0.f;
          for (int k = 0; k < K; ++k) {
            CurvePt nxt;
            if (k + 1 < K)
              nxt = curve_pt(g, __ldg(in.cs + k + 1), __ldg(in.cs + K + k + 1), x, nl, num);
            else
              nxt.y = y0;
            // -- the detached coefficient (the plain version's no_grad pass)
            const V3 rel = cur.y - bmin;
            const float u_r = dot(rel, ex) / exl2, v_r = dot(rel, ey) / eyl2;
            const V3 to_y = cur.y - x;
            const float d2 = fmaxf(dot(to_y, to_y), F(1e-12));
            const V3 wi = to_y * (F(1.0) / sqrtf(d2));
            const float cos_s = dot(wi, n), cos_l = dot(-wi, nrev);
            const bool valid = u_r >= 0.f && u_r <= F(1.0) && v_r >= 0.f && v_r <= F(1.0) &&
                               cur.lam > F(1.0 + 1e-4) && cos_s > 0.f && cos_l > 0.f;
            if (valid) {
              const V3 wl = world_to_local(wi, n, ss, ts);
              const V3 f = wo.z * wl.z > F(1e-5) ? matte_f(kd, sigma, sc, wo, wl)
                                                 : V3{0.f, 0.f, 0.f};
              const float h = (dl.x * tint.x * le.x * f.x + dl.y * tint.y * le.y * f.y +
                               dl.z * tint.z * le.z * f.z) *
                              (cos_s * cos_l / d2);
              const V3 tx = nxt.y - prev.y;
              const float arc = F(0.5) * length(tx);
              V3 n_hat = cross(nrev, tx);
              n_hat = n_hat * (F(1.0) / fmaxf(length(n_hat), F(1e-12)));
              const float side = dot(cur.y - y_c, n_hat);
              n_hat = n_hat * (side > 0.f ? F(1.0) : (side < 0.f ? F(-1.0) : 0.f));
              const float coeff = -(h * arc);
              value = value + coeff * dot(n_hat, cur.y);
              // -- the adjoint of y_k = x + (s_k - x) λ_k, seeded coeff · n̂
              const V3 yb = n_hat * coeff;
              const V3 sx = cur.s - x;
              const float lam_b = dot(yb, sx);
              V3 s_b = yb * cur.lam;
              x_b = x_b + (yb - yb * cur.lam);
              num_b = num_b + lam_b / cur.den;
              if (!cur.guard) {
                const float den_b = -(lam_b * cur.lam / cur.den);
                s_b = s_b + nl * den_b;
                x_b = x_b - nl * den_b;
              }
              const float ck = __ldg(in.cs + k), sk = __ldg(in.cs + K + k);
              m_b = m_b + s_b;
              e1_b = e1_b + s_b * (ck * g.rho);
              e2_b = e2_b + s_b * (sk * g.rho);
              rho_b = rho_b + dot(s_b, g.e1 * ck + g.e2 * sk);
              any = true;
            }
            prev = cur;
            cur = nxt;
          }
          // num = (bmin - x) · n_l
          x_b = x_b - nl * num_b;
        }
        if (!any) continue;
        // -- the adjoint of what the samples share ----------------------------
        V3 c_b = m_b;  // m = c - ŵ (radius · ratio)
        // e2 = ŵ × e1
        V3 wh_b = cross(g.e1, e2_b);
        e1_b = e1_b + cross(e2_b, g.w_hat);
        // e1 = o / sqrt(max(o·o, 1e-20))
        const float inv_b = dot(e1_b, g.o);
        V3 o_b = e1_b * g.inv_o;
        const float oo_b =
            inv_b * (F(-0.5) * g.inv_o * g.inv_o * g.inv_o) * max_grad(g.oo, F(1e-20));
        o_b = o_b + g.o * (F(2.0) * oo_b);
        if (g.big) {  // o = (ŵy, -ŵx, 0)
          wh_b.y = wh_b.y + o_b.x;
          wh_b.x = wh_b.x - o_b.y;
        } else {  // o = (0, ŵz, -ŵy)
          wh_b.z = wh_b.z + o_b.y;
          wh_b.y = wh_b.y - o_b.z;
        }
        wh_b = wh_b - m_b * (radius * g.ratio);
        const float t_b = -dot(m_b, g.w_hat);
        float radius_b = t_b * g.ratio;
        float ratio_b = t_b * radius;
        // ρ = radius · sqrt(max(1 - ratio², 1e-12))
        radius_b = radius_b + rho_b * g.sq;
        const float qq_b = rho_b * radius * (F(0.5) / g.sq) * max_grad(g.qq, F(1e-12));
        ratio_b = ratio_b - F(2.0) * g.ratio * qq_b;
        // ratio = clip(radius / dc, 0, 1 - 1e-6)
        const float rr_b = ratio_b * clip_grad(g.rr, 0.f, F(1.0 - 1e-6));
        radius_b = radius_b + rr_b / g.dc;
        float dc_b = -(rr_b * radius / (g.dc * g.dc));
        // ŵ = w · (1 / dc)
        const float iv = F(1.0) / g.dc;
        V3 w_b = wh_b * iv;
        dc_b = dc_b - dot(wh_b, g.w) * (iv * iv);
        // dc = max(d, 1e-9), d = sqrt(max(w·w, 1e-20))
        const float d_b = dc_b * max_grad(g.d, F(1e-9));
        w_b = w_b + g.w * (d_b / g.d * max_grad(dot(g.w, g.w), F(1e-20)));
        // w = c - x
        c_b = c_b + w_b;
        x_b = x_b - w_b;
        xb = xb + x_b;
        acc[0] += value;
        acc[(1 + 4 * j) * stride] += c_b.x;
        acc[(2 + 4 * j) * stride] += c_b.y;
        acc[(3 + 4 * j) * stride] += c_b.z;
        acc[(4 + 4 * j) * stride] += radius_b;
      }
    }
    float* gp = gx + 3LL * r * hw + p;
    gp[0] = xb.x;
    gp[hw] = xb.y;
    gp[2 * hw] = xb.z;
  }
}

}  // namespace
