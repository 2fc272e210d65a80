// Materials and textures of the render megakernels: the Fresnel terms, the
// two microfacet distributions (Beckmann, Trowbridge-Reitz/GGX; isotropic or
// not), the metal and glass samples, and the uv textures.  Device code for
// K1 and K2, included by path.cuh inside its namespace (it uses path.cuh's
// constants and fastmath polynomial).
//
// The metal and glass code is written once over a scalar type T: `float` in
// K1 and in K2's forward sweep, with the plain torch version's operations in
// its order (ops/bsdf.py), so K1 stays bit-identical to it; and `Dual` in
// K2's adjoint, a value with DUAL_N tangents whose arithmetic carries the
// derivatives by hand-written rules (JAX's: 0.5 to each side of a max or min
// at a tie, sign(x) for |x| with 0 at 0, nothing through a comparison or a
// floor).  K2 seeds the tangents with the sample's inputs a few at a time
// and contracts the outputs' tangents with their cotangents
// (adjoint.cuh `material_adj`).  Where the torch version computes two
// branches and selects one by value, this code computes only the selected
// one: the same values, and no 0 x inf from the other branch's derivative.
#pragma once

// ------------------------------------------------------------ dual numbers --
constexpr int DUAL_N = 4;  // tangents per evaluation

struct Dual {
  float v;
  float d[DUAL_N];
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(float x) : v(x) {
    for (int i = 0; i < DUAL_N; ++i) d[i] = 0.f;
  }
};

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(const Dual& x) { return x.v; }

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
  for (int i = 0; i < DUAL_N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
__device__ __forceinline__ Dual operator+(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v + b;
  return r;
}
__device__ __forceinline__ Dual operator+(float a, const Dual& b) {
  Dual r = b;
  r.v = a + b.v;
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a) {
  Dual r;
  r.v = -a.v;
  for (int i = 0; i < DUAL_N; ++i) r.d[i] = -a.d[i];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
  for (int i = 0; i < DUAL_N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v - b;
  return r;
}
__device__ __forceinline__ Dual operator-(float a, const Dual& b) {
  Dual r = -b;
  r.v = a - b.v;
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
  for (int i = 0; i < DUAL_N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, float b) {
  Dual r;
  r.v = a.v * b;
  for (int i = 0; i < DUAL_N; ++i) r.d[i] = a.d[i] * b;
  return r;
}
__device__ __forceinline__ Dual operator*(float a, const Dual& b) { return b * a; }
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
  for (int i = 0; i < DUAL_N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) / b.v;
  return r;
}
__device__ __forceinline__ Dual operator/(const Dual& a, float b) {
  Dual r;
  r.v = a.v / b;
  for (int i = 0; i < DUAL_N; ++i) r.d[i] = a.d[i] / b;
  return r;
}
__device__ __forceinline__ Dual operator/(float a, const Dual& b) {
  Dual r;
  r.v = a / b.v;
  for (int i = 0; i < DUAL_N; ++i) r.d[i] = -r.v * b.d[i] / b.v;
  return r;
}
// y = f(x) with f'(x) = g: y.d = x.d * g
__device__ __forceinline__ Dual chain(const Dual& x, float y, float g) {
  Dual r;
  r.v = y;
  for (int i = 0; i < DUAL_N; ++i) r.d[i] = x.d[i] * g;
  return r;
}

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ float m_max(float x, float c) { return fmaxf(x, c); }
__device__ __forceinline__ float m_min(float x, float c) { return fminf(x, c); }

__device__ __forceinline__ Dual m_sqrt(const Dual& x) {
  float y = sqrtf(x.v);
  return chain(x, y, F(0.5) / y);
}
__device__ __forceinline__ Dual m_exp(const Dual& x) {
  float y = expf(x.v);
  return chain(x, y, y);
}
__device__ __forceinline__ Dual m_log(const Dual& x) { return chain(x, logf(x.v), F(1.0) / x.v); }
__device__ __forceinline__ Dual m_sin(const Dual& x) { return chain(x, sinf(x.v), cosf(x.v)); }
__device__ __forceinline__ Dual m_cos(const Dual& x) { return chain(x, cosf(x.v), -sinf(x.v)); }
__device__ __forceinline__ Dual m_abs(const Dual& x) {
  return chain(x, fabsf(x.v), x.v > 0.f ? 1.f : (x.v < 0.f ? -1.f : 0.f));
}
// max / min against a constant bound c; at a tie half the derivative
__device__ __forceinline__ Dual m_max(const Dual& x, float c) {
  return chain(x, fmaxf(x.v, c), x.v > c ? 1.f : (x.v == c ? F(0.5) : 0.f));
}
__device__ __forceinline__ Dual m_min(const Dual& x, float c) {
  return chain(x, fminf(x.v, c), x.v < c ? 1.f : (x.v == c ? F(0.5) : 0.f));
}
template <class T>
__device__ __forceinline__ T m_clamp(const T& x, float lo, float hi) {
  return m_min(m_max(x, lo), hi);
}

// ------------------------------------------------------- generic vectors --
template <class T>
struct Vt {
  T x, y, z;
};
template <class T>
__device__ __forceinline__ Vt<T> operator+(const Vt<T>& a, const Vt<T>& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <class T>
__device__ __forceinline__ Vt<T> operator-(const Vt<T>& a, const Vt<T>& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <class T>
__device__ __forceinline__ Vt<T> operator-(const Vt<T>& a) {
  return {-a.x, -a.y, -a.z};
}
template <class T>
__device__ __forceinline__ Vt<T> operator*(const Vt<T>& a, const Vt<T>& b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
template <class T, class S>
__device__ __forceinline__ Vt<T> operator*(const Vt<T>& a, const S& s) {
  return {a.x * s, a.y * s, a.z * s};
}
template <class T>
__device__ __forceinline__ T vdot(const Vt<T>& a, const Vt<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <class T>
__device__ __forceinline__ Vt<T> vnormalize(const Vt<T>& a) {
  return a * (F(1.0) / m_sqrt(m_max(vdot(a, a), F(1e-20))));
}
template <class T>
__device__ __forceinline__ Vt<T> vzero() {
  return {T(0.f), T(0.f), T(0.f)};
}
__device__ __forceinline__ Vt<float> to_vt(V3 a) { return {a.x, a.y, a.z}; }
__device__ __forceinline__ V3 to_v3(const Vt<float>& a) { return {a.x, a.y, a.z}; }

// -------------------------------------------------- shading-space trig ----
template <class T>
__device__ __forceinline__ T sin_theta_t(const Vt<T>& w) {
  return m_sqrt(m_max(m_max(F(1.0) - w.z * w.z, 0.f), F(1e-12)));
}
template <class T>
__device__ __forceinline__ T cos2_phi_t(const Vt<T>& w) {
  T s = sin_theta_t(w);
  if (fabsf(val(s)) < F(1e-3)) return T(F(1.0));
  T c = m_clamp(w.x / (val(s) == 0.f ? T(F(1.0)) : s), F(-1.0), F(1.0));
  return c * c;
}
template <class T>
__device__ __forceinline__ T sin2_phi_t(const Vt<T>& w) {
  T s = sin_theta_t(w);
  if (fabsf(val(s)) < F(1e-3)) return T(0.f);
  T c = m_clamp(w.y / (val(s) == 0.f ? T(F(1.0)) : s), F(-1.0), F(1.0));
  return c * c;
}

// ------------------------------------------------------------ fastmath ----
template <class T>
__device__ __forceinline__ T atan_poly_t(const T& t) {
  T t2 = t * t;
  T p = F(-0.0117212) * t2 + F(0.05265332);
  p = p * t2 + F(-0.11643287);
  p = p * t2 + F(0.19354346);
  p = p * t2 + F(-0.33262347);
  p = p * t2 + F(0.99997726);
  return t * p;
}
// fastmath.atan: the polynomial on |x| <= 1, reflected above
template <class T>
__device__ __forceinline__ T atan_t(const T& x) {
  if (!(fabsf(val(x)) > 1.f)) return atan_poly_t(x);
  T r = atan_poly_t(F(1.0) / x);
  return (val(x) >= 0.f ? F(PI_2) : F(-PI_2)) - r;
}
// fastmath.tan of a constant: sin / cos, the cosine kept off 0
__device__ __forceinline__ float tan_sc(float x) {
  float c = cosf(x);
  return sinf(x) / (fabsf(c) < F(1e-20) ? F(1e-20) : c);
}

// ------------------------------------------------------------- Fresnel ----
template <class T>
__device__ T fr_dielectric_t(const T& cos_theta_i, const T& eta_i, const T& eta_t) {
  T cos_i = m_clamp(cos_theta_i, F(-1.0), F(1.0));
  bool entering = val(cos_i) > 0.f;
  T ei = entering ? eta_i : eta_t;
  T et = entering ? eta_t : eta_i;
  cos_i = m_abs(cos_i);
  T sin_i = m_sqrt(m_max(F(1.0) - cos_i * cos_i, F(1e-12)));
  T sin_t = ei / et * sin_i;
  if (val(sin_t) >= F(1.0)) return T(F(1.0));  // total internal reflection
  T cos_t = m_sqrt(m_max(F(1.0) - sin_t * sin_t, F(1e-12)));
  T ti = et * cos_i, it = ei * cos_t, ii = ei * cos_i, tt = et * cos_t;
  T r_parl = (ti - it) / m_max(ti + it, F(1e-20));
  T r_perp = (ii - tt) / m_max(ii + tt, F(1e-20));
  return F(0.5) * (r_parl * r_parl + r_perp * r_perp);
}

// One channel of fr_conductor (eta_i = 1): cos_i, cos2, sin2 of the incidence.
template <class T>
__device__ __forceinline__ T fr_conductor1(const T& cos_i, const T& cos2, const T& sin2, const T& eta,
                                           const T& etak) {
  T eta2 = eta * eta, etak2 = etak * etak;
  T t0 = eta2 - etak2 - sin2;
  T a2b2 = m_sqrt(m_max(t0 * t0 + eta2 * etak2 * F(4.0), 0.f));
  T t1 = a2b2 + cos2;
  T a = m_sqrt(m_max((a2b2 + t0) * F(0.5), 0.f));
  T t2 = a * (F(2.0) * cos_i);
  T rs = (t1 - t2) / (t1 + t2);
  T t3 = a2b2 * cos2 + sin2 * sin2;
  T t4 = t2 * sin2;
  T rp = rs * ((t3 - t4) / (t3 + t4));
  return (rp + rs) * F(0.5);
}

// The Fresnel term of a microfacet lobe: a conductor (eta, k per channel) or
// a dielectric (eta.x, the same in every channel).
template <class T>
struct Fresnel {
  bool conductor;
  Vt<T> eta, k;
};
template <class T>
__device__ Vt<T> fresnel_eval(const Fresnel<T>& fr, const T& cos_theta_i) {
  if (!fr.conductor) {
    T f = fr_dielectric_t(cos_theta_i, T(F(1.0)), fr.eta.x);
    return {f, f, f};
  }
  T cos_i = m_clamp(m_abs(cos_theta_i), 0.f, F(1.0));
  T cos2 = cos_i * cos_i;
  T sin2 = F(1.0) - cos2;
  return {fr_conductor1(cos_i, cos2, sin2, fr.eta.x, fr.k.x),
          fr_conductor1(cos_i, cos2, sin2, fr.eta.y, fr.k.y),
          fr_conductor1(cos_i, cos2, sin2, fr.eta.z, fr.k.z)};
}

// ------------------------------------------------ microfacet distributions --
// A half-vector drawn from D(wh)|cos(theta_h)| (ops/bsdf.py `_sample_wh`).
template <class T>
__device__ Vt<T> sample_wh_t(float u1, float u2, const T& ax, const T& ay, const Vt<T>& wo, int kind) {
  T tan2, phi;
  if (kind == BECKMANN) {
    float log_sample = logf(fmaxf(u1, F(1e-20)));
    if (fabsf(val(ax - ay)) < F(1e-3)) {
      tan2 = -ax * ax * log_sample;
      phi = T(u2 * F(2.0) * F(PI));
    } else {
      phi = atan_t(ay / ax * tan_sc(F(2.0 * PI) * u1 + F(0.5 * PI)));
      if (u1 > F(0.5)) phi = phi + F(PI);
      T sp = m_sin(phi), cp = m_cos(phi);
      tan2 = -log_sample / (cp * cp / (ax * ax) + sp * sp / (ay * ay));
    }
  } else {
    if (fabsf(val(ax - ay)) < F(1e-7)) {
      phi = T(F(2.0 * PI) * u2);
      tan2 = ax * ax * u1 / fmaxf(F(1.0) - u1, F(1e-7));
    } else {
      phi = atan_t(ay / ax * tan_sc(F(PI_OVER_2) + F(2.0 * PI) * u1));
      if (u1 > F(0.5)) phi = phi + F(PI);
      T sp = m_sin(phi), cp = m_cos(phi);
      T alpha2 = F(1.0) / (cp * cp / (ax * ax) + sp * sp / (ay * ay));
      tan2 = alpha2 * u1 / fmaxf(F(1.0) - u1, F(1e-7));
    }
  }
  T cos_t = F(1.0) / m_sqrt(F(1.0) + tan2);
  T sin_t = m_sqrt(m_max(F(1.0) - cos_t * cos_t, F(1e-12)));
  Vt<T> wh = {sin_t * m_cos(phi), sin_t * m_sin(phi), cos_t};
  return val(wo.z) * val(wh.z) > F(1e-5) ? wh : -wh;
}

template <class T>
__device__ T distribution_d_t(const Vt<T>& wh, const T& ax, const T& ay, int kind) {
  T c2 = wh.z * wh.z;
  if (val(c2) < F(1e-5)) return T(0.f);  // tan2_theta = 1e5 >= INF
  T tan2 = m_max(F(1.0) - c2, 0.f) / m_max(c2, F(1e-20));
  if (val(tan2) >= F(INF)) return T(0.f);
  T cos4 = c2 * c2;
  T term = cos2_phi_t(wh) / (ax * ax) + sin2_phi_t(wh) / (ay * ay);
  if (kind == BECKMANN) return m_exp(-tan2 * term) / (F(PI) * ax * ay * m_max(cos4, F(1e-20)));
  T e1 = F(1.0) + term * tan2;
  return F(1.0) / (F(PI) * ax * ay * m_max(cos4 * (e1 * e1), F(1e-20)));
}

template <class T>
__device__ Vt<T> microfacet_r_f_t(const Vt<T>& r, const Vt<T>& wo, const Vt<T>& wi, const T& ax,
                                  const T& ay, int kind, const Fresnel<T>& fr) {
  T cos_o = m_abs(wo.z), cos_i = m_abs(wi.z);
  Vt<T> wh = wo + wi;
  if (val(cos_i) < EPSILON || val(cos_o) < EPSILON || val(vdot(wh, wh)) < F(1e-12)) return vzero<T>();
  wh = vnormalize(wh);
  Vt<T> f = fresnel_eval(fr, vdot(wi, wh));
  T d = distribution_d_t(wh, ax, ay, kind);
  return r * f * (d / m_max(F(4.0) * cos_i * cos_o, F(1e-12)));
}

template <class T>
__device__ void microfacet_r_sample_t(const Vt<T>& r, float u1, float u2, const Vt<T>& wo, const T& ax,
                                      const T& ay, int kind, const Fresnel<T>& fr, Vt<T>& wi,
                                      Vt<T>& w) {
  Vt<T> wh = sample_wh_t(u1, u2, ax, ay, wo, kind);
  wi = wh * (F(2.0) * vdot(wo, wh)) - wo;
  bool ok = val(wo.z) >= EPSILON && val(wo.z) * val(wi.z) > F(1e-5);
  T pdf = distribution_d_t(wh, ax, ay, kind) * m_abs(wh.z) / m_max(F(4.0) * vdot(wo, wh), F(1e-12));
  if (!(ok && val(pdf) > F(1e-12))) {
    w = vzero<T>();
    return;
  }
  w = microfacet_r_f_t(r, wo, wi, ax, ay, kind, fr) * (m_abs(wi.z) / m_max(pdf, F(1e-12)));
}

// GLSL refract of incident i about n, eta = etaI/etaT; false on total
// internal reflection (the direction is then the zero vector).
template <class T>
__device__ __forceinline__ bool refract_t(const Vt<T>& i, const Vt<T>& n, const T& eta, Vt<T>& d) {
  T cos_i = -vdot(i, n);
  T k = F(1.0) - eta * eta * (F(1.0) - cos_i * cos_i);
  if (val(k) < 0.f) {
    d = vzero<T>();
    return false;
  }
  d = i * eta + n * (eta * cos_i - m_sqrt(m_max(k, F(1e-12))));
  return true;
}

// Rough dielectric transmission BTDF value and pdf (ops/bsdf.py
// microfacet_t_f / microfacet_t_pdf).
template <class T>
__device__ Vt<T> microfacet_t_f_t(const Vt<T>& t_col, const Vt<T>& wo, const Vt<T>& wi, const T& eta,
                                  bool into, const T& ax, const T& ay, int kind) {
  if (val(wo.z) * val(wi.z) > F(1e-5) || fabsf(val(wi.z)) < F(1e-3) || fabsf(val(wo.z)) < F(1e-3))
    return vzero<T>();
  T eta_rel = into ? eta : F(1.0) / eta;
  Vt<T> wh = vnormalize(wo + wi * eta_rel);
  if (val(wh.z) < 0.f) wh = -wh;
  T f = fr_dielectric_t(vdot(wo, wh), T(F(1.0)), eta);
  T denom = vdot(wo, wh) + eta_rel * vdot(wi, wh);
  T d = distribution_d_t(wh, ax, ay, kind);
  T den = wi.z * wo.z * denom * denom;
  T factor = m_abs(d * eta_rel * eta_rel * m_abs(vdot(wi, wh)) * m_abs(vdot(wo, wh)) /
                   (fabsf(val(den)) < F(1e-12) ? T(F(1e-12)) : den));
  return t_col * ((F(1.0) - f) * factor / m_max(eta_rel * eta_rel, F(1e-12)));
}

template <class T>
__device__ T microfacet_t_pdf_t(const Vt<T>& wo, const Vt<T>& wi, const T& eta, bool into, const T& ax,
                                const T& ay, int kind) {
  if (val(wo.z) * val(wi.z) > F(1e-5)) return T(0.f);
  T eta_rel = into ? eta : F(1.0) / eta;
  Vt<T> wh = vnormalize(wo + wi * eta_rel);
  T denom = vdot(wo, wh) + eta_rel * vdot(wi, wh);
  T d2 = denom * denom;
  T dwh_dwi = m_abs(eta_rel * eta_rel * vdot(wi, wh) / (fabsf(val(d2)) < F(1e-12) ? T(F(1e-12)) : d2));
  return distribution_d_t(wh, ax, ay, kind) * m_abs(wh.z) * dwh_dwi;
}

// ----------------------------------------------------------- the samples ----
// Material parameters in their packed order: METAL uroughness, vroughness,
// eta[3], k[3]; GLASS kr, kt, eta, uroughness, vroughness.
constexpr int MAX_MAT_PARAMS = 8;
__device__ __forceinline__ int material_params(int cat) { return cat == METAL ? 8 : 5; }

// The BSDF sample of a METAL or GLASS hit (ops/bsdf.py metal_sample,
// glass_sample): the direction wi and the weight f |cos| / pdf, before the
// clip.  `kind` is BECKMANN or TROWBRIDGE_REITZ.
template <class T>
__device__ void sample_material_t(int cat, int kind, const T* mp, const Vt<T>& sc, float u1, float u2,
                                  float u_lobe, const Vt<T>& wo, bool into, Vt<T>& wi, Vt<T>& w) {
  if (cat == METAL) {
    Fresnel<T> fr = {true, {mp[2], mp[3], mp[4]}, {mp[5], mp[6], mp[7]}};
    microfacet_r_sample_t(sc, u1, u2, wo, m_max(mp[0], F(1e-4)), m_max(mp[1], F(1e-4)), kind, fr, wi, w);
    return;
  }
  const T &kr = mp[0], &kt = mp[1], &eta = mp[2];
  if (val(mp[3]) < EPSILON && val(mp[4]) < EPSILON) {  // specular glass
    T f_refl = fr_dielectric_t(wo.z, T(F(1.0)), eta);
    if (u_lobe < val(f_refl)) {
      wi = {-wo.x, -wo.y, wo.z};
      w = sc * kr;
      return;
    }
    T eta_i = into ? T(F(1.0)) : eta, eta_t = into ? eta : T(F(1.0));
    T rel = eta_i / eta_t;
    Vt<T> n = {T(0.f), T(0.f), T(val(wo.z) >= 0.f ? F(1.0) : F(-1.0))};
    if (!refract_t(-wo, n, rel, wi)) {
      w = vzero<T>();
      return;
    }
    w = sc * (kt * rel * rel);
    return;
  }
  // rough glass: 50/50 lobe choice, each lobe's weight doubled
  T ax = m_max(mp[3], F(1e-4)), ay = m_max(mp[4], F(1e-4));
  if (!(u_lobe >= F(0.5))) {
    Fresnel<T> fr = {false, {eta, eta, eta}, {eta, eta, eta}};
    microfacet_r_sample_t(sc * kr, u1, u2, wo, ax, ay, kind, fr, wi, w);
    w = w * F(2.0);
    return;
  }
  Vt<T> wh = sample_wh_t(u1, u2, ax, ay, wo, kind);
  T eta_rel_in = into ? F(1.0) / eta : eta;
  if (!refract_t(-wo, val(vdot(wo, wh)) < 0.f ? -wh : wh, eta_rel_in, wi)) {
    w = vzero<T>();
    return;
  }
  Vt<T> f_t = microfacet_t_f_t(sc * kt, wo, wi, eta, into, ax, ay, kind);
  T pdf_t = microfacet_t_pdf_t(wo, wi, eta, into, ax, ay, kind);
  w = val(pdf_t) > F(1e-9) ? f_t * (m_abs(wi.z) / m_max(pdf_t, F(1e-9))) : vzero<T>();
  w = w * F(2.0);
}

// ------------------------------------------------------------ textures ----
// The surface color of a texture row (ops/textures.py), from the hit's u, v.
__device__ V3 texture_color(const Scene& s, int cat, int off, float u, float v) {
  switch (cat) {
    case CHECKERBOARD: {
      float size = P(s, off), width = F(0.5) * P(s, off + 1) / size;
      float fx = u / size - floorf(u / size), fy = v / size - floorf(v / size);
      bool outline = fx < width || fx > F(1.0) - width || fy < width || fy > F(1.0) - width;
      return outline ? V3{F(0.5), F(0.5), F(0.5)} : V3{1.f, 1.f, 1.f};
    }
    case CHECKERBOARD2: {
      float size = P(s, off + 6);
      float m = fmodf(floorf(u / size) + floorf(v / size), F(2.0));
      if (m != 0.f && m < 0.f) m += F(2.0);  // torch.remainder: the divisor's sign
      return m < F(0.5) ? P3(s, off) : P3(s, off + 3);
    }
    case BILERP:
      return P3(s, off) * ((F(1.0) - u) * (F(1.0) - v)) + P3(s, off + 3) * ((F(1.0) - u) * v) +
             P3(s, off + 6) * (u * (F(1.0) - v)) + P3(s, off + 9) * (u * v);
    case MIXF: {
      float t = P(s, off + 6);
      return P3(s, off) * (F(1.0) - t) + P3(s, off + 3) * t;
    }
    case SCALE: return P3(s, off) * P3(s, off + 3);
    case UVF: return V3{u - floorf(u), v - floorf(v), 0.f};
  }
  return P3(s, off);  // UNIFORM_COLOR
}
