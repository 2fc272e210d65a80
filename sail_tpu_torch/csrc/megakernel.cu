// Forward path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `render_block_pallas`
// (sail_tpu/ops/pallas/megakernel.py:159, pl.pallas_call at :244): for every
// pixel of an H x W block, a loop over spp samples of PCG3D jitter -> camera
// ray -> max_bounces x (closest-hit fold, surface color, BSDF sample, next-
// event estimation with a shadow any-hit ray), returning the spp-SUM of
// radiance as three float32 planes.
//
// What bounds it on this card: no data reuse and almost no memory traffic
// (72 scene floats and a small int table, read by every thread from the same
// addresses; 12 bytes written per pixel).  It is bound by FP32 and SFU issue
// (sqrt, div, sin/cos) and by divergence: lanes of a warp hit different
// objects and materials and die at different bounces.
//
// Design: one thread per pixel, as in the reference's fragment shader.  The
// TPU kernel's (8, 256) tiles and lock-step masked lanes are not carried
// over.  A thread keeps its path state in registers, runs the spp loop and
// the bounce loop itself, and adds samples in sample order, so results are
// deterministic.  A dead path leaves the bounce loop at once: the masked TPU
// loop adds exactly +0 for it from then on, so this is bit-identical, not
// the TPU kernel's approximate tile-level early exit.  The scene arrives as
// the flat float vector (the JAX package's leaf order) plus an int32 table;
// the kernel switches on category at run time, so one build serves every
// scene made of the ported categories (SPHERE, RECTANGLE, CORNELLBOX; MATTE,
// MIRROR; UNIFORM_COLOR; AREA over RECTANGLE).  The closest-hit fold keeps
// t only per object and computes hit details once for the winner: the same
// values the masked fold selects.
//
// Numerics follow the plain torch version (render/integrator.py) operation
// by operation: build with -fmad=false and without --use_fast_math; rsqrt is
// 1.0f/sqrtf; atan2/acos are the repo's polynomials (core/fastmath.py);
// cosf/sinf are full precision.  Constants are written as double literals
// cast to float, as Python rounds them.  The RNG runs in uint32_t, which is
// bit-identical to the JAX package's int32 encoding.

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

namespace {

constexpr double PI = 3.141592653589793;
constexpr double INV_PI = 0.3183098861837907;
constexpr double TWO_PI = 2.0 * PI;
constexpr double PI_2 = PI / 2.0;
constexpr float EPSILON = F(1e-5);
constexpr float MAX_DISTANCE = F(1e5);

// constants.py category ids
constexpr int SPHERE = 2, RECTANGLE = 3, CORNELLBOX = 9;
constexpr int MATTE = 1;  // the other material row is MIRROR
constexpr int TAG_PIXEL_JITTER = 0, TAG_BSDF = 1, TAG_LIGHT_U = 3;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float length(V3 a) { return sqrtf(fmaxf(dot(a, a), F(1e-20))); }
__device__ __forceinline__ V3 normalize(V3 a) {
  return a * (F(1.0) / sqrtf(fmaxf(dot(a, a), F(1e-20))));
}
__device__ __forceinline__ float max_component(V3 a) { return fmaxf(fmaxf(a.x, a.y), a.z); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
__device__ __forceinline__ V3 clip01(V3 a) {
  return {clampf(a.x, 0.f, 1.f), clampf(a.y, 0.f, 1.f), clampf(a.z, 0.f, 1.f)};
}
__device__ __forceinline__ V3 world_to_local(V3 v, V3 n, V3 s, V3 t) { return {dot(v, s), dot(v, t), dot(v, n)}; }
__device__ __forceinline__ V3 local_to_world(V3 v, V3 n, V3 s, V3 t) {
  return {s.x * v.x + t.x * v.y + n.x * v.z, s.y * v.x + t.y * v.y + n.y * v.z,
          s.z * v.x + t.z * v.y + n.z * v.z};
}
__device__ __forceinline__ V3 ortho(V3 d) {
  bool big = fabsf(d.x) > F(1e-5) || fabsf(d.y) > F(1e-5);
  return big ? V3{d.y, -d.x, 0.f} : V3{0.f, d.z, -d.y};
}
__device__ __forceinline__ V3 to_object(V3 v) { return {-v.z, v.x, v.y}; }
__device__ __forceinline__ V3 from_object(V3 v) { return {v.y, v.z, -v.x}; }
__device__ __forceinline__ float safe_div(float num, float den) {
  const float eps = F(1e-12);
  return num / (fabsf(den) < eps ? (den < 0.f ? -eps : eps) : den);
}

// ---------------------------------------------------------------- RNG ----
__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x21F0AAADu;
  x = (x ^ (x >> 15)) * 0x735A2D97u;
  return x ^ (x >> 15);
}

__device__ __forceinline__ uint32_t stream_id(uint32_t seed, uint32_t sample, int bounce, int tag) {
  uint32_t s = splitmix32(seed ^ splitmix32(sample));
  return splitmix32(s ^ (uint32_t)(bounce * 0x9E37 + tag * 0x85EB + 0x1234));
}

// pixel_uniform3: PCG3D over (col, row, stream), top 24 bits -> [0, 1).
__device__ __forceinline__ void uniform3(uint32_t sid, uint32_t row, uint32_t col, float& a, float& b,
                                         float& c) {
  const uint32_t m = 1664525u, k = 1013904223u;
  uint32_t x = col * m + k, y = row * m + k, z = sid * m + k;
  x += y * z;
  y += z * x;
  z += x * y;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  x += y * z;
  y += z * x;
  z += x * y;
  const float scale = F(1.0 / 16777216.0);
  a = (float)(x >> 8) * scale;
  b = (float)(y >> 8) * scale;
  c = (float)(z >> 8) * scale;
}

// ----------------------------------------------------------- fastmath ----
__device__ __forceinline__ float atan_poly(float t) {
  float t2 = t * t;
  float p = F(-0.0117212);
  p = p * t2 + F(0.05265332);
  p = p * t2 + F(-0.11643287);
  p = p * t2 + F(0.19354346);
  p = p * t2 + F(-0.33262347);
  p = p * t2 + F(0.99997726);
  return t * p;
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
  bool swap = fabsf(y) > fabsf(x);
  float num = swap ? x : y;
  float den = swap ? y : x;
  den = den == 0.f ? F(1e-30) : den;
  float r = atan_poly(num / den);
  float s = ((y < 0.f) != (x < 0.f)) ? F(-PI_2) : F(PI_2);
  r = swap ? s - r : r;
  return x < 0.f ? (y >= 0.f ? r + F(PI) : r - F(PI)) : r;
}

__device__ __forceinline__ float acos_poly(float x) {
  x = clampf(x, F(-1.0), F(1.0));
  float s = sqrtf(fmaxf(F(1.0) - x * x, F(1e-20)));
  return atan2_poly(s, x);
}

// --------------------------------------------------------------- scene ----
struct Scene {
  const float* __restrict__ p;
  const int* __restrict__ obj;    // 5 ints per object
  const int* __restrict__ mat;    // 2 ints per material row
  const int* __restrict__ tex;    // 2 ints per texture row
  const int* __restrict__ light;  // 3 ints per light
  int n_obj, n_light, cam;
};

__device__ __forceinline__ float P(const Scene& s, int i) { return __ldg(s.p + i); }
__device__ __forceinline__ V3 P3(const Scene& s, int i) { return {P(s, i), P(s, i + 1), P(s, i + 2)}; }

struct Hit {
  float t;
  V3 p, ng, dpdu;
  float u, v;
  V3 sc;       // Cornell-wall color override
  bool use_sc;
};

// ----------------------------------------------------------- quadratic ----
__device__ __forceinline__ bool quadratic(float a, float b, float c, float& lo, float& hi) {
  float discrim = b * b - F(4.0) * a * c;
  bool ok = discrim >= 0.f;
  float root = sqrtf(ok ? fmaxf(discrim, F(1e-20)) : F(1.0));
  root = ok ? root : 0.f;
  float q = b < 0.f ? F(-0.5) * (b - root) : F(-0.5) * (b + root);
  float t0 = q / (a == 0.f ? F(1e-20) : a);
  float t1 = c / (q == 0.f ? F(1e-20) : q);
  lo = fminf(t0, t1);
  hi = fmaxf(t0, t1);
  return ok;
}

// -------------------------------------------------------------- sphere ----
// params: center[3], radius, emission[3], reverse
__device__ __forceinline__ float sphere_t(const Scene& s, int off, V3 ro, V3 rd, V3& o, V3& d) {
  V3 c = P3(s, off);
  float r = P(s, off + 3);
  o = to_object(ro - c);
  d = to_object(rd);
  float a = dot(d, d);
  float b = F(2.0) * dot(o, d);
  float c2 = dot(o, o) - r * r;
  float t1, t2;
  bool ok = quadratic(a, b, c2, t1, t2);
  float t = t1 < EPSILON ? t2 : t1;
  bool valid = ok && (t2 >= EPSILON) && (t < MAX_DISTANCE);
  return valid ? t : MAX_DISTANCE;
}

__device__ Hit sphere_hit(const Scene& s, int off, V3 ro, V3 rd) {
  V3 o, d;
  Hit h;
  h.t = sphere_t(s, off, ro, rd, o, d);
  V3 c = P3(s, off);
  float r = P(s, off + 3);
  V3 q = o + d * h.t;
  q.x = (q.x == 0.f && q.y == 0.f) ? F(1e-5) * r : q.x;
  float phi = atan2_poly(q.y, q.x);
  phi = phi < 0.f ? phi + F(TWO_PI) : phi;
  h.u = phi / F(TWO_PI);
  float cos_t = clampf(q.z / r, F(-1.0 + 1e-6), F(1.0 - 1e-6));
  h.v = acos_poly(cos_t) / F(PI);
  V3 dpdu = {F(-TWO_PI) * q.y, F(TWO_PI) * q.x, 0.f};
  V3 ng = q * (F(1.0) / r);
  h.p = from_object(q) + c;
  h.ng = from_object(ng);
  h.dpdu = from_object(dpdu);
  h.sc = {0.f, 0.f, 0.f};
  h.use_sc = false;
  return h;
}

// ----------------------------------------------------------- rectangle ----
// params: bmin[3], bmax[3], emission[3], reverse
struct RectFrame {
  V3 ex, ey, n, ss, ts;
  float len_x, len_y;
};

__device__ __forceinline__ RectFrame rect_frame(const Scene& s, int off) {
  RectFrame f;
  V3 ext = P3(s, off + 3) - P3(s, off);
  f.ex = {ext.x, 0.f, 0.f};
  f.ey = {0.f, ext.y, ext.z};
  f.n = normalize(cross(f.ex, f.ey));
  f.len_x = length(f.ex);
  f.len_y = length(f.ey);
  f.ss = f.ex * (F(1.0) / fmaxf(f.len_x, F(1e-20)));
  f.ts = cross(f.n, f.ss);
  return f;
}

__device__ __forceinline__ float rect_t(const Scene& s, int off, const RectFrame& f, V3 ro, V3 rd, V3& hl) {
  V3 d_l = world_to_local(rd, f.n, f.ss, f.ts);
  V3 o_l = world_to_local(ro - P3(s, off), f.n, f.ss, f.ts);
  float t = -safe_div(o_l.z, d_l.z);
  hl = o_l + d_l * t;
  bool valid = fabsf(d_l.z) > F(1e-12) && t >= EPSILON && hl.x <= f.len_x && hl.y <= f.len_y &&
               hl.x >= -EPSILON && hl.y >= -EPSILON && t < MAX_DISTANCE;
  return valid ? t : MAX_DISTANCE;
}

__device__ Hit rect_hit(const Scene& s, int off, V3 ro, V3 rd) {
  RectFrame f = rect_frame(s, off);
  V3 hl;
  Hit h;
  h.t = rect_t(s, off, f, ro, rd, hl);
  h.u = hl.x / fmaxf(f.len_x, F(1e-20));
  h.v = hl.y / fmaxf(f.len_y, F(1e-20));
  h.p = local_to_world(hl, f.n, f.ss, f.ts) + P3(s, off);
  h.ng = f.n;
  h.dpdu = f.ex;
  h.sc = {0.f, 0.f, 0.f};
  h.use_sc = false;
  return h;
}

// ---------------------------------------------------------- cornellbox ----
__device__ __forceinline__ void slab(V3 ro, V3 rd, V3 bmin, V3 bmax, float& tnear, float& tfar) {
  V3 inv = {safe_div(F(1.0), rd.x), safe_div(F(1.0), rd.y), safe_div(F(1.0), rd.z)};
  V3 tmin = (bmin - ro) * inv;
  V3 tmax = (bmax - ro) * inv;
  tnear = fmaxf(fmaxf(fminf(tmin.x, tmax.x), fminf(tmin.y, tmax.y)), fminf(tmin.z, tmax.z));
  tfar = fminf(fminf(fmaxf(tmin.x, tmax.x), fmaxf(tmin.y, tmax.y)), fmaxf(tmin.z, tmax.z));
}

__device__ __forceinline__ float cornell_t(const Scene& s, int off, V3 ro, V3 rd) {
  float tnear, tfar;
  slab(ro, rd, P3(s, off), P3(s, off + 3), tnear, tfar);
  bool valid = tnear < tfar && tfar > EPSILON;
  return valid ? tfar : MAX_DISTANCE;
}

__device__ __forceinline__ float face_axis(float h, float lo, float hi) {
  const float eps = F(1e-4);
  return h < lo + eps ? F(-1.0) : (h > hi - eps ? F(1.0) : 0.f);
}

__device__ Hit cornell_hit(const Scene& s, int off, V3 ro, V3 rd) {
  V3 bmin = P3(s, off), bmax = P3(s, off + 3);
  Hit h;
  h.t = cornell_t(s, off, ro, rd);
  V3 p = ro + rd * h.t;
  float nx = face_axis(p.x, bmin.x, bmax.x);
  float ny = face_axis(p.y, bmin.y, bmax.y);
  float nz = face_axis(p.z, bmin.z, bmax.z);
  bool hx = nx != 0.f, hy = ny != 0.f, hz = nz != 0.f;
  V3 n = -V3{hx ? nx : 0.f, (!hx && hy) ? ny : 0.f, (!hx && !hy) ? (hz ? nz : F(1.0)) : 0.f};
  bool use_x = fabsf(n.x) < F(0.5);
  h.dpdu = use_x ? cross(n, V3{1.f, 0.f, 0.f}) : cross(n, V3{0.f, 1.f, 0.f});
  const float eps = F(1e-4);
  // left GREEN, right BLUE, floor/ceiling/front WHITE, back BLACK
  if (p.x < bmin.x + eps) h.sc = {F(0.25), F(0.75), F(0.25)};
  else if (p.x > bmax.x - eps) h.sc = {F(0.25), F(0.25), F(0.75)};
  else if (p.y < bmin.y + eps || p.y > bmax.y - eps || p.z > bmin.z + eps) h.sc = {1.f, 1.f, 1.f};
  else h.sc = {0.f, 0.f, 0.f};
  h.use_sc = true;
  V3 ext = bmax - bmin;
  V3 rel = {safe_div(p.x - bmin.x, ext.x), safe_div(p.y - bmin.y, ext.y), safe_div(p.z - bmin.z, ext.z)};
  bool on_x = fabsf(n.x) > F(0.5), on_y = fabsf(n.y) > F(0.5);
  h.u = on_x ? rel.y : rel.x;
  h.v = on_x ? rel.z : (on_y ? rel.z : rel.y);
  h.p = p;
  h.ng = n;
  return h;
}

// ------------------------------------------------- scene-level queries ----
__device__ __forceinline__ float object_t(const Scene& s, int i, V3 ro, V3 rd) {
  int cat = __ldg(s.obj + 5 * i), off = __ldg(s.obj + 5 * i + 1);
  V3 a, b;
  switch (cat) {
    case SPHERE: return sphere_t(s, off, ro, rd, a, b);
    case RECTANGLE: return rect_t(s, off, rect_frame(s, off), ro, rd, a);
    case CORNELLBOX: return cornell_t(s, off, ro, rd);
  }
  return MAX_DISTANCE;
}

// Closest hit in scene order; strict <, so a tie keeps the earlier object.
__device__ __forceinline__ int closest(const Scene& s, V3 ro, V3 rd) {
  float best_t = MAX_DISTANCE;
  int best = -1;
  for (int i = 0; i < s.n_obj; ++i) {
    float t = object_t(s, i, ro, rd);
    if (t < best_t) {
      best_t = t;
      best = i;
    }
  }
  return best;
}

__device__ __forceinline__ bool occluded(const Scene& s, V3 ro, V3 rd, float max_t) {
  for (int i = 0; i < s.n_obj; ++i) {
    float t = object_t(s, i, ro, rd);
    if (t > EPSILON && t < max_t) return true;
  }
  return false;
}

__device__ Hit object_hit(const Scene& s, int i, V3 ro, V3 rd) {
  int cat = __ldg(s.obj + 5 * i), off = __ldg(s.obj + 5 * i + 1);
  if (cat == SPHERE) return sphere_hit(s, off, ro, rd);
  if (cat == RECTANGLE) return rect_hit(s, off, ro, rd);
  return cornell_hit(s, off, ro, rd);
}

// ---------------------------------------------------------------- BSDF ----
__device__ __forceinline__ float sin_theta(V3 w) { return sqrtf(fmaxf(fmaxf(F(1.0) - w.z * w.z, 0.f), F(1e-12))); }
__device__ __forceinline__ float cos_phi(V3 w) {
  float s = sin_theta(w);
  return fabsf(s) < F(1e-3) ? F(1.0) : clampf(w.x / (s == 0.f ? F(1.0) : s), F(-1.0), F(1.0));
}
__device__ __forceinline__ float sin_phi(V3 w) {
  float s = sin_theta(w);
  return fabsf(s) < F(1e-3) ? 0.f : clampf(w.y / (s == 0.f ? F(1.0) : s), F(-1.0), F(1.0));
}

// Lambertian for sigma < EPSILON, else Oren-Nayar (sigma in radians).
__device__ V3 matte_f(float kd, float sigma, V3 sc, V3 wo, V3 wi) {
  V3 r = sc * kd;
  if (sigma < EPSILON) return r * F(INV_PI);
  float s2 = sigma * sigma;
  float a = F(1.0) - s2 / (F(2.0) * (s2 + F(0.33)));
  float b = F(0.45) * s2 / (s2 + F(0.09));
  float sin_ti = sin_theta(wi), sin_to = sin_theta(wo);
  float d_cos = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo);
  float max_cos = (sin_ti > EPSILON && sin_to > EPSILON) ? fmaxf(d_cos, 0.f) : 0.f;
  float aci = fabsf(wi.z), aco = fabsf(wo.z);
  bool steeper = aci > aco;
  float sin_alpha = steeper ? sin_to : sin_ti;
  float tan_beta = steeper ? sin_ti / fmaxf(aci, F(1e-7)) : sin_to / fmaxf(aco, F(1e-7));
  return r * (F(INV_PI) * (a + b * max_cos * sin_alpha * tan_beta));
}

// ---------------------------------------------------------- the kernel ----
__global__ void __launch_bounds__(256) render_block_kernel(Scene s, float* __restrict__ out_x,
                                                           float* __restrict__ out_y,
                                                           float* __restrict__ out_z, int height,
                                                           int width, int spp, uint32_t seed,
                                                           uint32_t sample0, int max_bounces, int row0,
                                                           int image_height) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || lrow >= height) return;
  uint32_t row = (uint32_t)(row0 + lrow);

  const int cam = s.cam;
  V3 eye = P3(s, cam), right = P3(s, cam + 3), up = P3(s, cam + 6), back = P3(s, cam + 9);
  float tan_half = P(s, cam + 12), aspect = P(s, cam + 13);
  const float sx_scale = F(2.0 / (double)width), sy_scale = F(2.0 / (double)image_height);
  const float fcol = (float)col, frow = (float)(int)row;

  V3 acc = {0.f, 0.f, 0.f};
  for (int k = 0; k < spp; ++k) {
    uint32_t sample = sample0 + (uint32_t)k;
    float jx, jy, unused;
    uniform3(stream_id(seed, sample, 0, TAG_PIXEL_JITTER), row, (uint32_t)col, jx, jy, unused);
    float ndc_x = (fcol + jx) * sx_scale - F(1.0);
    float ndc_y = F(1.0) - (frow + jy) * sy_scale;
    float sx = ndc_x * tan_half * aspect;
    float sy = ndc_y * tan_half;
    V3 rd = normalize(V3{right.x * sx + up.x * sy - back.x, right.y * sx + up.y * sy - back.y,
                         right.z * sx + up.z * sy - back.z});
    V3 ro = eye;
    V3 e = {0.f, 0.f, 0.f}, thr = {1.f, 1.f, 1.f};
    bool skip_emission = false;

    for (int bounce = 0; bounce < max_bounces; ++bounce) {
      int i = closest(s, ro, rd);
      if (i < 0) break;  // miss: the path adds nothing more
      Hit h = object_hit(s, i, ro, rd);
      const int* o = s.obj + 5 * i;
      int off = __ldg(o + 1), mat_row = __ldg(o + 2), tex_row = __ldg(o + 3);
      bool emissive = __ldg(o + 4) != 0;
      int cat = __ldg(o);
      int eoff = off + (cat == SPHERE ? 4 : 6);
      float reverse = P(s, eoff + 3);
      bool face = dot(h.ng * reverse, rd) < -EPSILON;
      V3 emission = face ? P3(s, eoff) : V3{0.f, 0.f, 0.f};
      bool into = dot(h.ng, rd) < -EPSILON;
      V3 n = into ? h.ng : -h.ng;

      // shading frame
      bool dpdu_ok = dot(h.dpdu, h.dpdu) > F(1e-16);
      V3 ss = normalize(dpdu_ok ? h.dpdu : ortho(n));
      ss = normalize(ss - n * dot(ss, n));
      V3 ts = cross(n, ss);
      V3 wo = world_to_local(-rd, n, ss, ts);

      V3 sc = h.use_sc ? h.sc : P3(s, __ldg(s.tex + 2 * tex_row + 1));

      float u1, u2, u_lobe;
      uniform3(stream_id(seed, sample, bounce, TAG_BSDF), row, (uint32_t)col, u1, u2, u_lobe);
      int mcat = __ldg(s.mat + 2 * mat_row), moff = __ldg(s.mat + 2 * mat_row + 1);
      bool is_matte = mcat == MATTE;
      V3 wi, weight;
      if (is_matte) {
        float kd = P(s, moff), sigma = P(s, moff + 1);
        float r = sqrtf(u1);
        float angle = F(2.0 * PI) * u2;
        wi = {r * cosf(angle), r * sinf(angle), sqrtf(fmaxf(F(1.0) - u1, F(1e-12)))};
        bool same = wo.z * wi.z > F(1e-5);
        float pdf = same ? fabsf(wi.z) * F(INV_PI) : 0.f;
        V3 f = matte_f(kd, sigma, sc, wo, wi);
        weight = f * (pdf > 0.f ? fabsf(wi.z) / fmaxf(pdf, F(1e-20)) : 0.f);
      } else {  // MIRROR
        wi = {-wo.x, -wo.y, wo.z};
        weight = sc * P(s, moff);
      }
      weight = clip01(weight);

      V3 contrib = (skip_emission && emissive) ? V3{0.f, 0.f, 0.f} : emission;
      bool did_nee = false;
      if (s.n_light > 0) {
        float lu1, lu2, lr;
        uniform3(stream_id(seed, sample, bounce, TAG_LIGHT_U), row, (uint32_t)col, lu1, lu2, lr);
        did_nee = is_matte && !emissive;
        if (did_nee) {
          int lidx = min((int)(lr * (float)s.n_light), s.n_light - 1);
          const int* l = s.light + 3 * lidx;
          int loff = __ldg(s.obj + 5 * __ldg(l + 1) + 1);
          // AREA light over a RECTANGLE: point, normal, area pdf
          RectFrame f = rect_frame(s, loff);
          V3 p_l = P3(s, loff) + f.ex * lu1 + f.ey * lu2;
          float pdf_a = F(1.0) / fmaxf(length(f.ex) * length(f.ey), F(1e-12));
          V3 n_l = f.n * P(s, loff + 9);
          V3 to_l = p_l - h.p;
          float d2 = fmaxf(dot(to_l, to_l), F(1e-12));
          V3 wl = to_l * (F(1.0) / sqrtf(d2));
          float cos_l = fmaxf(dot(n_l, -wl), 0.f);
          float cos_s = fmaxf(dot(wl, n), 0.f);
          V3 rad = P3(s, __ldg(l + 2)) * (cos_l * cos_s / (d2 * pdf_a) * (float)s.n_light);
          // one shadow ray toward the sample
          float dist = length(to_l);
          V3 wsh = to_l * (F(1.0) / fmaxf(dist, F(1e-12)));
          bool occ = occluded(s, h.p + n * F(1e-4), wsh, dist * F(1.0 - 1e-3));
          V3 direct = rad * (occ ? 0.f : F(1.0));
          V3 wl_local = world_to_local(wsh, n, ss, ts);
          V3 f_light = wo.z * wl_local.z > F(1e-5)
                           ? matte_f(P(s, moff), P(s, moff + 1), sc, wo, wl_local)
                           : V3{0.f, 0.f, 0.f};
          contrib = contrib + direct * f_light;
        }
      }
      e = e + thr * contrib;
      thr = thr * weight;

      V3 wi_world = local_to_world(wi, n, ss, ts);
      float outdot = dot(n, wi_world);
      ro = h.p + n * (outdot > EPSILON ? F(1e-4) : F(-1e-4));
      rd = wi_world;
      skip_emission = did_nee;
      if (!(max_component(thr) > 0.f)) break;  // dead: adds nothing more
    }
    acc = acc + e;
  }
  size_t idx = (size_t)lrow * (size_t)width + (size_t)col;
  out_x[idx] = acc.x;
  out_y[idx] = acc.y;
  out_z[idx] = acc.z;
}

}  // namespace

// Plain C entry point (bound with ctypes).  `table` is the device int32
// scene table: 5 ints per object (category, param offset, material row,
// texture row, emissive), then 2 per material row (category, offset), 2 per
// texture row (category, offset) and 3 per light (category, object, param
// offset).  Launches on `stream`, does not synchronise, and returns the
// launch's cudaError_t.
extern "C" int sail_render_block(const float* params, const int* table, int n_obj, int n_mat,
                                 int n_tex, int n_light, int cam, float* out_x, float* out_y,
                                 float* out_z, int height, int width, int spp, int seed, int sample0,
                                 int max_bounces, int row0, int image_height, void* stream) {
  Scene s;
  s.p = params;
  s.obj = table;
  s.mat = s.obj + 5 * n_obj;
  s.tex = s.mat + 2 * n_mat;
  s.light = s.tex + 2 * n_tex;
  s.n_obj = n_obj;
  s.n_light = n_light;
  s.cam = cam;
  dim3 block(16, 16);
  dim3 grid((width + 15) / 16, (height + 15) / 16);
  render_block_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      s, out_x, out_y, out_z, height, width, spp, (uint32_t)seed, (uint32_t)sample0, max_bounces,
      row0, image_height);
  return (int)cudaGetLastError();
}
