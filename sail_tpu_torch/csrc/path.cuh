// Device code shared by the render megakernels: K1 (megakernel.cu, the
// forward) and K2 (megakernel_grad.cu, the backward).  Vector math, the
// counter-based RNG, the fastmath polynomials, the scene table, the
// intersections and bound boxes of the nine shape categories, the closest-hit
// fold (with its opt-in cluster cull) and the shadow scan, K1's pass that
// runs both for two rays at once over staged invariants (`fold`), the matte
// BSDF (the metal and glass samples and the textures are bsdf.cuh), and one
// path bounce (`bounce`, in parts that K1 runs around a deferred shadow ray:
// `bounce_open`, `light_sample`, `nee_light`, `advance`) with every
// intermediate value the adjoint reads (`Bounce`).
//
// Numerics follow the plain torch version (render/integrator.py) operation
// by operation: build with -fmad=false and without --use_fast_math; rsqrt is
// 1.0f/sqrtf; atan2/acos are the repo's polynomials (core/fastmath.py);
// cosf/sinf/expf/logf (the BSDF samples, the hyperboloid's tangent, the
// microfacet distributions) are full precision.  Constants are written as double literals
// cast to float, as Python rounds them.  The RNG runs in uint32_t, which is
// bit-identical to the JAX package's int32 encoding.  K2's forward sweep runs
// this same code, so its paths are K1's paths bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) ((float)(x))

namespace {

constexpr double PI = 3.141592653589793;
constexpr double INV_PI = 0.3183098861837907;
constexpr double TWO_PI = 2.0 * PI;
constexpr double PI_2 = PI / 2.0;
constexpr double PI_OVER_2 = 1.570796326794896;  // constants.py's literal
constexpr float EPSILON = F(1e-5);
constexpr float MAX_DISTANCE = F(1e5);
constexpr float INF = F(1e5);

// constants.py category ids
constexpr int CUBE = 1, SPHERE = 2, RECTANGLE = 3, CONE = 4, CYLINDER = 5, DISK = 6,
              HYPERBOLOID = 7, PARABOLOID = 8, CORNELLBOX = 9;
constexpr int MATTE = 1, MIRROR = 2, METAL = 3, GLASS = 4;
constexpr int UNIFORM_COLOR = 0, CHECKERBOARD = 5, CHECKERBOARD2 = 7, BILERP = 8, MIXF = 9,
              SCALE = 10, UVF = 11;
constexpr int BECKMANN = 1, TROWBRIDGE_REITZ = 2;
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

// The phases a profiling build of K1 strips (csrc/profile.cu, the counterparts
// of the patches of tools/profile_megakernel.py's `phases_section`): a bit
// mask, a template parameter of `bounce` that is 0 (strip nothing) in K1 and
// K2.  CONST_RNG: every uniform3 gives (0.5, 0.5, 0.5), the pixel jitter
// included; CONST_TEXTURE: the surface color is (1, 1, 1), the Cornell
// walls' included; NO_SHADOW: no shadow scan, every light sample visible;
// NO_NEE: no light sample adds radiance (the next bounce still skips the
// emission NEE would have counted, as the patched integrator does).
constexpr int STRIP_CONST_RNG = 1, STRIP_CONST_TEXTURE = 2, STRIP_NO_SHADOW = 4,
              STRIP_NO_NEE = 8;

template <int STRIP = 0>
__device__ __forceinline__ void draw3(uint32_t sid, uint32_t row, uint32_t col, float& a, float& b,
                                      float& c) {
  if constexpr ((STRIP & STRIP_CONST_RNG) != 0) {
    a = b = c = F(0.5);
  } else {
    uniform3(sid, row, col, a, b, c);
  }
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
constexpr int OBJ_INTS = 6;  // ints per object row of the table
constexpr int CLUSTER = 8;   // objects per bound box of the opt-in cull

struct Scene {
  const float* __restrict__ p;
  const int* __restrict__ obj;    // OBJ_INTS ints per object, in fold order
  const int* __restrict__ group;  // 2 ints per batched group
  const int* __restrict__ mat;    // 3 ints per material row
  const int* __restrict__ tex;    // 2 ints per texture row
  const int* __restrict__ light;  // 3 ints per light
  const float* box;               // 6 floats per cluster (the cull's bound boxes), or null
  int n_obj, n_plain, n_groups, n_light, cam;
};

// The scene over the device int32 table.  Object rows come in the closest-hit
// fold order: the objects of small categories in scene order (n_plain rows),
// then each batched group (BATCH_THRESHOLD or more objects of one category)
// in the order its category first appears, its objects in scene order.  Each
// row is (category, param offset, material row, texture row, emissive, scene
// index).  Then 2 ints per batched group (first row, count), 3 per material
// row (category, offset, microfacet distribution), 2 per texture row
// (category, offset) and 3 per light (category, table row of its object,
// param offset).  Built on the
// host by the C entries; `box` is set by a kernel that culls.
inline Scene make_scene(const float* params, const int* table, int n_obj, int n_plain,
                        int n_groups, int n_mat, int n_tex, int n_light, int cam) {
  Scene s;
  s.p = params;
  s.obj = table;
  s.group = s.obj + OBJ_INTS * n_obj;
  s.mat = s.group + 2 * n_groups;
  s.tex = s.mat + 3 * n_mat;
  s.light = s.tex + 2 * n_tex;
  s.box = nullptr;
  s.n_obj = n_obj;
  s.n_plain = n_plain;
  s.n_groups = n_groups;
  s.n_light = n_light;
  s.cam = cam;
  return s;
}

__device__ __forceinline__ float P(const Scene& s, int i) { return __ldg(s.p + i); }
__device__ __forceinline__ V3 P3(const Scene& s, int i) { return {P(s, i), P(s, i + 1), P(s, i + 2)}; }
__device__ __forceinline__ int obj_cat(const Scene& s, int row) { return __ldg(s.obj + OBJ_INTS * row); }
__device__ __forceinline__ int obj_off(const Scene& s, int row) { return __ldg(s.obj + OBJ_INTS * row + 1); }

// Where a row's emission starts: after its shape's own fields.
__device__ __forceinline__ int emission_offset(int cat) {
  switch (cat) {
    case SPHERE: return 4;
    case CONE: case CYLINDER: case DISK: return 5;
    case HYPERBOLOID: return 11;
    default: return 6;  // CUBE, RECTANGLE, CORNELLBOX, PARABOLOID
  }
}

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

__device__ Hit rect_hit(const Scene& s, int off, const RectFrame& f, V3 ro, V3 rd) {
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

__device__ __forceinline__ Hit rect_hit(const Scene& s, int off, V3 ro, V3 rd) {
  return rect_hit(s, off, rect_frame(s, off), ro, rd);
}

// ---------------------------------------------------------------- boxes ----
// The slab test's reciprocal direction: a function of the ray alone, which K1
// computes once per ray (`Ray`) and K2 in every test.
__device__ __forceinline__ V3 recip(V3 rd) {
  return {safe_div(F(1.0), rd.x), safe_div(F(1.0), rd.y), safe_div(F(1.0), rd.z)};
}

__device__ __forceinline__ void slab_inv(V3 ro, V3 inv, V3 bmin, V3 bmax, float& tnear, float& tfar) {
  V3 tmin = (bmin - ro) * inv;
  V3 tmax = (bmax - ro) * inv;
  tnear = fmaxf(fmaxf(fminf(tmin.x, tmax.x), fminf(tmin.y, tmax.y)), fminf(tmin.z, tmax.z));
  tfar = fminf(fminf(fmaxf(tmin.x, tmax.x), fmaxf(tmin.y, tmax.y)), fmaxf(tmin.z, tmax.z));
}

__device__ __forceinline__ void slab(V3 ro, V3 rd, V3 bmin, V3 bmax, float& tnear, float& tfar) {
  slab_inv(ro, recip(rd), bmin, bmax, tnear, tfar);
}

__device__ __forceinline__ float face_axis(float h, float lo, float hi) {
  const float eps = F(1e-4);
  return h < lo + eps ? F(-1.0) : (h > hi - eps ? F(1.0) : 0.f);
}

// Face normal by nearest-bound comparison; priority x > y > z, default +z.
__device__ __forceinline__ V3 box_normal(V3 p, V3 bmin, V3 bmax) {
  float nx = face_axis(p.x, bmin.x, bmax.x);
  float ny = face_axis(p.y, bmin.y, bmax.y);
  float nz = face_axis(p.z, bmin.z, bmax.z);
  bool hx = nx != 0.f, hy = ny != 0.f, hz = nz != 0.f;
  return V3{hx ? nx : 0.f, (!hx && hy) ? ny : 0.f, (!hx && !hy) ? (hz ? nz : F(1.0)) : 0.f};
}

__device__ __forceinline__ V3 box_dpdu(V3 n) {
  bool use_x = fabsf(n.x) < F(0.5);
  return use_x ? cross(n, V3{1.f, 0.f, 0.f}) : cross(n, V3{0.f, 1.f, 0.f});
}

__device__ __forceinline__ void box_uv(V3 p, V3 n, V3 bmin, V3 bmax, float& u, float& v) {
  V3 ext = bmax - bmin;
  V3 rel = {safe_div(p.x - bmin.x, ext.x), safe_div(p.y - bmin.y, ext.y), safe_div(p.z - bmin.z, ext.z)};
  bool on_x = fabsf(n.x) > F(0.5), on_y = fabsf(n.y) > F(0.5);
  u = on_x ? rel.y : rel.x;
  v = on_x ? rel.z : (on_y ? rel.z : rel.y);
}

// ----------------------------------------------------------------- cube ----
// params: bmin[3], bmax[3], emission[3], reverse
// `inv` = recip(rd)
__device__ __forceinline__ float cube_t_inv(const Scene& s, int off, V3 ro, V3 inv) {
  float tnear, tfar;
  slab_inv(ro, inv, P3(s, off), P3(s, off + 3), tnear, tfar);
  bool outside = tnear > EPSILON && tnear < tfar;
  float t = outside ? tnear : tfar;
  bool valid = tnear < tfar && t > EPSILON;
  return valid ? t : MAX_DISTANCE;
}

__device__ __forceinline__ float cube_t(const Scene& s, int off, V3 ro, V3 rd) {
  return cube_t_inv(s, off, ro, recip(rd));
}

__device__ Hit cube_hit(const Scene& s, int off, V3 ro, V3 rd, V3 inv) {
  V3 bmin = P3(s, off), bmax = P3(s, off + 3);
  Hit h;
  h.t = cube_t_inv(s, off, ro, inv);
  h.p = ro + rd * h.t;
  h.ng = box_normal(h.p, bmin, bmax);
  h.dpdu = box_dpdu(h.ng);
  box_uv(h.p, h.ng, bmin, bmax, h.u, h.v);
  h.sc = {0.f, 0.f, 0.f};
  h.use_sc = false;
  return h;
}

__device__ __forceinline__ Hit cube_hit(const Scene& s, int off, V3 ro, V3 rd) {
  return cube_hit(s, off, ro, rd, recip(rd));
}

// ---------------------------------------------------------- cornellbox ----
__device__ __forceinline__ float cornell_t_inv(const Scene& s, int off, V3 ro, V3 inv) {
  float tnear, tfar;
  slab_inv(ro, inv, P3(s, off), P3(s, off + 3), tnear, tfar);
  bool valid = tnear < tfar && tfar > EPSILON;
  return valid ? tfar : MAX_DISTANCE;
}

__device__ __forceinline__ float cornell_t(const Scene& s, int off, V3 ro, V3 rd) {
  return cornell_t_inv(s, off, ro, recip(rd));
}

__device__ Hit cornell_hit(const Scene& s, int off, V3 ro, V3 rd, V3 inv) {
  V3 bmin = P3(s, off), bmax = P3(s, off + 3);
  Hit h;
  h.t = cornell_t_inv(s, off, ro, inv);
  V3 p = ro + rd * h.t;
  V3 n = -box_normal(p, bmin, bmax);
  h.dpdu = box_dpdu(n);
  const float eps = F(1e-4);
  // left GREEN, right BLUE, floor/ceiling/front WHITE, back BLACK
  if (p.x < bmin.x + eps) h.sc = {F(0.25), F(0.75), F(0.25)};
  else if (p.x > bmax.x - eps) h.sc = {F(0.25), F(0.25), F(0.75)};
  else if (p.y < bmin.y + eps || p.y > bmax.y - eps || p.z > bmin.z + eps) h.sc = {1.f, 1.f, 1.f};
  else h.sc = {0.f, 0.f, 0.f};
  h.use_sc = true;
  box_uv(p, n, bmin, bmax, h.u, h.v);
  h.p = p;
  h.ng = n;
  return h;
}

__device__ __forceinline__ Hit cornell_hit(const Scene& s, int off, V3 ro, V3 rd) {
  return cornell_hit(s, off, ro, rd, recip(rd));
}

// ------------------------------------------------------- the quadrics ----
// Nearest root whose hit lies in z in [zlo, zhi], else the far root (cone,
// cylinder, hyperboloid, paraboloid).
__device__ __forceinline__ float clipped_quadratic(V3 o, V3 d, float a, float b, float c2, float zlo,
                                                   float zhi) {
  float t1, t2;
  bool ok = quadratic(a, b, c2, t1, t2);
  ok = ok && t2 >= -EPSILON;
  float t1c = t1 < EPSILON ? t2 : t1;
  float z1 = o.z + d.z * t1c;
  bool in1 = z1 >= zlo && z1 <= zhi;
  float z2 = o.z + d.z * t2;
  bool in2 = z2 >= zlo && z2 <= zhi && t1c != t2;
  float t = in1 ? t1c : t2;
  bool valid = ok && (in1 || in2) && t < MAX_DISTANCE && t >= EPSILON;
  return valid ? t : MAX_DISTANCE;
}

__device__ __forceinline__ float phi_of(float x, float y) {
  float phi = atan2_poly(y, x);
  return phi < 0.f ? phi + F(TWO_PI) : phi;
}

// cone / cylinder params: p[3], h, r, emission[3], reverse
__device__ __forceinline__ float cone_t(const Scene& s, int off, V3 ro, V3 rd, V3& o, V3& d) {
  float hh = P(s, off + 3), r = P(s, off + 4);
  o = to_object(ro - P3(s, off));
  d = to_object(rd);
  float rh = r / hh;
  float k = rh * rh;
  float a = d.x * d.x + d.y * d.y - k * d.z * d.z;
  float b = F(2.0) * (d.x * o.x + d.y * o.y - k * d.z * (o.z - hh));
  float c2 = o.x * o.x + o.y * o.y - k * (o.z - hh) * (o.z - hh);
  return clipped_quadratic(o, d, a, b, c2, -EPSILON, hh);
}

__device__ __forceinline__ float cylinder_t(const Scene& s, int off, V3 ro, V3 rd, V3& o, V3& d) {
  float hh = P(s, off + 3), r = P(s, off + 4);
  o = to_object(ro - P3(s, off));
  d = to_object(rd);
  float a = d.x * d.x + d.y * d.y;
  float b = F(2.0) * (d.x * o.x + d.y * o.y);
  float c2 = o.x * o.x + o.y * o.y - r * r;
  return clipped_quadratic(o, d, a, b, c2, -EPSILON, hh);
}

// The tail shared by the quadrics' hits: p, ng = normalize(dpdu x dpdv) and
// the world tangent from the object-space hit q.
__device__ __forceinline__ void quadric_tail(Hit& h, V3 q, V3 dpdv, V3 pos) {
  V3 dpdu = {F(-TWO_PI) * q.y, F(TWO_PI) * q.x, 0.f};
  h.ng = from_object(normalize(cross(dpdu, dpdv)));
  h.dpdu = from_object(dpdu);
  h.p = from_object(q) + pos;
  h.sc = {0.f, 0.f, 0.f};
  h.use_sc = false;
}

__device__ Hit frustum_hit(const Scene& s, int off, int cat, V3 ro, V3 rd) {
  V3 o, d;
  Hit h;
  h.t = cat == CONE ? cone_t(s, off, ro, rd, o, d) : cylinder_t(s, off, ro, rd, o, d);
  float hh = P(s, off + 3);
  V3 q = o + d * h.t;
  h.u = phi_of(q.x, q.y) / F(TWO_PI);
  h.v = q.z / hh;
  V3 dpdv = {0.f, 0.f, hh};
  if (cat == CONE) {
    float inv1mv = safe_div(F(1.0), F(1.0) - h.v);
    dpdv.x = -q.x * inv1mv;
    dpdv.y = -q.y * inv1mv;
  }
  quadric_tail(h, q, dpdv, P3(s, off));
  return h;
}

// disk params: p[3], r, inner_r, emission[3], reverse
__device__ __forceinline__ float disk_t(const Scene& s, int off, V3 ro, V3 rd, V3& q) {
  float r = P(s, off + 3), ir = P(s, off + 4);
  V3 o = to_object(ro - P3(s, off)), d = to_object(rd);
  float t = -safe_div(o.z, d.z);
  q = o + d * t;
  float dist2 = q.x * q.x + q.y * q.y;
  bool valid = fabsf(d.z) > F(1e-12) && t > 0.f && t < MAX_DISTANCE && dist2 <= r * r &&
               dist2 >= ir * ir;
  return valid ? t : MAX_DISTANCE;
}

__device__ Hit disk_hit(const Scene& s, int off, V3 ro, V3 rd) {
  V3 q;
  Hit h;
  h.t = disk_t(s, off, ro, rd, q);
  float r = P(s, off + 3), ir = P(s, off + 4);
  h.u = phi_of(q.x, q.y) / F(TWO_PI);
  float r_hit = sqrtf(q.x * q.x + q.y * q.y);
  h.v = F(1.0) - safe_div(r_hit - ir, r - ir);
  V3 dpdu = {F(-TWO_PI) * q.y, F(TWO_PI) * q.x, 0.f};
  h.ng = from_object(V3{0.f, 0.f, F(1.0)});  // local +z == world +y
  h.dpdu = from_object(dpdu);
  h.p = from_object(q) + P3(s, off);
  h.sc = {0.f, 0.f, 0.f};
  h.use_sc = false;
  return h;
}

// hyperboloid params: p[3], p1[3], p2[3], ah, ch, emission[3], reverse
__device__ __forceinline__ float hyperboloid_t(const Scene& s, int off, V3 ro, V3 rd, V3& o, V3& d) {
  float ah = P(s, off + 9), ch = P(s, off + 10);
  float z1 = P(s, off + 5), z2 = P(s, off + 8);
  o = to_object(ro - P3(s, off));
  d = to_object(rd);
  float a = ah * (d.x * d.x + d.y * d.y) - ch * d.z * d.z;
  float b = F(2.0) * (ah * (d.x * o.x + d.y * o.y) - ch * d.z * o.z);
  float c2 = ah * (o.x * o.x + o.y * o.y) - ch * o.z * o.z - F(1.0);
  return clipped_quadratic(o, d, a, b, c2, fminf(z1, z2), fmaxf(z1, z2));
}

__device__ Hit hyperboloid_hit(const Scene& s, int off, V3 ro, V3 rd) {
  V3 o, d;
  Hit h;
  h.t = hyperboloid_t(s, off, ro, rd, o, d);
  V3 p1 = P3(s, off + 3), p2 = P3(s, off + 6);
  V3 q = o + d * h.t;
  h.v = safe_div(q.z - p1.z, p2.z - p1.z);
  V3 pr = p1 * (F(1.0) - h.v) + p2 * h.v;
  float phi = phi_of(pr.x * q.x + pr.y * q.y, pr.x * q.y - q.x * pr.y);
  h.u = phi / F(TWO_PI);
  float sin_p = sinf(phi), cos_p = cosf(phi);
  float dx = p2.x - p1.x, dy = p2.y - p1.y, dz = p2.z - p1.z;
  quadric_tail(h, q, V3{dx * cos_p - dy * sin_p, dx * sin_p + dy * cos_p, dz}, P3(s, off));
  return h;
}

// paraboloid params: p[3], z0, z1, r, emission[3], reverse
__device__ __forceinline__ float paraboloid_t(const Scene& s, int off, V3 ro, V3 rd, V3& o, V3& d) {
  float z0 = P(s, off + 3), z1 = P(s, off + 4), r = P(s, off + 5);
  o = to_object(ro - P3(s, off));
  d = to_object(rd);
  float zmin = fminf(z0, z1), zmax = fmaxf(z0, z1);
  float k = safe_div(zmax, r * r);
  float a = k * (d.x * d.x + d.y * d.y);
  float b = F(2.0) * k * (d.x * o.x + d.y * o.y) - d.z;
  float c2 = k * (o.x * o.x + o.y * o.y) - o.z;
  return clipped_quadratic(o, d, a, b, c2, zmin, zmax);
}

__device__ Hit paraboloid_hit(const Scene& s, int off, V3 ro, V3 rd) {
  V3 o, d;
  Hit h;
  h.t = paraboloid_t(s, off, ro, rd, o, d);
  float z0 = P(s, off + 3), z1 = P(s, off + 4);
  float zmin = fminf(z0, z1), zmax = fmaxf(z0, z1);
  V3 q = o + d * h.t;
  h.u = phi_of(q.x, q.y) / F(TWO_PI);
  h.v = safe_div(q.z - zmin, zmax - zmin);
  float hz = fabsf(q.z) < F(1e-8) ? F(1e-8) : q.z;
  float dz = zmax - zmin;
  quadric_tail(h, q, V3{dz * q.x / (F(2.0) * hz), dz * q.y / (F(2.0) * hz), dz}, P3(s, off));
  return h;
}

// ----------------------------------------------------------- bound box ----
// Conservative world AABB of one object (comparisons only, no gradient).
// Degenerate axes are padded relative to the coordinate's magnitude, so a
// flat rectangle or a disk survives the strict slab test.
__device__ void object_aabb(const Scene& s, int cat, int off, V3& lo, V3& hi) {
  V3 p = P3(s, off);
  switch (cat) {
    case CUBE: case RECTANGLE: case CORNELLBOX: {
      V3 b1 = P3(s, off + 3);
      float mag = fmaxf(fmaxf(fabsf(p.x), fabsf(b1.x)),
                        fmaxf(fmaxf(fabsf(p.y), fabsf(b1.y)), fmaxf(fabsf(p.z), fabsf(b1.z))));
      float eps = F(1e-4) * (F(1.0) + mag);
      lo = p - V3{eps, eps, eps};
      hi = b1 + V3{eps, eps, eps};
      return;
    }
    case SPHERE: {
      float r = P(s, off + 3);
      lo = p - V3{r, r, r};
      hi = p + V3{r, r, r};
      return;
    }
    case CONE: case CYLINDER: {
      float hh = P(s, off + 3), r = P(s, off + 4);
      lo = p + V3{-r, F(0.0) * hh, -r};
      hi = p + V3{r, hh, r};
      return;
    }
    case DISK: {
      float r = P(s, off + 3), eps = F(1e-4) * (F(1.0) + fabsf(p.y));
      lo = p + V3{-r, -eps, -r};
      hi = p + V3{r, eps, r};
      return;
    }
    case PARABOLOID: {
      float z0 = P(s, off + 3), z1 = P(s, off + 4), r = P(s, off + 5);
      float zmax = fmaxf(z0, z1), zmin = fminf(fminf(z0, z1), F(0.0) * z0);
      lo = p + V3{-r, zmin, -r};
      hi = p + V3{r, zmax, r};
      return;
    }
    default: {  // HYPERBOLOID
      V3 p1 = P3(s, off + 3), p2 = P3(s, off + 6);
      float r = fmaxf(sqrtf(p1.x * p1.x + p1.y * p1.y), sqrtf(p2.x * p2.x + p2.y * p2.y));
      lo = p + V3{-r, fminf(p1.z, p2.z), -r};
      hi = p + V3{r, fmaxf(p1.z, p2.z), r};
      return;
    }
  }
}

// The bound boxes of every cluster (CLUSTER consecutive rows of a batched
// group), 6 floats each, into `box`: the threads of a block share the work.
__device__ void cluster_boxes(const Scene& s, float* box, int tid, int n_threads) {
  int c = 0;
  for (int g = 0; g < s.n_groups; ++g) {
    int first = __ldg(s.group + 2 * g), count = __ldg(s.group + 2 * g + 1);
    for (int k0 = 0; k0 < count; k0 += CLUSTER, ++c) {
      if (c % n_threads != tid) continue;
      V3 lo, hi;
      int end = first + min(k0 + CLUSTER, count);
      for (int i = first + k0; i < end; ++i) {
        V3 a, b;
        object_aabb(s, obj_cat(s, i), obj_off(s, i), a, b);
        if (i == first + k0) {
          lo = a;
          hi = b;
        } else {
          lo = {fminf(lo.x, a.x), fminf(lo.y, a.y), fminf(lo.z, a.z)};
          hi = {fmaxf(hi.x, b.x), fmaxf(hi.y, b.y), fmaxf(hi.z, b.z)};
        }
      }
      float* o = box + 6 * c;
      o[0] = lo.x; o[1] = lo.y; o[2] = lo.z;
      o[3] = hi.x; o[4] = hi.y; o[5] = hi.z;
    }
  }
}

// ------------------------------------------------- scene-level queries ----
// The scene queries and `bounce` are templates over two compile-time facts
// of a scene, so that K1 compiles only the code a scene needs:
//   ALL  - it holds a shape other than SPHERE, RECTANGLE and CORNELLBOX (the
//          benchmark scenes' three); without it the six other shapes' code
//          is left out (config 2 measured 6% slower with it, an H100);
//   CULL - the kernel may cull (the cluster boxes are set when `s.box` is);
//   MATS - it holds a material other than MATTE and MIRROR or a texture other
//          than UNIFORM_COLOR; without it the metal, glass and uv texture
//          code is left out, and configs 1-2 compile the smaller bounce.
// K2 takes CULL's default (it sets no cluster boxes, so it never culls) and
// ALL as its build says (render_grad.cuh).

// The t-only test of table row i.  The benchmark scenes' categories come
// first as plain branches: one switch over all nine measured 4-13% slower on
// K1 and K2 (an H100, config 2).
template <bool ALL = true>
__device__ __forceinline__ float object_t(const Scene& s, int i, V3 ro, V3 rd) {
  int cat = obj_cat(s, i), off = obj_off(s, i);
  V3 a, b;
  if (cat == SPHERE) return sphere_t(s, off, ro, rd, a, b);
  if (cat == RECTANGLE) return rect_t(s, off, rect_frame(s, off), ro, rd, a);
  if (!ALL || cat == CORNELLBOX) return cornell_t(s, off, ro, rd);
  switch (cat) {
    case CUBE: return cube_t(s, off, ro, rd);
    case CONE: return cone_t(s, off, ro, rd, a, b);
    case CYLINDER: return cylinder_t(s, off, ro, rd, a, b);
    case DISK: return disk_t(s, off, ro, rd, a);
    case HYPERBOLOID: return hyperboloid_t(s, off, ro, rd, a, b);
    case PARABOLOID: return paraboloid_t(s, off, ro, rd, a, b);
  }
  return MAX_DISTANCE;
}

// Can the ray reach cluster c's bound box before `bound`?
__device__ __forceinline__ bool cluster_possible(const Scene& s, int c, V3 ro, V3 rd, float bound) {
  const float* b = s.box + 6 * c;
  float tn, tf;
  slab(ro, rd, V3{b[0], b[1], b[2]}, V3{b[3], b[4], b[5]}, tn, tf);
  return tn < tf && tf > EPSILON && tn < bound;
}

// Closest hit in fold order (the table's row order); strict <, so a tie
// keeps the earlier row.  With the cluster boxes set (`cull`), a batched
// group's cluster is skipped when its box cannot be reached before the best
// hit so far: exact, as no object inside it can then win.
template <bool ALL = true, bool CULL = true>
__device__ __forceinline__ int closest(const Scene& s, V3 ro, V3 rd) {
  float best_t = MAX_DISTANCE;
  int best = -1;
  const bool cull = CULL && s.box;
  const int end = cull ? s.n_plain : s.n_obj;
  for (int i = 0; i < end; ++i) {
    float t = object_t<ALL>(s, i, ro, rd);
    if (t < best_t) {
      best_t = t;
      best = i;
    }
  }
  if (!cull) return best;
  int c = 0;
  for (int g = 0; g < s.n_groups; ++g) {
    int first = __ldg(s.group + 2 * g), count = __ldg(s.group + 2 * g + 1);
    for (int k0 = 0; k0 < count; k0 += CLUSTER, ++c) {
      if (!cluster_possible(s, c, ro, rd, best_t)) continue;
      int stop = first + min(k0 + CLUSTER, count);
      for (int i = first + k0; i < stop; ++i) {
        float t = object_t<ALL>(s, i, ro, rd);
        if (t < best_t) {
          best_t = t;
          best = i;
        }
      }
    }
  }
  return best;
}

// Any occluder with t in (EPSILON, max_t), in fold order; stops at the first.
template <bool ALL = true, bool CULL = true>
__device__ __forceinline__ bool occluded(const Scene& s, V3 ro, V3 rd, float max_t) {
  const bool cull = CULL && s.box;
  const int end = cull ? s.n_plain : s.n_obj;
  for (int i = 0; i < end; ++i) {
    float t = object_t<ALL>(s, i, ro, rd);
    if (t > EPSILON && t < max_t) return true;
  }
  if (!cull) return false;
  int c = 0;
  for (int g = 0; g < s.n_groups; ++g) {
    int first = __ldg(s.group + 2 * g), count = __ldg(s.group + 2 * g + 1);
    for (int k0 = 0; k0 < count; k0 += CLUSTER, ++c) {
      if (!cluster_possible(s, c, ro, rd, max_t)) continue;
      int stop = first + min(k0 + CLUSTER, count);
      for (int i = first + k0; i < stop; ++i) {
        float t = object_t<ALL>(s, i, ro, rd);
        if (t > EPSILON && t < max_t) return true;
      }
    }
  }
  return false;
}

template <bool ALL = true>
__device__ Hit object_hit(const Scene& s, int i, V3 ro, V3 rd) {
  int cat = obj_cat(s, i), off = obj_off(s, i);
  if (!ALL) {
    if (cat == SPHERE) return sphere_hit(s, off, ro, rd);
    if (cat == RECTANGLE) return rect_hit(s, off, ro, rd);
    return cornell_hit(s, off, ro, rd);
  }
  switch (cat) {
    case SPHERE: return sphere_hit(s, off, ro, rd);
    case RECTANGLE: return rect_hit(s, off, ro, rd);
    case CUBE: return cube_hit(s, off, ro, rd);
    case CONE: case CYLINDER: return frustum_hit(s, off, cat, ro, rd);
    case DISK: return disk_hit(s, off, ro, rd);
    case HYPERBOLOID: return hyperboloid_hit(s, off, ro, rd);
    case PARABOLOID: return paraboloid_hit(s, off, ro, rd);
  }
  return cornell_hit(s, off, ro, rd);
}

// ------------------------------------------ K1's fold and staged values ----
// K1 (render_block.cuh) computes what does not change within a launch or
// along a ray once: each rectangle's frame once per block, each ray's slab
// reciprocal once per ray.  The values come from the same functions on the
// same inputs, so every test below gives the value of its counterpart above
// (object_t, closest, occluded, object_hit), which K2 keeps.

// A ray and its slab reciprocal, recip(d).
struct Ray {
  V3 o, d, inv;
};

__device__ __forceinline__ Ray make_ray(V3 o, V3 d) { return {o, d, recip(d)}; }

// A block's staged rectangle frames: f[row] = rect_frame of each RECTANGLE
// table row below n, in shared memory (the other rows' slots unused).  A
// rectangle at row n or later computes its frame in each test.
struct Frames {
  const RectFrame* f;
  int n;
};

// Fills `f` (n slots) for stage_frames' rows: the threads of a block share
// the work, as in cluster_boxes.
__device__ void stage_frames(const Scene& s, RectFrame* f, int n, int tid, int n_threads) {
  for (int i = tid; i < n; i += n_threads)
    if (obj_cat(s, i) == RECTANGLE) f[i] = rect_frame(s, obj_off(s, i));
}

__device__ __forceinline__ RectFrame row_frame(const Scene& s, const Frames& fr, int row, int off) {
  return row < fr.n ? fr.f[row] : rect_frame(s, off);
}

// The t-only tests of table row i for ray `a` where `with_a` and ray `b`
// where `with_b` (MAX_DISTANCE where not), in one dispatch: each branch tests
// both rays with the row's parameters, read once.
template <bool ALL>
__device__ __forceinline__ void object_t2(const Scene& s, const Frames& fr, int i, bool with_a,
                                          const Ray& a, bool with_b, const Ray& b, float& ta,
                                          float& tb) {
  const int cat = obj_cat(s, i), off = obj_off(s, i);
  V3 x, y;
  ta = tb = MAX_DISTANCE;
  auto both = [&](auto t) {
    if (with_a) ta = t(a);
    if (with_b) tb = t(b);
  };
  if (cat == SPHERE) return both([&](const Ray& r) { return sphere_t(s, off, r.o, r.d, x, y); });
  if (cat == RECTANGLE) {
    const RectFrame f = row_frame(s, fr, i, off);
    return both([&](const Ray& r) { return rect_t(s, off, f, r.o, r.d, x); });
  }
  if (!ALL || cat == CORNELLBOX)
    return both([&](const Ray& r) { return cornell_t_inv(s, off, r.o, r.inv); });
  switch (cat) {
    case CUBE: return both([&](const Ray& r) { return cube_t_inv(s, off, r.o, r.inv); });
    case CONE: return both([&](const Ray& r) { return cone_t(s, off, r.o, r.d, x, y); });
    case CYLINDER: return both([&](const Ray& r) { return cylinder_t(s, off, r.o, r.d, x, y); });
    case DISK: return both([&](const Ray& r) { return disk_t(s, off, r.o, r.d, x); });
    case HYPERBOLOID:
      return both([&](const Ray& r) { return hyperboloid_t(s, off, r.o, r.d, x, y); });
    case PARABOLOID:
      return both([&](const Ray& r) { return paraboloid_t(s, off, r.o, r.d, x, y); });
  }
}

// cluster_possible with the ray's reciprocal.
__device__ __forceinline__ bool cluster_reach(const Scene& s, int c, const Ray& r, float bound) {
  const float* b = s.box + 6 * c;
  float tn, tf;
  slab_inv(r.o, r.inv, V3{b[0], b[1], b[2]}, V3{b[3], b[4], b[5]}, tn, tf);
  return tn < tf && tf > EPSILON && tn < bound;
}

// K1's fold: closest's row for ray `a` and, where `want_b` (SHADOW builds),
// occluded's bit for ray `b` below `max_b` (in `occ`), in one pass over the
// rows in fold order.  `a` keeps closest's strict < (a tie keeps the earlier
// row); `b`'s bit is an OR over the rows, which no order changes, and its
// test stops once set.  With the cull each ray keeps its own cluster test
// (best_t for `a`, max_b for `b`), as in closest and occluded.  Without
// `want_a` (a shadow ray with no next ray) `a`'s result is not used: the
// rows before the clusters test it all the same (a branch there cost K1
// 2-3% on an H100), the clusters skip it.
template <bool ALL, bool CULL, bool SHADOW = true>
__device__ __forceinline__ int fold(const Scene& s, const Frames& fr, bool want_a, const Ray& a,
                                    bool want_b, const Ray& b, float max_b, bool& occ) {
  float best_t = MAX_DISTANCE;
  int best = -1;
  occ = false;
  auto test = [&](int i, bool for_a, bool for_b) {
    float ta, tb;
    object_t2<ALL>(s, fr, i, for_a, a, for_b, b, ta, tb);
    if (for_a && ta < best_t) {
      best_t = ta;
      best = i;
    }
    if (for_b && tb > EPSILON && tb < max_b) occ = true;
  };
  want_b = SHADOW && want_b;
  const bool cull = CULL && s.box;
  const int end = cull ? s.n_plain : s.n_obj;
  for (int i = 0; i < end; ++i) test(i, true, want_b && !occ);
  if (!cull) return best;
  int c = 0;
  for (int g = 0; g < s.n_groups; ++g) {
    int first = __ldg(s.group + 2 * g), count = __ldg(s.group + 2 * g + 1);
    for (int k0 = 0; k0 < count; k0 += CLUSTER, ++c) {
      bool pa = want_a && cluster_reach(s, c, a, best_t);
      bool pb = want_b && !occ && cluster_reach(s, c, b, max_b);
      if (!pa && !pb) continue;
      int stop = first + min(k0 + CLUSTER, count);
      for (int i = first + k0; i < stop; ++i) test(i, pa, pb && !occ);
    }
  }
  return best;
}

// object_hit with the staged frames and the ray's reciprocal.
template <bool ALL = true>
__device__ Hit object_hit(const Scene& s, const Frames& fr, int i, const Ray& r) {
  int cat = obj_cat(s, i), off = obj_off(s, i);
  if (cat == SPHERE) return sphere_hit(s, off, r.o, r.d);
  if (cat == RECTANGLE) return rect_hit(s, off, row_frame(s, fr, i, off), r.o, r.d);
  if (!ALL || cat == CORNELLBOX) return cornell_hit(s, off, r.o, r.d, r.inv);
  switch (cat) {
    case CUBE: return cube_hit(s, off, r.o, r.d, r.inv);
    case CONE: case CYLINDER: return frustum_hit(s, off, cat, r.o, r.d);
    case DISK: return disk_hit(s, off, r.o, r.d);
    case HYPERBOLOID: return hyperboloid_hit(s, off, r.o, r.d);
    case PARABOLOID: return paraboloid_hit(s, off, r.o, r.d);
  }
  return cornell_hit(s, off, r.o, r.d, r.inv);
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

#include "bsdf.cuh"

// ------------------------------------------------------------- camera ----
// Primary ray direction through pixel (row, col) with jitter (jx, jy).
struct Camera {
  V3 eye, right, up, back;
  float tan_half, aspect;
};

__device__ __forceinline__ Camera load_camera(const Scene& s) {
  const int cam = s.cam;
  return {P3(s, cam), P3(s, cam + 3), P3(s, cam + 6), P3(s, cam + 9), P(s, cam + 12), P(s, cam + 13)};
}

// The unnormalised direction; ndc_x/ndc_y/sx/sy are returned for the adjoint.
__device__ __forceinline__ V3 camera_dir(const Camera& c, float fcol, float frow, float jx, float jy,
                                         float sx_scale, float sy_scale, float& ndc_x, float& ndc_y,
                                         float& sx, float& sy) {
  ndc_x = (fcol + jx) * sx_scale - F(1.0);
  ndc_y = F(1.0) - (frow + jy) * sy_scale;
  sx = ndc_x * c.tan_half * c.aspect;
  sy = ndc_y * c.tan_half;
  return V3{c.right.x * sx + c.up.x * sy - c.back.x, c.right.y * sx + c.up.y * sy - c.back.y,
            c.right.z * sx + c.up.z * sy - c.back.z};
}

// --------------------------------------------------------------- bounce ----
// The state a path carries into a bounce (the radiance sum e aside: its
// cotangent is the pixel's g at every bounce, so the adjoint never needs it).
struct PathState {
  V3 ro, rd, thr;
  bool skip_emission;
};

// Every value of one bounce that K2's adjoint reads.  K1 keeps none of it:
// the fields it does not use are dead code there.
struct Bounce {
  int obj, off, eoff, tex_off, moff, tcat, mcat, kind;
  bool emissive, emit_on, is_matte;
  float u1, u2, u_lobe;  // the BSDF sample's uniforms
  Hit h;
  bool into, dpdu_ok;
  V3 n, a, ss1, ss2, ss, ts, wo, sc;
  float kd, sigma;  // matte
  V3 wi, weight_raw, weight, contrib, wi_world;
  float cw;         // matte: weight_raw = f * cw, cw free of parameters
  float offs;       // ro' = p + n * offs
  // next-event estimation (nee_on: did NEE, unoccluded, light in wo's hemisphere)
  bool nee_on, occ;  // occ: the shadow ray was blocked (false where no NEE ran)
  int loff, lem;
  RectFrame lf;
  float lu1, lu2, pdf_a, d2, cos_l, cos_s, dist;
  V3 n_l, to_l, wl, wsh, wl_local, rad, f_light;
};

// A bounce in parts around its shadow ray, so that K1 can test the shadow
// ray later, together with the path's next ray (render_block.cuh); `bounce`
// runs them in sequence with the shadow scan between them.
//
// The values of bounce_open that the later parts read, kept where the caller
// keeps its own (registers), not only in `v`.
struct Shading {
  V3 n, ss, ts, wo, sc, wi, weight;
};

// bounce_open: the bounce from `st` whose closest hit is table row i (>= 0):
// hit record, shading frame, surface color, BSDF sample and the emission it
// adds (`contrib`).  STAGED (K1): rectangle frames from `fr` and the ray's
// reciprocal `inv`; otherwise (K2) both computed where used.
template <bool ALL = true, bool MATS = true, int STRIP = 0, bool STAGED = false>
__device__ __forceinline__ void bounce_open(const Scene& s, const Frames& fr, const PathState& st,
                                            int i, V3 inv, uint32_t seed, uint32_t sample,
                                            int bounce_idx, uint32_t row, uint32_t col, Bounce& v,
                                            Shading& sh, V3& contrib) {
  V3 rd = st.rd;
  v.obj = i;
  if constexpr (STAGED) v.h = object_hit<ALL>(s, fr, i, Ray{st.ro, rd, inv});
  else v.h = object_hit<ALL>(s, i, st.ro, rd);
  const Hit& h = v.h;
  const int* o = s.obj + OBJ_INTS * i;
  int off = __ldg(o + 1), mat_row = __ldg(o + 2), tex_row = __ldg(o + 3);
  v.emissive = __ldg(o + 4) != 0;
  v.off = off;
  v.eoff = off + emission_offset(__ldg(o));
  float reverse = P(s, v.eoff + 3);
  bool face = dot(h.ng * reverse, rd) < -EPSILON;
  V3 emission = face ? P3(s, v.eoff) : V3{0.f, 0.f, 0.f};
  v.into = dot(h.ng, rd) < -EPSILON;
  V3 n = v.into ? h.ng : -h.ng;
  v.n = n;

  // shading frame
  v.dpdu_ok = dot(h.dpdu, h.dpdu) > F(1e-16);
  v.a = v.dpdu_ok ? h.dpdu : ortho(n);
  v.ss1 = normalize(v.a);
  v.ss2 = v.ss1 - n * dot(v.ss1, n);
  V3 ss = normalize(v.ss2);
  V3 ts = cross(n, ss);
  V3 wo = world_to_local(-rd, n, ss, ts);
  v.ss = ss;
  v.ts = ts;
  v.wo = wo;

  v.tcat = __ldg(s.tex + 2 * tex_row);
  v.tex_off = __ldg(s.tex + 2 * tex_row + 1);
  V3 sc;
  if constexpr ((STRIP & STRIP_CONST_TEXTURE) != 0) {
    sc = {F(1.0), F(1.0), F(1.0)};
  } else {
    sc = h.use_sc ? h.sc : (MATS ? texture_color(s, v.tcat, v.tex_off, h.u, h.v) : P3(s, v.tex_off));
  }
  v.sc = sc;

  float u1, u2, u_lobe;
  draw3<STRIP>(stream_id(seed, sample, bounce_idx, TAG_BSDF), row, col, u1, u2, u_lobe);
  int mcat = __ldg(s.mat + 3 * mat_row);
  v.mcat = mcat;
  v.moff = __ldg(s.mat + 3 * mat_row + 1);
  v.is_matte = mcat == MATTE;
  V3 wi, weight;
  if (v.is_matte) {
    v.kd = P(s, v.moff);
    v.sigma = P(s, v.moff + 1);
    float r = sqrtf(u1);
    float angle = F(2.0 * PI) * u2;
    wi = {r * cosf(angle), r * sinf(angle), sqrtf(fmaxf(F(1.0) - u1, F(1e-12)))};
    bool same = wo.z * wi.z > F(1e-5);
    float pdf = same ? fabsf(wi.z) * F(INV_PI) : 0.f;
    V3 f = matte_f(v.kd, v.sigma, sc, wo, wi);
    v.cw = pdf > 0.f ? fabsf(wi.z) / fmaxf(pdf, F(1e-20)) : 0.f;
    weight = f * v.cw;
  } else if (!MATS || mcat == MIRROR) {
    wi = {-wo.x, -wo.y, wo.z};
    weight = sc * P(s, v.moff);
  } else {  // METAL, GLASS
    v.kind = __ldg(s.mat + 3 * mat_row + 2);
    v.u1 = u1;
    v.u2 = u2;
    v.u_lobe = u_lobe;
    float mp[MAX_MAT_PARAMS];
    const int n = material_params(mcat);
#pragma unroll
    for (int k = 0; k < MAX_MAT_PARAMS; ++k) mp[k] = k < n ? P(s, v.moff + k) : 0.f;
    Vt<float> wi_t, w_t;
    sample_material_t<float>(mcat, v.kind, mp, to_vt(sc), u1, u2, u_lobe, to_vt(wo), v.into, wi_t, w_t);
    wi = to_v3(wi_t);
    weight = to_v3(w_t);
  }
  v.wi = wi;
  v.weight_raw = weight;
  weight = clip01(weight);
  v.weight = weight;
  sh = {n, ss, ts, wo, sc, wi, weight};

  v.emit_on = face && !(st.skip_emission && v.emissive);
  contrib = v.emit_on ? emission : V3{0.f, 0.f, 0.f};
}

// The light sample of a bounce that samples one (matte, not emissive; its
// uniforms lu1, lu2, lr), up to its shadow ray: from v.h.p + sh.n * 1e-4
// along v.wsh, below v.dist * (1 - 1e-3).
template <bool STAGED = false>
__device__ __forceinline__ void light_sample(const Scene& s, const Frames& fr, Bounce& v,
                                             const Shading& sh, float lu1, float lu2, float lr) {
  int lidx = min((int)(lr * (float)s.n_light), s.n_light - 1);
  const int* l = s.light + 3 * lidx;
  int lrow = __ldg(l + 1);
  int loff = obj_off(s, lrow);
  v.loff = loff;
  v.lem = __ldg(l + 2);
  v.lu1 = lu1;
  v.lu2 = lu2;
  // AREA light over a RECTANGLE: point, normal, area pdf
  RectFrame f;
  if constexpr (STAGED) f = row_frame(s, fr, lrow, loff);
  else f = rect_frame(s, loff);
  v.lf = f;
  V3 p_l = P3(s, loff) + f.ex * lu1 + f.ey * lu2;
  if constexpr (STAGED) v.pdf_a = F(1.0) / fmaxf(f.len_x * f.len_y, F(1e-12));  // length(ex) ...
  else v.pdf_a = F(1.0) / fmaxf(length(f.ex) * length(f.ey), F(1e-12));
  v.n_l = f.n * P(s, loff + 9);
  v.to_l = p_l - v.h.p;
  v.d2 = fmaxf(dot(v.to_l, v.to_l), F(1e-12));
  v.wl = v.to_l * (F(1.0) / sqrtf(v.d2));
  v.cos_l = fmaxf(dot(v.n_l, -v.wl), 0.f);
  v.cos_s = fmaxf(dot(v.wl, sh.n), 0.f);
  v.rad = P3(s, v.lem) * (v.cos_l * v.cos_s / (v.d2 * v.pdf_a) * (float)s.n_light);
  // one shadow ray toward the sample
  v.dist = length(v.to_l);
  v.wsh = v.to_l * (F(1.0) / fmaxf(v.dist, F(1e-12)));
}

// The light sample's BSDF value toward the shadow ray (whatever the ray's
// bit): v.wl_local, v.f_light; returns whether the light lies in wo's
// hemisphere.
__device__ __forceinline__ bool nee_light(Bounce& v, const Shading& sh) {
  v.wl_local = world_to_local(v.wsh, sh.n, sh.ss, sh.ts);
  bool lit = sh.wo.z * v.wl_local.z > F(1e-5);
  v.f_light = lit ? matte_f(v.kd, v.sigma, sh.sc, sh.wo, v.wl_local) : V3{0.f, 0.f, 0.f};
  return lit;
}

// The path's next state: throughput, the next ray, the emission skip.
__device__ __forceinline__ void advance(PathState& st, Bounce& v, const Shading& sh, bool did_nee) {
  st.thr = st.thr * sh.weight;
  V3 wi_world = local_to_world(sh.wi, sh.n, sh.ss, sh.ts);
  v.wi_world = wi_world;
  float outdot = dot(sh.n, wi_world);
  v.offs = outdot > EPSILON ? F(1e-4) : F(-1e-4);
  st.ro = v.h.p + sh.n * v.offs;
  st.rd = wi_world;
  st.skip_emission = did_nee;
}

// One bounce of the path from `st`, as K2 runs it: closest hit, bounce_open,
// the light sample and its shadow scan, the radiance and the next state.
// Returns false on a miss (the path adds nothing more); otherwise adds the
// bounce's radiance to `e` and advances `st`.  The bounce's two discrete
// decisions land in `v`: the winner's table row (`v.obj`) and the shadow
// ray's bit (`v.occ`).  REPLAY (K2's reverse sweep, adjoint.cuh) takes both
// from `v` as an earlier call on the same state recorded them, in place of
// the closest-hit fold and the shadow scan; every other value is computed by
// the same code in the same order, so a replayed bounce is the recorded one
// bit for bit.
template <bool ALL = true, bool CULL = true, bool MATS = true, int STRIP = 0, bool REPLAY = false>
__device__ __forceinline__ bool bounce(const Scene& s, PathState& st, V3& e, uint32_t seed,
                                       uint32_t sample, int bounce_idx, uint32_t row, uint32_t col,
                                       Bounce& v) {
  int i;
  if constexpr (REPLAY) i = v.obj;
  else i = closest<ALL, CULL>(s, st.ro, st.rd);
  if (i < 0) return false;
  const Frames none{nullptr, 0};
  Shading sh;
  V3 contrib;
  bounce_open<ALL, MATS, STRIP>(s, none, st, i, V3{0.f, 0.f, 0.f}, seed, sample, bounce_idx, row,
                                col, v, sh, contrib);
  bool did_nee = false;
  v.nee_on = false;
  if constexpr (!REPLAY) v.occ = false;
  if (s.n_light > 0) {
    float lu1, lu2, lr;
    draw3<STRIP>(stream_id(seed, sample, bounce_idx, TAG_LIGHT_U), row, col, lu1, lu2, lr);
    did_nee = v.is_matte && !v.emissive;
    if (did_nee && (STRIP & STRIP_NO_NEE) == 0) {
      light_sample(s, none, v, sh, lu1, lu2, lr);
      bool occ = false;
      if constexpr (REPLAY) occ = v.occ;
      else if constexpr ((STRIP & STRIP_NO_SHADOW) == 0)
        occ = occluded<ALL, CULL>(s, v.h.p + sh.n * F(1e-4), v.wsh, v.dist * F(1.0 - 1e-3));
      if constexpr (!REPLAY) v.occ = occ;
      V3 direct = v.rad * (occ ? 0.f : F(1.0));
      bool lit = nee_light(v, sh);
      v.nee_on = lit && !occ;
      contrib = contrib + direct * v.f_light;
    }
  }
  v.contrib = contrib;
  e = e + st.thr * contrib;
  advance(st, v, sh, did_nee);
  return true;
}

}  // namespace
