// KH's per-pixel work: the penumbra term's primary and mirror receivers
// (`diff/boundary.py` `shadow_boundary_term`) and the adjoint of their
// points with respect to the camera.  receivers.cu launches it one thread a
// pixel; csrc/host/edge_host.cpp runs it on the CPU.
//
// Forward, for the pixel-centre camera ray (`_pixel_rays`): the closest hit
// against the scene (path.cuh `closest`, `object_hit`: the fold K1, KR and K2
// run), then, where the scene has a Mirror material, the ray reflected off
// that hit (offset 1e-4 along the facing normal) and its closest hit.  For
// each receiver it writes what KP reads (penumbra.cuh `KPIn`): the facing
// normal, the shading frame ss, ts, wo (bounce_open's), the surface color,
// the tint it is seen through (1 for the primary; for the mirror receiver
// the mirror's clip(sc · kr, 0, 1) where the primary hit is a Mirror, else
// 0), the material row where the hit is a matte, non-emissive receiver
// (else -1), the object's scene index, and the hit point.  A miss gives
// `intersect_scene`'s miss record (every field 0, object -1), and the same
// expressions run on it, so every plane is the plain version's.
//
// Backward: the cotangent of the points (R, 3, H, W) onto the camera's 14
// parameters (eye, right, up, back, tan_half_fovy, aspect), through the hit
// points at fixed (detached) geometry: K2's hit adjoints (adjoint.cuh) give
// the cotangents of each hit's ray from those of its point and normal; the
// mirror receiver's go back through the reflection onto the primary hit's
// point, normal and ray; camera_adj takes the primary ray's onto the camera.
// The scene's parameters take none (`NoGrad`).
#pragma once

// adjoint.cuh's stored bounces, which nothing here reads
#ifndef MAX_GRAD_BOUNCES
#define MAX_GRAD_BOUNCES 1
#endif
#include "adjoint.cuh"

namespace {

// floats a receiver writes per pixel (KP's plane set: penumbra.cuh
// KP_PLANES) and the camera's parameters
constexpr int KH_PLANES = 18;
constexpr int KH_CAMERA = 14;

// A gradient that keeps nothing: the hit adjoints' share of the scene.
struct NoGrad {};
__device__ __forceinline__ void gadd(NoGrad, int, float) {}
__device__ __forceinline__ void gadd3(NoGrad, int, V3) {}

// The camera's 14 parameters of a gradient laid out as the flat tensor's
// (offset `cam` first), at p[(i - cam) * stride].
struct CamGrad {
  float* p;
  int stride, cam;
};
__device__ __forceinline__ void gadd(CamGrad G, int i, float d) {
  G.p[(i - G.cam) * G.stride] += d;
}
__device__ __forceinline__ void gadd3(CamGrad G, int i, V3 d) {
  gadd(G, i, d.x);
  gadd(G, i + 1, d.y);
  gadd(G, i + 2, d.z);
}

// intersect_scene's record of the closest hit of (ro, rd): the winner's
// table row (-1: a miss) and the fields the receivers read.
struct KHHit {
  int row, mat_row, tex_row, obj;
  bool emissive, into;
  Hit h;
  V3 n;  // the normal facing the ray
};

__device__ __forceinline__ KHHit kh_hit(const Scene& s, V3 ro, V3 rd) {
  KHHit r;
  const V3 zero = {0.f, 0.f, 0.f};
  r.row = closest<true, false>(s, ro, rd);
  if (r.row >= 0) {
    r.h = object_hit<true>(s, r.row, ro, rd);
    const int* o = s.obj + OBJ_INTS * r.row;
    r.mat_row = __ldg(o + 2);
    r.tex_row = __ldg(o + 3);
    r.emissive = __ldg(o + 4) != 0;
    r.obj = __ldg(o + 5);
  } else {
    r.h = {MAX_DISTANCE, zero, zero, zero, 0.f, 0.f, zero, false};
    r.mat_row = r.tex_row = 0;
    r.emissive = false;
    r.obj = -1;
  }
  r.into = dot(r.h.ng, rd) < -EPSILON;
  r.n = r.into ? r.h.ng : -r.h.ng;
  return r;
}

__device__ __forceinline__ int mat_cat(const Scene& s, int mat_row) {
  return __ldg(s.mat + 3 * mat_row);
}

__device__ __forceinline__ V3 kh_color(const Scene& s, const KHHit& r) {
  if (r.h.use_sc) return r.h.sc;
  return texture_color(s, __ldg(s.tex + 2 * r.tex_row), __ldg(s.tex + 2 * r.tex_row + 1), r.h.u,
                       r.h.v);
}

__device__ __forceinline__ void st3(float* p, long long hw, V3 v) {
  p[0] = v.x;
  p[hw] = v.y;
  p[2 * hw] = v.z;
}

// Receiver r's planes, ints and point at pixel p: its hit `k` reached along
// d, its surface color, tint and whether it may be a receiver at all.
__device__ __forceinline__ void kh_write(const KHHit& k, V3 d, V3 sc, V3 tint, bool seen,
                                         bool matte, int r, long long p, long long hw,
                                         float* planes, int* ints, float* xs) {
  // the shading frame (boundary.py `_shading_frame`, path.cuh bounce_open)
  const V3 n = k.n;
  const bool dpdu_ok = dot(k.h.dpdu, k.h.dpdu) > F(1e-16);
  const V3 ss1 = normalize(dpdu_ok ? k.h.dpdu : ortho(n));
  const V3 ss = normalize(ss1 - n * dot(ss1, n));
  const V3 ts = cross(n, ss);
  const V3 wo = world_to_local(-d, n, ss, ts);
  float* pl = planes + (long long)KH_PLANES * r * hw + p;
  st3(pl, hw, n);
  st3(pl + 3 * hw, hw, ss);
  st3(pl + 6 * hw, hw, ts);
  st3(pl + 9 * hw, hw, wo);
  st3(pl + 12 * hw, hw, sc);
  st3(pl + 15 * hw, hw, tint);
  const bool mask = seen && k.row >= 0 && matte && !k.emissive;
  ints[2LL * r * hw + p] = mask ? k.mat_row : -1;
  ints[(2LL * r + 1) * hw + p] = k.obj;
  st3(xs + 3LL * r * hw + p, hw, k.h.p);
}

// The pixel-centre camera ray of (row, col) (`_pixel_rays`): its direction
// before normalising, with camera_dir's intermediates for the adjoint.
__device__ __forceinline__ V3 kh_camera_dir(const Camera& c, int row, int col, int height,
                                            int width, float& ndc_x, float& ndc_y, float& sx,
                                            float& sy) {
  return camera_dir(c, (float)col, (float)row, F(0.5), F(0.5), F(2.0 / (double)width),
                    F(2.0 / (double)height), ndc_x, ndc_y, sx, sy);
}

// The mirror bounce's ray off hit k of ray rd: rd2 = normalize(rd - n (2 n.rd)),
// ro2 = p + n 1e-4.
__device__ __forceinline__ void kh_reflect(const KHHit& k, V3 rd, V3& ro2, V3& rd2) {
  rd2 = normalize(rd - k.n * (F(2.0) * dot(k.n, rd)));
  ro2 = k.h.p + k.n * F(1e-4);
}

// The forward of pixel (row, col): R receivers (1: primary; 2: and mirror).
__device__ __forceinline__ void receivers_pixel(const Scene& s, int R, int row, int col,
                                                int height, int width, float* planes, int* ints,
                                                float* xs) {
  const long long hw = (long long)height * width, p = (long long)row * width + col;
  const Camera c = load_camera(s);
  float ndc_x, ndc_y, sx, sy;
  const V3 rd = normalize(kh_camera_dir(c, row, col, height, width, ndc_x, ndc_y, sx, sy));
  const KHHit k1 = kh_hit(s, c.eye, rd);
  const V3 sc1 = kh_color(s, k1);
  const V3 one = {F(1.0), F(1.0), F(1.0)};
  kh_write(k1, rd, sc1, one, true, mat_cat(s, k1.mat_row) == MATTE, 0, p, hw, planes, ints, xs);
  if (R < 2) return;
  const bool spec1 = k1.row >= 0 && mat_cat(s, k1.mat_row) == MIRROR;
  V3 ro2, rd2;
  kh_reflect(k1, rd, ro2, rd2);
  const KHHit k2 = kh_hit(s, ro2, rd2);
  // sample_material's Mirror weight, sc · kr, clipped
  const V3 tint = spec1 ? clip01(sc1 * P(s, __ldg(s.mat + 3 * k1.mat_row + 1)))
                        : V3{0.f, 0.f, 0.f};
  kh_write(k2, rd2, kh_color(s, k2), tint, spec1, mat_cat(s, k2.mat_row) == MATTE, 1, p, hw,
           planes, ints, xs);
}

// Hit row i's adjoint (K2's, adjoint.cuh): the cotangents of its point and
// normal onto its ray, the geometry held fixed.
__device__ __forceinline__ void kh_hit_adj(const Scene& s, int i, V3 ro, V3 rd, V3 d_p, V3 d_ng,
                                           V3& d_ro, V3& d_rd) {
  const int cat = obj_cat(s, i), off = obj_off(s, i);
  const V3 z = {0.f, 0.f, 0.f};
  const NoGrad G;
  switch (cat) {
    case SPHERE:
      sphere_hit_adj<false>(s, off, ro, rd, d_p, d_ng, z, 0.f, 0.f, d_ro, d_rd, G);
      break;
    case RECTANGLE:
      rect_hit_adj<false>(s, off, ro, rd, d_p, d_ng, z, 0.f, 0.f, d_ro, d_rd, G);
      break;
    case CUBE: case CORNELLBOX:
      box_hit_adj<false>(s, off, cat == CUBE, ro, rd, d_p, 0.f, 0.f, d_ro, d_rd, G);
      break;
    case CONE: case CYLINDER:
      frustum_hit_adj<false>(s, off, cat == CONE, ro, rd, d_p, d_ng, z, 0.f, 0.f, d_ro, d_rd, G);
      break;
    case DISK: disk_hit_adj<false>(s, off, ro, rd, d_p, z, 0.f, 0.f, d_ro, d_rd, G); break;
    case HYPERBOLOID:
      hyperboloid_hit_adj<false>(s, off, ro, rd, d_p, d_ng, z, 0.f, 0.f, d_ro, d_rd, G);
      break;
    case PARABOLOID:
      paraboloid_hit_adj<false>(s, off, ro, rd, d_p, d_ng, z, 0.f, 0.f, d_ro, d_rd, G);
      break;
  }
}

// The backward of pixel (row, col): adds the camera's share of g · points
// (gx, (R, 3, hw)) to acc[j * stride], j < KH_CAMERA.  A pixel whose points
// take no cotangent adds nothing.
__device__ __forceinline__ void receivers_grad_pixel(const Scene& s, int R, const float* gx,
                                                     int row, int col, int height, int width,
                                                     float* acc, int stride) {
  const long long hw = (long long)height * width, p = (long long)row * width + col;
  const V3 zero = {0.f, 0.f, 0.f};
  const V3 g1 = {gx[p], gx[hw + p], gx[2 * hw + p]};
  const V3 g2 = R > 1 ? V3{gx[3 * hw + p], gx[4 * hw + p], gx[5 * hw + p]} : zero;
  const bool mirror = g2.x != 0.f || g2.y != 0.f || g2.z != 0.f;
  if (!mirror && g1.x == 0.f && g1.y == 0.f && g1.z == 0.f) return;
  const Camera c = load_camera(s);
  float ndc_x, ndc_y, sx, sy;
  const V3 dir = kh_camera_dir(c, row, col, height, width, ndc_x, ndc_y, sx, sy);
  const V3 rd = normalize(dir);
  const KHHit k1 = kh_hit(s, c.eye, rd);
  if (k1.row < 0) return;  // the miss record is constant
  V3 d_p1 = g1, d_n1 = zero, d_ro = zero, d_rd = zero;
  if (mirror) {
    V3 ro2, rd2;
    kh_reflect(k1, rd, ro2, rd2);
    const int i2 = closest<true, false>(s, ro2, rd2);
    if (i2 >= 0) {
      V3 d_ro2 = zero, d_rd2 = zero;
      kh_hit_adj(s, i2, ro2, rd2, g2, zero, d_ro2, d_rd2);
      // ro2 = p1 + n1 · 1e-4
      d_p1 = d_p1 + d_ro2;
      d_n1 = d_n1 + d_ro2 * F(1e-4);
      // rd2 = normalize(r), r = rd - n1 · k, k = 2 (n1 · rd)
      const float k = F(2.0) * dot(k1.n, rd);
      V3 d_r = zero;
      normalize_adj(rd - k1.n * k, d_rd2, d_r);
      d_rd = d_rd + d_r;
      d_n1 = d_n1 - d_r * k;
      const float d_dot = F(2.0) * -dot(d_r, k1.n);
      d_n1 = d_n1 + rd * d_dot;
      d_rd = d_rd + k1.n * d_dot;
    }
  }
  // n1 = into ? ng : -ng
  kh_hit_adj(s, k1.row, c.eye, rd, d_p1, k1.into ? d_n1 : -d_n1, d_ro, d_rd);
  camera_adj(s, c, dir, ndc_x, ndc_y, sx, sy, d_ro, d_rd, CamGrad{acc, stride, s.cam});
}

}  // namespace
