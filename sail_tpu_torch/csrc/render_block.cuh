// K1's per-pixel loop and kernel, a template over the scene kind (path.cuh's
// ALL, CULL and MATS) and a strip mask (path.cuh's STRIP_*); megakernel.cu
// says what it computes and how.  megakernel.cu builds the eight scene kinds
// with STRIP 0, the production K1; profile.cu builds config 2's kind with one
// phase stripped, so that "full minus stripped" is always this kernel's phase
// cost.  trace_rays.cu (KR) runs the same loop from given rays.
// csrc/host/k1_host.cpp runs `render_pixel` on the CPU, csrc/host/edge_host.cpp
// `ray_radiance`.
#pragma once

#include "path.cuh"

namespace {

// The spp-SUM of radiance of a thread's samples: the loop of K1 and KR.
//
// One loop runs the pixel's samples and their bounces.  A path that misses,
// dies or ends its last bounce starts the next sample's camera ray in the
// next iteration (path regeneration), so a thread does not wait for the
// other lanes of its warp to end their sample.  Without the cull, each
// iteration opens with a block barrier (__syncthreads_or, lock step), which
// ends the loop once no thread of the block has a ray left: every thread of
// the block must call this (`inside` false past the image's edge), and the
// warps run the same phase together and share the instruction cache.  With
// the cull a ray's work varies with the clusters it reaches, and waiting for
// the block's slowest ray at every step cost more than it saved (64 spheres
// on an H100: 118.6 ms without the barrier, 123.2 with), so there each thread
// ends its own loop.
//
// A bounce that samples a light leaves its shadow ray pending, with the two
// sums its bit chooses between (p_lit, p_occ: thr * contrib either way); the
// next iteration tests it in the same pass over the objects as the path's
// next ray (`fold`), and adds it to `e` before that ray's bounce adds
// anything; the thread's last one, with no next ray, is tested alone.  So
// each thread adds the same terms in the same order as one bounce at a time
// (path.cuh `bounce`), and `e` reaches `acc` in sample order: the image is
// the same bit for bit.
//
// `first_ray(sample, st)` sets a sample's first ray, st.ro and st.rd:
// `render_pixel` below gives K1's jittered camera ray, `ray_radiance` a ray
// of the caller's (trace_rays.cu, KR).  The rest of the loop is theirs in
// common.
template <bool ALL, bool CULL, bool MATS, int STRIP, class FirstRay>
__device__ __forceinline__ V3 trace_loop(const Scene& s, const Frames& fr, bool inside,
                                         uint32_t row, uint32_t col, int spp, uint32_t seed,
                                         uint32_t sample0, int max_bounces,
                                         FirstRay&& first_ray) {
  constexpr bool SHADOW = (STRIP & STRIP_NO_SHADOW) == 0;
  constexpr bool LOCK_STEP = !CULL;
  const V3 zero = {0.f, 0.f, 0.f};
  V3 acc = zero, e = zero;
  PathState st = {zero, zero, zero, false};
  int k = 0, b = 0;           // samples started; the bounce st's ray takes
  uint32_t sample = sample0;  // the sample st's ray belongs to
  bool ray = false;           // st holds a ray to trace
  bool sh = false;            // a shadow ray is pending
  bool flush = false;         // e is an ended sample's, waiting for its shadow ray
  V3 sh_o = zero, sh_d = zero, p_lit = zero, p_occ = zero;
  float sh_max = 0.f;
  if (max_bounces < 1) spp = 0;  // every sample adds +0
  for (;;) {
    if (!ray && inside && k < spp) {  // the next sample's first ray
      sample = sample0 + (uint32_t)k++;
      first_ray(sample, st);
      st.thr = {1.f, 1.f, 1.f};
      st.skip_emission = false;
      b = 0;
      ray = true;
    }
    if (LOCK_STEP ? !__syncthreads_or(ray || sh) : !(ray || sh)) break;
    if (!ray && !sh) continue;
    const Ray a = make_ray(st.ro, st.rd);
    Ray shadow = a;
    if (sh) shadow = make_ray(sh_o, sh_d);
    bool occ;
    const int i = fold<ALL, CULL, SHADOW>(s, fr, ray, a, sh, shadow, sh_max, occ);
    if (sh) {
      e = e + (occ ? p_occ : p_lit);
      sh = false;
    }
    if (flush) {
      acc = acc + e;
      e = zero;
      flush = false;
    }
    if (!ray) continue;
    bool more = false;
    if (i >= 0) {
      Bounce v;
      Shading shade;
      V3 contrib;
      bounce_open<ALL, MATS, STRIP, true>(s, fr, st, i, a.inv, seed, sample, b, row, col, v, shade,
                                          contrib);
      bool did_nee = false, pending = false;
      if (s.n_light > 0) {
        float lu1, lu2, lr;
        draw3<STRIP>(stream_id(seed, sample, b, TAG_LIGHT_U), row, col, lu1, lu2, lr);
        did_nee = v.is_matte && !v.emissive;
        if (did_nee && (STRIP & STRIP_NO_NEE) == 0) {
          light_sample<true, ALL>(s, fr, v, shade, lu1, lu2, lr);
          nee_light(v, shade);
          // bounce's contrib + direct * f_light, direct = rad * (occ ? 0 : 1)
          V3 c_lit = contrib + v.rad * F(1.0) * v.f_light;
          if constexpr (SHADOW) {
            p_lit = st.thr * c_lit;
            p_occ = st.thr * (contrib + v.rad * 0.f * v.f_light);
            sh_o = v.h.p + shade.n * F(1e-4);
            sh_d = v.wsh;
            sh_max = v.dist * F(1.0 - 1e-3);
            pending = sh = true;
          } else {
            contrib = c_lit;
          }
        }
      }
      if (!pending) e = e + st.thr * contrib;
      advance(st, v, shade, did_nee);
      more = ++b < max_bounces && max_component(st.thr) > 0.f;  // else dead: adds nothing more
    }
    if (!more) {  // a miss, a dead path or the last bounce: the sample ends
      ray = false;
      if (sh) {
        flush = true;
      } else {
        acc = acc + e;
        e = zero;
      }
    }
  }
  return acc;
}

// The spp-SUM of radiance of pixel (row, col) from its jittered camera
// rays: K1's loop for one thread.
template <bool ALL, bool CULL, bool MATS, int STRIP>
__device__ __forceinline__ V3 render_pixel(const Scene& s, const Frames& fr, bool inside,
                                           uint32_t row, uint32_t col, int spp, uint32_t seed,
                                           uint32_t sample0, int max_bounces, float sx_scale,
                                           float sy_scale) {
  return trace_loop<ALL, CULL, MATS, STRIP>(
      s, fr, inside, row, col, spp, seed, sample0, max_bounces,
      [&](uint32_t sample, PathState& st) {
        const Camera cam = load_camera(s);
        float jx, jy, unused, ndc_x, ndc_y, sx, sy;
        draw3<STRIP>(stream_id(seed, sample, 0, TAG_PIXEL_JITTER), row, col, jx, jy, unused);
        st.rd = normalize(camera_dir(cam, (float)col, (float)(int)row, jx, jy, sx_scale, sy_scale,
                                     ndc_x, ndc_y, sx, sy));
        st.ro = cam.eye;
      });
}

// The radiance of one given ray (ro, rd) of sample `sample`, drawing its
// numbers from pixel (row, col)'s streams as K1's paths do: the plain
// `integrator.trace_rays` of one ray with a PixelNoise, KR's loop for one
// thread.  No cull, no strip.
template <bool ALL, bool MATS>
__device__ __forceinline__ V3 ray_radiance(const Scene& s, const Frames& fr, bool inside,
                                           uint32_t row, uint32_t col, uint32_t sample,
                                           uint32_t seed, int max_bounces, V3 ro, V3 rd) {
  return trace_loop<ALL, false, MATS, 0>(s, fr, inside, row, col, 1, seed, sample, max_bounces,
                                         [&](uint32_t, PathState& st) {
                                           st.ro = ro;
                                           st.rd = rd;
                                         });
}

// The dynamic shared memory a K1 block takes without opting in: the cull's
// bound boxes come first (megakernel.cu's MAX_CLUSTERS fill it), the frames
// take what is left.
constexpr int K1_SMEM = 48 * 1024;

// The frames a launch stages: the first `n_frames` rows' (the wrapper's
// count: up to the last rectangle row), as many as fit beside the boxes.
inline int staged_frames(int n_clusters, int n_frames) {
  int room = (K1_SMEM - 6 * (int)sizeof(float) * n_clusters) / (int)sizeof(RectFrame);
  return n_frames < 0 ? 0 : (n_frames < room ? n_frames : (room < 0 ? 0 : room));
}

inline size_t k1_smem_bytes(int n_clusters, int n_frames) {
  return (size_t)n_clusters * 6 * sizeof(float) + (size_t)n_frames * sizeof(RectFrame);
}

#ifdef __CUDACC__
// Built for the eight scene kinds of path.cuh's ALL, CULL and MATS; the entry
// point launches the one the scene needs.  256-thread blocks, four per SM
// (64 registers, spilling to the L1-cached stack), where MATS takes three
// (80 registers): timed in turns on an H100, four were up to 4% faster than
// three without MATS and 5-8% with the cull, and 0.5-3% slower on the MATS
// rows (config 3, its open twin); two blocks (104-121 registers, no spill)
// were 5-24% slower than three, and 128-thread blocks no faster.  Dynamic
// shared memory: the cull's n_clusters bound boxes (6 floats each), then the
// first n_frames table rows' rectangle frames (path.cuh `Frames`).
template <bool ALL, bool CULL, bool MATS, int STRIP = 0>
__global__ void __launch_bounds__(256, MATS ? 3 : 4)
    render_block_kernel(Scene s, int n_clusters, int n_frames, float* __restrict__ out_x,
                        float* __restrict__ out_y, float* __restrict__ out_z, int height,
                        int width, int spp, uint32_t seed, uint32_t sample0, int max_bounces,
                        int row0, int image_height) {
  extern __shared__ float smem[];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, n_threads = blockDim.x * blockDim.y;
  if (CULL) {
    cluster_boxes(s, smem, tid, n_threads);
    s.box = smem;
  }
  RectFrame* frames = reinterpret_cast<RectFrame*>(smem + 6 * n_clusters);
  stage_frames(s, frames, n_frames, tid, n_threads);
  __syncthreads();
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = col < width && lrow < height;
  V3 acc = render_pixel<ALL, CULL, MATS, STRIP>(
      s, Frames{frames, n_frames}, inside, (uint32_t)(row0 + lrow), (uint32_t)col, spp, seed,
      sample0, max_bounces, F(2.0 / (double)width), F(2.0 / (double)image_height));
  if (!inside) return;
  size_t idx = (size_t)lrow * (size_t)width + (size_t)col;
  out_x[idx] = acc.x;
  out_y[idx] = acc.y;
  out_z[idx] = acc.z;
}
#endif

}  // namespace
