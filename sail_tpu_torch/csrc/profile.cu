// The profiling kernels for NVIDIA Hopper (sm_90a): the intersect-only path
// (K5a), the FP32 and SFU issue-peak loops (K5b, K5c), and K1 with one phase
// stripped.  Measuring instruments, not production code: each does exactly
// the work it claims, so that its time splits K1's or reads what the card
// issues.
//
// K5a replaces the TPU kernel `isect_kernel_call`
// (tools/profile_megakernel.py:380, pl.pallas_call at :413): per pixel, a
// sum over spp samples of, over `max_bounces` bounces, the closest hit's t
// where the ray hits, the ray then mirror-reflected about the hit's normal,
// re-normalised and restarted at p + n * 1e-4.  Every sample traces the same
// rays (the TPU kernel's noise is PixelNoise(0, 0, ...) for every sample and
// ignores the seed).  A ray that misses is not stopped: its hit is the miss
// record (t = 1e5, p = 0, n = -0), so its direction stays and the next ray
// starts at the world origin, as in the TPU kernel.  Bound by the FP32 work
// of the closest-hit fold (every object tested on every bounce; no cull, as
// the TPU kernel's fold has none) and the winner's hit record.  Design: K1's
// thread per pixel and its fold and hit record (path.cuh `fold` for one ray,
// `object_hit` with the block's staged rectangle frames and the ray's slab
// reciprocal); the sample loop starts
// each sample from the camera ray through an empty asm statement that the
// compiler must assume changes it, so the loop-invariant bounce loop is run
// spp times and not once.
//
// K5b replaces `run_kernel` of `vpu_peak_section`
// (tools/profile_megakernel.py:519, pl.pallas_call at :532): K iterations of
// a mix on a = col * 1e-3 + 1, b = 0.5 a + 0.25 per element of an (R, Cn)
// block, out a + b; the TPU grid's G steps all write the same block.  Here
// each of G * R * Cn threads computes its element and stores it, so no step's
// work is dead code.  `fma_mix` is the FMA pipe's peak: written with
// __fmaf_rn, so it issues FFMA although the library builds -fmad=false.
// `integrator_mix` is written as K1 is built, a separate multiply and add,
// and its rsqrt is rsqrtf (the SFU's MUFU.RSQ): it reads the FP32 pipe
// without FMA and the SFU together.  Bound by the FP32 pipe or the SFU,
// whichever is slower for the mix.
//
// K5c replaces `run_kernel_ilp8` (tools/profile_megakernel.py:572,
// pl.pallas_call at :588): 8 independent `integrator_mix` chains per
// iteration, summed as the TPU kernel sums them.  Independent chains give
// the scheduler work to issue while a chain waits on its last result: the
// issue-limited rate, where K5b's single chain may be latency-limited.
//
// K1 with a phase stripped is K1's own kernel (render_block.cuh) built as
// `render_block_kernel<false, false, false, STRIP>`: config 2's scene kind
// only, no cull; path.cuh says what each STRIP bit removes.  The production
// K1 (megakernel.cu) is the same template with STRIP 0.

#include "render_block.cuh"

namespace {

constexpr int BLOCK = 256;

// ------------------------------------------------------------------ K5a ----
template <bool ALL>
__global__ void __launch_bounds__(BLOCK) isect_only_kernel(Scene s, int n_frames,
                                                           float* __restrict__ out, int height,
                                                           int width, int spp, int max_bounces,
                                                           int row0, int image_height) {
  // K1's staged frames, before any thread leaves
  extern __shared__ float smem[];
  RectFrame* frames = reinterpret_cast<RectFrame*>(smem);
  stage_frames(s, frames, n_frames, threadIdx.y * blockDim.x + threadIdx.x, blockDim.x * blockDim.y);
  __syncthreads();
  const Frames fr{frames, n_frames};
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || lrow >= height) return;
  uint32_t row = (uint32_t)(row0 + lrow);
  const Camera cam = load_camera(s);
  const float sx_scale = F(2.0 / (double)width), sy_scale = F(2.0 / (double)image_height);
  float jx, jy, unused, ndc_x, ndc_y, sx, sy;
  uniform3(stream_id(0u, 0u, 0, TAG_PIXEL_JITTER), row, (uint32_t)col, jx, jy, unused);
  const V3 rd0 = normalize(
      camera_dir(cam, (float)col, (float)(int)row, jx, jy, sx_scale, sy_scale, ndc_x, ndc_y, sx, sy));
  const V3 ro0 = cam.eye;

  float acc = 0.f;
  for (int k = 0; k < spp; ++k) {
    V3 ro = ro0, rd = rd0;
    // the compiler must assume this changes ro and rd: each sample runs
    asm volatile("" : "+f"(ro.x), "+f"(ro.y), "+f"(ro.z), "+f"(rd.x), "+f"(rd.y), "+f"(rd.z));
    float a = 0.f;
    for (int b = 0; b < max_bounces; ++b) {
      const Ray r = make_ray(ro, rd);
      bool unused_occ;
      int i = fold<ALL, false, false>(s, fr, true, r, false, r, 0.f, unused_occ);
      float t = MAX_DISTANCE;
      V3 p = {0.f, 0.f, 0.f}, ng = {0.f, 0.f, 0.f};  // the miss record
      if (i >= 0) {
        Hit h = object_hit<ALL>(s, fr, i, r);
        t = h.t;
        p = h.p;
        ng = h.ng;
      }
      a = a + (i >= 0 ? t : 0.f);
      V3 n = dot(ng, rd) < -EPSILON ? ng : -ng;
      rd = normalize(rd - n * (F(2.0) * dot(n, rd)));
      ro = p + n * F(1e-4);
    }
    acc = acc + a;
  }
  out[(size_t)lrow * (size_t)width + (size_t)col] = acc;
}

// ------------------------------------------------------------- K5b, K5c ----
constexpr int MIX_FMA = 0, MIX_INTEGRATOR = 1;

__device__ __forceinline__ void fma_mix(float& a, float& b) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a = __fmaf_rn(a, b, F(1.000001));
    b = __fmaf_rn(b, a, F(0.999999));
  }
}

__device__ __forceinline__ void integrator_mix(float& a, float& b) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a = a * b + F(1.000001);
    float m = fmaxf(a, b);
    float sel = a > b ? a : b * F(1.000001);
    b = rsqrtf(fabsf(m * sel) + F(1.0));
  }
}

// a = col * 1e-3 + 1 and b = 0.5 a + 0.25, as the TPU kernels start
__device__ __forceinline__ float start_a(int col) { return (float)col * F(1e-3) + F(1.0); }
__device__ __forceinline__ float start_b(float a) { return a * F(0.5) + F(0.25); }

template <int MIX>
__global__ void __launch_bounds__(BLOCK) alu_peak_kernel(float* __restrict__ out, int block_elems,
                                                         int cols, long long total, int iters) {
  long long idx = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (idx >= total) return;
  int e = (int)(idx % block_elems);  // every grid step writes the same block
  float a = start_a(e % cols);
  float b = start_b(a);
  for (int k = 0; k < iters; ++k) {
    if (MIX == MIX_FMA) fma_mix(a, b);
    else integrator_mix(a, b);
  }
  out[e] = a + b;
}

__global__ void __launch_bounds__(BLOCK) alu_peak_ilp8_kernel(float* __restrict__ out,
                                                              int block_elems, int cols,
                                                              long long total, int iters) {
  long long idx = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (idx >= total) return;
  int e = (int)(idx % block_elems);
  float base = start_a(e % cols);
  float a[8], b[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a[c] = base * F(1.0 + 0.01 * c);
    b[c] = start_b(base);
  }
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int c = 0; c < 8; ++c) integrator_mix(a[c], b[c]);
  }
  float acc = a[0];
#pragma unroll
  for (int c = 1; c < 8; ++c) acc = acc + a[c] + b[c];
  out[e] = acc + b[0];
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`, does
// not synchronise, and returns the launch's cudaError_t.  The scene arguments
// (params through cam, all_shapes, materials, n_clusters) are those of
// sail_render_block (megakernel.cu).

// K5a: out[h, w] = sum over spp of the bounces' t.  The seed is not an
// argument: the kernel it replaces ignores it.
extern "C" int sail_isect_only(const float* params, const int* table, int n_obj, int n_plain,
                               int n_groups, int n_mat, int n_tex, int n_light, int cam,
                               int all_shapes, int n_frames, float* out, int height, int width,
                               int spp, int max_bounces, int row0, int image_height,
                               void* stream) {
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  dim3 block(16, 16);
  dim3 grid((width + 15) / 16, (height + 15) / 16);
  n_frames = staged_frames(0, n_frames);
  size_t smem = k1_smem_bytes(0, n_frames);
  if (all_shapes)
    isect_only_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        s, n_frames, out, height, width, spp, max_bounces, row0, image_height);
  else
    isect_only_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
        s, n_frames, out, height, width, spp, max_bounces, row0, image_height);
  return (int)cudaGetLastError();
}

// K5b: `mix` 0 = fma_mix, 1 = integrator_mix; out is the (rows, cols) block,
// written by each of `grid` steps.
extern "C" int sail_alu_peak(int mix, float* out, int rows, int cols, int grid, int iters,
                             void* stream) {
  if (mix != MIX_FMA && mix != MIX_INTEGRATOR) return (int)cudaErrorInvalidValue;
  long long total = (long long)grid * rows * cols;
  long long blocks = (total + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (mix == MIX_FMA)
    alu_peak_kernel<MIX_FMA><<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        out, rows * cols, cols, total, iters);
  else
    alu_peak_kernel<MIX_INTEGRATOR><<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        out, rows * cols, cols, total, iters);
  return (int)cudaGetLastError();
}

// K5c: 8 independent integrator_mix chains per element.
extern "C" int sail_alu_peak_ilp8(float* out, int rows, int cols, int grid, int iters,
                                  void* stream) {
  long long total = (long long)grid * rows * cols;
  long long blocks = (total + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  alu_peak_ilp8_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(out, rows * cols, cols,
                                                                            total, iters);
  return (int)cudaGetLastError();
}

// K1 with the phases of `strip` (one STRIP_* bit of path.cuh) stripped, for
// config 2's scene kind: a scene with another shape or material, or the
// cull, is refused.
extern "C" int sail_render_block_stripped(int strip, const float* params, const int* table,
                                          int n_obj, int n_plain, int n_groups, int n_mat,
                                          int n_tex, int n_light, int cam, int all_shapes,
                                          int materials, int n_clusters, int n_frames,
                                          float* out_x, float* out_y, float* out_z, int height,
                                          int width, int spp, int seed, int sample0,
                                          int max_bounces, int row0, int image_height,
                                          void* stream) {
  if (all_shapes || materials || n_clusters) return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  dim3 block(16, 16);
  dim3 grid((width + 15) / 16, (height + 15) / 16);
  n_frames = staged_frames(0, n_frames);
  using Kernel = decltype(&render_block_kernel<false, false, false, STRIP_CONST_RNG>);
  Kernel kernel;
  switch (strip) {
    case STRIP_CONST_RNG: kernel = render_block_kernel<false, false, false, STRIP_CONST_RNG>; break;
    case STRIP_CONST_TEXTURE:
      kernel = render_block_kernel<false, false, false, STRIP_CONST_TEXTURE>;
      break;
    case STRIP_NO_SHADOW: kernel = render_block_kernel<false, false, false, STRIP_NO_SHADOW>; break;
    case STRIP_NO_NEE: kernel = render_block_kernel<false, false, false, STRIP_NO_NEE>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  kernel<<<grid, block, k1_smem_bytes(0, n_frames), (cudaStream_t)stream>>>(
      s, 0, n_frames, out_x, out_y, out_z, height, width, spp, (uint32_t)seed, (uint32_t)sample0,
      max_bounces, row0, image_height);
  return (int)cudaGetLastError();
}
