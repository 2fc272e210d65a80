// Backward path-tracing megakernel (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `render_grad_block_pallas`
// (sail_tpu/ops/pallas/megakernel.py:262, pl.pallas_call at :476): dL/dparams
// for L = sum over pixels of g . image_sum, where image_sum is K1's spp-SUM
// of radiance over an H x W block and g three float32 planes.  The result is
// the flat gradient in the parameter vector's (jax.tree.leaves) order.
//
// What bounds it on this card: like K1, FP32/SFU throughput and divergence, at
// roughly three forward bounces' work per bounce (the forward sweep, the
// re-run, the adjoint); and, unlike K1, local memory.  Each thread keeps a
// gradient array of the scene's n_params floats and up to MAX_GRAD_BOUNCES
// stored states; their indices are run-time parameter offsets, so they live
// in local memory (L1-cached) and every gradient add is a load and a store.
// The array's size is a template parameter: the kernel is built for the caps
// in CAPS (352, 1,024 and 4,096 floats) and the wrapper runs the smallest
// that holds the scene, so a few-object scene keeps a small frame and the
// 256-sphere scene (3,375 parameters) still fits.  Each size is built twice,
// with and without path.cuh's MATS (metal, glass and the uv textures), so
// scenes of matte, mirror and uniform colors (configs 1-2) keep the smaller
// adjoint.  The warps' partial sums sit in dynamic shared memory
// (8 x n_params floats, 108 KB at 3,375, above the 48 KB default only after
// cudaFuncSetAttribute).  Every shape has its adjoint (adjoint.cuh); K2
// folds without the cull, which changes no value.
//
// Design (adjoint.cuh): one thread per pixel.  Per sample a forward sweep
// with K1's own code stores each bounce's input state; the reverse sweep
// re-runs bounce b from its state and applies its hand-written adjoint, then
// the camera's.  The TPU kernel carries one (1, n) sum across its sequential
// grid; Hopper's blocks run in parallel and in no order, so the sum is two
// passes with a fixed order and no float atomics: each block reduces its
// threads (warp shuffles in a fixed tree, then warps in order through shared
// memory) into one row of a (n_blocks, n_params) buffer, and a second kernel
// sums the rows (a fixed stride and tree per parameter).  Repeated calls give
// bit-identical gradients.  A path that misses or dies leaves the loop, as in
// K1: the masked JAX adjoint gives such lanes exactly zero cotangent.

#include "adjoint.cuh"

namespace {

constexpr int BLOCK_X = 16, BLOCK_Y = 16, THREADS = BLOCK_X * BLOCK_Y, WARPS = THREADS / 32;

// The gradient-array sizes K2 is built for: the wrapper takes the smallest
// that holds the scene's parameters.  352 holds every scene of a few
// objects; 4,096 the 256-sphere scene (13 N + 47 = 3,375 parameters).
constexpr int CAPS[] = {352, 1024, 4096};
constexpr int N_CAPS = sizeof(CAPS) / sizeof(CAPS[0]);

// One block per SM asked for: ptxas then gives K2 the 219 registers it needs;
// left alone it capped the kernel at 128 with spills, 23% slower (an H100).
template <int CAP, bool MATS>
__global__ void __launch_bounds__(THREADS, 1)
    render_grad_kernel(Scene s, int n_params, const float* __restrict__ gx,
                       const float* __restrict__ gy, const float* __restrict__ gz,
                       float* __restrict__ rows, int height, int width, int spp, uint32_t seed,
                       uint32_t sample0, int max_bounces, int row0, int image_height) {
  int col = blockIdx.x * BLOCK_X + threadIdx.x;
  int lrow = blockIdx.y * BLOCK_Y + threadIdx.y;
  float G[CAP];
  for (int p = 0; p < n_params; ++p) G[p] = 0.f;
  if (col < width && lrow < height) {  // threads past the edge add zeros
    size_t idx = (size_t)lrow * (size_t)width + (size_t)col;
    V3 g = {gx[idx], gy[idx], gz[idx]};
    const Camera c = load_camera(s);
    const float sx_scale = F(2.0 / (double)width), sy_scale = F(2.0 / (double)image_height);
    for (int k = 0; k < spp; ++k) {
      sample_grad<MATS>(s, c, g, seed, sample0 + (uint32_t)k, max_bounces, (uint32_t)(row0 + lrow),
                  (uint32_t)col, sx_scale, sy_scale, G);
    }
  }
  // the warps' partial sums, WARPS rows of n_params floats (dynamic)
  extern __shared__ float part[];
  int tid = threadIdx.y * BLOCK_X + threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int p = 0; p < n_params; ++p) {
    float v = G[p];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) part[warp * n_params + p] = v;
  }
  __syncthreads();
  float* row = rows + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * (size_t)n_params;
  for (int p = tid; p < n_params; p += THREADS) {
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += part[w * n_params + p];
    row[p] = v;
  }
}

template <int CAP, bool MATS>
int launch_grad(dim3 grid, dim3 block, cudaStream_t stream, Scene s, int n_params,
                const float* gx, const float* gy, const float* gz, float* rows, int height,
                int width, int spp, uint32_t seed, uint32_t sample0, int max_bounces, int row0,
                int image_height) {
  size_t smem = (size_t)WARPS * (size_t)n_params * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(render_grad_kernel<CAP, MATS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  render_grad_kernel<CAP, MATS><<<grid, block, smem, stream>>>(
      s, n_params, gx, gy, gz, rows, height, width, spp, seed, sample0, max_bounces, row0,
      image_height);
  return (int)cudaGetLastError();
}

// out[p] = sum over r of rows[r][p]: one block per parameter, each thread a
// fixed stride of rows in order, then a fixed tree in shared memory.
__global__ void __launch_bounds__(256)
    reduce_grad_rows_kernel(const float* __restrict__ rows, int n_rows, int n_params,
                            float* __restrict__ out) {
  __shared__ float buf[256];
  int p = blockIdx.x, t = threadIdx.x;
  float v = 0.f;
  for (int r = t; r < n_rows; r += 256) v += rows[(size_t)r * (size_t)n_params + p];
  buf[t] = v;
  __syncthreads();
  for (int h = 128; h > 0; h >>= 1) {
    if (t < h) buf[t] += buf[t + h];
    __syncthreads();
  }
  if (t == 0) out[p] = buf[0];
}

}  // namespace

// K2's compile-time bounds: block columns, block rows, most bounces, the
// number of gradient-array sizes, then the sizes.  The wrapper raises above
// them.
extern "C" int sail_grad_limits(int* out) {
  out[0] = BLOCK_X;
  out[1] = BLOCK_Y;
  out[2] = MAX_GRAD_BOUNCES;
  out[3] = N_CAPS;
  for (int i = 0; i < N_CAPS; ++i) out[4 + i] = CAPS[i];
  return 0;
}

// Plain C entry points (bound with ctypes); `table` is the device int32 scene
// table (path.cuh make_scene).  `rows` holds ceil(W/16) * ceil(H/16) rows of
// n_params floats, one per thread block in launch order; `cap` is one of
// CAPS, at least n_params; `materials` as in sail_render_block.  Each
// launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t.
extern "C" int sail_render_grad_block(const float* params, const int* table, int n_obj,
                                      int n_plain, int n_groups, int n_mat, int n_tex,
                                      int n_light, int cam, int n_params, int cap, int materials,
                                      const float* gx, const float* gy, const float* gz,
                                      float* rows, int height, int width, int spp, int seed,
                                      int sample0, int max_bounces, int row0, int image_height,
                                      void* stream) {
  if (n_params > cap || max_bounces > MAX_GRAD_BOUNCES) return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y);
  cudaStream_t st = (cudaStream_t)stream;
#define SAIL_LAUNCH(C, M)                                                                      \
  launch_grad<C, M>(grid, block, st, s, n_params, gx, gy, gz, rows, height, width, spp,       \
                    (uint32_t)seed, (uint32_t)sample0, max_bounces, row0, image_height)
  switch (cap) {
    case CAPS[0]: return materials ? SAIL_LAUNCH(CAPS[0], true) : SAIL_LAUNCH(CAPS[0], false);
    case CAPS[1]: return materials ? SAIL_LAUNCH(CAPS[1], true) : SAIL_LAUNCH(CAPS[1], false);
    case CAPS[2]: return materials ? SAIL_LAUNCH(CAPS[2], true) : SAIL_LAUNCH(CAPS[2], false);
  }
#undef SAIL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int sail_reduce_grad_rows(const float* rows, int n_rows, int n_params, float* out,
                                     void* stream) {
  reduce_grad_rows_kernel<<<n_params, 256, 0, (cudaStream_t)stream>>>(rows, n_rows, n_params, out);
  return (int)cudaGetLastError();
}
