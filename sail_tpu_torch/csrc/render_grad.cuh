// K2's kernel, a template over where the gradient lives (CAP), the scene kind
// (path.cuh's ALL and MATS), a strip mask (adjoint.cuh's GRAD_NO_*), the
// blocks per SM its registers are sized for and the scene's lights (LIGHTS:
// a light other than AREA over a RECTANGLE, path.cuh light_sample's);
// megakernel_grad.cu says what it
// computes and how, ops/cuda/megakernel.py `grad_build` which scene takes
// which build.
// megakernel_grad.cu builds the production K2 (STRIP 0); profile_grad.cu
// builds config 2's kind with a phase stripped, so that "full minus
// stripped" is always this kernel's phase cost.
#pragma once

#include "adjoint.cuh"

#if !defined(GRAD_BLOCK_X) || !defined(GRAD_BLOCK_Y) || !defined(SHARED_GRAD)
#error "K2's sources take their numbers as defines (ops/cuda/megakernel.py GradBuild.defines)"
#endif

namespace {

// K2's thread block; CAP SHARED_GRAD keeps each thread's gradient in its
// column of a block-wide (n_params, THREADS) array in dynamic shared memory,
// any other CAP is a local array of CAP floats.
constexpr int BLOCK_X = GRAD_BLOCK_X, BLOCK_Y = GRAD_BLOCK_Y, THREADS = BLOCK_X * BLOCK_Y,
              WARPS = THREADS / 32;

// The dynamic shared memory a launch of the CAP build takes.
inline size_t grad_smem_bytes(int cap, int n_params) {
  return (size_t)(cap == SHARED_GRAD ? THREADS + WARPS : WARPS) * (size_t)n_params * sizeof(float);
}

template <int CAP, bool ALL, bool MATS, int STRIP, int MIN_BLOCKS, bool LIGHTS = false>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    render_grad_kernel(Scene s, int n_params, const float* __restrict__ gx,
                       const float* __restrict__ gy, const float* __restrict__ gz,
                       float* __restrict__ rows, int height, int width, int spp, uint32_t seed,
                       uint32_t sample0, int max_bounces, int row0, int image_height) {
  // [the gradient's columns, shared build only] then the warps' partial sums,
  // WARPS rows of n_params floats
  extern __shared__ float smem[];
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr bool SHARED = CAP == SHARED_GRAD;
  float local[SHARED ? 1 : CAP];
  const Grad<SHARED ? THREADS : 1> G{SHARED ? smem + tid : local};
  float* part = smem + (SHARED ? (size_t)THREADS * (size_t)n_params : 0);
  for (int p = 0; p < n_params; ++p) gref(G, p) = 0.f;
  int col = blockIdx.x * BLOCK_X + threadIdx.x;
  int lrow = blockIdx.y * BLOCK_Y + threadIdx.y;
  // every thread takes part in the sweeps' barriers; those past the edge
  // trace nothing and add zeros
  const bool inside = col < width && lrow < height;
  const size_t idx = (size_t)lrow * (size_t)width + (size_t)col;
  const V3 g = inside ? V3{gx[idx], gy[idx], gz[idx]} : V3{0.f, 0.f, 0.f};
  const Camera c = load_camera(s);
  const float sx_scale = F(2.0 / (double)width), sy_scale = F(2.0 / (double)image_height);
  for (int k = 0; k < spp; ++k) {
    sample_grad<MATS, STRIP, ALL, LIGHTS>(s, c, g, seed, sample0 + (uint32_t)k, max_bounces,
                                  (uint32_t)(row0 + lrow), (uint32_t)col, sx_scale, sy_scale,
                                  inside, G);
  }
  // each warp's sum in a fixed shuffle tree, then the warps in order
  for (int p = 0; p < n_params; ++p) {
    float v = gref(G, p);
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

// One launch of a K2 build on `stream`: opts the kernel in to the dynamic
// shared memory it needs, launches it, and returns the cudaError_t.
template <int CAP, bool ALL, bool MATS, int STRIP, int MIN_BLOCKS, bool LIGHTS = false>
int launch_grad(Scene s, int n_params, const float* gx, const float* gy, const float* gz,
                float* rows, int height, int width, int spp, uint32_t seed, uint32_t sample0,
                int max_bounces, int row0, int image_height, cudaStream_t stream) {
  dim3 block(BLOCK_X, BLOCK_Y);
  dim3 grid((width + BLOCK_X - 1) / BLOCK_X, (height + BLOCK_Y - 1) / BLOCK_Y);
  size_t smem = grad_smem_bytes(CAP, n_params);
  auto kernel = render_grad_kernel<CAP, ALL, MATS, STRIP, MIN_BLOCKS, LIGHTS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, smem, stream>>>(s, n_params, gx, gy, gz, rows, height, width, spp, seed,
                                        sample0, max_bounces, row0, image_height);
  return (int)cudaGetLastError();
}

}  // namespace
