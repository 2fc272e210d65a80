// KP: the penumbra (NEE-visibility) edge term of sphere occluders under
// rectangle lights, with its adjoint, on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package computes
// `shadow_boundary_term` (`sail_tpu/diff/boundary.py:773`) with XLA inside
// the jitted train step (`sail_tpu/parallel/render_sharded.py:257`), where
// the (K, H, W) tensors of each receiver and (sphere, light) pair fuse; the
// port's plain version (`ops/cuda/penumbra.py` `penumbra_scalar_plain`) runs
// them as eager torch launches, each intermediate a (K, H, W) float32 tensor
// in HBM, once detached and once under autograd.  For every pixel, receiver
// (the surface seen directly, through a mirror, through one diffuse bounce),
// pair and curve sample it computes the detached coefficient and the
// gradient of Σ coeff · (n̂ · y) with respect to the occluders' centers and
// radii and the receiver points (penumbra.cuh says how).
//
// What bounds it: operations.  A pixel reads its receivers' planes once (84
// bytes a receiver: the point, normal, frame, wo, surface color and tint,
// the material row and object id) and writes its point's gradient (12
// bytes a receiver); per receiver and pair it does ~150 FP32 operations,
// then ~45 per curve sample and ~250 more per sample that lights the
// receiver (matte_f, the tangent, the adjoint).
//
// Design: one thread a pixel; the receivers, pairs and the K samples loop
// in registers, so no (K, H, W) intermediate exists.  The periodic tangent
// (the plain version's torch.roll over K) comes from samples k - 1 and
// k + 1, computed as the loop reaches them (K + 1 curve points a pair, not
// 3K).  A sample that does not light the receiver does no more than its
// mask.  The sphere partials (and the term's value) are summed over a
// block's 256 pixels in a fixed tree in shared memory (each thread's
// running sums in its own column), one row a block; K2's reduce
// (`reduce_grad_rows`) then sums the rows in its fixed order.  No float
// atomics: the result is the same bits on every call.

#include "penumbra.cuh"

namespace {

constexpr int KP_BX = 16, KP_BY = 16, KP_THREADS = KP_BX * KP_BY;

__global__ void __launch_bounds__(KP_THREADS)
    penumbra_kernel(KPIn in, float* __restrict__ rows, float* __restrict__ gx, int height,
                    int width) {
  extern __shared__ float acc[];  // (1 + 4 S) columns of KP_THREADS
  const int t = threadIdx.y * KP_BX + threadIdx.x;
  const int n_cols = 1 + 4 * in.S;
  for (int j = 0; j < n_cols; ++j) acc[j * KP_THREADS + t] = 0.f;
  const int col = blockIdx.x * KP_BX + threadIdx.x, row = blockIdx.y * KP_BY + threadIdx.y;
  if (col < width && row < height)
    penumbra_pixel(in, (long long)row * width + col, acc + t, KP_THREADS, gx);
  __syncthreads();
  for (int h = KP_THREADS / 2; h > 0; h /= 2) {
    if (t < h)
      for (int j = 0; j < n_cols; ++j) acc[j * KP_THREADS + t] += acc[j * KP_THREADS + t + h];
    __syncthreads();
  }
  const long long block = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  for (int j = t; j < n_cols; j += KP_THREADS) rows[block * n_cols + j] = acc[j * KP_THREADS];
}

}  // namespace

// The most occluding spheres a launch takes: their columns fill the 227 KB
// of shared memory a block may opt into.
constexpr int KP_MAX_SPHERES = (232448 / (KP_THREADS * 4) - 1) / 4;

extern "C" int sail_penumbra_limits(int* out) {
  out[0] = KP_BX;
  out[1] = KP_BY;
  out[2] = KP_MAX_SPHERES;
  out[3] = KP_PLANES;
  out[4] = KP_LIGHT;
  return 0;
}

// Plain C entry point (bound with ctypes), device pointers as penumbra.cuh's
// KPIn lays them out; `rows` (n_blocks, 1 + 4 S) block partials, row-major
// over the 16 x 16 block grid; `gx` (R, 3, H, W).  Launches on `stream`,
// does not synchronise, and returns the launch's cudaError_t.
extern "C" int sail_penumbra(const float* x, const float* planes, const int* ints, const float* dl,
                             const float* mats, const float* spheres, const int* sphere_obj,
                             const float* lights, const int* light_obj, const float* cs, int R,
                             int S, int L, int K, float* rows, float* gx, int height, int width,
                             void* stream) {
  if (S < 0 || S > KP_MAX_SPHERES || R < 0 || L < 0 || K < 1 || height < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  KPIn in{x, planes, ints, dl, mats, spheres, sphere_obj, lights, light_obj, cs,
          R, S, L, K, (long long)height * width};
  const size_t smem = (size_t)(1 + 4 * S) * KP_THREADS * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(penumbra_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(KP_BX, KP_BY);
  dim3 grid((width + KP_BX - 1) / KP_BX, (height + KP_BY - 1) / KP_BY);
  penumbra_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(in, rows, gx, height, width);
  return (int)cudaGetLastError();
}
