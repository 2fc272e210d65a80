// KH: the penumbra term's primary and mirror receivers, with the adjoint of
// their points with respect to the camera, on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package finds these receivers with XLA
// inside the jitted train step (`sail_tpu/diff/boundary.py`
// `shadow_boundary_term`, `sail_tpu/parallel/render_sharded.py:257`); the
// port's plain version (`diff/boundary.py` `_shadow_term_plain`) runs them
// as eager torch over (H, W) tensors: the pixel rays, the closest-hit fold
// of the camera rays and of their mirror bounce, each twice (detached, and
// again under autograd for the live points), the shading frames, surface
// colors and the mirror's tint, KP's stacked planes, and autograd's backward
// of the live points: ~5,700 launches at config 5's size, most of them
// passes over full-image planes.  This is that work in two launches
// (receivers.cuh says what a pixel computes).
//
// What bounds it: bytes and the closest-hit fold.  The forward writes 92
// bytes a pixel a receiver (18 planes, 2 ints, the point) after two folds
// over the scene's objects; the backward reads 12 bytes a receiver, folds
// again where the points take a cotangent, and writes one row of 14
// partials a block.
//
// Design: one thread a pixel, 16 x 16 blocks.  The forward runs K1's fold
// and hit code (path.cuh `closest`, `object_hit`, texture_color) with the
// plain version's order of operations and -fmad=false, so its outputs are
// the plain version's bit for bit.  The backward recomputes the pixel's hits
// (the same values), applies K2's hit adjoints and camera adjoint, sums each
// block's 256 pixels in a fixed tree in shared memory and writes one row a
// block; K2's reduce (`reduce_grad_rows`) sums the rows in its fixed order.
// No float atomics: the same bits on every call.

#include "receivers.cuh"

namespace {

constexpr int KH_BX = 16, KH_BY = 16, KH_THREADS = KH_BX * KH_BY;

__global__ void __launch_bounds__(KH_THREADS)
    receivers_kernel(Scene s, int R, float* __restrict__ planes, int* __restrict__ ints,
                     float* __restrict__ xs, int height, int width) {
  const int col = blockIdx.x * KH_BX + threadIdx.x, row = blockIdx.y * KH_BY + threadIdx.y;
  if (col < width && row < height)
    receivers_pixel(s, R, row, col, height, width, planes, ints, xs);
}

__global__ void __launch_bounds__(KH_THREADS)
    receivers_grad_kernel(Scene s, int R, const float* __restrict__ gx, float* __restrict__ rows,
                          int height, int width) {
  __shared__ float acc[KH_CAMERA * KH_THREADS];  // column j of thread t: acc[j * KH_THREADS + t]
  const int t = threadIdx.y * KH_BX + threadIdx.x;
  for (int j = 0; j < KH_CAMERA; ++j) acc[j * KH_THREADS + t] = 0.f;
  const int col = blockIdx.x * KH_BX + threadIdx.x, row = blockIdx.y * KH_BY + threadIdx.y;
  if (col < width && row < height)
    receivers_grad_pixel(s, R, gx, row, col, height, width, acc + t, KH_THREADS);
  __syncthreads();
  for (int h = KH_THREADS / 2; h > 0; h /= 2) {
    if (t < h)
      for (int j = 0; j < KH_CAMERA; ++j) acc[j * KH_THREADS + t] += acc[j * KH_THREADS + t + h];
    __syncthreads();
  }
  const long long block = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (t < KH_CAMERA) rows[block * KH_CAMERA + t] = acc[t * KH_THREADS];
}

}  // namespace

extern "C" int sail_receivers_limits(int* out) {
  out[0] = KH_BX;
  out[1] = KH_BY;
  out[2] = KH_PLANES;
  out[3] = KH_CAMERA;
  return 0;
}

// Plain C entry points (bound with ctypes): the scene as sail_render_block
// takes it (params, the int32 table and its section counts, the camera's
// offset), R receivers (1 or 2).  The forward writes `planes` (R, 18, H, W),
// `ints` (R, 2, H, W) and `xs` (R, 3, H, W); the backward reads `gx`
// (R, 3, H, W) and writes `rows` (n_blocks, 14), row-major over the 16 x 16
// block grid.  Each launches on `stream`, does not synchronise, and returns
// the launch's cudaError_t.
extern "C" int sail_receivers(const float* params, const int* table, int n_obj, int n_plain,
                              int n_groups, int n_mat, int n_tex, int n_light, int cam, int R,
                              float* planes, int* ints, float* xs, int height, int width,
                              void* stream) {
  if (R < 1 || R > 2 || height < 1 || width < 1) return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  dim3 block(KH_BX, KH_BY);
  dim3 grid((width + KH_BX - 1) / KH_BX, (height + KH_BY - 1) / KH_BY);
  receivers_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(s, R, planes, ints, xs, height,
                                                              width);
  return (int)cudaGetLastError();
}

extern "C" int sail_receivers_grad(const float* params, const int* table, int n_obj, int n_plain,
                                   int n_groups, int n_mat, int n_tex, int n_light, int cam,
                                   int R, const float* gx, float* rows, int height, int width,
                                   void* stream) {
  if (R < 1 || R > 2 || height < 1 || width < 1) return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  dim3 block(KH_BX, KH_BY);
  dim3 grid((width + KH_BX - 1) / KH_BX, (height + KH_BY - 1) / KH_BY);
  receivers_grad_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(s, R, gx, rows, height, width);
  return (int)cudaGetLastError();
}
