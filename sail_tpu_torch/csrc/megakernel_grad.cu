// Backward path-tracing megakernel (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `render_grad_block_pallas`
// (sail_tpu/ops/pallas/megakernel.py:262, pl.pallas_call at :476): dL/dparams
// for L = sum over pixels of g . image_sum, where image_sum is K1's spp-SUM
// of radiance over an H x W block and g three float32 planes.  The result is
// the flat gradient in the parameter vector's (jax.tree.leaves) order.
//
// What bounds it on this card: FP32 issue and divergence, like K1, over a
// large body of code.  Per bounce K2 runs K1's forward bounce, replays it and
// runs its hand-written adjoint; the kernel is 9,600-16,800 instructions
// (~55,000 with metal, glass and the uv textures), several times an SM's
// instruction cache.  Registers (214-255 a thread) hold it to one block of 8
// warps per SM, two with spills where the launch bound asks for them.
//
// What the design does about it (adjoint.cuh `sample_grad`):
// - Replay, not re-trace.  The forward sweep records each bounce's input
//   state and its two discrete decisions, the closest hit's winner and the
//   shadow ray's bit (8 bytes); the reverse sweep replays the bounce from
//   them (path.cuh `bounce` with REPLAY), so the closest-hit fold and the
//   shadow scan, whose results carry no cotangent, run once per bounce.
//   Every other value is the same code in the same order, so the gradient is
//   the re-trace's bit for bit.
// - Lock step.  Both sweeps step their bounces together across the block, a
//   barrier before each bounce: the warps of an SM then run the same phase of
//   the same bounce and share the instruction cache.  Left to drift apart
//   over a pixel's samples they took three times as long (configs 2 and 3 at
//   1024² x 64 spp, an H100).
// - The gradient in shared memory.  Up to SHARED_MAX_PARAMS (220) parameters
//   each thread keeps its gradient in its column of a (n_params, 256) array
//   in dynamic shared memory, Gs[p * 256 + thread]: a warp's 32 lanes add to
//   32 banks whatever parameter each adds to, each slot has one owner (no
//   atomics), and the frame keeps only the stored states and decisions
//   (416 bytes).  Configs 1-3, the quadrics, the open twin and up to 13
//   spheres take it.  Larger scenes (the check scene, 16 spheres and more)
//   keep a local array of the smallest of CAPS (352, 1,024, 4,096 floats)
//   that holds them, with replay and lock step.  grad_build.h holds the
//   shared build's limits and the choice of the launch bound; the wrapper
//   picks CAP.
// - Builds per scene kind.  Each build is made with and without path.cuh's
//   MATS (metal, glass and the uv textures), so scenes of matte, mirror and
//   uniform colors keep the smaller adjoint; configs 1-2's kind (also no
//   shape beyond spheres, rectangles and a Cornell box: path.cuh's ALL
//   false) up to TWO_BLOCK_MAX_PARAMS (109) has a shared build of its own,
//   without the six other shapes' code (9,600 instructions against 16,800)
//   and at two blocks per SM.  Every shape has its adjoint; K2 folds
//   without the cull, which changes no value.
//
// The TPU kernel carries one (1, n) sum across its sequential grid; Hopper's
// blocks run in parallel and in no order, so the sum is two passes with a
// fixed order and no float atomics: each block reduces its threads (warp
// shuffles in a fixed tree, then warps in order through shared memory) into
// one row of a (n_blocks, n_params) buffer, and a second kernel sums the rows
// (a fixed stride and tree per parameter).  Repeated calls give bit-identical
// gradients, the same bits whichever build runs a scene.  A path that misses
// or dies leaves its sweep, as in K1: the masked JAX adjoint gives such lanes
// exactly zero cotangent.

#include "render_grad.cuh"

namespace {

// The local gradient arrays K2 is built for: a scene above SHARED_MAX_PARAMS
// takes the smallest that holds its parameters.  352 holds every scene of a
// few objects; 4,096 the 256-sphere scene (13 N + 47 = 3,375 parameters).
constexpr int CAPS[] = {352, 1024, 4096};
constexpr int N_CAPS = sizeof(CAPS) / sizeof(CAPS[0]);

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
// number of local gradient-array sizes, the sizes, then the most parameters
// the shared build takes.  The wrapper raises above them.
extern "C" int sail_grad_limits(int* out) {
  out[0] = BLOCK_X;
  out[1] = BLOCK_Y;
  out[2] = MAX_GRAD_BOUNCES;
  out[3] = N_CAPS;
  for (int i = 0; i < N_CAPS; ++i) out[4 + i] = CAPS[i];
  out[4 + N_CAPS] = SHARED_MAX_PARAMS;
  return 0;
}

// The blocks per SM of the build sail_render_grad_block launches for these
// arguments (grad_build.h), for labels and tests.
extern "C" int sail_grad_min_blocks(int n_params, int cap, int all_shapes, int materials) {
  return grad_min_blocks(cap, n_params, all_shapes != 0, materials != 0);
}

// Plain C entry points (bound with ctypes); `table` is the device int32 scene
// table (path.cuh make_scene).  `rows` holds ceil(W/16) * ceil(H/16) rows of
// n_params floats, one per thread block in launch order; `cap` is the build
// the wrapper picked: SHARED_GRAD (0, n_params up to SHARED_MAX_PARAMS) or
// one of CAPS, at least n_params; `all_shapes` and `materials` as in
// sail_render_block.  The launch bound follows from them (grad_min_blocks).
// Each launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t.
extern "C" int sail_render_grad_block(const float* params, const int* table, int n_obj,
                                      int n_plain, int n_groups, int n_mat, int n_tex,
                                      int n_light, int cam, int n_params, int cap, int all_shapes,
                                      int materials, const float* gx, const float* gy,
                                      const float* gz, float* rows, int height, int width,
                                      int spp, int seed, int sample0, int max_bounces, int row0,
                                      int image_height, void* stream) {
  if (n_params > (cap == SHARED_GRAD ? SHARED_MAX_PARAMS : cap) ||
      max_bounces > MAX_GRAD_BOUNCES)
    return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
#define SAIL_LAUNCH(C, A, M, B)                                                                \
  launch_grad<C, A, M, 0, B>(s, n_params, gx, gy, gz, rows, height, width, spp,              \
                             (uint32_t)seed, (uint32_t)sample0, max_bounces, row0,            \
                             image_height, (cudaStream_t)stream)
  if (grad_min_blocks(cap, n_params, all_shapes != 0, materials != 0) == 2)
    return SAIL_LAUNCH(SHARED_GRAD, false, false, 2);
  switch (cap) {
    case SHARED_GRAD:
      return materials ? SAIL_LAUNCH(SHARED_GRAD, true, true, 1)
                       : SAIL_LAUNCH(SHARED_GRAD, true, false, 1);
    case CAPS[0]:
      return materials ? SAIL_LAUNCH(CAPS[0], true, true, 1) : SAIL_LAUNCH(CAPS[0], true, false, 1);
    case CAPS[1]:
      return materials ? SAIL_LAUNCH(CAPS[1], true, true, 1) : SAIL_LAUNCH(CAPS[1], true, false, 1);
    case CAPS[2]:
      return materials ? SAIL_LAUNCH(CAPS[2], true, true, 1) : SAIL_LAUNCH(CAPS[2], true, false, 1);
  }
#undef SAIL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int sail_reduce_grad_rows(const float* rows, int n_rows, int n_params, float* out,
                                     void* stream) {
  reduce_grad_rows_kernel<<<n_params, 256, 0, (cudaStream_t)stream>>>(rows, n_rows, n_params, out);
  return (int)cudaGetLastError();
}
