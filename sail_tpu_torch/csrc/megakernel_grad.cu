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
// - The gradient in shared memory.  Up to SHARED_GRAD_MAX_PARAMS (220)
//   parameters each thread keeps its gradient in its column of a
//   (n_params, 256) array in dynamic shared memory, Gs[p * 256 + thread]: a
//   warp's 32 lanes add to 32 banks whatever parameter each adds to, each
//   slot has one owner (no atomics), and the frame keeps only the stored
//   states and decisions (416 bytes).  Configs 1-3, the quadrics, the open
//   twin and up to 13 spheres take it.  Larger scenes (the check scene, 16
//   spheres and more) keep a local array of the smallest of GRAD_CAPS (352,
//   1,024, 4,096 floats) that holds them, with replay and lock step.
// - Builds per scene kind.  Each build is made with and without path.cuh's
//   MATS (metal, glass and the uv textures), so scenes of matte, mirror and
//   uniform colors keep the smaller adjoint; configs 1-2's kind (also no
//   shape beyond spheres, rectangles and a Cornell box: path.cuh's ALL
//   false) up to TWO_BLOCK_MAX_PARAMS (109) has a shared build of its own,
//   without the six other shapes' code (9,600 instructions against 16,800)
//   and at two blocks per SM.  Every shape has its adjoint; K2 folds
//   without the cull, which changes no value.  A scene with a light other
//   than AREA over a RECTANGLE (config 4: a point and a spot light; an area
//   light over any other shape) takes a LIGHTS build (path.cuh
//   light_sample_other, adjoint.cuh light_adj), made at every gradient
//   array, with and without MATS; no other build holds that code.
//
// One build a library.  ops/cuda/megakernel.py `grad_build` is the one place
// that decides which build a scene runs, and the numbers it decides with;
// this file is compiled once per build (utils/build.py), the build's
// template arguments and limits given as defines (`GradBuild.defines`):
// GRAD_CAP, GRAD_ALL, GRAD_MATS, GRAD_MIN_BLOCKS, GRAD_LIGHTS and
// GRAD_MAX_PARAMS, beside render_grad.cuh's GRAD_BLOCK_X, GRAD_BLOCK_Y and
// SHARED_GRAD and adjoint.cuh's MAX_GRAD_BOUNCES.  A build compiles the
// first time a call needs it.
//
// The TPU kernel carries one (1, n) sum across its sequential grid; Hopper's
// blocks run in parallel and in no order, so the sum is two passes with a
// fixed order and no float atomics: each block reduces its threads (warp
// shuffles in a fixed tree, then warps in order through shared memory) into
// one row of a (n_blocks, n_params) buffer, and a second kernel sums the rows
// (reduce_grad_rows.cu).  Repeated calls give bit-identical gradients, the
// same bits whichever build runs a scene.  A path that misses or dies leaves
// its sweep, as in K1: the masked JAX adjoint gives such lanes exactly zero
// cotangent.

#include "render_grad.cuh"

#ifndef GRAD_CAP
#error "megakernel_grad.cu is compiled once per K2 build, with its defines (ops/cuda/megakernel.py GradBuild.defines)"
#endif

// Plain C entry point (bound with ctypes): K2's first pass with this
// library's build.  `table` is the device int32 scene table (path.cuh
// make_scene); `rows` holds ceil(W/16) * ceil(H/16) rows of n_params floats,
// one per thread block in launch order; `all_shapes`, `materials` and
// `lights` are the scene's kind (sail_render_block's, and a light other than
// AREA over a RECTANGLE).  A scene the build does not hold (more than
// GRAD_MAX_PARAMS parameters, more than MAX_GRAD_BOUNCES bounces, a kind
// whose code the build lacks) returns cudaErrorInvalidValue.  Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t.
extern "C" int sail_render_grad_block(const float* params, const int* table, int n_obj,
                                      int n_plain, int n_groups, int n_mat, int n_tex,
                                      int n_light, int cam, int n_params, int all_shapes,
                                      int materials, int lights, const float* gx, const float* gy,
                                      const float* gz, float* rows, int height, int width,
                                      int spp, int seed, int sample0, int max_bounces, int row0,
                                      int image_height, void* stream) {
  if (n_params > GRAD_MAX_PARAMS || max_bounces > MAX_GRAD_BOUNCES || (all_shapes && !GRAD_ALL) ||
      (materials && !GRAD_MATS) || (lights && !GRAD_LIGHTS))
    return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  return launch_grad<GRAD_CAP, GRAD_ALL, GRAD_MATS, 0, GRAD_MIN_BLOCKS, GRAD_LIGHTS>(
      s, n_params, gx, gy, gz, rows, height, width, spp, (uint32_t)seed, (uint32_t)sample0,
      max_bounces, row0, image_height, (cudaStream_t)stream);
}
