// K2's builds and which scene takes which: the one place that decides, in
// plain C++ so that the kernels (render_grad.cuh, megakernel_grad.cu,
// profile_grad.cu) and the host build (host/k2_host.cpp) share it.
#pragma once

namespace {

constexpr int BLOCK_X = 16, BLOCK_Y = 16, THREADS = BLOCK_X * BLOCK_Y, WARPS = THREADS / 32;

// CAP of the build that keeps each thread's gradient in its column of a
// block-wide (n_params, THREADS) array in dynamic shared memory; any other
// CAP is a local array of CAP floats (megakernel_grad.cu CAPS).
constexpr int SHARED_GRAD = 0;
// The shared memory a block may have on Hopper, and so the most parameters
// the shared build takes: (THREADS + WARPS) x n_params floats, the columns
// and the warps' partial sums, within 232,448 bytes (220 parameters).
constexpr int MAX_BLOCK_SMEM = 232448;
constexpr int SHARED_MAX_PARAMS = MAX_BLOCK_SMEM / ((THREADS + WARPS) * (int)sizeof(float));

// The shared memory of an SM (of which each resident block reserves 1 KB),
// and so the most parameters at which two blocks of the shared build fit on
// one SM (109).  Configs 1-2's kind (spheres, rectangles and a Cornell box;
// matte, mirror and uniform colors; path.cuh's ALL and MATS false) up to
// this size runs a shared build of its own at `__launch_bounds__(THREADS,
// 2)` (at most 128 registers, some spilled): config 2 measured it 17% faster
// than at (THREADS, 1) (an H100).  Every other build takes (THREADS, 1), one
// block per SM, and ALL: every shape.
constexpr int SM_SMEM = 233472, BLOCK_RESERVED_SMEM = 1024;
constexpr int TWO_BLOCK_MAX_PARAMS =
    (SM_SMEM / 2 - BLOCK_RESERVED_SMEM) / ((THREADS + WARPS) * (int)sizeof(float));

// The blocks per SM of the build a scene runs (its launch bound), from the
// build the wrapper picked (`cap`), the scene's parameters and its kind.
inline int grad_min_blocks(int cap, int n_params, bool all_shapes, bool materials) {
  const bool two =
      cap == SHARED_GRAD && !all_shapes && !materials && n_params <= TWO_BLOCK_MAX_PARAMS;
  return two ? 2 : 1;
}

}  // namespace
