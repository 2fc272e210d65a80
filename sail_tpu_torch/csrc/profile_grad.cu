// K2's profiling builds for NVIDIA Hopper (sm_90a): K2's own kernel template
// (render_grad.cuh) for configs 1-2's scene kind (spheres, rectangles and a
// Cornell box; matte, mirror and uniform colors; the gradient in shared
// memory) with a phase stripped, at two blocks per SM as the production K2
// runs that kind.  Compiled with that production build's defines
// (megakernel_grad.cu; ops/cuda/profile.py).  Measuring instruments, not production code: each does
// exactly the work it claims, so that its time splits K2's.
//
// - forward_only (GRAD_NO_ADJOINT | GRAD_NO_REPLAY): K2's forward sweep,
//   which stores each bounce's state and decisions; it adds the sample's
//   g . radiance to the gradient's slot 0.
// - no_adjoint (GRAD_NO_ADJOINT): the sweep and the reverse sweep's replay
//   without the adjoint; slot 0 as above, slot 1 the replayed bounces whose
//   output state differs from the recorded one (0), slot 2 g . radiance
//   again from the replayed bounces (adjoint.cuh says why).
// "full minus no_adjoint" is the adjoint's cost, "no_adjoint minus
// forward_only" the replay's.  Rows as K2's: one per thread block.

#include "render_grad.cuh"

#ifndef GRAD_CAP
#error "profile_grad.cu is compiled with a K2 build's defines (ops/cuda/profile.py)"
#endif

namespace {

// The variants, in the order of sail_render_grad_profile's `variant`
// (ops/cuda/profile.py GRAD_STRIPS).
constexpr int VARIANT_FORWARD_ONLY = 0, VARIANT_NO_ADJOINT = 1;

}  // namespace

// Plain C entry point (bound with ctypes), arguments as sail_render_grad_block
// less `lights`.  It runs only the scenes the build it was compiled with
// holds (configs 1-2's kind up to GRAD_MAX_PARAMS parameters) and returns
// cudaErrorInvalidValue for any other.  Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t.
extern "C" int sail_render_grad_profile(int variant, const float* params, const int* table,
                                        int n_obj, int n_plain, int n_groups, int n_mat,
                                        int n_tex, int n_light, int cam, int n_params,
                                        int all_shapes, int materials, const float* gx,
                                        const float* gy, const float* gz, float* rows, int height,
                                        int width, int spp, int seed, int sample0,
                                        int max_bounces, int row0, int image_height,
                                        void* stream) {
  if (n_params > GRAD_MAX_PARAMS || max_bounces > MAX_GRAD_BOUNCES || (all_shapes && !GRAD_ALL) ||
      (materials && !GRAD_MATS))
    return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
#define SAIL_LAUNCH(STRIP)                                                                    \
  launch_grad<GRAD_CAP, GRAD_ALL, GRAD_MATS, STRIP, GRAD_MIN_BLOCKS, GRAD_LIGHTS>(              \
      s, n_params, gx, gy, gz, rows, height, width, spp, (uint32_t)seed, (uint32_t)sample0,    \
      max_bounces, row0, image_height, (cudaStream_t)stream)
  switch (variant) {
    case VARIANT_FORWARD_ONLY: return SAIL_LAUNCH(GRAD_NO_ADJOINT | GRAD_NO_REPLAY);
    case VARIANT_NO_ADJOINT: return SAIL_LAUNCH(GRAD_NO_ADJOINT);
  }
#undef SAIL_LAUNCH
  return (int)cudaErrorInvalidValue;
}
