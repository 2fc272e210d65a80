// K2's LIGHTS builds at its two largest local gradient arrays, for NVIDIA
// Hopper (sm_90a).
//
// The same kernel as megakernel_grad.cu (render_grad.cuh
// `render_grad_kernel`; that file's header says what it computes and how),
// instantiated for a scene with a light other than AREA over a RECTANGLE
// (path.cuh light_sample_other, adjoint.cuh light_adj) of more than 352
// parameters: `render_grad_kernel<1024 | 4096, true, MATS, 0, 1, true>`,
// with and without MATS.  megakernel_grad.cu holds the LIGHTS builds of the
// shared array and of the 352-float one.  These four are a library of their
// own so that nvcc compiles them beside megakernel_grad.cu (utils/build.py
// starts one nvcc per library, all together) and not after it, and so that
// the builds configs 1-4 take stay what they were.  The block partials this
// entry writes are summed by megakernel_grad.cu's reduce, as every K2
// build's are.

#include "render_grad.cuh"

namespace {

// The local gradient-array sizes built here with LIGHTS: megakernel_grad.cu's
// CAPS[1] and CAPS[2], which the wrapper checks against sail_grad_lights_caps.
constexpr int LIGHTS_CAPS[] = {1024, 4096};
constexpr int N_LIGHTS_CAPS = sizeof(LIGHTS_CAPS) / sizeof(LIGHTS_CAPS[0]);

}  // namespace

// The sizes this library is built for: their number, then the sizes.
extern "C" int sail_grad_lights_caps(int* out) {
  out[0] = N_LIGHTS_CAPS;
  for (int i = 0; i < N_LIGHTS_CAPS; ++i) out[1 + i] = LIGHTS_CAPS[i];
  return 0;
}

// sail_render_grad_block's arguments and result (megakernel_grad.cu), for a
// scene with `lights` (and so `all_shapes`) whose `cap` is one of
// LIGHTS_CAPS; anything else returns cudaErrorInvalidValue.  Launches on
// `stream` and does not synchronise.
extern "C" int sail_render_grad_lights(const float* params, const int* table, int n_obj,
                                       int n_plain, int n_groups, int n_mat, int n_tex,
                                       int n_light, int cam, int n_params, int cap,
                                       int all_shapes, int materials, int lights,
                                       const float* gx, const float* gy, const float* gz,
                                       float* rows, int height, int width, int spp, int seed,
                                       int sample0, int max_bounces, int row0,
                                       int image_height, void* stream) {
  if (!lights || !all_shapes || n_params > cap || max_bounces > MAX_GRAD_BOUNCES)
    return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
#define SAIL_LAUNCH(C, M)                                                                    \
  launch_grad<C, true, M, 0, 1, true>(s, n_params, gx, gy, gz, rows, height, width, spp,     \
                                      (uint32_t)seed, (uint32_t)sample0, max_bounces, row0, \
                                      image_height, (cudaStream_t)stream)
  switch (cap) {
    case LIGHTS_CAPS[0]:
      return materials ? SAIL_LAUNCH(LIGHTS_CAPS[0], true) : SAIL_LAUNCH(LIGHTS_CAPS[0], false);
    case LIGHTS_CAPS[1]:
      return materials ? SAIL_LAUNCH(LIGHTS_CAPS[1], true) : SAIL_LAUNCH(LIGHTS_CAPS[1], false);
  }
#undef SAIL_LAUNCH
  return (int)cudaErrorInvalidValue;
}
