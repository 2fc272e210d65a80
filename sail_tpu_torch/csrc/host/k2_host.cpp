// K2's per-sample code on the CPU, for tests/test_torch_k2_host.py: each
// pixel's gradient, from the shipped `sample_grad` (the reverse sweep
// replays the recorded decisions) or from a reverse sweep that re-traces each
// bounce (`closest` and `occluded` again, as K2 did before replay), one
// pixel at a time in K2's thread order.  It runs K2's LIGHTS
// code for every scene (a rectangle light there takes the same code as in
// the other builds).  Build with a host compiler, this
// directory first on the include path, no contraction of multiply-adds
// (the kernels build -fmad=false) and K2's bounce limit as the kernels take
// it (ops/cuda/megakernel.py MAX_GRAD_BOUNCES):
//   g++ -std=c++17 -O2 -ffp-contract=off -fPIC -shared -I csrc/host \
//       -DMAX_GRAD_BOUNCES=8 -o k2_host.so csrc/host/k2_host.cpp

#include "../adjoint.cuh"

namespace {

// The reverse sweep before replay: each bounce run again from its state.
template <bool MATS>
void sample_grad_retrace(const Scene& s, const Camera& c, V3 g, uint32_t seed, uint32_t sample,
                         int max_bounces, uint32_t row, uint32_t col, float sx_scale,
                         float sy_scale, Grad<1> G) {
  PathState states[MAX_GRAD_BOUNCES];
  float jx, jy, unused, ndc_x, ndc_y, sx, sy;
  uniform3(stream_id(seed, sample, 0, TAG_PIXEL_JITTER), row, col, jx, jy, unused);
  V3 dir = camera_dir(c, (float)col, (float)(int)row, jx, jy, sx_scale, sy_scale, ndc_x, ndc_y,
                      sx, sy);
  PathState st;
  st.rd = normalize(dir);
  st.ro = c.eye;
  st.thr = {1.f, 1.f, 1.f};
  st.skip_emission = false;
  V3 e = {0.f, 0.f, 0.f};
  int nb = 0;
  for (int b = 0; b < max_bounces; ++b) {
    states[b] = st;
    Bounce v;
    if (!bounce<true, true, MATS, 0, false, true>(s, st, e, seed, sample, b, row, col, v)) break;
    nb = b + 1;
    if (!(max_component(st.thr) > 0.f)) break;
  }
  V3 d_ro = {0.f, 0.f, 0.f}, d_rd = {0.f, 0.f, 0.f}, d_thr = {0.f, 0.f, 0.f};
  for (int b = nb - 1; b >= 0; --b) {
    PathState again = states[b];
    Bounce v;
    bounce<true, true, MATS, 0, false, true>(s, again, e, seed, sample, b, row, col, v);
    bounce_adj<MATS, true, true>(s, states[b], v, g, d_ro, d_rd, d_thr, G);
  }
  camera_adj(s, c, dir, ndc_x, ndc_y, sx, sy, d_ro, d_rd, G);
}

template <bool MATS>
void pixel_grads(const Scene& s, int n_params, bool replay, const float* gx, const float* gy,
                 const float* gz, float* out, int height, int width, int spp, uint32_t seed,
                 uint32_t sample0, int max_bounces, int row0, int image_height) {
  const Camera c = load_camera(s);
  const float sx_scale = F(2.0 / (double)width), sy_scale = F(2.0 / (double)image_height);
  for (int lrow = 0; lrow < height; ++lrow) {
    for (int col = 0; col < width; ++col) {
      size_t idx = (size_t)lrow * (size_t)width + (size_t)col;
      Grad<1> G{out + idx * (size_t)n_params};
      for (int p = 0; p < n_params; ++p) G.p[p] = 0.f;
      V3 g = {gx[idx], gy[idx], gz[idx]};
      for (int k = 0; k < spp; ++k) {
        uint32_t sample = sample0 + (uint32_t)k, row = (uint32_t)(row0 + lrow);
        if (replay)
          sample_grad<MATS, 0, true, true>(s, c, g, seed, sample, max_bounces, row, (uint32_t)col,
                                           sx_scale, sy_scale, true, G);
        else
          sample_grad_retrace<MATS>(s, c, g, seed, sample, max_bounces, row, (uint32_t)col,
                                    sx_scale, sy_scale, G);
      }
    }
  }
}

}  // namespace

// Each pixel's gradient, `out` (height * width, n_params) row-major; the
// scene and its table as K2's C entry takes them (host memory here).
// `replay` != 0: the shipped sample_grad; 0: the re-tracing reverse sweep.
extern "C" int sail_host_pixel_grads(const float* params, const int* table, int n_obj,
                                     int n_plain, int n_groups, int n_mat, int n_tex,
                                     int n_light, int cam, int n_params, int materials,
                                     int replay, const float* gx, const float* gy,
                                     const float* gz, float* out, int height, int width, int spp,
                                     int seed, int sample0, int max_bounces, int row0,
                                     int image_height) {
  if (max_bounces > MAX_GRAD_BOUNCES) return 1;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  if (materials)
    pixel_grads<true>(s, n_params, replay != 0, gx, gy, gz, out, height, width, spp,
                      (uint32_t)seed, (uint32_t)sample0, max_bounces, row0, image_height);
  else
    pixel_grads<false>(s, n_params, replay != 0, gx, gy, gz, out, height, width, spp,
                       (uint32_t)seed, (uint32_t)sample0, max_bounces, row0, image_height);
  return 0;
}
