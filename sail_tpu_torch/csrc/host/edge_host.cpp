// The edge terms' kernels on the CPU, for tests/test_torch_edge_kernels.py,
// tests/test_torch_alhazen.py and tests/test_torch_receivers.py: KR's
// per-ray loop (render_block.cuh `ray_radiance`, a block of one thread, whose
// barrier returns its own predicate), KP's per-pixel term and adjoint
// (penumbra.cuh `penumbra_pixel`), KA's Alhazen solve (alhazen.cuh) and KH's
// receivers and their adjoint (receivers.cuh), through the stub
// cuda_runtime.h.
// Build with a host compiler, this directory first on the include path and
// no contraction of multiply-adds (the kernels build -fmad=false), as
// `utils/build.load_host(source, EDGE_HOST_FLAGS)` does (the tests' fixture):
//   g++ -O3 -fPIC -shared csrc/host/edge_host.cpp -std=c++17 -ffp-contract=off -I csrc/host

#include <vector>

#include "../alhazen.cuh"
#include "../penumbra.cuh"
#include "../receivers.cuh"
#include "../render_block.cuh"

// KR's radiance of n rays, host arrays laid out as sail_trace_rays takes
// them (the table's frames computed here, not staged per block).
extern "C" int sail_host_trace_rays(const float* params, const int* table, int n_obj, int n_plain,
                                    int n_groups, int n_mat, int n_tex, int n_light, int cam,
                                    int n_frames, const float* ro_x, const float* ro_y,
                                    const float* ro_z, const float* rd_x, const float* rd_y,
                                    const float* rd_z, const int* sample, const int* ii,
                                    const int* jj, float* out_x, float* out_y, float* out_z, int n,
                                    int seed, int max_bounces) {
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  std::vector<RectFrame> frames((size_t)(n_frames > 0 ? n_frames : 0));
  stage_frames(s, frames.data(), n_frames, 0, 1);
  for (int i = 0; i < n; ++i) {
    V3 e = ray_radiance<true, true>(s, Frames{frames.data(), n_frames}, true, (uint32_t)ii[i],
                                    (uint32_t)jj[i], (uint32_t)sample[i], (uint32_t)seed,
                                    max_bounces, V3{ro_x[i], ro_y[i], ro_z[i]},
                                    V3{rd_x[i], rd_y[i], rd_z[i]});
    out_x[i] = e.x;
    out_y[i] = e.y;
    out_z[i] = e.z;
  }
  return 0;
}

// K1's camera ray of pixel (ii[i], jj[i]) in sample sample[i] (render_pixel's
// first ray), so that KR can be handed K1's own rays.
extern "C" int sail_host_camera_rays(const float* params, const int* table, int n_obj,
                                     int n_plain, int n_groups, int n_mat, int n_tex, int n_light,
                                     int cam, const int* sample, const int* ii, const int* jj,
                                     float* ro, float* rd, int n, int seed, int height,
                                     int width) {
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  const Camera c = load_camera(s);
  const float sx_scale = F(2.0 / (double)width), sy_scale = F(2.0 / (double)height);
  for (int i = 0; i < n; ++i) {
    float jx, jy, unused, ndc_x, ndc_y, sx, sy;
    draw3(stream_id((uint32_t)seed, (uint32_t)sample[i], 0, TAG_PIXEL_JITTER), (uint32_t)ii[i],
          (uint32_t)jj[i], jx, jy, unused);
    V3 d = normalize(camera_dir(c, (float)jj[i], (float)ii[i], jx, jy, sx_scale, sy_scale, ndc_x,
                                ndc_y, sx, sy));
    ro[3 * i] = c.eye.x;
    ro[3 * i + 1] = c.eye.y;
    ro[3 * i + 2] = c.eye.z;
    rd[3 * i] = d.x;
    rd[3 * i + 1] = d.y;
    rd[3 * i + 2] = d.z;
  }
  return 0;
}

// KP's per-pixel term on host arrays laid out as sail_penumbra takes them;
// `acc` (H·W, 1 + 4 S): each pixel's own value and sphere partials (summed
// by the caller), `gx` (R, 3, H, W).
extern "C" int sail_host_penumbra(const float* x, const float* planes, const int* ints,
                                  const float* dl, const float* mats, const float* spheres,
                                  const int* sphere_obj, const float* lights, const int* light_obj,
                                  const float* cs, int R, int S, int L, int K, float* acc,
                                  float* gx, int height, int width) {
  const long long hw = (long long)height * width;
  KPIn in{x, planes, ints, dl, mats, spheres, sphere_obj, lights, light_obj, cs, R, S, L, K, hw};
  const int n_cols = 1 + 4 * S;
  for (long long p = 0; p < hw; ++p) {
    float* a = acc + p * n_cols;
    for (int j = 0; j < n_cols; ++j) a[j] = 0.f;
    penumbra_pixel(in, p, a, 1, gx);
  }
  return 0;
}

// KA's solve on host arrays laid out as sail_alhazen takes them: the
// centre's scan searched in order for its first sign change (the kernel's
// ballot), then each azimuth.
extern "C" int sail_host_alhazen(const float* frame, const float* table, const float* cphi,
                                 const float* sphi, int n, float* out, unsigned char* mask) {
  const KAFrame f = ka_frame(frame);
  const float span = ka_psi_span(f);
  float hs[KA_NS];
  for (int k = 0; k < KA_NS; ++k) hs[k] = ka_h(f, ka_psi(table, k, span));
  int idx = -1;
  for (int k = 0; k + 1 < KA_NS && idx < 0; ++k)
    if (hs[k] * hs[k + 1] <= 0.f) idx = k;
  const KACenter c =
      ka_center(f, ka_psi(table, idx < 0 ? 0 : idx, span), ka_psi(table, idx < 0 ? 1 : idx + 1, span));
  out[0] = c.psi0;
  out[1] = c.dh;
  for (int j = 0; j < n; ++j) {
    bool m;
    ka_radial(f, c, idx >= 0, table + KA_NS, cphi[j], sphi[j], out[2 + j], out[2 + n + j], m);
    mask[j] = m;
  }
  return 0;
}

// KH's receivers on host arrays laid out as sail_receivers takes them.
extern "C" int sail_host_receivers(const float* params, const int* table, int n_obj, int n_plain,
                                   int n_groups, int n_mat, int n_tex, int n_light, int cam, int R,
                                   float* planes, int* ints, float* xs, int height, int width) {
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  for (int row = 0; row < height; ++row)
    for (int col = 0; col < width; ++col)
      receivers_pixel(s, R, row, col, height, width, planes, ints, xs);
  return 0;
}

// KH's adjoint on host arrays laid out as sail_receivers_grad takes them;
// `acc` (H·W, 14): each pixel's own camera partials (summed by the caller).
extern "C" int sail_host_receivers_grad(const float* params, const int* table, int n_obj,
                                        int n_plain, int n_groups, int n_mat, int n_tex,
                                        int n_light, int cam, int R, const float* gx, float* acc,
                                        int height, int width) {
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  for (int row = 0; row < height; ++row)
    for (int col = 0; col < width; ++col) {
      float* a = acc + ((long long)row * width + col) * KH_CAMERA;
      for (int j = 0; j < KH_CAMERA; ++j) a[j] = 0.f;
      receivers_grad_pixel(s, R, gx, row, col, height, width, a, 1);
    }
  return 0;
}
