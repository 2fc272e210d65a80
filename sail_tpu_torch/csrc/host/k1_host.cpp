// K1's per-pixel loop on the CPU, for tests/test_torch_k1_host.py: each
// pixel's spp-SUM of radiance from the shipped `render_pixel`
// (render_block.cuh: path regeneration, the shadow ray tested with the next
// ray in one pass, the staged frames and reciprocals; here a block of one
// thread, whose barrier returns its own predicate) or from the loop K1 ran
// before it (a sample loop around a bounce loop, path.cuh `bounce` with its
// own closest-hit fold and shadow scan, every frame and reciprocal computed
// per test), one pixel at a time.  Build with a host compiler, this directory
// first on the include path and no contraction of multiply-adds (the kernels
// build -fmad=false):
//   g++ -std=c++17 -O2 -ffp-contract=off -fPIC -shared -I csrc/host \
//       -o k1_host.so csrc/host/k1_host.cpp

#include <vector>

#include "../render_block.cuh"

namespace {

// The loop before path regeneration: each sample's bounces in turn, each
// bounce's shadow scan inside it.
template <bool ALL, bool CULL, bool MATS, int STRIP>
V3 pixel_by_sample(const Scene& s, uint32_t row, uint32_t col, int spp, uint32_t seed,
                   uint32_t sample0, int max_bounces, float sx_scale, float sy_scale) {
  const Camera cam = load_camera(s);
  V3 acc = {0.f, 0.f, 0.f};
  for (int k = 0; k < spp; ++k) {
    uint32_t sample = sample0 + (uint32_t)k;
    float jx, jy, unused, ndc_x, ndc_y, sx, sy;
    draw3<STRIP>(stream_id(seed, sample, 0, TAG_PIXEL_JITTER), row, col, jx, jy, unused);
    PathState st;
    st.rd = normalize(camera_dir(cam, (float)col, (float)(int)row, jx, jy, sx_scale, sy_scale,
                                 ndc_x, ndc_y, sx, sy));
    st.ro = cam.eye;
    st.thr = {1.f, 1.f, 1.f};
    st.skip_emission = false;
    V3 e = {0.f, 0.f, 0.f};
    for (int b = 0; b < max_bounces; ++b) {
      Bounce v;
      if (!bounce<ALL, CULL, MATS, STRIP, false, ALL>(s, st, e, seed, sample, b, row, col, v))
        break;
      if (!(max_component(st.thr) > 0.f)) break;
    }
    acc = acc + e;
  }
  return acc;
}

template <bool ALL, bool CULL, bool MATS, int STRIP>
void image(Scene s, int n_clusters, int n_frames, bool shipped, float* out_x, float* out_y,
           float* out_z, int height, int width, int spp, uint32_t seed, uint32_t sample0,
           int max_bounces, int row0, int image_height) {
  std::vector<float> boxes(6 * (size_t)n_clusters);
  std::vector<RectFrame> frames((size_t)n_frames);
  if (CULL) {
    cluster_boxes(s, boxes.data(), 0, 1);
    s.box = boxes.data();
  }
  stage_frames(s, frames.data(), n_frames, 0, 1);
  const float sx_scale = F(2.0 / (double)width), sy_scale = F(2.0 / (double)image_height);
  for (int lrow = 0; lrow < height; ++lrow) {
    for (int col = 0; col < width; ++col) {
      uint32_t row = (uint32_t)(row0 + lrow);
      V3 acc = shipped ? render_pixel<ALL, CULL, MATS, STRIP>(
                             s, Frames{frames.data(), n_frames}, true, row, (uint32_t)col, spp,
                             seed, sample0, max_bounces, sx_scale, sy_scale)
                       : pixel_by_sample<ALL, CULL, MATS, STRIP>(s, row, (uint32_t)col, spp, seed,
                                                                 sample0, max_bounces, sx_scale,
                                                                 sy_scale);
      size_t idx = (size_t)lrow * (size_t)width + (size_t)col;
      out_x[idx] = acc.x;
      out_y[idx] = acc.y;
      out_z[idx] = acc.z;
    }
  }
}

}  // namespace

// The image K1 gives for sail_render_block's arguments (host memory here),
// from the shipped loop (`shipped` != 0) or the loop before it; `strip` is
// a STRIP_* bit (config 2's scene kind only, as csrc/profile.cu builds it)
// or 0.  Returns 1 for a strip it does not take.
extern "C" int sail_host_render_block(int strip, const float* params, const int* table, int n_obj,
                                      int n_plain, int n_groups, int n_mat, int n_tex,
                                      int n_light, int cam, int all_shapes, int materials,
                                      int n_clusters, int n_frames, int shipped, float* out_x,
                                      float* out_y, float* out_z, int height, int width, int spp,
                                      int seed, int sample0, int max_bounces, int row0,
                                      int image_height) {
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  using Image = decltype(&image<true, true, true, 0>);
  const Image kinds[8] = {image<false, false, false, 0>, image<false, false, true, 0>,
                          image<false, true, false, 0>,  image<false, true, true, 0>,
                          image<true, false, false, 0>,  image<true, false, true, 0>,
                          image<true, true, false, 0>,   image<true, true, true, 0>};
  Image fn = kinds[(all_shapes ? 4 : 0) + (n_clusters > 0 ? 2 : 0) + (materials ? 1 : 0)];
  if (strip != 0) {
    if (all_shapes || materials || n_clusters) return 1;
    switch (strip) {
      case STRIP_CONST_RNG: fn = image<false, false, false, STRIP_CONST_RNG>; break;
      case STRIP_CONST_TEXTURE: fn = image<false, false, false, STRIP_CONST_TEXTURE>; break;
      case STRIP_NO_SHADOW: fn = image<false, false, false, STRIP_NO_SHADOW>; break;
      case STRIP_NO_NEE: fn = image<false, false, false, STRIP_NO_NEE>; break;
      default: return 1;
    }
  }
  fn(s, n_clusters, n_frames, shipped != 0, out_x, out_y, out_z, height, width, spp,
     (uint32_t)seed, (uint32_t)sample0, max_bounces, row0, image_height);
  return 0;
}
