// K1's kernel, a template over the scene kind (path.cuh's ALL, CULL and
// MATS) and a strip mask (path.cuh's STRIP_*); megakernel.cu says what it
// computes and how.  megakernel.cu builds the eight scene kinds with STRIP 0,
// the production K1; profile.cu builds config 2's kind with one phase
// stripped, so that "full minus stripped" is always this kernel's phase cost.
#pragma once

#include "path.cuh"

namespace {

// Three 256-thread blocks per SM: ptxas then keeps K1 at 80 registers (a
// small spill) where left alone it took 117 and fit two blocks, 16% slower
// on config 2 (an H100).  Built for the eight scene kinds of path.cuh's ALL,
// CULL and MATS; the entry point launches the one the scene needs.
template <bool ALL, bool CULL, bool MATS, int STRIP = 0>
__global__ void __launch_bounds__(256, 3) render_block_kernel(Scene s, int n_clusters,
                                                           float* __restrict__ out_x,
                                                           float* __restrict__ out_y,
                                                           float* __restrict__ out_z, int height,
                                                           int width, int spp, uint32_t seed,
                                                           uint32_t sample0, int max_bounces, int row0,
                                                           int image_height) {
  // the cull's cluster bound boxes, once per block, before any thread leaves
  extern __shared__ float boxes[];
  if (CULL) {
    cluster_boxes(s, boxes, threadIdx.y * blockDim.x + threadIdx.x, blockDim.x * blockDim.y);
    __syncthreads();
    s.box = boxes;
  }
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || lrow >= height) return;
  uint32_t row = (uint32_t)(row0 + lrow);

  const Camera cam = load_camera(s);
  const float sx_scale = F(2.0 / (double)width), sy_scale = F(2.0 / (double)image_height);
  const float fcol = (float)col, frow = (float)(int)row;

  V3 acc = {0.f, 0.f, 0.f};
  for (int k = 0; k < spp; ++k) {
    uint32_t sample = sample0 + (uint32_t)k;
    float jx, jy, unused, ndc_x, ndc_y, sx, sy;
    draw3<STRIP>(stream_id(seed, sample, 0, TAG_PIXEL_JITTER), row, (uint32_t)col, jx, jy, unused);
    PathState st;
    st.rd = normalize(camera_dir(cam, fcol, frow, jx, jy, sx_scale, sy_scale, ndc_x, ndc_y, sx, sy));
    st.ro = cam.eye;
    st.thr = {1.f, 1.f, 1.f};
    st.skip_emission = false;
    V3 e = {0.f, 0.f, 0.f};
    for (int b = 0; b < max_bounces; ++b) {
      Bounce v;
      if (!bounce<ALL, CULL, MATS, STRIP>(s, st, e, seed, sample, b, row, (uint32_t)col, v)) break;  // miss
      if (!(max_component(st.thr) > 0.f)) break;  // dead: adds nothing more
    }
    acc = acc + e;
  }
  size_t idx = (size_t)lrow * (size_t)width + (size_t)col;
  out_x[idx] = acc.x;
  out_y[idx] = acc.y;
  out_z[idx] = acc.z;
}

}  // namespace
