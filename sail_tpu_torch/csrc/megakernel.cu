// Forward path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `render_block_pallas`
// (sail_tpu/ops/pallas/megakernel.py:159, pl.pallas_call at :244): for every
// pixel of an H x W block, a loop over spp samples of PCG3D jitter -> camera
// ray -> max_bounces x (closest-hit fold, surface color, BSDF sample, next-
// event estimation with a shadow any-hit ray), returning the spp-SUM of
// radiance as three float32 planes.  It also replaces that kernel's
// many-object form (K1-many): the batched winner-fold the TPU kernel unrolls
// for groups of 8 or more objects of one shape, with its opt-in CLUSTER=8
// bound-box cull (sail_tpu/ops/intersect.py:593-760 for the closest hit,
// :885-925 for the shadow scan; set by megakernel.py:241-242).  A CUDA loop
// has no unroll cap, so every group size runs in the kernel (the TPU kernel
// fell back to XLA above 128 objects).
//
// What bounds it on this card: no data reuse and almost no memory traffic
// (the scene's floats and a small int table, read by every thread from the
// same addresses; 12 bytes written per pixel).  It is bound by FP32 and SFU
// throughput (sqrt, div, sin/cos) and by divergence: lanes of a warp hit
// different objects and materials and die at different bounces.  Its work
// grows with the objects each ray tests, which the cull cuts where the
// objects are spatially grouped in scene order.
//
// Design: one thread per pixel, as in the reference's fragment shader.  The
// TPU kernel's (8, 256) tiles and lock-step masked lanes are not carried
// over.  A thread keeps its path state in registers, runs the spp loop and
// the bounce loop itself, and adds samples in sample order, so results are
// deterministic.  A dead path leaves the bounce loop at once: the masked TPU
// loop adds exactly +0 for it from then on, so this is bit-identical, not
// the TPU kernel's approximate tile-level early exit.  The scene arrives as
// the flat float vector (the JAX package's leaf order) plus an int32 table;
// the kernel switches on category at run time, so one build serves every
// scene made of the ported categories (all nine shapes; MATTE, MIRROR;
// UNIFORM_COLOR; AREA over RECTANGLE).  The closest-hit fold keeps t only
// per object and computes hit details once for the winner: the design of
// the TPU's batched fold, whose order the table's rows follow (small
// categories in scene order, then each batched group), so a tie picks the
// object JAX picks.  With the cull, each block first builds the groups'
// cluster bound boxes in shared memory; a thread then skips a cluster whose
// box it cannot reach before its best hit (the TPU kernel culls per tile,
// with an `any` over its lanes).  Both are exact: a culled cluster cannot
// change the fold, so the image does not depend on the cull.
//
// The device code (intersections, BSDF, one bounce) is path.cuh, shared with
// K2; its numerics follow the plain torch version operation by operation.

#include "path.cuh"

namespace {

// Three 256-thread blocks per SM: ptxas then keeps K1 at 80 registers (a
// small spill) where left alone it took 117 and fit two blocks, 16% slower
// on config 2 (an H100).  Built for the four scene kinds of path.cuh's ALL
// and CULL; the entry point launches the one the scene needs.
template <bool ALL, bool CULL>
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
    uniform3(stream_id(seed, sample, 0, TAG_PIXEL_JITTER), row, (uint32_t)col, jx, jy, unused);
    PathState st;
    st.rd = normalize(camera_dir(cam, fcol, frow, jx, jy, sx_scale, sy_scale, ndc_x, ndc_y, sx, sy));
    st.ro = cam.eye;
    st.thr = {1.f, 1.f, 1.f};
    st.skip_emission = false;
    V3 e = {0.f, 0.f, 0.f};
    for (int b = 0; b < max_bounces; ++b) {
      Bounce v;
      if (!bounce<ALL, CULL>(s, st, e, seed, sample, b, row, (uint32_t)col, v)) break;  // miss
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

// The most cull clusters a launch takes: their bound boxes fill the 48 KB of
// shared memory a block gets without opting in.
constexpr int MAX_CLUSTERS = 48 * 1024 / (6 * (int)sizeof(float));

extern "C" int sail_max_clusters() { return MAX_CLUSTERS; }

// Plain C entry point (bound with ctypes); `table` is the device int32 scene
// table (make_scene).  `all_shapes` != 0: the scene holds a shape other than
// a sphere, a rectangle and a Cornell box.  `n_clusters` > 0 turns the cull
// on: the kernel then builds that many cluster bound boxes in shared memory.
// Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t.
extern "C" int sail_render_block(const float* params, const int* table, int n_obj, int n_plain,
                                 int n_groups, int n_mat, int n_tex, int n_light, int cam,
                                 int all_shapes, int n_clusters, float* out_x, float* out_y,
                                 float* out_z, int height, int width, int spp, int seed, int sample0,
                                 int max_bounces, int row0, int image_height, void* stream) {
  if (n_clusters < 0 || n_clusters > MAX_CLUSTERS) return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  dim3 block(16, 16);
  dim3 grid((width + 15) / 16, (height + 15) / 16);
  size_t smem = (size_t)n_clusters * 6 * sizeof(float);
  auto kernel = all_shapes ? (n_clusters > 0 ? render_block_kernel<true, true>
                                             : render_block_kernel<true, false>)
                           : (n_clusters > 0 ? render_block_kernel<false, true>
                                             : render_block_kernel<false, false>);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      s, n_clusters, out_x, out_y, out_z, height, width, spp, (uint32_t)seed, (uint32_t)sample0,
      max_bounces, row0, image_height);
  return (int)cudaGetLastError();
}
