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
// scene made of the ported categories (all nine shapes; every material and
// texture; AREA over RECTANGLE).  The closest-hit fold keeps t only
// per object and computes hit details once for the winner: the design of
// the TPU's batched fold, whose order the table's rows follow (small
// categories in scene order, then each batched group), so a tie picks the
// object JAX picks.  With the cull, each block first builds the groups'
// cluster bound boxes in shared memory; a thread then skips a cluster whose
// box it cannot reach before its best hit (the TPU kernel culls per tile,
// with an `any` over its lanes).  Both are exact: a culled cluster cannot
// change the fold, so the image does not depend on the cull.
//
// The device code (intersections, BSDFs, textures, one bounce) is path.cuh
// and bsdf.cuh, shared with K2; its numerics follow the plain torch version
// operation by operation.  Metal and glass switch on the category at run
// time like the rest; the microfacet code computes only the branch a sample
// takes (iso or anisotropic, specular or rough, the lobe), where the TPU
// kernel evaluates both and selects.
//
// Early exit (K1-ee, `render_block_pallas(early_exit=True)`) needs no other
// build: the TPU kernel skips a bounce when every lane of its (8, 256) tile
// is dead, and a thread here leaves its bounce loop when its own path misses
// or dies, which skips at least as much and changes no value.

#include "render_block.cuh"

// The most cull clusters a launch takes: their bound boxes fill the 48 KB of
// shared memory a block gets without opting in.
constexpr int MAX_CLUSTERS = 48 * 1024 / (6 * (int)sizeof(float));

extern "C" int sail_max_clusters() { return MAX_CLUSTERS; }

// Plain C entry point (bound with ctypes); `table` is the device int32 scene
// table (make_scene).  `all_shapes` != 0: the scene holds a shape other than
// a sphere, a rectangle and a Cornell box; `materials` != 0: a material other
// than matte and mirror or a texture other than a uniform color.
// `n_clusters` > 0 turns the cull
// on: the kernel then builds that many cluster bound boxes in shared memory.
// Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t.
extern "C" int sail_render_block(const float* params, const int* table, int n_obj, int n_plain,
                                 int n_groups, int n_mat, int n_tex, int n_light, int cam,
                                 int all_shapes, int materials, int n_clusters, float* out_x,
                                 float* out_y,
                                 float* out_z, int height, int width, int spp, int seed, int sample0,
                                 int max_bounces, int row0, int image_height, void* stream) {
  if (n_clusters < 0 || n_clusters > MAX_CLUSTERS) return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  dim3 block(16, 16);
  dim3 grid((width + 15) / 16, (height + 15) / 16);
  size_t smem = (size_t)n_clusters * 6 * sizeof(float);
  using Kernel = decltype(&render_block_kernel<true, true, true>);
  const Kernel kernels[8] = {
      render_block_kernel<false, false, false>, render_block_kernel<false, false, true>,
      render_block_kernel<false, true, false>,  render_block_kernel<false, true, true>,
      render_block_kernel<true, false, false>,  render_block_kernel<true, false, true>,
      render_block_kernel<true, true, false>,   render_block_kernel<true, true, true>};
  Kernel kernel = kernels[(all_shapes ? 4 : 0) + (n_clusters > 0 ? 2 : 0) + (materials ? 1 : 0)];
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      s, n_clusters, out_x, out_y, out_z, height, width, spp, (uint32_t)seed, (uint32_t)sample0,
      max_bounces, row0, image_height);
  return (int)cudaGetLastError();
}
