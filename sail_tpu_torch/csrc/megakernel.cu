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
// TPU kernel's (8, 256) tiles and masked lanes are not carried over.  A
// thread keeps its path state in registers and runs its samples' bounces in
// one loop (render_block.cuh `render_pixel`), with three moves for this
// card:
// - lock step: each iteration opens with a block barrier, so the warps of a
//   block run the same phase together and share the instruction cache (the
//   MATS body is ~15,000 instructions), and the loop ends once no thread of
//   the block has a ray left;
// - path regeneration: a path that misses, dies or ends its last bounce
//   starts the next sample's camera ray in the next iteration, so its lane
//   does not wait for its warp to end the sample.  A dead path adds exactly
//   +0 in the masked TPU loop, so leaving it is bit-identical, not the TPU
//   kernel's approximate tile-level early exit;
// - the shadow ray of a light sample is tested in the next iteration's
//   pass over the objects, with the path's next ray (`fold`): every lane
//   runs that pass, and each object's parameters are read once for both
//   rays.  Its contribution is added before the next bounce's, so each
//   thread adds the same terms in the same order and samples in sample
//   order: results are deterministic and K1's plain version's bit for bit.
// What does not change within a launch or along a ray is computed once: each
// rectangle's frame per block, in shared memory (`stage_frames`), and each
// ray's slab reciprocal (`Ray`).  The scene arrives as
// the flat float vector (the JAX package's leaf order) plus an int32 table;
// the kernel switches on category at run time, so one build serves every
// scene made of the ported categories (all nine shapes; every material and
// texture; AREA over RECTANGLE).  The closest-hit fold keeps t only
// per object and computes hit details once for the winner: the design of
// the TPU's batched fold, whose order the table's rows follow (small
// categories in scene order, then each batched group), so a tie picks the
// object JAX picks.  With the cull, each block first builds the groups'
// cluster bound boxes in shared memory; each ray then skips a cluster whose
// box it cannot reach before its best hit (the shadow ray: before the light)
// (the TPU kernel culls per tile, with an `any` over its lanes).  Both are
// exact: a culled cluster cannot change the fold, so the image does not
// depend on the cull.
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
// is dead, and a thread here starts its next sample when its own path misses
// or dies, which skips at least as much and changes no value.

#include "render_block.cuh"

// The most cull clusters a launch takes: their bound boxes fill the 48 KB of
// shared memory a block gets without opting in (the staged frames then take
// none of it, and every rectangle computes its frame per test).
constexpr int MAX_CLUSTERS = K1_SMEM / (6 * (int)sizeof(float));

extern "C" int sail_max_clusters() { return MAX_CLUSTERS; }

// Plain C entry point (bound with ctypes); `table` is the device int32 scene
// table (make_scene).  `all_shapes` != 0: the scene holds a shape other than
// a sphere, a rectangle and a Cornell box; `materials` != 0: a material other
// than matte and mirror or a texture other than a uniform color.
// `n_clusters` > 0 turns the cull
// on: the kernel then builds that many cluster bound boxes in shared memory.
// `n_frames`: the table rows up to the last rectangle, whose frames each
// block stages in shared memory (as many as fit beside the boxes).
// Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t.
extern "C" int sail_render_block(const float* params, const int* table, int n_obj, int n_plain,
                                 int n_groups, int n_mat, int n_tex, int n_light, int cam,
                                 int all_shapes, int materials, int n_clusters, int n_frames,
                                 float* out_x, float* out_y, float* out_z, int height, int width,
                                 int spp, int seed, int sample0, int max_bounces, int row0,
                                 int image_height, void* stream) {
  if (n_clusters < 0 || n_clusters > MAX_CLUSTERS) return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  dim3 block(16, 16);
  dim3 grid((width + 15) / 16, (height + 15) / 16);
  n_frames = staged_frames(n_clusters, n_frames);
  size_t smem = k1_smem_bytes(n_clusters, n_frames);
  using Kernel = decltype(&render_block_kernel<true, true, true>);
  const Kernel kernels[8] = {
      render_block_kernel<false, false, false>, render_block_kernel<false, false, true>,
      render_block_kernel<false, true, false>,  render_block_kernel<false, true, true>,
      render_block_kernel<true, false, false>,  render_block_kernel<true, false, true>,
      render_block_kernel<true, true, false>,   render_block_kernel<true, true, true>};
  Kernel kernel = kernels[(all_shapes ? 4 : 0) + (n_clusters > 0 ? 2 : 0) + (materials ? 1 : 0)];
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      s, n_clusters, n_frames, out_x, out_y, out_z, height, width, spp, (uint32_t)seed,
      (uint32_t)sample0, max_bounces, row0, image_height);
  return (int)cudaGetLastError();
}
