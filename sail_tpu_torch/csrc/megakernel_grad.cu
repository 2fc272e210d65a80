// Backward path-tracing megakernel (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `render_grad_block_pallas`
// (sail_tpu/ops/pallas/megakernel.py:262, pl.pallas_call at :476): dL/dparams
// for L = sum over pixels of g . image_sum, where image_sum is K1's spp-SUM
// of radiance over an H x W block and g three float32 planes.  The result is
// the flat gradient in the parameter vector's (jax.tree.leaves) order.
//
// What bounds it on this card: FP32 issue and divergence, like K1, over a
// large body of code.  Per bounce K2 runs K1's forward bounce, replays it and
// runs its hand-written adjoint; the kernel is 9,600-16,800 instructions
// (~55,000 with metal, glass and the uv textures), several times an SM's
// instruction cache.  Registers (214-255 a thread) hold it to one block of 8
// warps per SM, two with spills where the launch bound asks for them.
//
// What the design does about it (adjoint.cuh `sample_grad`):
// - Replay, not re-trace.  The forward sweep records each bounce's input
//   state and its two discrete decisions, the closest hit's winner and the
//   shadow ray's bit (8 bytes); the reverse sweep replays the bounce from
//   them (path.cuh `bounce` with REPLAY), so the closest-hit fold and the
//   shadow scan, whose results carry no cotangent, run once per bounce.
//   Every other value is the same code in the same order, so the gradient is
//   the re-trace's bit for bit.
// - Lock step.  Both sweeps step their bounces together across the block, a
//   barrier before each bounce: the warps of an SM then run the same phase of
//   the same bounce and share the instruction cache.  Left to drift apart
//   over a pixel's samples they took three times as long (configs 2 and 3 at
//   1024² x 64 spp, an H100).
// - The gradient in shared memory.  Up to SHARED_MAX_PARAMS (220) parameters
//   each thread keeps its gradient in its column of a (n_params, 256) array
//   in dynamic shared memory, Gs[p * 256 + thread]: a warp's 32 lanes add to
//   32 banks whatever parameter each adds to, each slot has one owner (no
//   atomics), and the frame keeps only the stored states and decisions
//   (416 bytes).  Configs 1-3, the quadrics, the open twin and up to 13
//   spheres take it.  Larger scenes (the check scene, 16 spheres and more)
//   keep a local array of the smallest of CAPS (352, 1,024, 4,096 floats)
//   that holds them, with replay and lock step.  grad_build.h holds the
//   shared build's limits and the choice of the launch bound; the wrapper
//   picks CAP.
// - Builds per scene kind.  Each build is made with and without path.cuh's
//   MATS (metal, glass and the uv textures), so scenes of matte, mirror and
//   uniform colors keep the smaller adjoint; configs 1-2's kind (also no
//   shape beyond spheres, rectangles and a Cornell box: path.cuh's ALL
//   false) up to TWO_BLOCK_MAX_PARAMS (109) has a shared build of its own,
//   without the six other shapes' code (9,600 instructions against 16,800)
//   and at two blocks per SM.  Every shape has its adjoint; K2 folds
//   without the cull, which changes no value.  A scene with a light other
//   than AREA over a RECTANGLE (config 4: a point and a spot light; an area
//   light over any other shape) takes a LIGHTS build (path.cuh
//   light_sample_other, adjoint.cuh light_adj), made for every build but
//   configs 1-2's, with and without MATS: the shared and the 352-float
//   builds here, the 1,024- and 4,096-float ones in
//   megakernel_grad_lights.cu, a library of its own that compiles beside
//   this one; no other build holds that code, so the builds configs 1-3
//   take are what they were.
//
// The TPU kernel carries one (1, n) sum across its sequential grid; Hopper's
// blocks run in parallel and in no order, so the sum is two passes with a
// fixed order and no float atomics: each block reduces its threads (warp
// shuffles in a fixed tree, then warps in order through shared memory) into
// one row of a (n_blocks, n_params) buffer, and a second kernel sums the rows
// (per parameter 256 partials over rows in order, then a fixed tree; its
// clusters read whole sectors: reduce_grad_rows_kernel).  Repeated calls give bit-identical
// gradients, the same bits whichever build runs a scene.  A path that misses
// or dies leaves its sweep, as in K1: the masked JAX adjoint gives such lanes
// exactly zero cotangent.

#include <cooperative_groups.h>

#include "render_grad.cuh"

namespace cg = cooperative_groups;

namespace {

// The local gradient arrays K2 is built for: a scene above SHARED_MAX_PARAMS
// takes the smallest that holds its parameters.  352 holds every scene of a
// few objects; 4,096 the 256-sphere scene (13 N + 47 = 3,375 parameters).
constexpr int CAPS[] = {352, 1024, 4096};
constexpr int N_CAPS = sizeof(CAPS) / sizeof(CAPS[0]);
// The builds with the lights beyond AREA over a RECTANGLE (LIGHTS): the
// shared one and CAPS[0] here, CAPS[1] and CAPS[2] in
// megakernel_grad_lights.cu (its entry sail_render_grad_lights), so up to
// the largest cap.
constexpr int LIGHTS_MAX_CAP = CAPS[N_CAPS - 1];

// out[p] = sum over r of rows[r][p], in a fixed order: for each parameter,
// 256 partials, partial t the rows t, t + 256, ... added in row order to 0,
// then a halving tree over t (t += t + h for h = 128 ... 1).  A cluster of
// g blocks takes RED_TILE (8) consecutive parameters: block rank c holds the
// partials t = c (mod g), each thread PPT of them in registers with
// 16 / PPT rows of each loaded before they are added, and a warp's load
// reads 8 consecutive parameters of 4 rows (four 32-byte sectors where
// n_params is a multiple of 8).  The tree's levels h >= g pair partials of
// the same block (shared memory); each block then writes its 8 results into
// rank 0's shared memory, and after one cluster barrier rank 0 runs the
// last log2(g) levels.  reduce_cluster picks g: the smallest power of two up
// to RED_MAX_CLUSTER at which there is a block for every two SMs (on an
// H100: config 2's 72 parameters, 9 clusters of 8; 879 and 3,375 parameters,
// blocks of one).  Covering every SM (clusters of 16) and a second cluster
// barrier each measured slower.
constexpr int RED_PARTIALS = 256, RED_TILE = 8, RED_MAX_CLUSTER = 8, RED_LOADS = 16;

// The blocks of a reduce cluster for n_params parameters on n_sm SMs.
inline int reduce_cluster(int n_params, int n_sm) {
  const int tiles = (n_params + RED_TILE - 1) / RED_TILE;
  int g = 1;
  while (g < RED_MAX_CLUSTER && 2 * tiles * g < n_sm) g *= 2;
  return g;
}

// The partials a thread keeps in a cluster of g blocks: 4 / g, at least 1.
inline int reduce_per_thread(int g) { return g >= 4 ? 1 : 4 / g; }

template <int PPT>
__global__ void __launch_bounds__(RED_PARTIALS * RED_TILE / 4)
    reduce_grad_rows_kernel(const float* __restrict__ rows, int n_rows, int n_params, int g,
                            float* __restrict__ out) {
  constexpr int UNROLL = RED_LOADS / PPT;
  __shared__ float buf[RED_PARTIALS * RED_TILE];  // [partial of this block][parameter]
  __shared__ float gathered[RED_MAX_CLUSTER * RED_TILE];  // rank 0: each block's result
  const int tid = threadIdx.x, pl = tid % RED_TILE, q = tid / RED_TILE;
  const int nq = blockDim.x / RED_TILE;   // = RED_PARTIALS / g / PPT
  const int c = blockIdx.x % g;           // rank in the cluster (clusters along x)
  const int p = blockIdx.x / g * RED_TILE + pl;
  const bool live = p < n_params;
  float acc[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) acc[j] = 0.f;
  // adding +0 past the last row changes no partial: from 0, one is never -0
  const int n_k = (n_rows + RED_PARTIALS - 1) / RED_PARTIALS;
  for (int k0 = 0; k0 < n_k; k0 += UNROLL) {
    float x[UNROLL][PPT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int r = c + g * (q + nq * j) + RED_PARTIALS * (k0 + u);
        x[u][j] = live && r < n_rows ? __ldg(rows + (size_t)r * (size_t)n_params + p) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < PPT; ++j) acc[j] += x[u][j];
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) buf[(q + nq * j) * RED_TILE + pl] = acc[j];
  __syncthreads();
  // levels h = 128 ... g: partial i of this block is t = c + g i
  for (int h = RED_PARTIALS / g / 2; h > 0; h >>= 1) {
    for (int e = tid; e < h * RED_TILE; e += blockDim.x) buf[e] += buf[e + h * RED_TILE];
    __syncthreads();
  }
  if (g == 1) {
    if (tid < RED_TILE && live) out[p] = buf[tid];
    return;
  }
  // levels h = g / 2 ... 1 over the blocks' t = c partials, on rank 0
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < RED_TILE) cluster.map_shared_rank(gathered, 0)[c * RED_TILE + tid] = buf[tid];
  cluster.sync();
  if (c == 0 && tid < RED_TILE) {
    float v[RED_MAX_CLUSTER];
#pragma unroll
    for (int b = 0; b < RED_MAX_CLUSTER; ++b) v[b] = b < g ? gathered[b * RED_TILE + tid] : 0.f;
#pragma unroll
    for (int h = RED_MAX_CLUSTER / 2; h > 0; h >>= 1)
#pragma unroll
      for (int b = 0; b < h; ++b)
        if (h < g) v[b] += v[b + h];
    if (live) out[p] = v[0];
  }
}

template <int PPT>
int launch_reduce(const float* rows, int n_rows, int n_params, int g, float* out,
                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n_params + RED_TILE - 1) / RED_TILE * g));
  cfg.blockDim = dim3((unsigned)(RED_PARTIALS * RED_TILE / (g * PPT)));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, reduce_grad_rows_kernel<PPT>, rows, n_rows, n_params, g, out);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// K2's compile-time bounds: block columns, block rows, most bounces, the
// number of local gradient-array sizes, the sizes, the most parameters the
// shared build takes, then the largest local build with LIGHTS.  The wrapper
// raises above them.
extern "C" int sail_grad_limits(int* out) {
  out[0] = BLOCK_X;
  out[1] = BLOCK_Y;
  out[2] = MAX_GRAD_BOUNCES;
  out[3] = N_CAPS;
  for (int i = 0; i < N_CAPS; ++i) out[4 + i] = CAPS[i];
  out[4 + N_CAPS] = SHARED_MAX_PARAMS;
  out[5 + N_CAPS] = LIGHTS_MAX_CAP;
  return 0;
}

// The blocks per SM of the build sail_render_grad_block launches for these
// arguments (grad_build.h), for labels and tests.
extern "C" int sail_grad_min_blocks(int n_params, int cap, int all_shapes, int materials) {
  return grad_min_blocks(cap, n_params, all_shapes != 0, materials != 0);
}

// Plain C entry points (bound with ctypes); `table` is the device int32 scene
// table (path.cuh make_scene).  `rows` holds ceil(W/16) * ceil(H/16) rows of
// n_params floats, one per thread block in launch order; `cap` is the build
// the wrapper picked: SHARED_GRAD (0, n_params up to SHARED_MAX_PARAMS) or
// one of CAPS, at least n_params; `all_shapes` and `materials` as in
// sail_render_block; `lights`: a light other than AREA over a RECTANGLE
// (with all_shapes), built here for SHARED_GRAD and CAPS[0]; a larger cap
// with `lights` returns cudaErrorInvalidValue (sail_render_grad_lights takes
// it).  The launch bound follows from them (grad_min_blocks).
// Each launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t.
extern "C" int sail_render_grad_block(const float* params, const int* table, int n_obj,
                                      int n_plain, int n_groups, int n_mat, int n_tex,
                                      int n_light, int cam, int n_params, int cap, int all_shapes,
                                      int materials, int lights, const float* gx, const float* gy,
                                      const float* gz, float* rows, int height, int width,
                                      int spp, int seed, int sample0, int max_bounces, int row0,
                                      int image_height, void* stream) {
  if (n_params > (cap == SHARED_GRAD ? SHARED_MAX_PARAMS : cap) ||
      max_bounces > MAX_GRAD_BOUNCES || (lights && (!all_shapes || cap > LIGHTS_MAX_CAP)))
    return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
#define SAIL_LAUNCH(C, A, M, B, ...)                                                           \
  launch_grad<C, A, M, 0, B, ##__VA_ARGS__>(s, n_params, gx, gy, gz, rows, height, width, spp, \
                                            (uint32_t)seed, (uint32_t)sample0, max_bounces,  \
                                            row0, image_height, (cudaStream_t)stream)
  if (lights) {
    if (cap == SHARED_GRAD)
      return materials ? SAIL_LAUNCH(SHARED_GRAD, true, true, 1, true)
                       : SAIL_LAUNCH(SHARED_GRAD, true, false, 1, true);
    if (cap == CAPS[0])
      return materials ? SAIL_LAUNCH(CAPS[0], true, true, 1, true)
                       : SAIL_LAUNCH(CAPS[0], true, false, 1, true);
    return (int)cudaErrorInvalidValue;
  }
  if (grad_min_blocks(cap, n_params, all_shapes != 0, materials != 0) == 2)
    return SAIL_LAUNCH(SHARED_GRAD, false, false, 2);
  switch (cap) {
    case SHARED_GRAD:
      return materials ? SAIL_LAUNCH(SHARED_GRAD, true, true, 1)
                       : SAIL_LAUNCH(SHARED_GRAD, true, false, 1);
    case CAPS[0]:
      return materials ? SAIL_LAUNCH(CAPS[0], true, true, 1) : SAIL_LAUNCH(CAPS[0], true, false, 1);
    case CAPS[1]:
      return materials ? SAIL_LAUNCH(CAPS[1], true, true, 1) : SAIL_LAUNCH(CAPS[1], true, false, 1);
    case CAPS[2]:
      return materials ? SAIL_LAUNCH(CAPS[2], true, true, 1) : SAIL_LAUNCH(CAPS[2], true, false, 1);
  }
#undef SAIL_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The rows' sum (reduce_grad_rows_kernel): one launch of ceil(n_params / 8)
// clusters of reduce_cluster(...) blocks on `stream`; returns its
// cudaError_t.
extern "C" int sail_reduce_grad_rows(const float* rows, int n_rows, int n_params, float* out,
                                     void* stream) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int g = reduce_cluster(n_params, n_sm);
  switch (reduce_per_thread(g)) {
    case 1: return launch_reduce<1>(rows, n_rows, n_params, g, out, (cudaStream_t)stream);
    case 2: return launch_reduce<2>(rows, n_rows, n_params, g, out, (cudaStream_t)stream);
    default: return launch_reduce<4>(rows, n_rows, n_params, g, out, (cudaStream_t)stream);
  }
}
