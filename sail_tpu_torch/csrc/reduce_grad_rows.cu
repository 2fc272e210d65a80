// K2's second pass for NVIDIA Hopper (sm_90a): the sum of the block partials
// K2's first pass writes (megakernel_grad.cu), in a fixed order.
//
// The TPU kernel carries one (1, n) sum across its sequential grid; Hopper's
// blocks run in parallel and in no order, so K2 writes one row of a
// (n_blocks, n_params) buffer per thread block and this kernel sums the rows
// with no float atomics.  Repeated calls give bit-identical sums.  A library
// of its own, so that KP (penumbra.cu), whose block rows it also sums, and
// K2 load it without any of K2's builds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

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
