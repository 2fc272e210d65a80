// KR: the radiance of a flat batch of given rays, on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package traces the edge terms' straddle
// rays with its XLA integrator (`sail_tpu/render/integrator.py:155`
// `trace_rays`) inside the jitted train step
// (`sail_tpu/parallel/render_sharded.py:257`); the port's plain version is
// `render/integrator.trace_rays` with a per-ray PixelNoise, eager torch, one
// launch per operation per bounce.  This is that function as one launch: for
// ray i, from (ro[i], rd[i]), max_bounces bounces of the closest-hit fold,
// the surface, the BSDF sample and next-event estimation with its shadow ray,
// every number drawn from the streams stream_id(seed, sample[i], bounce,
// TAG) at pixel (ii[i], jj[i]), as K1 draws a pixel's; out: the radiance,
// three float32 planes.
//
// What bounds it: as K1, FP32 and SFU work and divergence, no data reuse;
// the bytes are 44 a ray (six floats and three ints in, three floats out).
// Config 5's step hands it 4,608 rays of 4 bounces: 18 blocks of 256
// threads on 132 SMs, so one launch is all it takes and latency, not
// throughput, sets its time.
//
// Design: one thread a ray, K1's own loop (render_block.cuh `trace_loop`,
// which K1's `render_pixel` runs from its camera rays) from the given ray:
// one sample, regeneration off (nothing to regenerate), lock step, the
// shadow ray tested with the next ray in one pass, rectangle frames staged
// per block.  So KR adds the same terms in the same order as K1 and its
// plain version, bit for bit (-fmad=false).  Built for one scene kind, ALL
// and MATS (every shape, light, material and texture), without the cull:
// the batches are small, and one build keeps nvcc's time small.

#include "render_block.cuh"

namespace {

__global__ void __launch_bounds__(256, 3)
    trace_rays_kernel(Scene s, int n_frames, const float* __restrict__ ro_x,
                      const float* __restrict__ ro_y, const float* __restrict__ ro_z,
                      const float* __restrict__ rd_x, const float* __restrict__ rd_y,
                      const float* __restrict__ rd_z, const int* __restrict__ sample,
                      const int* __restrict__ ii, const int* __restrict__ jj,
                      float* __restrict__ out_x, float* __restrict__ out_y,
                      float* __restrict__ out_z, int n, uint32_t seed, int max_bounces) {
  extern __shared__ float smem[];
  RectFrame* frames = reinterpret_cast<RectFrame*>(smem);
  stage_frames(s, frames, n_frames, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool inside = i < n;
  V3 ro = {0.f, 0.f, 0.f}, rd = ro;
  uint32_t row = 0, col = 0, smp = 0;
  if (inside) {
    ro = {ro_x[i], ro_y[i], ro_z[i]};
    rd = {rd_x[i], rd_y[i], rd_z[i]};
    row = (uint32_t)ii[i];
    col = (uint32_t)jj[i];
    smp = (uint32_t)sample[i];
  }
  // every thread of the block runs the loop (its barrier), those past n
  // with `inside` false
  V3 e = ray_radiance<true, true>(s, Frames{frames, n_frames}, inside, row, col, smp, seed,
                                  max_bounces, ro, rd);
  if (!inside) return;
  out_x[i] = e.x;
  out_y[i] = e.y;
  out_z[i] = e.z;
}

}  // namespace

constexpr int KR_BLOCK = 256;

// Plain C entry point (bound with ctypes): the scene as sail_render_block
// takes it (params, the int32 table and its section counts, the camera's
// offset, `n_frames` table rows whose rectangle frames a block stages), the
// n rays as nine device arrays, the outputs as three.  Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t.
extern "C" int sail_trace_rays(const float* params, const int* table, int n_obj, int n_plain,
                               int n_groups, int n_mat, int n_tex, int n_light, int cam,
                               int n_frames, const float* ro_x, const float* ro_y,
                               const float* ro_z, const float* rd_x, const float* rd_y,
                               const float* rd_z, const int* sample, const int* ii, const int* jj,
                               float* out_x, float* out_y, float* out_z, int n, int seed,
                               int max_bounces, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  Scene s = make_scene(params, table, n_obj, n_plain, n_groups, n_mat, n_tex, n_light, cam);
  n_frames = staged_frames(0, n_frames);
  trace_rays_kernel<<<(n + KR_BLOCK - 1) / KR_BLOCK, KR_BLOCK, k1_smem_bytes(0, n_frames),
                      (cudaStream_t)stream>>>(s, n_frames, ro_x, ro_y, ro_z, rd_x, rd_y, rd_z,
                                              sample, ii, jj, out_x, out_y, out_z, n,
                                              (uint32_t)seed, max_bounces);
  return (int)cudaGetLastError();
}
