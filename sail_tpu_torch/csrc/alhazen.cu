// KA: the detached Alhazen solve of the sphere-mirror silhouette term (the
// centre and every azimuth's radial root) as one kernel, on NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package solves it with XLA inside the
// jitted train step (`sail_tpu/diff/boundary.py` `_mirror_sphere_silhouette_fn`,
// `sail_tpu/parallel/render_sharded.py:257`), where the scans and halvings
// fuse; the port's plain version (`ops/cuda/alhazen.py` `solve_plain`) runs
// them as eager torch ops on a scalar or a few hundred azimuths, ~6,400 of
// them a (mirror sphere, sphere) pair, each a kernel of microseconds inside
// the edge terms' CUDA graph.  The solve is detached (its gradient comes from
// one live Newton step from its roots, in torch), so KA has no adjoint.
//
// What bounds it: latency.  Each thread evaluates the curve ~80 times in a
// dependent chain (48 scan samples at most, 30 halvings, two slopes), each
// ~70 FP32 operations and a cosf/sinf pair; the centre another ~100 times in
// the first warp before the azimuths start.  A few hundred azimuths fill two
// blocks: the card's throughput is not the limit, the chain's length is.
//
// Design: one thread block a group of KA_THREADS azimuths.  Each block's
// first warp solves the centre, a scalar, for itself: the 64 scan samples in
// two passes of its lanes, a ballot for the first sign change, then lane 0's
// 30 halvings; the centre reaches the block's threads through shared memory
// behind one __syncthreads, so no grid-wide sync or second launch is needed.
// Then each thread solves one azimuth in registers.  Built -fmad=false and
// following the plain version's float32 operations in order, so the sign
// decisions and the roots agree with it to rounding (bit for bit where the
// transcendentals agree).  Launches on the given stream and does not
// synchronise: it runs inside the edge terms' CUDA graph.

#include "alhazen.cuh"

namespace {

constexpr int KA_THREADS = 128;

__global__ void __launch_bounds__(KA_THREADS)
    alhazen_kernel(const float* __restrict__ frame, const float* __restrict__ table,
                   const float* __restrict__ cphi, const float* __restrict__ sphi, int n,
                   float* __restrict__ out, unsigned char* __restrict__ mask) {
  __shared__ float hs[KA_NS];
  __shared__ KACenter center;
  __shared__ bool found_c;
  const KAFrame f = ka_frame(frame);
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    const float span = ka_psi_span(f);
    hs[l] = ka_h(f, ka_psi(table, l, span));
    hs[l + 32] = ka_h(f, ka_psi(table, l + 32, span));
    __syncwarp();
    const unsigned lo_bits = __ballot_sync(~0u, hs[l] * hs[l + 1] <= 0.f);
    const unsigned hi_bits = __ballot_sync(~0u, l < 31 && hs[l + 32] * hs[l + 33] <= 0.f);
    if (l == 0) {
      const int idx = lo_bits ? __ffs(lo_bits) - 1 : (hi_bits ? 31 + __ffs(hi_bits) : 0);
      center = ka_center(f, ka_psi(table, idx, span), ka_psi(table, idx + 1, span));
      found_c = (lo_bits | hi_bits) != 0u;
    }
  }
  __syncthreads();
  const int j = blockIdx.x * KA_THREADS + threadIdx.x;
  if (j == 0) {
    out[0] = center.psi0;
    out[1] = center.dh;
  }
  if (j < n) {
    bool m;
    ka_radial(f, center, found_c, table + KA_NS, __ldg(cphi + j), __ldg(sphi + j), out[2 + j],
              out[2 + n + j], m);
    mask[j] = m;
  }
}

}  // namespace

extern "C" int sail_alhazen_limits(int* out) {
  out[0] = KA_FRAME;
  out[1] = KA_NS;
  out[2] = KA_NB;
  out[3] = KA_THREADS;
  return 0;
}

// Plain C entry point (bound with ctypes), device pointers: `frame`
// (KA_FRAME floats), `table` (the KA_NS centre-scan fractions, then the KA_NB
// radial ones), `cphi`, `sphi` (n each); `out` (2 + 2 n): ψ0, h'(ψ0), β0 (n),
// g'(β0) (n); `mask` (n bytes, 0 or 1).  Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t.
extern "C" int sail_alhazen(const float* frame, const float* table, const float* cphi,
                            const float* sphi, int n, float* out, unsigned char* mask,
                            void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + KA_THREADS - 1) / KA_THREADS;
  alhazen_kernel<<<blocks, KA_THREADS, 0, (cudaStream_t)stream>>>(frame, table, cphi, sphi, n,
                                                                  out, mask);
  return (int)cudaGetLastError();
}
