// A host stand-in for <cuda_runtime.h>, so that the kernels' per-thread
// device code (path.cuh, bsdf.cuh, adjoint.cuh, render_block.cuh's
// `render_pixel`) compiles with a C++ compiler for the CPU: the qualifiers
// become plain (inline) C++, __ldg a load, and a block barrier one thread's
// own.  Only k1_host.cpp and k2_host.cpp include it (`-I csrc/host`); the
// kernels build with nvcc and the real header.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#define __device__
#define __host__
#define __forceinline__ inline

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

// One thread is the whole block: the barrier returns its own predicate.
inline int __syncthreads_or(int predicate) { return predicate != 0; }

using std::max;
using std::min;
