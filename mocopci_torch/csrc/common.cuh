// Shared helpers for the port's kernels: a plain C interface (pointers and the
// stream as void*), each entry returning cudaGetLastError() after its launch.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

#define MOCOPCI_API extern "C" __attribute__((visibility("default")))

namespace mocopci {

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.1f * x; }

// (value, index) pair ordering used by every lexicographic reduction:
// smaller value first, then smaller index.
__device__ __forceinline__ bool lex_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mocopci
