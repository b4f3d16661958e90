// Shared helpers for the port's kernels: a plain C interface (pointers and the
// stream as void*), each entry returning cudaGetLastError() after its launch.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

#define MOCOPCI_API extern "C" __attribute__((visibility("default")))

// Inside an entry point that launches several kernels: return the first
// launch error instead of launching on.
#define MOCOPCI_CHECK_LAUNCH()                  \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

namespace mocopci {

// out[e] = sum_b partial[b][e] over nblk block partials, in block order: the
// fixed-order second pass of every cross-block reduction (deterministic).
static __global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int nblk, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += partial[static_cast<size_t>(b) * E + e];
  out[e] = acc;
}

static inline cudaError_t reduce_partials(const float* partial, float* out, int nblk, int E,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<(E + 255) / 256, 256, 0, stream>>>(partial, out, nblk, E);
  return cudaGetLastError();
}

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.1f * x; }
__device__ __forceinline__ float dleaky(float x) { return x >= 0.f ? 1.f : 0.1f; }

// (value, index) pair ordering used by every lexicographic reduction:
// smaller value first, then smaller index.
__device__ __forceinline__ bool lex_less(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// Asynchronous copies global -> shared of 4 or 16 bytes (cp.async), their
// group commit and the wait for every group of this thread.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// The same with a zero fill: where ok is false nothing is read and the
// destination's bytes become zeros.
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4z(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// every group but the newest has landed (for this thread's copies)
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mocopci
