// Both directed 1-NN minima of two xyz clouds from one distance sweep.
//
// Replaces mocopci_tpu/ops/pallas/chamfer_pair.py: _pair_keys (:126,
// pallas_call :136), the forward of chamfer_pair (:169).  Semantics, exactly:
//   d(n, m)  = fma(dz, dz, fma(dx, dx, dy * dy)), dx = p1x - p2x etc., the
//              contraction XLA's CPU compiler gives the Pallas kernel body, so
//              keys equal the interpret-mode reference bit for bit;
//   key      = (bits(d) & ~mask) | index, mask = 2^idx_bits - 1,
//              idx_bits = bit_length(max(N, M) - 1); "inf" is 0x7F7FFFFF;
//   k12[n]   = min over m of key(d(n, m), m)   (pc1 -> pc2)
//   k21[m]   = min over n of key(d(n, m), n)   (pc2 -> pc1)
// The caller fills both outputs with 0x7F7FFFFF before the launch.
//
// Bound on the H100: operations (N*M distances, two key minima each; the
// bytes are the clouds and the keys).  Design: a block takes 1024 queries (8
// per thread, in registers) against a slice of 256 reference points staged in
// shared memory and read as broadcasts.  Each thread keeps its queries' row
// minima in registers; per reference point the 8 column keys of a thread are
// reduced in registers, then across the warp by one __reduce_min_sync, then
// across the block's warps by a shared-memory atomicMin.  Blocks merge both
// outputs with global atomicMin on the int32 keys: min does not depend on
// order, so the result is deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 8;                    // queries per thread
constexpr int kQB = kThreads * kQ;       // queries per block
constexpr int kMB = 256;                 // reference points per block
constexpr int kInf = 0x7FFFFFFF;         // masked-out query: no column key
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) chamfer_pair_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2, int N, int M, int mask,
    int* __restrict__ k12, int* __restrict__ k21) {
  __shared__ float rx[kMB], ry[kMB], rz[kMB];
  __shared__ int cmin[kMB];
  const int g = blockIdx.y;
  const int m0 = blockIdx.z * kMB;
  const int mc = min(kMB, M - m0);
  const float* pb = p2 + (static_cast<size_t>(g) * M + m0) * 3;
  for (int e = threadIdx.x; e < mc; e += kThreads) {
    rx[e] = pb[3 * e];
    ry[e] = pb[3 * e + 1];
    rz[e] = pb[3 * e + 2];
    cmin[e] = kInf;
  }
  float qx[kQ], qy[kQ], qz[kQ];
  int rmin[kQ], qid[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int n = blockIdx.x * kQB + i * kThreads + threadIdx.x;
    const bool valid = n < N;
    const float* p = p1 + (static_cast<size_t>(g) * N + (valid ? n : 0)) * 3;
    qx[i] = p[0];
    qy[i] = p[1];
    qz[i] = p[2];
    rmin[i] = kInf;
    // d >= 0, so (bits & ~mask) | kInf == kInf: an invalid query adds no key
    qid[i] = valid ? n : kInf;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < mc; ++j) {
    const float x = rx[j], y = ry[j], z = rz[j];
    const int col = m0 + j;
    int cm = kInf;
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const float dx = __fsub_rn(qx[i], x);
      const float dy = __fsub_rn(qy[i], y);
      const float dz = __fsub_rn(qz[i], z);
      const float d = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
      const int hi = __float_as_int(d) & ~mask;
      rmin[i] = min(rmin[i], hi | col);
      cm = min(cm, hi | qid[i]);
    }
    cm = __reduce_min_sync(kFull, cm);
    if (lane == 0) atomicMin(&cmin[j], cm);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < mc; e += kThreads)
    atomicMin(&k21[static_cast<size_t>(g) * M + m0 + e], cmin[e]);
#pragma unroll
  for (int i = 0; i < kQ; ++i)
    if (qid[i] != kInf) atomicMin(&k12[static_cast<size_t>(g) * N + qid[i]], rmin[i]);
}

}  // namespace

// pc1 (G, N, 3), pc2 (G, M, 3) f32 -> k12 (G, N), k21 (G, M) int32, both
// pre-filled with 0x7F7FFFFF by the caller.
MOCOPCI_API int mocopci_chamfer_pair(const float* p1, const float* p2, int G, int N, int M,
                                     int idx_bits, int* k12, int* k21, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mask = static_cast<int>((1u << idx_bits) - 1u);
  dim3 grid(mocopci::ceil_div(N, kQB), G, mocopci::ceil_div(M, kMB));
  chamfer_pair_kernel<<<grid, kThreads, 0, st>>>(p1, p2, N, M, mask, k12, k21);
  return cudaGetLastError();
}
