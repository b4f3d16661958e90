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
//   k21[m]   = min(0x7F7FFFFF, min over n of key(d(n, m), n))   (pc2 -> pc1)
//
// Bound on the H100: operations (N*M distances, two key minima each; the
// bytes are the clouds and the keys).  The arithmetic is fixed by the bit
// contract: 3 subtractions, a product and 2 FMAs a pair, then the key's mask
// and the two minima, each an add of the index (the masked bits are zero, so
// | is +) and a min in one DPX instruction (__viaddmin_s32): 9 issue slots a
// pair, against the 9 flops of the f32 bound.
// Design: a block holds up to 4096 queries, 8 a thread in registers, and
// walks a span of the reference cloud: chunks of 64 points staged in shared
// memory as float4 (x, y, z, index) by cp.async, double-buffered, each point
// one broadcast load.  A thread keeps its queries' row keys in registers; a
// point's column key is reduced over the thread's queries in registers, over
// the warp by one __reduce_min_sync, and written by a plain store into the
// warp's row of the chunk; the rows are merged across warps once per chunk
// (under the next chunk's sweep), so each block writes one key a point.  The
// number of spans is chosen to fill the card at the call's G
// (kernels/chamfer_pair.py launch_grid).  A key written by a single block is
// a plain store: k21 when one block holds every query (N <= 4096), k12 when
// one span is the whole cloud; otherwise the blocks merge with global
// atomicMin on the int32 keys into outputs the caller fills (k12 with
// 0x7FFFFFFF, k21 with 0x7F7FFFFF): min does not depend on order, so the
// result is deterministic.
// Queries and points past the ends are duplicates of the last one, index
// included, so they change no minimum.
#include "common.cuh"

namespace {

constexpr int kQ = 8;                    // queries a thread
constexpr int kMaxThreads = 512;         // threads a block, at most
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kChunk = 64;               // reference points a chunk
constexpr int kInfKey = 0x7F7FFFFF;      // k21's ceiling (the f32 max's bits)
constexpr unsigned kFull = 0xffffffffu;

// min(a + b, c) in one instruction on sm_90 (DPX)
__device__ __forceinline__ int add_min(int a, int b, int c) { return __viaddmin_s32(a, b, c); }

__global__ void __launch_bounds__(kMaxThreads, 1) chamfer_pair_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2, int N, int M, int nmask,
    int span, int* __restrict__ k12, int* __restrict__ k21) {
  __shared__ __align__(16) float4 ref[2][kChunk];
  __shared__ int colmin[2][kMaxWarps][kChunk];
  const int T = blockDim.x, W = T >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.y;
  const int nchunks = mocopci::ceil_div(M, kChunk);
  const int c0 = blockIdx.z * span, c1 = min(c0 + span, nchunks);
  const float* pb = p2 + static_cast<size_t>(g) * M * 3;

  // Queues chunk c's points into ref[b]: x, y, z by cp.async, the index by a
  // plain store; points past M repeat point M - 1.
  auto stage = [&](int c, int b) {
    for (int e = tid; e < 4 * kChunk; e += T) {
      const int p = e >> 2, k = e & 3;
      const int m = min(c * kChunk + p, M - 1);
      float* dst = reinterpret_cast<float*>(&ref[b][p]) + k;
      if (k < 3)
        mocopci::cp_async4(dst, pb + static_cast<size_t>(m) * 3 + k);
      else
        *dst = __int_as_float(m);
    }
    mocopci::cp_async_commit();
  };
  // The column keys of chunk c, from the warps' rows in colmin[b].
  auto merge = [&](int c, int b) {
    for (int j = tid; j < kChunk; j += T) {
      const int m = c * kChunk + j;
      if (m >= M) break;
      int v = min(colmin[b][0][j], kInfKey);
      for (int w = 1; w < W; ++w) v = min(v, colmin[b][w][j]);
      int* dst = k21 + static_cast<size_t>(g) * M + m;
      if (gridDim.x == 1)
        *dst = v;
      else
        atomicMin(dst, v);
    }
  };
  if (c0 < c1) stage(c0, 0);

  float qx[kQ], qy[kQ], qz[kQ];
  int rmin[kQ], qid[kQ];
  const int n0 = blockIdx.x * T * kQ + tid;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    qid[i] = min(n0 + i * T, N - 1);
    const float* p = p1 + (static_cast<size_t>(g) * N + qid[i]) * 3;
    qx[i] = p[0];
    qy[i] = p[1];
    qz[i] = p[2];
    rmin[i] = INT_MAX;
  }

  for (int c = c0; c < c1; ++c) {
    const int b = (c - c0) & 1;
    mocopci::cp_async_wait0();
    __syncthreads();        // chunk c has landed; every warp is done with chunk c - 1
    if (c + 1 < c1) stage(c + 1, b ^ 1);
    if (c > c0) merge(c - 1, b ^ 1);
    const float4* rp = ref[b];
    int* row = colmin[b][warp];
#pragma unroll 2
    for (int j = 0; j < kChunk; ++j) {
      const float4 r = rp[j];
      const int col = __float_as_int(r.w);
      int cm = INT_MAX;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const float dx = __fsub_rn(qx[i], r.x);
        const float dy = __fsub_rn(qy[i], r.y);
        const float dz = __fsub_rn(qz[i], r.z);
        const float d = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
        const int hi = __float_as_int(d) & nmask;
        rmin[i] = add_min(hi, col, rmin[i]);
        cm = add_min(hi, qid[i], cm);
      }
      cm = __reduce_min_sync(kFull, cm);
      if (lane == 0) row[j] = cm;
    }
  }
  __syncthreads();
  if (c0 < c1) merge(c1 - 1, (c1 - 1 - c0) & 1);
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int n = n0 + i * T;
    if (n < N) {
      int* dst = k12 + static_cast<size_t>(g) * N + n;
      if (gridDim.z == 1)
        *dst = rmin[i];
      else
        atomicMin(dst, rmin[i]);
    }
  }
}

}  // namespace

// pc1 (G, N, 3), pc2 (G, M, 3) f32 -> k12 (G, N), k21 (G, M) int32.  A block
// of `threads` threads (a multiple of 32, at most 512) holds 8 queries a
// thread and walks `span` chunks of 64 reference points; where more than one
// block holds a query (M > 64 span) or a point (N > 8 threads), the caller
// fills that output first: k12 with 0x7FFFFFFF, k21 with 0x7F7FFFFF.
MOCOPCI_API int mocopci_chamfer_pair(const float* p1, const float* p2, int G, int N, int M,
                                     int idx_bits, int threads, int span, int* k12, int* k21,
                                     void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || span < 1 || N < 1 || M < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nmask = ~static_cast<int>((1u << idx_bits) - 1u);
  dim3 grid(mocopci::ceil_div(N, threads * kQ), G,
            mocopci::ceil_div(mocopci::ceil_div(M, kChunk), span));
  chamfer_pair_kernel<<<grid, threads, 0, st>>>(p1, p2, N, M, nmask, span, k12, k21);
  return cudaGetLastError();
}
