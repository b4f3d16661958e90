// The k smallest of each candidate row, in ascending order:
//   out[r, i] = idxs[r, p_i], p_0 < ... the positions of the row's values in
//   ascending (value, position) order; ties go to the lowest position.
// With no idxs (a null pointer) out[r, i] = p_i.  Values must not be NaN.
//
// Replaces mocopci_tpu/ops/pallas/select_k.py: select_min_k_pallas (:54,
// pallas_call :73), whose k rounds each take the row minimum, the lowest
// position holding it, and mask that entry to +inf.
//
// Bound on the H100: bytes (the row's values read once, k indices gathered,
// k written).  Design: T threads own a row (a warp for rows up to 1024, a
// block of 256 above), thread t the positions t, t + T, ..., held in V
// registers.  Each thread keeps the least (value, position) of its own
// positions that is still unpicked.  A round reduces those T pairs (warp
// shuffles, then shared memory across warps), which gives the next pick, and
// only the thread that owned it rescans its registers for the least pair
// after the pick.  Nothing is masked or written back: the picks come in
// strictly increasing lexicographic order, so "unpicked" is "after the last
// pick".  The picks go out as positions, turned into indices after the last
// round.  Rows over 16384 rescan from memory instead (V = 0): a first version
// did that at every width and gathered each pick's index inside its round;
// it spent its time waiting on L2 and on those loads.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MAX;      // no position left

__device__ __forceinline__ bool after(float v, int p, float tv, int tp) {
  return v > tv || (v == tv && p > tp);
}

__device__ __forceinline__ void take_if_less(float x, int p, float& bv, int& bp) {
  if (mocopci::lex_less(x, p, bv, bp)) {
    bv = x;
    bp = p;
  }
}

// The least (value, position) among this thread's positions after (tv, tp);
// every position counts when first is set.  reg holds the V values of
// positions t + j*T (V > 0), else they are read from v.
template <int T, int V>
__device__ __forceinline__ void least_after(const float* __restrict__ v, const float* reg, int L,
                                            int t, bool first, float tv, int tp, float& bv,
                                            int& bp) {
  bv = __int_as_float(0x7f800000);
  bp = kNone;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int p = t + j * T;
      if (p < L && (first || after(reg[j], p, tv, tp))) take_if_less(reg[j], p, bv, bp);
    }
  } else {
    for (int p = t; p < L; p += T) {
      const float x = __ldg(v + p);
      if (first || after(x, p, tv, tp)) take_if_less(x, p, bv, bp);
    }
  }
}

__device__ __forceinline__ void warp_least(float& v, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int op = __shfl_xor_sync(kFull, p, off);
    take_if_less(ov, op, v, p);
  }
}

// T = 32: a warp per row, kWarps rows per block; T = kThreads: a block per row.
template <int T, int V>
__global__ void __launch_bounds__(kThreads) select_min_k_kernel(
    const float* __restrict__ vals, const int* __restrict__ idxs, int* __restrict__ out, int R,
    int L, int k) {
  __shared__ float s_v[kWarps];
  __shared__ int s_p[kWarps];
  const int t = threadIdx.x % T;
  const int r = blockIdx.x * (kThreads / T) + threadIdx.x / T;
  if (T == 32 && r >= R) return;      // whole warps leave; no block barrier below
  const float* v = vals + static_cast<size_t>(r) * L;
  float reg[V > 0 ? V : 1];
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int p = t + j * T;
      reg[j] = p < L ? __ldg(v + p) : 0.f;
    }
  }
  float bv;
  int bp;
  least_after<T, V>(v, reg, L, t, true, 0.f, 0, bv, bp);
  for (int i = 0; i < k; ++i) {
    float mv = bv;
    int mp = bp;
    warp_least(mv, mp);
    if constexpr (T > 32) {
      const int warp = threadIdx.x / 32;
      if ((threadIdx.x & 31) == 0) {
        s_v[warp] = mv;
        s_p[warp] = mp;
      }
      __syncthreads();
      mv = s_v[0];
      mp = s_p[0];
      for (int w = 1; w < kWarps; ++w) take_if_less(s_v[w], s_p[w], mv, mp);
      __syncthreads();              // every thread has read s_v / s_p
    }
    if (t == 0) out[static_cast<size_t>(r) * k + i] = mp < L ? mp : 0;
    if (mp != kNone && mp % T == t) least_after<T, V>(v, reg, L, t, false, mv, mp, bv, bp);
  }
  if (idxs == nullptr) return;
  // the picked positions -> their indices, all at once: a gather inside the
  // rounds would stall each round on its load
  if constexpr (T > 32) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  int* o = out + static_cast<size_t>(r) * k;
  for (int i = t; i < k; i += T) o[i] = __ldg(idxs + static_cast<size_t>(r) * L + o[i]);
}

template <int T, int V>
void launch(const float* vals, const int* idxs, int* out, int R, int L, int k,
            cudaStream_t st) {
  select_min_k_kernel<T, V><<<mocopci::ceil_div(R, kThreads / T), kThreads, 0, st>>>(
      vals, idxs, out, R, L, k);
}

}  // namespace

// vals (R, L) f32, idxs (R, L) int32 or null -> out (R, k) int32; 1 <= k <= L.
MOCOPCI_API int mocopci_select_min_k(const float* vals, const int* idxs, int* out, int R, int L,
                                     int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 32 * 4) launch<32, 4>(vals, idxs, out, R, L, k, st);
  else if (L <= 32 * 8) launch<32, 8>(vals, idxs, out, R, L, k, st);
  else if (L <= 32 * 16) launch<32, 16>(vals, idxs, out, R, L, k, st);
  else if (L <= 32 * 32) launch<32, 32>(vals, idxs, out, R, L, k, st);
  else if (L <= kThreads * 8) launch<kThreads, 8>(vals, idxs, out, R, L, k, st);
  else if (L <= kThreads * 16) launch<kThreads, 16>(vals, idxs, out, R, L, k, st);
  else if (L <= kThreads * 32) launch<kThreads, 32>(vals, idxs, out, R, L, k, st);
  else if (L <= kThreads * 64) launch<kThreads, 64>(vals, idxs, out, R, L, k, st);
  else launch<kThreads, 0>(vals, idxs, out, R, L, k, st);
  return cudaGetLastError();
}
