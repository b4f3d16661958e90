// Approximate k-nearest neighbours with packed (distance | index) keys, one
// warp per query.
//
// Replaces mocopci_tpu/ops/pallas/knn.py: fused_knn_pallas (:181, pallas_call
// in _fused_knn_call :259), the JAX package's default kNN mode.  Semantics,
// exactly as the Pallas kernel:
//   key(j)  = (bits(d_j) & ~mask) | j, compared as signed int32, where
//             mask = 2^idx_bits - 1 and idx_bits = bit_length(M - 1);
//   bin[j]  = min over reference tiles t of key(t * tr + j), j < tr, with
//             tr = min(1024, round_up(M, 128)); columns past M never enter;
//   fold    (M > tr, k <= 384): each column c mod 128 keeps the 3 least of its
//             tr / 128 bins;
//   output  = the k least of the bins (or of the survivors), ascending,
//             each key & mask.
// Distances: Euclidean with C <= 8 is 0 + sum_c (q_c - r_c)^2 in channel
// order with round-to-nearest intrinsics and no FMA (bit-identical to the
// plain twin and to csrc/knn.cu); otherwise (|q|^2 + |r|^2) - 2 q.r with |r|^2
// from the caller, or 1 - q.r for cosine on normalised rows.  A negative
// cosine distance keeps its bit pattern and so sorts first, as on the TPU.
//
// Bound on the H100: operations (every query scans every reference row; the
// bytes are the two clouds and the k indices).  Design: a block holds 8
// warps, one query each, and stages each reference tile in shared memory as
// coordinate planes read by all 8.  Lane l owns bins j = l + 32 t (t < 32) in
// registers, so the per-column minimum is a register min and the fold is
// lane-local: lane l owns columns l, l+32, l+64, l+96 and all 8 slabs of each
// (bin t = u + 4 s).  Extraction is k rounds of a warp-wide integer min
// (__reduce_min_sync); keys are unique, so exactly one lane owns the minimum.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;                // queries per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;              // largest tr
constexpr int kSub = 64;                 // reference rows per staged sub-tile (wide rows)
constexpr int kInf = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int pack(float d, int mask, int col) {
  return (__float_as_int(d) & ~mask) | col;
}

// The k least bins of the warp, ascending (no fold: every bin is a candidate).
template <int NT>
__device__ __forceinline__ void extract_all(int (&bins)[NT], int k, int mask, int lane, int* o) {
  int cur = kInf;
#pragma unroll
  for (int t = 0; t < NT; ++t) cur = min(cur, bins[t]);
  for (int i = 0; i < k; ++i) {
    const int m = __reduce_min_sync(kFull, cur);
    if (lane == 0) o[i] = m & mask;
    if (cur == m) {            // the one lane holding m
      int nxt = kInf;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (bins[t] == m) bins[t] = kInf;
        nxt = min(nxt, bins[t]);
      }
      cur = nxt;
    }
  }
}

// Fold 8 slabs of 128 columns to each column's 3 least bins, then a
// tournament over the column heads (each column stays sorted).
__device__ __forceinline__ void extract_fold(const int (&bins)[32], int k, int mask, int lane,
                                             int* o) {
  int h[4], s2[4], s3[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    int a = kInf, b = kInf, c = kInf;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int v = bins[u + 4 * s];
      if (v < a) {
        c = b;
        b = a;
        a = v;
      } else if (v < b) {
        c = b;
        b = v;
      } else if (v < c) {
        c = v;
      }
    }
    h[u] = a;
    s2[u] = b;
    s3[u] = c;
  }
  for (int i = 0; i < k; ++i) {
    const int best = min(min(h[0], h[1]), min(h[2], h[3]));
    const int m = __reduce_min_sync(kFull, best);
    if (lane == 0) o[i] = m & mask;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (h[u] == m) {
        h[u] = s2[u];
        s2[u] = s3[u];
        s3[u] = kInf;
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void extract(int (&bins)[NT], int k, int mask, int fold, int lane,
                                        int* o) {
  if constexpr (NT == 32) {
    if (fold) {
      extract_fold(bins, k, mask, lane, o);
      return;
    }
  }
  extract_all(bins, k, mask, lane, o);
}

// Euclidean, C <= CC <= 8: direct squared differences against coordinate
// planes of the reference tile.
template <int NT, int CC>
__global__ void __launch_bounds__(kThreads) knn_approx_xyz_kernel(
    const float* __restrict__ q, const float* __restrict__ r, int N, int M, int C, int k,
    int tr, int mask, int fold, int* __restrict__ out) {
  __shared__ float rs[CC][kTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = n < N;
  float qv[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c)
    qv[c] = (active && c < C) ? q[(static_cast<size_t>(b) * N + n) * C + c] : 0.f;
  const int nt = tr >> 5;
  int bins[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) bins[t] = kInf;
  const float* rb = r + static_cast<size_t>(b) * M * C;
  for (int base = 0; base < M; base += tr) {
    const int cnt = min(tr, M - base);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * C; e += kThreads) {
      const int row = e / C, c = e - row * C;
      rs[c][row] = rb[static_cast<size_t>(base) * C + e];
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = lane + 32 * t;
        if (t < nt && j < cnt) {
          float d = 0.f;
#pragma unroll
          for (int c = 0; c < CC; ++c) {
            if (CC == 3 || c < C) {
              const float diff = __fsub_rn(qv[c], rs[c][j]);
              d = __fadd_rn(d, __fmul_rn(diff, diff));
            }
          }
          bins[t] = min(bins[t], pack(d, mask, base + j));
        }
      }
    }
  }
  if (!active) return;
  extract(bins, k, mask, fold, lane, out + (static_cast<size_t>(b) * N + n) * k);
}

// Wide rows: metric 0 = Euclidean (|q|^2 + |r|^2) - 2 q.r, 1 = cosine 1 - q.r.
// The reference tile is staged kSub rows at a time as channel planes; the
// warp's query row sits in shared memory and is read as a broadcast.
template <int NT>
__global__ void __launch_bounds__(kThreads) knn_approx_dot_kernel(
    const float* __restrict__ q, const float* __restrict__ r, const float* __restrict__ rn,
    int N, int M, int C, int k, int metric, int tr, int mask, int fold, int* __restrict__ out) {
  extern __shared__ float sm[];
  float* rs = sm;                       // [C][kSub]
  const int w = threadIdx.x >> 5;
  float* qs = rs + C * kSub + w * C;    // this warp's query [C]
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + w;
  const bool active = n < N;
  for (int c = lane; c < C; c += 32)
    qs[c] = active ? q[(static_cast<size_t>(b) * N + n) * C + c] : 0.f;
  __syncwarp();
  float qn = 0.f;
  if (metric == 0)
    for (int c = 0; c < C; ++c) qn = fmaf(qs[c], qs[c], qn);
  int bins[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) bins[t] = kInf;
  const float* rb = r + static_cast<size_t>(b) * M * C;
  const float* rnb = rn + static_cast<size_t>(b) * M;
  for (int base = 0; base < M; base += tr) {
    const int cnt = min(tr, M - base);
#pragma unroll
    for (int st = 0; st < NT / 2; ++st) {
      const int s0 = st * kSub;          // first tile column of this sub-tile
      if (s0 < cnt) {                    // uniform over the block
        const int sc = min(kSub, cnt - s0);
        __syncthreads();
        for (int e = threadIdx.x; e < sc * C; e += kThreads) {
          const int row = e / C, c = e - row * C;
          rs[c * kSub + row] = rb[static_cast<size_t>(base + s0) * C + e];
        }
        __syncthreads();
        if (active) {
          float a0 = 0.f, a1 = 0.f;
          for (int c = 0; c < C; ++c) {
            const float qc = qs[c];
            a0 = fmaf(qc, rs[c * kSub + lane], a0);
            a1 = fmaf(qc, rs[c * kSub + lane + 32], a1);
          }
          const float acc[2] = {a0, a1};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = s0 + lane + 32 * u;    // = lane + 32 * (2 st + u)
            if (lane + 32 * u < sc) {
              const float d = metric == 0
                                  ? __fsub_rn(__fadd_rn(qn, rnb[base + j]), 2.f * acc[u])
                                  : __fsub_rn(1.f, acc[u]);
              bins[2 * st + u] = min(bins[2 * st + u], pack(d, mask, base + j));
            }
          }
        }
      }
    }
  }
  if (!active) return;
  extract(bins, k, mask, fold, lane, out + (static_cast<size_t>(b) * N + n) * k);
}

template <int NT>
cudaError_t run(const float* q, const float* r, const float* rn, int B, int N, int M, int C,
                int k, int metric, int tr, int mask, int fold, int* out, cudaStream_t st) {
  dim3 grid(mocopci::ceil_div(N, kWarps), B);
  if (metric == 0 && C <= 8) {
    if (C == 3)
      knn_approx_xyz_kernel<NT, 3><<<grid, kThreads, 0, st>>>(q, r, N, M, C, k, tr, mask,
                                                               fold, out);
    else
      knn_approx_xyz_kernel<NT, 8><<<grid, kThreads, 0, st>>>(q, r, N, M, C, k, tr, mask,
                                                               fold, out);
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(C) * (kSub + kWarps) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(knn_approx_dot_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  knn_approx_dot_kernel<NT><<<grid, kThreads, smem, st>>>(q, r, rn, N, M, C, k, metric, tr,
                                                          mask, fold, out);
  return cudaGetLastError();
}

}  // namespace

// query (B, N, C), ref (B, M, C) f32, rn (B, M) = |ref|^2 (read only for
// Euclidean rows wider than 8) -> out (B, N, k) int32.  metric 0 = Euclidean,
// 1 = cosine on normalised rows.  tr = min(1024, round_up(M, 128)),
// idx_bits = bit_length(M - 1), fold as the module note; k <= min(tr, 384).
MOCOPCI_API int mocopci_knn_approx(const float* q, const float* r, const float* rn, int B,
                                   int N, int M, int C, int k, int metric, int tr,
                                   int idx_bits, int fold, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mask = static_cast<int>((1u << idx_bits) - 1u);
  const int nt = tr / 32;
  if (tr % 128 != 0 || tr > kTile || (fold && nt != 32)) return cudaErrorInvalidValue;
  if (nt <= 4) return run<4>(q, r, rn, B, N, M, C, k, metric, tr, mask, fold, out, st);
  if (nt <= 8) return run<8>(q, r, rn, B, N, M, C, k, metric, tr, mask, fold, out, st);
  if (nt <= 16) return run<16>(q, r, rn, B, N, M, C, k, metric, tr, mask, fold, out, st);
  return run<32>(q, r, rn, B, N, M, C, k, metric, tr, mask, fold, out, st);
}
