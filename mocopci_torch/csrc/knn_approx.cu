// Approximate k-nearest neighbours with packed (distance | index) keys.
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
// bytes are the two clouds and the k indices).  Both forms keep a query's
// bins where one owner updates each (a min is order-free, so the bits do not
// depend on the schedule), and extract with one warp a query: lane l owns
// bins j = l + 32 t (t < tr / 32) in registers, so the fold is lane-local
// (lane l owns columns l, l+32, l+64, l+96 and all 8 slabs of each, bin t =
// u + 4 s), and k rounds of a warp-wide integer min (__reduce_min_sync; keys
// are unique, so exactly one lane owns the minimum) give the output.
//   Euclidean, C <= 8 (knn_approx_xyz_kernel): the reference is staged once
//     per block as coordinate planes in shared memory (the whole cloud when
//     C x round_up(M, tr) floats fit in 96 KB: 8192 points at C = 3), and the
//     block then walks over groups of 16 queries, 2 a warp, so each staged
//     coordinate read serves two queries; the bins live in registers (32 a
//     lane a query).  The grid is about two blocks an SM.  Where 16-query
//     groups would not give every SM two blocks, a warp takes one query (8
//     a group), so a small call spreads wider and extracts with less latency.
//     A larger reference streams through the planes in chunks, one group a
//     block.
//     Per pair: 3 subtractions, 3 products, 2 sums (the leading 0 + x is x
//     exactly), one logic op for the key and one integer min.
//   dot form, C > 8 (knn_approx_dot_kernel): a block of 16 queries, 256
//     threads; the reference streams in stages of 128 rows x 64 channels by
//     cp.async, double-buffered, rows at a stride of 68 floats (no bank
//     conflicts for the float4 reads); a thread sums the dots of 4 queries x
//     2 rows of each stage on FMAs, one chain a pair in channel order (the
//     TPU kernel's float32 sum).  (On mma.sync at 3xTF32 the dot moved
//     near-tied keys across quantisation steps often enough to move the
//     tiny model's approx forward on the card off its CPU run.)  The
//     epilogue folds |q|^2 + |r|^2 or 1 - q.r into the keys and takes the min
//     into the queries' bins in shared memory ([16][tr + 8] ints), each
//     (query, bin) owned by one thread throughout.  The bins are then
//     extracted as above.
#include "knn_planes.cuh"

namespace {

constexpr int kTile = 1024;              // largest tr

using mocopci::cp_async16z;
using mocopci::cp_async4z;
using mocopci::cp_async_commit;
using mocopci::cp_async_wait0;

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

// ---- Euclidean, C <= CC <= 8 (knn_planes.cuh) ----
template <int NT, int CC, int QW>
__global__ void __launch_bounds__(kXThreads, 2) knn_approx_xyz_kernel(
    const float* __restrict__ q, const float* __restrict__ r, int N, int M, int C, int k,
    int tr, int mask, int fold, int chunk, int* __restrict__ out) {
  extern __shared__ float rs[];            // [CC][chunk] coordinate planes
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = (M + chunk - 1) / chunk;
  constexpr int kGroup = kXWarps * QW;     // queries a group
  const int ngroups = (N + kGroup - 1) / kGroup;
  const float* rb = r + static_cast<size_t>(b) * M * C;
  if (nchunks == 1) {
    stage_planes(rb, 0, M, C, chunk, rs);
    __syncthreads();
  }
  // groups blockIdx.x, + gridDim.x, ...: one a block when the reference streams
  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    int n[QW];
    float qv[QW][CC];
    int bins[QW][NT];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      n[qi] = grp * kGroup + warp * QW + qi;
#pragma unroll
      for (int c = 0; c < CC; ++c)
        qv[qi][c] = (n[qi] < N && c < C) ? q[(static_cast<size_t>(b) * N + n[qi]) * C + c] : 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) bins[qi][t] = kInf;
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      const int base = ch * chunk;
      if (nchunks > 1) {
        __syncthreads();
        stage_planes(rb, base, M, C, chunk, rs);
        __syncthreads();
      }
      scan_chunk<NT, CC, QW>(rs, chunk, C, min(chunk, M - base), tr, base, lane, qv,
                             [&](int qi, int t, float d, int col) {
                               bins[qi][t] = min(bins[qi][t], pack(d, mask, col));
                             });
    }
#pragma unroll
    for (int qi = 0; qi < QW; ++qi)
      if (n[qi] < N)
        extract(bins[qi], k, mask, fold, lane, out + (static_cast<size_t>(b) * N + n[qi]) * k);
  }
}

// ---- the dot form, C > 8 ----
constexpr int kDQ = 16;                    // queries a block
constexpr int kDThreads = 256;
constexpr int kDRows = 128;                // reference rows a stage
constexpr int kDKC = 64;                   // channels a stage
constexpr int kDLd = kDKC + 4;             // a staged row's stride (floats)

// a staged query row's stride (floats)
__host__ __device__ inline int dot_ldq(int C) { return (C + 3) / 4 * 4 + 4; }

// Queues the copies of reference rows [r0, r0 + 128), channels [c0, c0 + 64),
// into a [128][kDLd] stage, zero past M and C.
__device__ __forceinline__ void stage_dot(const float* __restrict__ rb, int r0, int M, int C,
                                          int c0, float* dst) {
  if ((C & 3) == 0) {
    for (int e = threadIdx.x; e < kDRows * kDKC / 4; e += kDThreads) {
      const int row = e / (kDKC / 4), c = (e - row * (kDKC / 4)) << 2;
      const bool ok = r0 + row < M && c0 + c < C;
      cp_async16z(dst + row * kDLd + c,
                  rb + (ok ? static_cast<size_t>(r0 + row) * C + c0 + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < kDRows * kDKC; e += kDThreads) {
      const int row = e / kDKC, c = e - row * kDKC;
      const bool ok = r0 + row < M && c0 + c < C;
      cp_async4z(dst + row * kDLd + c,
                 rb + (ok ? static_cast<size_t>(r0 + row) * C + c0 + c : 0), ok);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kDThreads) knn_approx_dot_kernel(
    const float* __restrict__ q, const float* __restrict__ r, const float* __restrict__ rn,
    int N, int M, int C, int k, int metric, int tr, int mask, int fold, int* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int ldb = tr + 8, ldq = dot_ldq(C);
  float* st = sm;                                      // [2][kDRows][kDLd] stages
  float* qs = st + 2 * kDRows * kDLd;                  // [16][ldq] queries
  float* qn = qs + kDQ * ldq;                          // [16] |q|^2
  int* bins = reinterpret_cast<int*>(qn + kDQ);        // [16][ldb]
  const int b = blockIdx.y, n0 = blockIdx.x * kDQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* rb = r + static_cast<size_t>(b) * M * C;
  const float* rnb = rn + static_cast<size_t>(b) * M;
  const int nch = (C + kDKC - 1) / kDKC, ntiles = (M + kDRows - 1) / kDRows;
  const int nstages = nch * ntiles;
  stage_dot(rb, 0, M, C, 0, st);
  cp_async_commit();
  const int cpad = (C + 3) & ~3;
  for (int e = tid; e < kDQ * cpad; e += kDThreads) {
    const int i = e / cpad, c = e - i * cpad;
    qs[i * ldq + c] = n0 + i < N && c < C ? q[(static_cast<size_t>(b) * N + n0 + i) * C + c] : 0.f;
  }
  for (int e = tid; e < kDQ * ldb; e += kDThreads) bins[e] = kInf;
  __syncthreads();
  if (tid < kDQ) {                                     // |q|^2 in channel order
    float s = 0.f;
    if (metric == 0)
      for (int c = 0; c < C; ++c) s = fmaf(qs[tid * ldq + c], qs[tid * ldq + c], s);
    qn[tid] = s;
  }

  // this thread's pairs: queries 4 qg .. 4 qg + 3 (one group a warp pair) x
  // rows rl and rl + 64 of each stage
  const int qg = warp >> 1, rl = tid & 63;
  float acc[4][2];
  for (int s = 0; s < nstages; ++s) {
    const int rt = s / nch, c = s - rt * nch, bf = s & 1;
    cp_async_wait0();
    __syncthreads();        // stage s has landed; every thread is done with stage s - 1
    if (s + 1 < nstages) {
      const int rt1 = (s + 1) / nch, c1 = s + 1 - rt1 * nch;
      stage_dot(rb, rt1 * kDRows, M, C, c1 * kDKC, st + (bf ^ 1) * kDRows * kDLd);
      cp_async_commit();
    }
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
    }
    // each pair's dot in channel order on FMAs, as the TPU kernel's f32 sum
    const float* r0 = st + bf * kDRows * kDLd + rl * kDLd;
    const float* r1 = r0 + 64 * kDLd;
    const float* qa = qs + 4 * qg * ldq + c * kDKC;
    const int nc = min(kDKC, cpad - c * kDKC);
#pragma unroll 4
    for (int cc = 0; cc < nc; cc += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(r0 + cc);
      const float4 x1 = *reinterpret_cast<const float4*>(r1 + cc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 y = *reinterpret_cast<const float4*>(qa + i * ldq + cc);
        acc[i][0] = fmaf(y.x, x0.x, acc[i][0]);
        acc[i][1] = fmaf(y.x, x1.x, acc[i][1]);
        acc[i][0] = fmaf(y.y, x0.y, acc[i][0]);
        acc[i][1] = fmaf(y.y, x1.y, acc[i][1]);
        acc[i][0] = fmaf(y.z, x0.z, acc[i][0]);
        acc[i][1] = fmaf(y.z, x1.z, acc[i][1]);
        acc[i][0] = fmaf(y.w, x0.w, acc[i][0]);
        acc[i][1] = fmaf(y.w, x1.w, acc[i][1]);
      }
    }
    if (c + 1 < nch) continue;
    // the keys into the bins (each (query, bin) owned by this thread throughout)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int col = rt * kDRows + rl + 64 * u;
      if (col < M) {
        const int j = col % tr;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = metric == 0
                              ? __fsub_rn(__fadd_rn(qn[4 * qg + i], rnb[col]), 2.f * acc[i][u])
                              : __fsub_rn(1.f, acc[i][u]);
          int* bp = bins + (4 * qg + i) * ldb + j;
          *bp = min(*bp, pack(d, mask, col));
        }
      }
    }
  }
  __syncthreads();
  const int nt = tr >> 5;
  for (int i = warp; i < kDQ; i += kDThreads / 32) {
    if (n0 + i >= N) break;
    int bv[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) bv[t] = t < nt ? bins[i * ldb + lane + 32 * t] : kInf;
    extract(bv, k, mask, fold, lane, out + (static_cast<size_t>(b) * N + n0 + i) * k);
  }
}

template <int NT, int CC, int QW>
cudaError_t run_xyz(const float* q, const float* r, int B, int N, int M, int C, int k, int tr,
                    int mask, int fold, int chunk, int gx, int* out, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(CC) * chunk * sizeof(float);
  if (chunk < tr || chunk % tr != 0 || smem > kXPlaneBytes) return cudaErrorInvalidValue;
  cudaError_t err = mocopci::allow_smem(knn_approx_xyz_kernel<NT, CC, QW>, smem);
  if (err != cudaSuccess) return err;
  knn_approx_xyz_kernel<NT, CC, QW><<<dim3(gx, B), kXThreads, smem, st>>>(
      q, r, N, M, C, k, tr, mask, fold, chunk, out);
  return cudaGetLastError();
}

template <int NT>
cudaError_t run(const float* q, const float* r, const float* rn, int B, int N, int M, int C,
                int k, int metric, int tr, int mask, int fold, int chunk, int gx, int qw,
                int* out, cudaStream_t st) {
  if (metric == 0 && C <= 8) {
    if (qw == 2)
      return C == 3 ? run_xyz<NT, 3, 2>(q, r, B, N, M, C, k, tr, mask, fold, chunk, gx, out, st)
                    : run_xyz<NT, 8, 2>(q, r, B, N, M, C, k, tr, mask, fold, chunk, gx, out, st);
    return C == 3 ? run_xyz<NT, 3, 1>(q, r, B, N, M, C, k, tr, mask, fold, chunk, gx, out, st)
                  : run_xyz<NT, 8, 1>(q, r, B, N, M, C, k, tr, mask, fold, chunk, gx, out, st);
  }
  const size_t smem = (2 * kDRows * kDLd + kDQ * static_cast<size_t>(dot_ldq(C)) + kDQ) *
                          sizeof(float) + static_cast<size_t>(kDQ) * (tr + 8) * sizeof(int);
  cudaError_t err = mocopci::allow_smem(knn_approx_dot_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  knn_approx_dot_kernel<NT><<<dim3(gx, B), kDThreads, smem, st>>>(
      q, r, rn, N, M, C, k, metric, tr, mask, fold, out);
  return cudaGetLastError();
}

}  // namespace

// query (B, N, C), ref (B, M, C) f32, rn (B, M) = |ref|^2 (read only for
// Euclidean rows wider than 8) -> out (B, N, k) int32.  metric 0 = Euclidean,
// 1 = cosine on normalised rows.  tr = min(1024, round_up(M, 128)),
// idx_bits = bit_length(M - 1), fold as the module note; k <= min(tr, 384);
// C <= 512.  The grid is gx x B blocks: for Euclidean C <= 8, each stages
// chunk reference rows (a multiple of tr, C x chunk floats within 96 KB) and
// walks over groups of 8 qw queries, qw (1 or 2) a warp (gx groups apart;
// one group a block when chunk < M); for the dot form gx = ceil(N / 16), and
// chunk and qw are not read.
MOCOPCI_API int mocopci_knn_approx(const float* q, const float* r, const float* rn, int B,
                                   int N, int M, int C, int k, int metric, int tr,
                                   int idx_bits, int fold, int chunk, int gx, int qw, int* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mask = static_cast<int>((1u << idx_bits) - 1u);
  const int nt = tr / 32;
  if (tr % 128 != 0 || tr > kTile || (fold && nt != 32) || C < 1 || C > 512 || gx < 1 ||
      (qw != 1 && qw != 2))
    return cudaErrorInvalidValue;
  if (nt <= 4)
    return run<4>(q, r, rn, B, N, M, C, k, metric, tr, mask, fold, chunk, gx, qw, out, st);
  if (nt <= 8)
    return run<8>(q, r, rn, B, N, M, C, k, metric, tr, mask, fold, chunk, gx, qw, out, st);
  if (nt <= 16)
    return run<16>(q, r, rn, B, N, M, C, k, metric, tr, mask, fold, chunk, gx, qw, out, st);
  return run<32>(q, r, rn, B, N, M, C, k, metric, tr, mask, fold, chunk, gx, qw, out, st);
}
