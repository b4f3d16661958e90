// Exact k-nearest neighbours, one thread per query.
//
// Replaces mocopci_tpu/ops/pallas/knn.py: exact_knn_pallas (:350, pallas_call
// in _exact_knn_call :424), Euclidean and cosine metric.  Result: the k
// smallest (distance, index) pairs in ascending lexicographic order, i.e. ties
// go to the lowest index, as lax.top_k and the Pallas exact kernel give.
//
// Distances: Euclidean with C <= 8 is the direct sum of squared differences
// (as knn.py:_dist_tile does for xyz), accumulated in channel order with
// round-to-nearest intrinsics and no FMA, bit-identical to the plain twin;
// otherwise the dot form, (-2 q.r + |q|^2) + |r|^2 for Euclidean and
// 1 - q.r for cosine, on rows the caller has already normalised.
//
// Bound on the H100: operations.  Every query scans all M reference rows
// (N*M*C multiply-adds plus one compare each); the bytes are small (the
// reference cloud is re-read from shared memory, not from HBM).  Design:
// reference rows are staged through shared memory in tiles that every thread
// of the block reads as broadcasts; each thread keeps its sorted k-list in
// registers (fully unrolled insertion, KMAX in {4,8,16,32}), and since the
// scan visits indices in ascending order a candidate enters the list only if
// it is strictly closer than the current k-th.  The (N, M) distance matrix is
// never written.
#include "common.cuh"

namespace {

template <int KMAX>
struct TopK {
  float d[KMAX];
  int i[KMAX];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      d[p] = __int_as_float(0x7f800000);  // +inf
      i[p] = INT_MAX;
    }
  }

  // ``ci`` is larger than every index held, so an equal distance loses.
  __device__ __forceinline__ void push(float cd, int ci) {
    if (!(cd < d[KMAX - 1])) return;
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (mocopci::lex_less(cd, ci, d[p], i[p])) {
        const float td = d[p];
        const int ti = i[p];
        d[p] = cd;
        i[p] = ci;
        cd = td;
        ci = ti;
      }
    }
  }
};

constexpr int kXyzThreads = 128;
constexpr int kXyzTile = 1024;

// Euclidean, C <= CC <= 8: direct squared differences, reference tile stored
// as coordinate planes in shared memory.
template <int KMAX, int CC>
__global__ void __launch_bounds__(kXyzThreads) knn_xyz_kernel(
    const float* __restrict__ q, const float* __restrict__ r, int N, int M, int C, int k,
    int* __restrict__ out) {
  __shared__ float rs[CC][kXyzTile];
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float qv[CC];
#pragma unroll
  for (int c = 0; c < CC; ++c)
    qv[c] = (n < N && c < C) ? q[(static_cast<size_t>(b) * N + n) * C + c] : 0.f;
  TopK<KMAX> top;
  top.init();
  const float* rb = r + static_cast<size_t>(b) * M * C;
  for (int base = 0; base < M; base += kXyzTile) {
    const int cnt = min(kXyzTile, M - base);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * C; e += blockDim.x) {
      const int row = e / C, c = e - row * C;
      rs[c][row] = rb[static_cast<size_t>(base) * C + e];
    }
    __syncthreads();
    if (n < N) {
      for (int j = 0; j < cnt; ++j) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          if (CC == 3 || c < C) {
            const float diff = __fsub_rn(qv[c], rs[c][j]);
            d = __fadd_rn(d, __fmul_rn(diff, diff));
          }
        }
        top.push(d, base + j);
      }
    }
  }
  if (n < N) {
    int* o = out + (static_cast<size_t>(b) * N + n) * k;
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p < k) o[p] = top.i[p];  // static index: the list stays in registers
    }
  }
}

constexpr int kDotQ = 64;   // queries (threads) per block
constexpr int kDotR = 32;   // reference rows per tile

// Dot form for wide rows: metric 0 = Euclidean, 1 = cosine (pre-normalised).
template <int KMAX>
__global__ void __launch_bounds__(kDotQ) knn_dot_kernel(
    const float* __restrict__ q, const float* __restrict__ r, int N, int M, int C, int k,
    int metric, int* __restrict__ out) {
  extern __shared__ float sm[];
  float* qs = sm;                  // [C][kDotQ], transposed: conflict-free reads
  float* rs = qs + C * kDotQ;      // [kDotR][C]
  float* rn = rs + kDotR * C;      // [kDotR]
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kDotQ;
  const int n = n0 + tid;
  const float* qb = q + static_cast<size_t>(b) * N * C;
  for (int e = tid; e < kDotQ * C; e += kDotQ) {
    const int row = e / C, c = e - row * C;
    qs[c * kDotQ + row] = (n0 + row < N) ? qb[static_cast<size_t>(n0 + row) * C + c] : 0.f;
  }
  __syncthreads();
  float qn = 0.f;
  for (int c = 0; c < C; ++c) qn += qs[c * kDotQ + tid] * qs[c * kDotQ + tid];
  TopK<KMAX> top;
  top.init();
  const float* rb = r + static_cast<size_t>(b) * M * C;
  for (int base = 0; base < M; base += kDotR) {
    const int cnt = min(kDotR, M - base);
    __syncthreads();
    for (int e = tid; e < cnt * C; e += kDotQ) rs[e] = rb[static_cast<size_t>(base) * C + e];
    __syncthreads();
    if (tid < cnt) {
      float s = 0.f;
      for (int c = 0; c < C; ++c) s += rs[tid * C + c] * rs[tid * C + c];
      rn[tid] = s;
    }
    __syncthreads();
    float acc[kDotR];
#pragma unroll
    for (int j = 0; j < kDotR; ++j) acc[j] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float qc = qs[c * kDotQ + tid];
#pragma unroll
      for (int j = 0; j < kDotR; ++j) acc[j] = fmaf(qc, rs[j * C + c], acc[j]);
    }
    if (n < N) {
#pragma unroll
      for (int j = 0; j < kDotR; ++j) {
        if (j < cnt) {
          const float d = metric == 0 ? __fadd_rn(__fadd_rn(-2.f * acc[j], qn), rn[j])
                                      : __fsub_rn(1.f, acc[j]);
          top.push(d, base + j);
        }
      }
    }
  }
  if (n < N) {
    int* o = out + (static_cast<size_t>(b) * N + n) * k;
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p < k) o[p] = top.i[p];  // static index: the list stays in registers
    }
  }
}

template <int KMAX>
cudaError_t run(const float* q, const float* r, int B, int N, int M, int C, int k,
                int metric, int* out, cudaStream_t st) {
  if (metric == 0 && C <= 8) {
    dim3 grid(mocopci::ceil_div(N, kXyzThreads), B);
    if (C == 3)
      knn_xyz_kernel<KMAX, 3><<<grid, kXyzThreads, 0, st>>>(q, r, N, M, C, k, out);
    else
      knn_xyz_kernel<KMAX, 8><<<grid, kXyzThreads, 0, st>>>(q, r, N, M, C, k, out);
    return cudaGetLastError();
  }
  const size_t smem = (static_cast<size_t>(C) * (kDotQ + kDotR) + kDotR) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(knn_dot_kernel<KMAX>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mocopci::ceil_div(N, kDotQ), B);
  knn_dot_kernel<KMAX><<<grid, kDotQ, smem, st>>>(q, r, N, M, C, k, metric, out);
  return cudaGetLastError();
}

}  // namespace

// query (B, N, C), ref (B, M, C) f32 -> out (B, N, k) int32.
// metric 0 = Euclidean, 1 = cosine on pre-normalised rows.  k <= 32, C <= 512.
MOCOPCI_API int mocopci_knn(const float* q, const float* r, int B, int N, int M, int C,
                            int k, int metric, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 4) return run<4>(q, r, B, N, M, C, k, metric, out, st);
  if (k <= 8) return run<8>(q, r, B, N, M, C, k, metric, out, st);
  if (k <= 16) return run<16>(q, r, B, N, M, C, k, metric, out, st);
  return run<32>(q, r, B, N, M, C, k, metric, out, st);
}
