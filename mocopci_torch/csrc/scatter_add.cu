// Deterministic scatter-add: out[g, n, c] = sum_s v[g, s, c] * 1[idx[g, s] == n],
// out-of-range and negative targets dropped, each sum taken in ascending
// source position s, so the same inputs give the same bits on every run.
//
// Replaces mocopci_tpu/ops/pallas/scatter_bucket.py: bucket_scatter_add_planes
// (:112, pallas_call :133) and its row wrapper bucket_scatter_add (:151).  The
// TPU kernel turns the scatter into radix one-hot matmuls on the MXU; on Hopper
// a counting sort of the targets does the same job without the O(S*N/128)
// one-hot work.
//
// Bound on the H100: bytes (the values read once, the sums written once; a
// handful of integer passes over the (G, S) targets beside them).  Design, per
// group g, five short launches:
//   1. count   targets per row (int atomics: the counts are exact whatever
//              the order);
//   2. scan    the counts into bucket offsets (one block per group);
//   3. fill    each bucket with its sources (atomic cursor: any order);
//   4. rank    each source within its bucket by source position, which puts
//              every bucket in ascending s order (a bucket of L entries costs
//              L reads per entry: skewed buckets stay correct, only slower);
//   5. reduce  one thread per (n, c) sums its bucket in that order.
// Values are read as rows (G, S, C) or planes (G, C, S).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool valid(int t, int N) { return t >= 0 && t < N; }

__global__ void scatter_count_kernel(const int* __restrict__ idx, int* __restrict__ counts, int S,
                             int N) {
  const int g = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int t = idx[static_cast<size_t>(g) * S + s];
  if (valid(t, N)) atomicAdd(&counts[static_cast<size_t>(g) * N + t], 1);
}

// offsets[g, 0..N] = exclusive prefix sums of counts[g, :]
__global__ void __launch_bounds__(kScanThreads) scatter_scan_kernel(const int* __restrict__ counts,
                                                            int* __restrict__ offsets, int N) {
  __shared__ int part[kScanThreads];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int per = (N + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, N), hi = min(lo + per, N);
  const int* c = counts + static_cast<size_t>(g) * N;
  int* o = offsets + static_cast<size_t>(g) * (N + 1);
  int sum = 0;
  for (int n = lo; n < hi; ++n) sum += c[n];
  part[tid] = sum;
  __syncthreads();
  // Hillis-Steele inclusive scan over the thread sums
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += add;
    __syncthreads();
  }
  int run = tid == 0 ? 0 : part[tid - 1];
  for (int n = lo; n < hi; ++n) {
    o[n] = run;
    run += c[n];
  }
  if (tid == kScanThreads - 1) o[N] = part[tid];
}

__global__ void scatter_fill_kernel(const int* __restrict__ idx, const int* __restrict__ offsets,
                            int* __restrict__ cursor, int* __restrict__ list, int S, int N) {
  const int g = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int t = idx[static_cast<size_t>(g) * S + s];
  if (!valid(t, N)) return;
  const int slot = offsets[static_cast<size_t>(g) * (N + 1) + t] +
                   atomicAdd(&cursor[static_cast<size_t>(g) * N + t], 1);
  list[static_cast<size_t>(g) * S + slot] = s;
}

// sorted[lo + rank(e)] = list[e], rank = sources in the bucket before list[e]
__global__ void scatter_rank_kernel(const int* __restrict__ idx, const int* __restrict__ offsets,
                            const int* __restrict__ list, int* __restrict__ sorted, int S,
                            int N) {
  const int g = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int* og = offsets + static_cast<size_t>(g) * (N + 1);
  if (e >= og[N]) return;
  const int* lg = list + static_cast<size_t>(g) * S;
  const int s = lg[e];
  const int t = idx[static_cast<size_t>(g) * S + s];
  const int lo = og[t], hi = og[t + 1];
  int r = 0;
  for (int f = lo; f < hi; ++f) r += lg[f] < s;
  sorted[static_cast<size_t>(g) * S + lo + r] = s;
}

__global__ void scatter_reduce_kernel(const float* __restrict__ v, const int* __restrict__ offsets,
                              const int* __restrict__ sorted, float* __restrict__ out, int S,
                              int C, int N, int planes) {
  const int g = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;   // (n, c), c fastest
  if (e >= N * C) return;
  const int n = e / C, c = e - n * C;
  const int* og = offsets + static_cast<size_t>(g) * (N + 1);
  const int* sg = sorted + static_cast<size_t>(g) * S;
  const float* vg = v + static_cast<size_t>(g) * S * C;
  float acc = 0.f;
  for (int f = og[n]; f < og[n + 1]; ++f) {
    const size_t s = sg[f];
    acc += planes ? vg[static_cast<size_t>(c) * S + s] : vg[s * C + c];
  }
  out[(static_cast<size_t>(g) * N + n) * C + c] = acc;
}

}  // namespace

// v (G, S, C) rows, or (G, C, S) planes when planes != 0; idx (G, S) int32;
// out (G, N, C) f32.  work: int32 scratch of G * (3 * N + 1 + 2 * S) entries,
// zeroed by the caller (counts and cursors must start at 0).
MOCOPCI_API int mocopci_scatter_add(const float* v, const int* idx, float* out, int* work,
                                    int G, int S, int C, int N, int planes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* counts = work;
  int* cursor = counts + static_cast<size_t>(G) * N;
  int* offsets = cursor + static_cast<size_t>(G) * N;
  int* list = offsets + static_cast<size_t>(G) * (N + 1);
  int* sorted = list + static_cast<size_t>(G) * S;
  const dim3 src_grid(mocopci::ceil_div(S, kThreads), G);
  scatter_count_kernel<<<src_grid, kThreads, 0, st>>>(idx, counts, S, N);
  MOCOPCI_CHECK_LAUNCH();
  scatter_scan_kernel<<<G, kScanThreads, 0, st>>>(counts, offsets, N);
  MOCOPCI_CHECK_LAUNCH();
  scatter_fill_kernel<<<src_grid, kThreads, 0, st>>>(idx, offsets, cursor, list, S, N);
  MOCOPCI_CHECK_LAUNCH();
  scatter_rank_kernel<<<src_grid, kThreads, 0, st>>>(idx, offsets, list, sorted, S, N);
  MOCOPCI_CHECK_LAUNCH();
  scatter_reduce_kernel<<<dim3(mocopci::ceil_div(N * C, kThreads), G), kThreads, 0, st>>>(
      v, offsets, sorted, out, S, C, N, planes);
  return cudaGetLastError();
}
