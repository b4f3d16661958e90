// Fusion head, one thread per (query, neighbour) pair p = j*N + n (k-major):
//   resi   = points2[idx[n, j]] - points1[n]
//   dist   = sqrt(|resi|^2 + 1e-20)
//   planes[:, p] = [resi, dist]                      (G, 4, P), for the blend
//   logits[p]    = max_c relu(relu(relu(x W1 + b1) W2 + b2) W3 + b3)[c]
// with BatchNorm already folded into W/b on the host (fold_bn_dense).
//
// Replaces three TPU kernels: mocopci_tpu/ops/pallas/gather_planes.py
// bucket_gather_pair_planes (:87, pallas_call :113), the build_pair_planes
// forward of fusion_planes.py (:148, pallas_call :154) and fusion_head.py
// fusion_head_pallas (:66, pallas_call :92).  The TPU needed a radix one-hot
// gather on the MXU and lane-dense planes; on Hopper a thread gathers its row
// directly.
//
// Bound on the H100: operations, 2*(4*64 + 64*64 + 64*128) = 25k flops per
// pair (40 GFLOP at 3 x 8192 x 64 pairs) against ~24 bytes of HBM traffic per
// pair.  Design: the 12.8k weight floats sit in shared memory and every
// thread of a warp reads the same weight (broadcast); each thread keeps its
// two 64-wide hidden vectors in registers and reduces the 128 outputs to
// their max on the fly, so no (G, C, P) activation exists anywhere.  Plain
// FMAs: a tensor-core version (pairs as the M dimension of an mma) is a later
// step.
//
// mocopci_fusion_pair_planes is the planes alone (the train path, whose head
// has batch statistics): bytes bound it, 4 + 12 bytes read and 16 written per
// pair.
//
// mocopci_pair_planes_rows and mocopci_pair_planes_bwd are build_pair_planes
// of fusion_planes.py on rows the caller has gathered: its forward (:148,
// pallas_call :154) and its backward _bwd_kernel (:112; _bpp_bwd :165,
// pallas_call :171).  Both are bound by bytes.  The forward is a thread per
// pair.  The backward recomputes resi and dist, forms
// d_resi = dx[0:3] + dx[3] * resi / dist, writes it as the row gradient, and
// sums d_p1t = -sum_j d_resi over the k-major slots j in ascending order: a
// thread per (g, n), so no atomics (the TPU carried that sum along its
// sequential slot axis).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kC1 = 64;
constexpr int kC2 = 128;

// x = [resi, dist] of pair p = j*N + n of group g, written to its planes.
__device__ __forceinline__ void pair_plane(const float* __restrict__ p2,
                                           const int* __restrict__ idx,
                                           const float* __restrict__ p1,
                                           float* __restrict__ planes, int g, int p, int N,
                                           int N2, int K2, float x[4]) {
  const int P = N * K2;
  const int j = p / N, n = p - j * N;
  const int r = idx[(static_cast<size_t>(g) * N + n) * K2 + j];
  const float* a = p2 + (static_cast<size_t>(g) * N2 + r) * 3;
  const float* c = p1 + (static_cast<size_t>(g) * N + n) * 3;
  x[0] = a[0] - c[0];
  x[1] = a[1] - c[1];
  x[2] = a[2] - c[2];
  x[3] = sqrtf(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])),
                                   __fmul_rn(x[2], x[2])),
                         1e-20f));
  float* pl = planes + static_cast<size_t>(g) * 4 * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) pl[static_cast<size_t>(i) * P + p] = x[i];
}

// resi = rows - query plane column, dist = sqrt(|resi|^2 + 1e-20), summed as
// the planes above.
__device__ __forceinline__ void resi_dist(const float* __restrict__ row,
                                          const float* __restrict__ p1t, int n, int N,
                                          float x[4]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = row[c] - p1t[static_cast<size_t>(c) * N + n];
  x[3] = sqrtf(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])),
                                   __fmul_rn(x[2], x[2])),
                         1e-20f));
}

// rows (G, P, 3) k-major, p1t (G, 3, N) -> planes (G, 4, P); a thread per pair.
__global__ void __launch_bounds__(kThreads) pair_planes_rows_kernel(
    const float* __restrict__ rows, const float* __restrict__ p1t, float* __restrict__ planes,
    int N, int P) {
  const int g = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float x[4];
  resi_dist(rows + (static_cast<size_t>(g) * P + p) * 3, p1t + static_cast<size_t>(g) * 3 * N,
            p % N, N, x);
  float* pl = planes + static_cast<size_t>(g) * 4 * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) pl[static_cast<size_t>(i) * P + p] = x[i];
}

// dx (G, 4, P) -> d_rows (G, P, 3), d_p1t (G, 3, N); a thread per (g, n)
// walks its K2 = P / N slots in ascending j.
__global__ void __launch_bounds__(kThreads) pair_planes_bwd_kernel(
    const float* __restrict__ rows, const float* __restrict__ p1t, const float* __restrict__ dx,
    float* __restrict__ d_rows, float* __restrict__ d_p1t, int N, int K2) {
  const int g = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const size_t P = static_cast<size_t>(N) * K2;
  const float* pg = p1t + static_cast<size_t>(g) * 3 * N;
  const float* dg = dx + static_cast<size_t>(g) * 4 * P;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int j = 0; j < K2; ++j) {
    const size_t p = static_cast<size_t>(j) * N + n;
    float x[4];
    resi_dist(rows + (static_cast<size_t>(g) * P + p) * 3, pg, n, N, x);
    const float w = dg[3 * P + p];
    const float d0 = dg[p] + w * (x[0] / x[3]);
    const float d1 = dg[P + p] + w * (x[1] / x[3]);
    const float d2 = dg[2 * P + p] + w * (x[2] / x[3]);
    float* dr = d_rows + (static_cast<size_t>(g) * P + p) * 3;
    dr[0] = d0;
    dr[1] = d1;
    dr[2] = d2;
    s0 -= d0;
    s1 -= d1;
    s2 -= d2;
  }
  float* dp = d_p1t + static_cast<size_t>(g) * 3 * N;
  dp[n] = s0;
  dp[N + n] = s1;
  dp[2 * N + n] = s2;
}

// The planes alone, for the train path (its head is fusion_head_train.cuh).
__global__ void __launch_bounds__(kThreads) fusion_pair_planes_kernel(
    const float* __restrict__ p2, const int* __restrict__ idx, const float* __restrict__ p1,
    float* __restrict__ planes, int N, int N2, int K2) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= N * K2) return;
  float x[4];
  pair_plane(p2, idx, p1, planes, blockIdx.y, p, N, N2, K2, x);
}

__global__ void __launch_bounds__(kThreads) fusion_pair_kernel(
    const float* __restrict__ p2, const int* __restrict__ idx, const float* __restrict__ p1,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3, const float* __restrict__ b3,
    float* __restrict__ planes, float* __restrict__ logits, int N, int N2, int K2) {
  extern __shared__ float sm[];
  float* s_w1 = sm;                 // [4][C1]
  float* s_b1 = s_w1 + 4 * kC1;
  float* s_w2 = s_b1 + kC1;         // [C1][C1]
  float* s_b2 = s_w2 + kC1 * kC1;
  float* s_w3 = s_b2 + kC1;         // [C1][C2]
  float* s_b3 = s_w3 + kC1 * kC2;
  const int tid = threadIdx.x;
  for (int e = tid; e < 4 * kC1; e += kThreads) s_w1[e] = w1[e];
  for (int e = tid; e < kC1 * kC1; e += kThreads) s_w2[e] = w2[e];
  for (int e = tid; e < kC1 * kC2; e += kThreads) s_w3[e] = w3[e];
  for (int e = tid; e < kC1; e += kThreads) {
    s_b1[e] = b1[e];
    s_b2[e] = b2[e];
  }
  for (int e = tid; e < kC2; e += kThreads) s_b3[e] = b3[e];
  __syncthreads();

  const int g = blockIdx.y;
  const int P = N * K2;
  const int p = blockIdx.x * kThreads + tid;
  if (p >= P) return;
  float x[4];
  pair_plane(p2, idx, p1, planes, g, p, N, N2, K2, x);

  float h1[kC1];
#pragma unroll
  for (int o = 0; o < kC1; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = fmaf(x[i], s_w1[i * kC1 + o], acc);
    h1[o] = fmaxf(acc + s_b1[o], 0.f);
  }
  float h2[kC1];
#pragma unroll
  for (int o = 0; o < kC1; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kC1; ++i) acc = fmaf(h1[i], s_w2[i * kC1 + o], acc);
    h2[o] = fmaxf(acc + s_b2[o], 0.f);
  }
  float m = 0.f;  // max over relu outputs, all >= 0
#pragma unroll 4
  for (int o = 0; o < kC2; ++o) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kC1; ++i) acc = fmaf(h2[i], s_w3[i * kC2 + o], acc);
    m = fmaxf(m, acc + s_b3[o]);
  }
  logits[static_cast<size_t>(g) * P + p] = m;
}

}  // namespace

// points2 (G, N2, 3), idx (G, N, K2) int32, points1 (G, N, 3), folded weights
// w1 (4, 64), w2 (64, 64), w3 (64, 128) with their biases, all f32
// -> planes (G, 4, N*K2), logits (G, N*K2), pair p = j*N + n.
MOCOPCI_API int mocopci_fusion_pair(const float* p2, const int* idx, const float* p1,
                                    const float* w1, const float* b1, const float* w2,
                                    const float* b2, const float* w3, const float* b3,
                                    float* planes, float* logits, int G, int N, int N2,
                                    int K2, void* stream) {
  const size_t smem =
      (4 * kC1 + kC1 + kC1 * kC1 + kC1 + kC1 * kC2 + kC2) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(fusion_pair_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mocopci::ceil_div(N * K2, kThreads), G);
  fusion_pair_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p2, idx, p1, w1, b1, w2, b2, w3, b3, planes, logits, N, N2, K2);
  return cudaGetLastError();
}

// points2 (G, N2, 3), idx (G, N, K2) int32, points1 (G, N, 3) -> planes (G, 4, N*K2).
MOCOPCI_API int mocopci_fusion_pair_planes(const float* p2, const int* idx, const float* p1,
                                           float* planes, int G, int N, int N2, int K2,
                                           void* stream) {
  dim3 grid(mocopci::ceil_div(N * K2, kThreads), G);
  fusion_pair_planes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p2, idx, p1, planes, N, N2, K2);
  return cudaGetLastError();
}

// rows (G, N*K2, 3) gathered k-major, p1t (G, 3, N) -> planes (G, 4, N*K2).
MOCOPCI_API int mocopci_pair_planes_rows(const float* rows, const float* p1t, float* planes,
                                         int G, int N, int K2, void* stream) {
  dim3 grid(mocopci::ceil_div(N * K2, kThreads), G);
  pair_planes_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, p1t, planes, N, N * K2);
  return cudaGetLastError();
}

// rows (G, N*K2, 3), p1t (G, 3, N), dx (G, 4, N*K2) -> d_rows (G, N*K2, 3),
// d_p1t (G, 3, N).
MOCOPCI_API int mocopci_pair_planes_bwd(const float* rows, const float* p1t, const float* dx,
                                        float* d_rows, float* d_p1t, int G, int N, int K2,
                                        void* stream) {
  dim3 grid(mocopci::ceil_div(N, kThreads), G);
  pair_planes_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, p1t, dx, d_rows, d_p1t, N, K2);
  return cudaGetLastError();
}
