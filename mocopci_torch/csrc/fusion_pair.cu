// Fusion head over gathered pairs (query n, neighbour slot j), p = j*N + n
// (k-major):
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
// gather on the MXU and lane-dense planes; on Hopper a thread gathers its rows
// directly.
//
// Bound on the H100: operations, 2*(4*64 + 64*64 + 64*128) = 25k flops per
// pair against ~24 bytes of HBM traffic per pair.  Design: the train head's
// layer chain (fusion_head.cuh): layer 1 on FMAs, W2 and W3 on wgmma m64nNk8
// at float32 grade (3xTF32), split once a block into hi and lo planes, the
// activations kept as accumulator fragments and reduced to the channel max
// on them, so no (G, C, P) activation exists anywhere; the folded bias and
// the ReLU are the epilogue.  Two warpgroups a block, one block an SM, a
// fixed grid walking units of 128 queries x 8 neighbour slots (fewer slots
// where 8 would leave SMs idle, so a small call still spreads over the
// card): a unit's rows of points1 and of idx (32 contiguous bytes a query)
// are read once, then each slot is a tile of 128 pair rows whose points2
// rows are gathered in front of its products while the tile before it runs
// (the gather stage); the planes are written once, a plane a lane.
//
// mocopci_fusion_pair_planes is the gather stage alone (the train path, whose
// head has batch statistics): bytes bound it, 4 + 12 bytes read and 16
// written per pair.  A thread takes a query and 8 slots at a time, its idx
// row segment read as one sector, gathers the 8 neighbour rows together and
// writes each slot's planes where the next thread writes the next query's;
// a fixed grid strides over the units, so no partial wave is left.
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
#include <algorithm>

#include "fusion_head.cuh"

namespace {

constexpr int kThreads = 128;     // the planes, rows and backward kernels
constexpr int kUnitJ = 8;         // neighbour slots a unit of the gather stage, at most
constexpr int kSms = 132;         // an H100's SMs: both gather entries' grids at most
constexpr int kPlanesBlocks = kSms * 8;   // the planes entry: 8 blocks an SM
// the eval kernel's vectors in shared memory: W1 (4, 64), b1, b2, b3
constexpr int EW1 = 0, EB1 = 4 * kC1, EB2 = EB1 + kC1, EB3 = EB2 + kC2, kEvalVec = EB3 + kC3;

// x = [resi, dist] of neighbour row a against query row c (the planes' bits)
__device__ __forceinline__ void pair_x(const float* __restrict__ a, const float (&c)[3],
                                       float (&x)[4]) {
  x[0] = a[0] - c[0];
  x[1] = a[1] - c[1];
  x[2] = a[2] - c[2];
  x[3] = sqrtf(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])),
                                   __fmul_rn(x[2], x[2])),
                         1e-20f));
}

// query n's row of points1 (zeros past N)
__device__ __forceinline__ void query_row(const float* __restrict__ p1, int g, int n, int N,
                                          float (&c)[3]) {
  const float* row = p1 + (static_cast<size_t>(g) * N + n) * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = n < N ? row[i] : 0.f;
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

// The gather stage alone, for the train path (its head is
// fusion_head_train.cuh): a fixed grid of threads striding over units
// (query, 8 slots), the queries fastest.
__global__ void __launch_bounds__(kThreads) fusion_pair_planes_kernel(
    const float* __restrict__ p2, const int* __restrict__ idx, const float* __restrict__ p1,
    float* __restrict__ planes, int G, int N, int N2, int K2) {
  const size_t P = static_cast<size_t>(N) * K2;
  const int nj = (K2 + kUnitJ - 1) / kUnitJ;
  const size_t units = static_cast<size_t>(G) * nj * N;
  for (size_t u = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; u < units;
       u += static_cast<size_t>(gridDim.x) * kThreads) {
    const int n = static_cast<int>(u % N), rest = static_cast<int>(u / N);
    const int g = rest / nj, j0 = (rest - g * nj) * kUnitJ;
    float c[3];
    query_row(p1, g, n, N, c);
    const int* ir = idx + (static_cast<size_t>(g) * N + n) * K2;
    int r[kUnitJ];
#pragma unroll
    for (int jj = 0; jj < kUnitJ; ++jj) r[jj] = j0 + jj < K2 ? ir[j0 + jj] : 0;
    float x[kUnitJ][4];      // every gather issued before the first store
#pragma unroll
    for (int jj = 0; jj < kUnitJ; ++jj)
      pair_x(p2 + (static_cast<size_t>(g) * N2 + r[jj]) * 3, c, x[jj]);
    float* pl = planes + static_cast<size_t>(g) * 4 * P + n;
#pragma unroll
    for (int jj = 0; jj < kUnitJ; ++jj)
      if (j0 + jj < K2)
#pragma unroll
        for (int i = 0; i < 4; ++i) pl[i * P + static_cast<size_t>(j0 + jj) * N] = x[jj][i];
  }
}

// The eval head: a fixed grid of blocks walks units (g, queries n0 + [0, 128),
// slots j0 + [0, uj)); warp w's rows are queries n0 + 16 w + gid and + 8.
__global__ void __launch_bounds__(kFThreads, 1) fusion_pair_kernel(
    const float* __restrict__ p2, const int* __restrict__ idx, const float* __restrict__ p1,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3, const float* __restrict__ b3,
    float* __restrict__ planes, float* __restrict__ logits, int G, int N, int N2, int K2,
    int uj) {
  extern __shared__ __align__(128) float sm[];
  float* vec = sm;                                                 // kEvalVec
  uint32_t* W2s = reinterpret_cast<uint32_t*>(vec + kEvalVec);     // hi, lo planes
  uint32_t* W3s = W2s + 2 * kC1 * kC2;                             // hi, lo planes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (int e = tid; e < 4 * kC1; e += kFThreads) vec[EW1 + e] = w1[e];
  for (int e = tid; e < kC1; e += kFThreads) {
    vec[EB1 + e] = b1[e];
    vec[EB2 + e] = b2[e];
  }
  for (int e = tid; e < kC3; e += kFThreads) vec[EB3 + e] = b3[e];
  for (int e = tid; e < kC1 * kC2; e += kFThreads) {
    const int o = b_offset(e / kC2, e % kC2);
    mocopci::split_tf32(w2[e], W2s[o], W2s[kC1 * kC2 + o]);
  }
  for (int e = tid; e < kC2 * kC3; e += kFThreads) {
    const int o = b_offset(e / kC3, e % kC3);
    mocopci::split_tf32(w3[e], W3s[o], W3s[kC2 * kC3 + o]);
  }
  mocopci::fence_async_shared();
  __syncthreads();
  const uint64_t w2hi = mocopci::wgmma_desc(W2s, kLbo, kSbo);
  const uint64_t w2lo = mocopci::wgmma_desc(W2s + kC1 * kC2, kLbo, kSbo);
  const uint64_t w3hi = mocopci::wgmma_desc(W3s, kLbo, kSbo);
  const uint64_t w3lo = mocopci::wgmma_desc(W3s + kC2 * kC3, kLbo, kSbo);
  const auto relu = [](int, float z) { return fmaxf(z, 0.f); };

  const size_t P = static_cast<size_t>(N) * K2;
  const int nq = (N + kFTile - 1) / kFTile, nj = (K2 + uj - 1) / uj;
  for (int u = blockIdx.x; u < G * nq * nj; u += gridDim.x) {
    const int g = u / (nq * nj), rem = u - g * nq * nj;
    const int n0 = (rem / nj) * kFTile + warp * 16 + gid, j0 = (rem % nj) * uj;
    const int n[2] = {n0, n0 + 8};
    const int j1 = min(K2, j0 + uj);
    float c[2][3];
    const int* ir[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      query_row(p1, g, n[h], N, c[h]);
      ir[h] = idx + (static_cast<size_t>(g) * N + min(n[h], N - 1)) * K2;
    }
    const float* p2g = p2 + static_cast<size_t>(g) * N2 * 3;
    // the neighbour rows of slot j, gathered ahead of the slot before
    float a[2][3];
    auto gather = [&](int j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* row = p2g + static_cast<size_t>(ir[h][j]) * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) a[h][i] = row[i];
      }
    };
    gather(j0);
    for (int j = j0; j < j1; ++j) {
      float xv[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pair_x(a[h], c[h], xv[h]);
        if (n[h] < N) {     // lane tig writes plane tig
          const float v = tig == 0 ? xv[h][0] : tig == 1 ? xv[h][1] : tig == 2 ? xv[h][2]
                                                                     : xv[h][3];
          planes[(static_cast<size_t>(g) * 4 + tig) * P + static_cast<size_t>(j) * N + n[h]] = v;
        }
      }
      if (j + 1 < j1) gather(j + 1);   // lands under this slot's products

      float h1[kC1 / 8][4];
      chain_layer1(xv, vec + EW1, vec + EB1, tig, h1);
      chain_activate(h1, tig, relu);
      float h2[kC2 / 8][4];
      chain_bias(vec + EB2, tig, h2);
      chain_product(h1, w2hi, w2lo, h2);
      chain_activate(h2, tig, relu);
      float z3[kC3 / 8][4];
      chain_bias(vec + EB3, tig, z3);
      chain_product(h2, w3hi, w3lo, z3);
      float mx[2];
      chain_channel_max(z3, tig, relu, mx);
      if (tig == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (n[h] < N)
            logits[static_cast<size_t>(g) * P + static_cast<size_t>(j) * N + n[h]] = mx[h];
      }
    }
  }
}

}  // namespace

// points2 (G, N2, 3), idx (G, N, K2) int32, points1 (G, N, 3), folded weights
// w1 (4, 64), w2 (64, 64), w3 (64, 128) with their biases, all f32
// -> planes (G, 4, N*K2), logits (G, N*K2), pair p = j*N + n.  A unit is 128
// queries x uj slots, uj the tiles of 128 pairs an SM takes when the
// G x ceil(N / 128) x K2 tiles are spread over the SMs, from 1 to 8; at most
// a block an SM.
MOCOPCI_API int mocopci_fusion_pair(const float* p2, const int* idx, const float* p1,
                                    const float* w1, const float* b1, const float* w2,
                                    const float* b2, const float* w3, const float* b3,
                                    float* planes, float* logits, int G, int N, int N2,
                                    int K2, void* stream) {
  const long long rows = static_cast<long long>(G) * mocopci::ceil_div(N, kFTile);
  const int uj =
      static_cast<int>(std::clamp<long long>((rows * K2 + kSms - 1) / kSms, 1, kUnitJ));
  const int nblk = static_cast<int>(std::min<long long>(rows * mocopci::ceil_div(K2, uj), kSms));
  const size_t smem = (kEvalVec + 2 * (kC1 * kC2 + kC2 * kC3)) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(fusion_pair_kernel, smem);
  if (err != cudaSuccess) return err;
  fusion_pair_kernel<<<nblk, kFThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p2, idx, p1, w1, b1, w2, b2, w3, b3, planes, logits, G, N, N2, K2, uj);
  return cudaGetLastError();
}

// points2 (G, N2, 3), idx (G, N, K2) int32, points1 (G, N, 3) -> planes (G, 4, N*K2).
MOCOPCI_API int mocopci_fusion_pair_planes(const float* p2, const int* idx, const float* p1,
                                           float* planes, int G, int N, int N2, int K2,
                                           void* stream) {
  const long long units =
      static_cast<long long>(G) * mocopci::ceil_div(K2, kUnitJ) * N;
  const int grid = static_cast<int>(std::min<long long>((units + kThreads - 1) / kThreads,
                                                        kPlanesBlocks));
  fusion_pair_planes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p2, idx, p1, planes, G, N, N2, K2);
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
