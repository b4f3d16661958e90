// One-hot scatter of xyz rows into planes:
//   out[g, c, o] = sum_s v[g, s, c] * 1[idx[g, s] == o],   c < 3,
// out-of-range and negative targets dropped, each sum taken in a fixed order
// (the same bits on every run).
//
// Replaces mocopci_tpu/ops/pallas/scatter.py: onehot_scatter_rows (:63,
// pallas_call :72), the TPU's (source tile x output tile) multiply-reduce.
// The Chamfer VJP takes it where a cloud size is not a multiple of 128.
//
// Bound on the H100: bytes (the rows and targets read once, the planes
// written once); the one-hot work is O(S * out) compares, as on the TPU, which
// is small at the sizes that reach it (one cloud under 256 points).  Design:
// a block per (group, output tile of up to 512 columns, chunk of 1024
// sources).  The block stages 512 sources (targets and rows) at a time in
// shared memory.  A column has 512 / C threads when the tile is C columns wide
// (C rounded up to 32): slice i of the threads walks the i-th part of each
// staged step in ascending order, reading broadcasts and adding the rows that
// hit its column; the slices' sums are then added in slice order, and the
// source chunks' partial planes in chunk order by a second pass.  No atomics.
// (A first version gave every column one thread and a block all the sources:
// at 64 columns and 8192 sources it ran 6 blocks, 7/8 of their threads idle.)
#include "common.cuh"

namespace {

constexpr int kThreads = 512;     // output columns per block at most (the TPU's TO)
constexpr int kSrc = 512;         // sources staged per step (its TS)
constexpr int kChunk = 1024;      // sources per block

__global__ void __launch_bounds__(kThreads) onehot_scatter_kernel(
    const float* __restrict__ v, const int* __restrict__ idx, float* __restrict__ out, int S,
    int n_out, int cols) {
  // source chunk z of S; with several chunks, out is the chunk's partial planes
  __shared__ int s_idx[kSrc];
  __shared__ float s_v[kSrc * 3];
  __shared__ float s_part[kThreads * 3];
  const int slices = kThreads / cols;
  const int col = threadIdx.x % cols, slice = threadIdx.x / cols;
  const int g = blockIdx.y;
  const int o = blockIdx.x * cols + col;
  const int* ig = idx + static_cast<size_t>(g) * S;
  const float* vg = v + static_cast<size_t>(g) * S * 3;
  const int s_end = min(S, static_cast<int>(blockIdx.z + 1) * kChunk);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int s0 = blockIdx.z * kChunk; s0 < s_end; s0 += kSrc) {
    const int n = min(kSrc, s_end - s0);
    const int per = (n + slices - 1) / slices;
    __syncthreads();              // the previous step's reads are done
    for (int e = threadIdx.x; e < n; e += kThreads) s_idx[e] = ig[s0 + e];
    for (int e = threadIdx.x; e < 3 * n; e += kThreads) s_v[e] = vg[static_cast<size_t>(s0) * 3 + e];
    __syncthreads();
    if (slice < slices) {
      const int hi = min(n, (slice + 1) * per);
      for (int s = slice * per; s < hi; ++s) {
        if (s_idx[s] == o) {
          a0 += s_v[3 * s];
          a1 += s_v[3 * s + 1];
          a2 += s_v[3 * s + 2];
        }
      }
    }
  }
  s_part[3 * threadIdx.x] = a0;
  s_part[3 * threadIdx.x + 1] = a1;
  s_part[3 * threadIdx.x + 2] = a2;
  __syncthreads();
  if (slice == 0 && o < n_out) {
    for (int i = 1; i < slices; ++i) {
      const float* q = s_part + 3 * (i * cols + col);
      a0 += q[0];
      a1 += q[1];
      a2 += q[2];
    }
    float* og = out + (static_cast<size_t>(blockIdx.z) * gridDim.y + g) * 3 * n_out;
    og[o] = a0;
    og[n_out + o] = a1;
    og[2 * n_out + o] = a2;
  }
}

}  // namespace

// v (G, S, 3) f32 rows, idx (G, S) int32 -> out (G, 3, n_out) f32.  work:
// f32 scratch of ceil(S / 1024) * G * 3 * n_out entries when S > 1024.
MOCOPCI_API int mocopci_onehot_scatter(const float* v, const int* idx, float* out, float* work,
                                       int G, int S, int n_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = min(kThreads, mocopci::ceil_div(n_out, 32) * 32);
  const int chunks = mocopci::ceil_div(S, kChunk);
  dim3 grid(mocopci::ceil_div(n_out, cols), G, chunks);
  onehot_scatter_kernel<<<grid, kThreads, 0, st>>>(v, idx, chunks > 1 ? work : out, S, n_out,
                                                    cols);
  if (chunks == 1) return cudaGetLastError();
  MOCOPCI_CHECK_LAUNCH();
  return mocopci::reduce_partials(work, out, chunks, G * 3 * n_out, st);
}
