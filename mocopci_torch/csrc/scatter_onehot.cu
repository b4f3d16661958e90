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
// one launch, no scratch in device memory.  A thread-block cluster of up to 8
// blocks per (group, output tile of 32 to 512 columns, narrower for more
// sources) splits the sources into chunks of at least 1024, one a block.  The block stages 512
// sources (targets and rows) at a time in shared memory.  A column has 512 /
// C threads when the tile is C columns wide (C rounded up to 32): slice i of
// the threads walks the i-th part of each staged step in ascending order,
// reading broadcasts and adding the rows that hit its column; the slices'
// sums are added in slice order into the block's partial planes, in shared
// memory.  After a cluster barrier, block r adds the r-th part of the tile's
// entries over the cluster's partials in chunk order, read from the other
// blocks' shared memory (Hopper's distributed shared memory).  No atomics.
// (An earlier version wrote the chunks' partials to a work buffer and summed
// them in a second launch.  A block per group and tile, with no chunks, would
// run 6 blocks at 64 columns and 8192 sources, each thread walking 512.)
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;     // output columns per block at most (the TPU's TO)
constexpr int kSrc = 512;         // sources staged per step (its TS)
constexpr int kChunk = 1024;      // sources per block at least
constexpr int kCluster = 8;       // blocks per cluster at most (the portable size)

__global__ void __launch_bounds__(kThreads) onehot_scatter_kernel(
    const float* __restrict__ v, const int* __restrict__ idx, float* __restrict__ out, int S,
    int n_out, int cols, int per_block) {
  __shared__ int s_idx[kSrc];
  __shared__ float s_v[kSrc * 3];
  __shared__ float s_part[kThreads * 3];
  __shared__ float s_tile[kThreads * 3];   // this block's partial planes, [3][cols]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int slices = kThreads / cols;
  const int col = threadIdx.x % cols, slice = threadIdx.x / cols;
  const int g = blockIdx.y;
  const int o = blockIdx.x * cols + col;
  const int* ig = idx + static_cast<size_t>(g) * S;
  const float* vg = v + static_cast<size_t>(g) * S * 3;
  const int s_end = min(S, (rank + 1) * per_block);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int s0 = rank * per_block; s0 < s_end; s0 += kSrc) {
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
  if (slice == 0) {
    for (int i = 1; i < slices; ++i) {
      const float* q = s_part + 3 * (i * cols + col);
      a0 += q[0];
      a1 += q[1];
      a2 += q[2];
    }
    s_tile[col] = a0;
    s_tile[cols + col] = a1;
    s_tile[2 * cols + col] = a2;
  }
  cluster.sync();                 // every block's partial planes are written
  float* og = out + static_cast<size_t>(g) * 3 * n_out;
  for (int e = rank * kThreads + threadIdx.x; e < 3 * cols; e += ranks * kThreads) {
    const int c = e / cols, oc = blockIdx.x * cols + (e - c * cols);
    float acc = 0.f;
    for (int r = 0; r < ranks; ++r) acc += cluster.map_shared_rank(s_tile, r)[e];
    if (oc < n_out) og[static_cast<size_t>(c) * n_out + oc] = acc;
  }
  cluster.sync();                 // no block leaves while another reads its planes
}

}  // namespace

// v (G, S, 3) f32 rows, idx (G, S) int32 -> out (G, 3, n_out) f32; one launch.
MOCOPCI_API int mocopci_onehot_scatter(const float* v, const int* idx, float* out, int G, int S,
                                       int n_out, void* stream) {
  const int chunks = min(kCluster, mocopci::ceil_div(S, kChunk));
  // whole staging steps a block: chunks of 1024 up to 8192 sources
  const int per_block = mocopci::ceil_div(S, chunks * kSrc) * kSrc;
  // tiles narrow enough (down to 32 columns) that a thread walks about 32 of
  // its block's sources
  const int walk = max(32, mocopci::ceil_div(kThreads * 32, min(S, per_block)) / 32 * 32);
  const int cols = min(min(kThreads, walk), mocopci::ceil_div(n_out, 32) * 32);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(mocopci::ceil_div(n_out, cols), G, chunks);
  config.blockDim = dim3(kThreads);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = chunks;
  config.attrs = &attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, onehot_scatter_kernel, v, idx, out, S, n_out,
                                       cols, per_block);
  return err != cudaSuccess ? err : cudaGetLastError();
}
