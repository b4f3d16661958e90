// The fusion head's layer chain on the tensor cores, shared by the train
// forward sweeps (fusion_head_train_fwd.cu) and the eval kernel
// (fusion_pair.cu): per pair the MLP 4 -> 64 -> 64 -> 128, then the max over
// the 128 channels.
//
// A block is two warpgroups (8 warps); a warpgroup owns 64 pairs, the M of
// its products, each warp 16 of them (rows gid and gid + 8 of the mma
// fragments).  Layer 1 (K = 4) runs on FMAs in accumulator layout; W2 and W3
// are the B operands of wgmma m64nNk8 at float32 grade (3xTF32, mma_tf32.cuh),
// split once a block into hi and lo planes in shared memory, K-major in
// 128-byte core matrices.  An activation stays in registers as accumulator
// fragments: n-tile ks of it is the next product's A fragment of k-step ks
// with its channels taken in the order (2 tig, 2 tig + 1) of the fragment, so
// the B planes hold W's rows in that order and no shuffle moves the
// activation.  What follows each layer (batch-statistics BN in training, the
// folded bias alone in eval, then the ReLU) is the caller's: a function of
// (channel, value) handed to activate() and channel_max().
#pragma once

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kC1 = 64, kC2 = 64, kC3 = 128;   // the widths after the 4 inputs
constexpr int kFWarps = 8;              // two warpgroups
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFTile = 16 * kFWarps;    // pairs per block step
// a B plane of K = 64 input channels: 16 core matrices along K, 128 bytes
// each, then the next 8 output channels
constexpr uint32_t kLbo = 128, kSbo = 16 * 128;

// float offset in a B plane of weight W[c][n] (input channel c, output n):
// k-step c / 8 holds channel 8 ks + 2 j at its k = j and 8 ks + 2 j + 1 at
// k = 4 + j (the A fragments' order)
__device__ __forceinline__ int b_offset(int c, int n) {
  const int q = c & 7, k = (c & ~7) + ((q & 1) << 2) + (q >> 1);
  return (n >> 3) * (kSbo / 4) + (k >> 2) * (kLbo / 4) + (n & 7) * 4 + (k & 3);
}

// acc[NT] += H W over 64 channels for the warpgroup's 64 rows: H held as
// accumulator fragments h[ks][4] (c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2,
// c3 the same at gid + 8).  K-step ks takes n-tile ks of H as its A fragment
// with the columns tig, tig + 4 standing for channels 8 ks + 2 tig, + 1
// (b_offset); whi, wlo describe W's hi and lo planes.  Three products a
// k-step, the two small terms first.
template <int NT>
__device__ __forceinline__ void chain_product(const float (&h)[kC1 / 8][4], uint64_t whi,
                                              uint64_t wlo, float (&acc)[NT][4]) {
  uint32_t hi[kC1 / 8][4], lo[kC1 / 8][4];
#pragma unroll
  for (int ks = 0; ks < kC1 / 8; ++ks) {
    const float a[4] = {h[ks][0], h[ks][2], h[ks][1], h[ks][3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) mocopci::split_tf32(a[i], hi[ks][i], lo[ks][i]);
  }
  mocopci::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kC1 / 8; ++ks) {
    const uint64_t o = ks * (2 * kLbo >> 4);     // the k-step's two core matrices
    if constexpr (NT == 8) {
      mocopci::wgmma_m64n64k8(acc, lo[ks], whi + o);
      mocopci::wgmma_m64n64k8(acc, hi[ks], wlo + o);
      mocopci::wgmma_m64n64k8(acc, hi[ks], whi + o);
    } else {
      mocopci::wgmma_m64n128k8(acc, lo[ks], whi + o);
      mocopci::wgmma_m64n128k8(acc, hi[ks], wlo + o);
      mocopci::wgmma_m64n128k8(acc, hi[ks], whi + o);
    }
  }
  mocopci::wgmma_commit();
  mocopci::wgmma_wait();
}

// Layer 1 on FMAs, in accumulator layout (element q: row q / 2, column
// nt * 8 + 2 tig + q % 2): z = b1 + sum_i x_i W1[i], W1 (4, kC1) row-major.
__device__ __forceinline__ void chain_layer1(const float (&xv)[2][4], const float* w1,
                                             const float* b1, int tig,
                                             float (&h1)[kC1 / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < kC1 / 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = nt * 8 + 2 * tig + (q & 1);
      float z = b1[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) z = fmaf(xv[q >> 1][i], w1[i * kC1 + c], z);
      h1[nt][q] = z;
    }
}

// acc = the bias of each column, the start of a product's sums
template <int NT>
__device__ __forceinline__ void chain_bias(const float* b, int tig, float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = b[nt * 8 + 2 * tig + (q & 1)];
}

// h = act(c, h) for each element, c its column
template <int NT, class Act>
__device__ __forceinline__ void chain_activate(float (&h)[NT][4], int tig, Act act) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) h[nt][q] = act(nt * 8 + 2 * tig + (q & 1), h[nt][q]);
}

// max over the 128 columns of act(c, z), for the thread's rows gid and gid + 8,
// reduced over the 4 lanes of a row; act returns values >= 0
template <class Act>
__device__ __forceinline__ void chain_channel_max(const float (&z)[kC3 / 8][4], int tig, Act act,
                                                  float (&mx)[2]) {
  mx[0] = mx[1] = -1.f;
#pragma unroll
  for (int nt = 0; nt < kC3 / 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      mx[q >> 1] = fmaxf(mx[q >> 1], act(nt * 8 + 2 * tig + (q & 1), z[nt][q]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

}  // namespace
