// Train-mode fusion head: per pair p the MLP 4 -> 64 -> 64 -> 128, each layer
// followed by BatchNorm with batch statistics per frame group (eps 1e-3) and
// ReLU, then the max over the 128 channels.  This header holds the packed
// parameter layout and what the forward sweeps (fusion_head_train_fwd.cu)
// and the backward sweeps (fusion_head_train_bwd.cu) share; both run their
// products on the tensor cores (mma_tf32.cuh).  The widths and the forward's
// layer chain are fusion_head.cuh's, which the eval kernel shares.
#pragma once

#include "fusion_head.cuh"

namespace {

constexpr int kCS = kC1 + kC2 + kC3;   // per-group stat row: [layer1 | layer2 | layer3]
// packed parameters: W1 b1 g1 e1 W2 b2 g2 e2 W3 b3 g3 e3 (W as (in, out), e = BN beta)
constexpr int OW1 = 0, OB1 = OW1 + 4 * kC1, OG1 = OB1 + kC1, OE1 = OG1 + kC1;
constexpr int OW2 = OE1 + kC1, OB2 = OW2 + kC1 * kC2, OG2 = OB2 + kC2, OE2 = OG2 + kC2;
constexpr int OW3 = OE2 + kC2, OB3 = OW3 + kC2 * kC3, OG3 = OB3 + kC3, OE3 = OG3 + kC3;
constexpr int kNParam = OE3 + kC3;

// The vectors a block keeps in shared memory beside its split weights:
// W1 b1 g1 e1, then b2 g2 e2, b3 g3 e3.
constexpr int kVec = OW2;
constexpr int SB2 = kVec, SG2 = SB2 + kC2, SE2 = SG2 + kC2;
constexpr int SB3 = SE2 + kC2, SG3 = SB3 + kC3, SE3 = SG3 + kC3;
constexpr int kVecAll = SE3 + kC3;

// Per-group sums of (a, b) for column col: this thread's two rows, then the
// 8 row pairs of the warp (lane bits 2-4), added to the warp's shared row.
__device__ __forceinline__ void group_acc(float a, float b, float* row, int GW, int col) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) < 4) {
    row[col] += a;
    row[GW + col] += b;
  }
}

}  // namespace
