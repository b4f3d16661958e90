// Train-mode fusion head: per pair p the MLP 4 -> 64 -> 64 -> 128, each layer
// followed by BatchNorm with batch statistics per frame group (eps 1e-3) and
// ReLU, then the max over the 128 channels.  This header holds the packed
// parameter layout and the forward sweeps; the backward sweeps, on the tensor
// cores, are in fusion_head_train_bwd.cu.
//
// Replaces mocopci_tpu/ops/pallas/fusion_head_train.py: fusion_head_train
// (:319), stats sweeps (pallas_call :356), output sweep (:371).  As there,
// nothing of shape (G, C, P) is stored: every sweep recomputes the layer
// chain from the (G, 4, P) planes.  Sweep k = 0, 1, 2 sums (z, z^2) of layer
// k+1 per group, the layers before it normalised with the statistics already
// found; sweep 3 writes o = max_c h3.
//
// Bound on the H100: operations, about 2 * 12.5k flops per pair for each
// full-chain recompute (about 2.5 chains over the 4 sweeps) against 16 bytes
// of HBM per pair and sweep.  Design: one thread per pair, 128 pairs (one
// tile) per block step, a fixed grid of blocks striding over the tiles.
// Weights and the group statistics sit in shared memory (70 KB at three
// groups); each thread keeps its pair's 64-wide vectors in registers and
// every FMA reads its weight from shared memory (no tensor cores yet).
// Per-group sums reduce over a warp by shuffles into per-warp shared rows.
// Block partials are summed in block order by a second kernel, so every sum
// has a fixed order and the result repeats bit for bit.
#pragma once

#include "common.cuh"

namespace {

constexpr int kR = 128;        // pairs per tile = threads per block
constexpr int kWarps = kR / 32;
constexpr int kC1 = 64, kC2 = 64, kC3 = 128;
constexpr int kCS = kC1 + kC2 + kC3;   // per-group stat row: [layer1 | layer2 | layer3]
// packed parameters: W1 b1 g1 e1 W2 b2 g2 e2 W3 b3 g3 e3 (W as (in, out), e = BN beta)
constexpr int OW1 = 0, OB1 = OW1 + 4 * kC1, OG1 = OB1 + kC1, OE1 = OG1 + kC1;
constexpr int OW2 = OE1 + kC1, OB2 = OW2 + kC1 * kC2, OG2 = OB2 + kC2, OE2 = OG2 + kC2;
constexpr int OW3 = OE2 + kC2, OB3 = OW3 + kC2 * kC3, OG3 = OB3 + kC3, OE3 = OG3 + kC3;
constexpr int kNParam = OE3 + kC3;

// floats of the per-block reduction of a forward sweep (its partial and its
// result), and the width of its per-group sums
__host__ __device__ constexpr int red_size(int mode, int F) {
  return mode == 0 ? F * 2 * kC1 : mode == 1 ? F * 2 * kC2 : mode == 2 ? F * 2 * kC3 : 0;
}

__host__ __device__ constexpr int group_width(int mode) {
  return mode == 0 ? kC1 : mode == 1 ? kC2 : mode == 2 ? kC3 : 0;
}

__device__ __forceinline__ void warp_acc(float a, float b, float* row, int C, int c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    row[c] += a;
    row[C + c] += b;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kR) fusion_head_train_kernel(
    const float* __restrict__ x, const float* __restrict__ params,
    const float* __restrict__ stats, float* __restrict__ out, float* __restrict__ partial,
    int G, int F, int P) {
  constexpr int GW = group_width(MODE);
  extern __shared__ float sm[];
  float* prm = sm;                          // kNParam
  float* st = prm + kNParam;                // [F][2][kCS] mean | rstd
  float* accw = st + F * 2 * kCS;           // [kWarps][F][2][GW]
  const int tid = threadIdx.x, warp = tid >> 5;
  for (int e = tid; e < kNParam; e += kR) prm[e] = params[e];
  for (int e = tid; e < F * 2 * kCS; e += kR) st[e] = stats[e];
  for (int e = tid; e < kWarps * F * 2 * GW; e += kR) accw[e] = 0.f;
  __syncthreads();

  const int Bg = G / F;
  const int tiles_per_g = (P + kR - 1) / kR;
  for (int t = blockIdx.x; t < G * tiles_per_g; t += gridDim.x) {
    const int g = t / tiles_per_g;
    const int p = (t - g * tiles_per_g) * kR + tid;
    const bool valid = p < P;
    const int f = g / Bg;
    const float* mean = st + f * 2 * kCS;
    const float* rstd = mean + kCS;
    float* grow = accw + (warp * F + f) * 2 * GW;
    float xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = valid ? x[(static_cast<size_t>(g) * 4 + i) * P + p] : 0.f;

    // layer 1
    float h1[kC1];
#pragma unroll
    for (int o = 0; o < kC1; ++o) {
      float z = prm[OB1 + o];
#pragma unroll
      for (int i = 0; i < 4; ++i) z = fmaf(xv[i], prm[OW1 + i * kC1 + o], z);
      if (MODE == 0) {
        const float zv = valid ? z : 0.f;
        warp_acc(zv, zv * zv, grow, GW, o);
      }
      const float zh = (z - mean[o]) * rstd[o];
      h1[o] = fmaxf(fmaf(prm[OG1 + o], zh, prm[OE1 + o]), 0.f);
    }
    if (MODE == 0) continue;

    // layer 2
    float h2[kC2];
#pragma unroll
    for (int o = 0; o < kC2; ++o) {
      float z = prm[OB2 + o];
#pragma unroll
      for (int i = 0; i < kC1; ++i) z = fmaf(h1[i], prm[OW2 + i * kC2 + o], z);
      if (MODE == 1) {
        const float zv = valid ? z : 0.f;
        warp_acc(zv, zv * zv, grow, GW, o);
      }
      const float zh = (z - mean[kC1 + o]) * rstd[kC1 + o];
      h2[o] = fmaxf(fmaf(prm[OG2 + o], zh, prm[OE2 + o]), 0.f);
    }
    if (MODE == 1) continue;

    // layer 3: its group sums (sweep 2) or the channel max (sweep 3)
    float mx = -1.f;
    for (int o = 0; o < kC3; ++o) {
      float z = prm[OB3 + o];
#pragma unroll
      for (int i = 0; i < kC2; ++i) z = fmaf(h2[i], prm[OW3 + i * kC3 + o], z);
      if (MODE == 2) {
        const float zv = valid ? z : 0.f;
        warp_acc(zv, zv * zv, grow, GW, o);
        continue;
      }
      const float zh = (z - mean[kC1 + kC2 + o]) * rstd[kC1 + kC2 + o];
      mx = fmaxf(mx, fmaxf(fmaf(prm[OG3 + o], zh, prm[OE3 + o]), 0.f));
    }
    if (MODE == 3 && valid) out[static_cast<size_t>(g) * P + p] = mx;
  }

  // this block's partial of the group sums (F, 2, GW)
  __syncthreads();
  float* pb = partial + static_cast<size_t>(blockIdx.x) * red_size(MODE, F);
  for (int e = tid; e < F * 2 * GW; e += kR) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += accw[w * F * 2 * GW + e];
    pb[e] = s;
  }
}

template <int MODE>
cudaError_t launch_sweep(const float* x, const float* params, const float* stats, float* out,
                         float* partial, float* red, int G, int F, int P, int nblk,
                         cudaStream_t st) {
  const size_t floats = kNParam + 2 * static_cast<size_t>(F) * kCS +
                        static_cast<size_t>(kWarps) * F * 2 * group_width(MODE);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = mocopci::allow_smem(fusion_head_train_kernel<MODE>, smem);
  if (err != cudaSuccess) return err;
  fusion_head_train_kernel<MODE><<<nblk, kR, smem, st>>>(x, params, stats, out, partial, G, F, P);
  MOCOPCI_CHECK_LAUNCH();
  const int E = red_size(MODE, F);
  return E > 0 ? mocopci::reduce_partials(partial, red, nblk, E, st) : cudaSuccess;
}

}  // namespace
