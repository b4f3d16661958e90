// Train-mode fusion head: per pair p the MLP 4 -> 64 -> 64 -> 128, each layer
// followed by BatchNorm with batch statistics per frame group (eps 1e-3) and
// ReLU, then the max over the 128 channels; and its backward.
//
// Replaces mocopci_tpu/ops/pallas/fusion_head_train.py: fusion_head_train
// (:319), stats sweeps (pallas_call :356), output sweep (:371), backward
// sweeps (:408).  As there, nothing of shape (G, C, P) is stored: every sweep
// recomputes the layer chain from the (G, 4, P) planes.
//   forward   sweep k = 0, 1, 2 sums (z, z^2) of layer k+1 per group, the
//             layers before it normalised with the statistics already found;
//             sweep 3 writes o = max_c h3.
//   backward  sweep 4 sums (dpre3, dpre3*zh3) per group (dpre = the gradient
//             at the BN output, before ReLU); sweep 5 uses them for dz3 and
//             sums layer 2's pair plus dW3, db3; sweep 6 likewise for layer 1
//             plus dW2, db2; sweep 7 writes dx and sums dW1, db1.  Channel-max
//             ties split the gradient evenly and relu'(0) = 0, as the TPU
//             kernel (and XLA's reduce-max gradient).
//
// Bound on the H100: operations, about 2 * 12.5k flops per pair for each
// full-chain recompute (8 sweeps, ~6.5 full chains, plus the weight-gradient
// products) against 16-32 bytes of HBM per pair and sweep.  Design: one
// thread per pair, 128 pairs (one tile) per block step, a fixed grid of
// blocks striding over the tiles.  Weights and the group statistics sit in
// shared memory (77 KB in a forward sweep, two blocks per SM; the backward's
// tiles bring it to 210 KB, one block); each thread keeps its pair's 64-wide
// vectors in registers.
// Per-group sums reduce over a warp by shuffles into per-warp shared rows;
// weight gradients are tile products through shared memory, one owner thread
// per element.  Block partials are summed in block order by a second kernel,
// so every sum has a fixed order and the result repeats bit for bit.  Plain
// FMAs, no tensor cores.
#pragma once

#include "common.cuh"

namespace {

constexpr int kR = 128;        // pairs per tile = threads per block
constexpr int kWarps = kR / 32;
constexpr int kLd = kR + 1;    // padded tile row
constexpr int kC1 = 64, kC2 = 64, kC3 = 128;
constexpr int kCS = kC1 + kC2 + kC3;   // per-group stat row: [layer1 | layer2 | layer3]
// packed parameters: W1 b1 g1 e1 W2 b2 g2 e2 W3 b3 g3 e3 (W as (in, out), e = BN beta)
constexpr int OW1 = 0, OB1 = OW1 + 4 * kC1, OG1 = OB1 + kC1, OE1 = OG1 + kC1;
constexpr int OW2 = OE1 + kC1, OB2 = OW2 + kC1 * kC2, OG2 = OB2 + kC2, OE2 = OG2 + kC2;
constexpr int OW3 = OE2 + kC2, OB3 = OW3 + kC2 * kC3, OG3 = OB3 + kC3, OE3 = OG3 + kC3;
constexpr int kNParam = OE3 + kC3;

// floats of the per-block reduction for a sweep (its partial and its result)
__host__ __device__ constexpr int red_size(int mode, int F) {
  return mode == 0 ? F * 2 * kC1
       : mode == 1 ? F * 2 * kC2
       : mode == 2 ? F * 2 * kC3
       : mode == 3 ? 0
       : mode == 4 ? F * 2 * kC3
       : mode == 5 ? F * 2 * kC2 + kC2 * kC3 + kC3
       : mode == 6 ? F * 2 * kC1 + kC1 * kC2 + kC2
                   : 4 * kC1 + kC1;
}

// width of the per-group sums of a sweep (0: none)
__host__ __device__ constexpr int group_width(int mode) {
  return mode == 0 ? kC1 : mode == 1 ? kC2 : mode == 2 ? kC3 : mode == 4 ? kC3
       : mode == 5 ? kC2 : mode == 6 ? kC1 : 0;
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

// dW[i][o] += sum_r A[i][r] * Bt[o][r], db[o] += sum_r Bt[o][r]; A [Cin][kLd],
// Bt [Cout][kLd]; element (i, o) owned by thread o % kR.
__device__ void tile_gemm(const float* A, int Cin, const float* Bt, int Cout, float* dW,
                          float* db) {
  for (int o = threadIdx.x; o < Cout; o += kR) {
    const float* b = Bt + o * kLd;
    for (int i0 = 0; i0 < Cin; i0 += 16) {
      float acc[16];
#pragma unroll
      for (int ii = 0; ii < 16; ++ii) acc[ii] = 0.f;
      for (int r = 0; r < kR; ++r) {
        const float bv = b[r];
#pragma unroll
        for (int ii = 0; ii < 16; ++ii)
          if (i0 + ii < Cin) acc[ii] = fmaf(A[(i0 + ii) * kLd + r], bv, acc[ii]);
      }
#pragma unroll
      for (int ii = 0; ii < 16; ++ii)
        if (i0 + ii < Cin) dW[(i0 + ii) * Cout + o] += acc[ii];
    }
    float s = 0.f;
    for (int r = 0; r < kR; ++r) s += b[r];
    db[o] += s;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kR) fusion_head_train_kernel(
    const float* __restrict__ x, const float* __restrict__ params,
    const float* __restrict__ stats, const float* __restrict__ bsum,
    const float* __restrict__ dout, float* __restrict__ out, float* __restrict__ partial,
    int G, int F, int P, float inv_s) {
  constexpr int GW = group_width(MODE);
  extern __shared__ float sm[];
  float* prm = sm;                          // kNParam
  float* st = prm + kNParam;                // [F][2][kCS] mean | rstd
  float* bs = st + F * 2 * kCS;             // [F][2][kCS] Sa | Sb
  float* accw = bs + F * 2 * kCS;           // [kWarps][F][2][GW]
  // the rest only in the sweeps that use it (see launch_sweep)
  float* T0 = accw + kWarps * F * 2 * kC3;  // [kC3][kLd] z3, then dz3 / dz2 / dz1
  float* T1 = T0 + kC3 * kLd;               // [kC2][kLd] h2 / h1 / x
  float* dwa = T1 + kC2 * kLd;              // weight-gradient accumulators
  const int tid = threadIdx.x, warp = tid >> 5;
  for (int e = tid; e < kNParam; e += kR) prm[e] = params[e];
  for (int e = tid; e < F * 2 * kCS; e += kR) {
    st[e] = stats[e];
    bs[e] = MODE >= 5 ? bsum[e] : 0.f;
  }
  for (int e = tid; e < kWarps * F * 2 * kC3; e += kR) accw[e] = 0.f;
  if (MODE >= 5)
    for (int e = tid; e < kC2 * kC3 + kC3; e += kR) dwa[e] = 0.f;
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
    const float* Sa = bs + f * 2 * kCS;
    const float* Sb = Sa + kCS;
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
    float h2[kC2], zh2[kC2];
#pragma unroll
    for (int o = 0; o < kC2; ++o) {
      float z = prm[OB2 + o];
#pragma unroll
      for (int i = 0; i < kC1; ++i) z = fmaf(h1[i], prm[OW2 + i * kC2 + o], z);
      if (MODE == 1) {
        const float zv = valid ? z : 0.f;
        warp_acc(zv, zv * zv, grow, GW, o);
      }
      zh2[o] = (z - mean[kC1 + o]) * rstd[kC1 + o];
      h2[o] = fmaxf(fmaf(prm[OG2 + o], zh2[o], prm[OE2 + o]), 0.f);
    }
    if (MODE == 1) continue;
    if (MODE == 5) {
#pragma unroll
      for (int i = 0; i < kC2; ++i) T1[i * kLd + tid] = valid ? h2[i] : 0.f;
    }

    // layer 3, pass A: z3 (kept in T0), the channel max and its multiplicity
    float mx = -1.f;
    int cnt = 0;
    for (int o = 0; o < kC3; ++o) {
      float z = prm[OB3 + o];
#pragma unroll
      for (int i = 0; i < kC2; ++i) z = fmaf(h2[i], prm[OW3 + i * kC3 + o], z);
      if (MODE == 2) {
        const float zv = valid ? z : 0.f;
        warp_acc(zv, zv * zv, grow, GW, o);
        continue;
      }
      if (MODE >= 4) T0[o * kLd + tid] = z;
      const float zh = (z - mean[kC1 + kC2 + o]) * rstd[kC1 + kC2 + o];
      const float h = fmaxf(fmaf(prm[OG3 + o], zh, prm[OE3 + o]), 0.f);
      if (h > mx) {
        mx = h;
        cnt = 1;
      } else if (h == mx) {
        ++cnt;
      }
    }
    if (MODE == 2) continue;
    if (MODE == 3) {
      if (valid) out[static_cast<size_t>(g) * P + p] = mx;
      continue;
    }

    // layer 3, pass B: dpre3, its group sums (sweep 4) or dz3 and dh2
    const float d = valid ? dout[static_cast<size_t>(g) * P + p] / static_cast<float>(cnt) : 0.f;
    float dh2[kC2];
#pragma unroll
    for (int i = 0; i < kC2; ++i) dh2[i] = 0.f;
    for (int o = 0; o < kC3; ++o) {
      const int c = kC1 + kC2 + o;
      const float z = T0[o * kLd + tid];
      const float zh = (z - mean[c]) * rstd[c];
      const float pre = fmaf(prm[OG3 + o], zh, prm[OE3 + o]);
      const float h = fmaxf(pre, 0.f);
      const float dpre = (h == mx && pre > 0.f) ? d : 0.f;
      if (MODE == 4) {
        warp_acc(dpre, dpre * zh, grow, GW, o);
        continue;
      }
      const float dz =
          valid ? rstd[c] * (dpre * prm[OG3 + o] - (Sa[c] + zh * Sb[c]) * inv_s) : 0.f;
      T0[o * kLd + tid] = dz;
#pragma unroll
      for (int i = 0; i < kC2; ++i) dh2[i] = fmaf(prm[OW3 + i * kC3 + o], dz, dh2[i]);
    }
    if (MODE == 4) continue;

    // layer 2 backward
    float dh1[kC1];
#pragma unroll
    for (int k = 0; k < kC1; ++k) dh1[k] = 0.f;
#pragma unroll
    for (int i = 0; i < kC2; ++i) {
      const int c = kC1 + i;
      const float pre = fmaf(prm[OG2 + i], zh2[i], prm[OE2 + i]);
      const float dpre = pre > 0.f ? dh2[i] : 0.f;
      if (MODE == 5) {
        warp_acc(dpre, dpre * zh2[i], grow, GW, i);
      } else {
        const float dz =
            valid ? rstd[c] * (dpre * prm[OG2 + i] - (Sa[c] + zh2[i] * Sb[c]) * inv_s) : 0.f;
        if (MODE == 6) T0[i * kLd + tid] = dz;
#pragma unroll
        for (int k = 0; k < kC1; ++k) dh1[k] = fmaf(prm[OW2 + k * kC2 + i], dz, dh1[k]);
      }
    }
    if (MODE == 5) {
      __syncthreads();
      tile_gemm(T1, kC2, T0, kC3, dwa, dwa + kC2 * kC3);
      __syncthreads();
      continue;
    }

    // layer 1 backward (z1 recomputed from x)
    float dx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kC1; ++k) {
      float z = prm[OB1 + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) z = fmaf(xv[i], prm[OW1 + i * kC1 + k], z);
      const float zh = (z - mean[k]) * rstd[k];
      const float pre = fmaf(prm[OG1 + k], zh, prm[OE1 + k]);
      const float dpre = pre > 0.f ? dh1[k] : 0.f;
      if (MODE == 6) {
        warp_acc(dpre, dpre * zh, grow, GW, k);
        T1[k * kLd + tid] = valid ? fmaxf(pre, 0.f) : 0.f;
      } else {
        const float dz =
            valid ? rstd[k] * (dpre * prm[OG1 + k] - (Sa[k] + zh * Sb[k]) * inv_s) : 0.f;
        T0[k * kLd + tid] = dz;
#pragma unroll
        for (int i = 0; i < 4; ++i) dx[i] = fmaf(prm[OW1 + i * kC1 + k], dz, dx[i]);
      }
    }
    if (MODE == 6) {
      __syncthreads();
      tile_gemm(T1, kC1, T0, kC2, dwa, dwa + kC1 * kC2);
      __syncthreads();
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      T1[i * kLd + tid] = xv[i];
      if (valid) out[(static_cast<size_t>(g) * 4 + i) * P + p] = dx[i];
    }
    __syncthreads();
    tile_gemm(T1, 4, T0, kC1, dwa, dwa + 4 * kC1);
    __syncthreads();
  }

  // this block's partial: [group sums (F, 2, GW) | dW | db]
  __syncthreads();
  float* pb = partial + static_cast<size_t>(blockIdx.x) * red_size(MODE, F);
  int off = 0;
  if (GW > 0) {
    for (int e = tid; e < F * 2 * GW; e += kR) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += accw[w * F * 2 * GW + e];
      pb[e] = s;
    }
    off = F * 2 * GW;
  }
  const int nw = red_size(MODE, F) - off;
  for (int e = tid; e < nw; e += kR) pb[off + e] = dwa[e];
}

template <int MODE>
cudaError_t launch_sweep(const float* x, const float* params, const float* stats,
                         const float* bsum, const float* dout, float* out, float* partial,
                         float* red, int G, int F, int P, int nblk, cudaStream_t st) {
  // the forward sweeps need no tiles: 77 KB, two blocks per SM; the backward
  // sweeps the z3 / dz tile (sweep 4) and the second tile with the weight
  // gradients (sweeps 5-7), up to 210 KB
  const size_t floats = kNParam + 4 * static_cast<size_t>(F) * kCS +
                        static_cast<size_t>(kWarps) * F * 2 * kC3 +
                        (MODE >= 4 ? kC3 * static_cast<size_t>(kLd) : 0) +
                        (MODE >= 5 ? kC2 * static_cast<size_t>(kLd) + kC2 * kC3 + kC3 : 0);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = mocopci::allow_smem(fusion_head_train_kernel<MODE>, smem);
  if (err != cudaSuccess) return err;
  const float inv_s = 1.f / (static_cast<float>(G / F) * static_cast<float>(P));
  fusion_head_train_kernel<MODE><<<nblk, kR, smem, st>>>(x, params, stats, bsum, dout, out,
                                                        partial, G, F, P, inv_s);
  MOCOPCI_CHECK_LAUNCH();
  const int E = red_size(MODE, F);
  return E > 0 ? mocopci::reduce_partials(partial, red, nblk, E, st) : cudaSuccess;
}

}  // namespace
