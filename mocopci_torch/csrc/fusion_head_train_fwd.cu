// Train fusion head, forward sweeps 0-3, on the tensor cores.
//
// Replaces mocopci_tpu/ops/pallas/fusion_head_train.py: fusion_head_train
// (:319), stats sweeps (pallas_call :356), output sweep (:371).  As there,
// nothing of shape (G, C, P) is stored: every sweep recomputes the layer
// chain from the (G, 4, P) planes.  Sweep k = 0, 1, 2 sums (z, z^2) of layer
// k+1 per group, the layers before it normalised with the statistics already
// found; sweep 3 writes o = max_c h3.
//
// Bound on the H100: operations.  The four sweeps run about 57k flops of
// products per pair (z2 = h1 W2 in sweeps 1-3, z3 = h2 W3 in sweeps 2-3)
// against 16 bytes of HBM per pair and sweep.  Design: the layer chain of
// fusion_head.cuh (layer 1 on FMAs, W2 and W3 on wgmma m64nNk8 at 3xTF32,
// activations kept as accumulator fragments), two warpgroups a block, one
// block per SM, a fixed grid of blocks striding over tiles of 128 pairs; BN,
// ReLU and the channel max run on the fragments.  Each thread keeps its
// columns' (sum z, sum z^2) in registers while the block's tiles stay in one
// group, and adds them into per-warp shared rows (shuffles over lane bits
// 2-4) when the group changes; the warps' rows, then the blocks' partials (a
// second kernel) are summed in a fixed order, so the result repeats bit for
// bit.
#include "fusion_head_train.cuh"

namespace {

// floats of the split weights a sweep needs: none, W2, or W2 and W3 (hi and
// lo planes each)
__host__ __device__ constexpr int fwd_weight_floats(int mode) {
  return mode == 0 ? 0 : mode == 1 ? 2 * kC1 * kC2 : 2 * (kC1 * kC2 + kC2 * kC3);
}

// the width of a sweep's per-group sums, and floats of its reduction (its
// block partial and its result)
__host__ __device__ constexpr int group_width(int mode) {
  return mode == 0 ? kC1 : mode == 1 ? kC2 : mode == 2 ? kC3 : 0;
}

__host__ __device__ constexpr int red_size(int mode, int F) { return F * 2 * group_width(mode); }

// this thread's running (sum z, sum z^2) of columns nt * 8 + 2 tig + e over
// its valid rows
template <int NT>
__device__ __forceinline__ void sum_rows(const float (&z)[NT][4], bool v0, bool v1,
                                         float (&sa)[NT][2], float (&sb)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = v0 ? z[nt][e] : 0.f, b = v1 ? z[nt][2 + e] : 0.f;
      sa[nt][e] += a + b;
      sb[nt][e] += a * a + b * b;
    }
}

template <int MODE>
__global__ void __launch_bounds__(kFThreads, 1) fusion_head_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ params,
    const float* __restrict__ stats, float* __restrict__ out, float* __restrict__ partial,
    int G, int F, int P) {
  constexpr int GW = group_width(MODE);
  constexpr int NS = MODE < 3 ? GW / 8 : 1;   // n-tiles of the summed layer
  extern __shared__ __align__(128) float sm[];
  float* vec = sm;                                                 // kVecAll
  uint32_t* W2s = reinterpret_cast<uint32_t*>(vec + kVecAll);      // hi, lo planes
  uint32_t* W3s = W2s + 2 * kC1 * kC2;                             // hi, lo planes
  float* st = vec + kVecAll + fwd_weight_floats(MODE);             // [F][2][kCS] mean | rstd
  float* accw = st + F * 2 * kCS;                                  // [kFWarps][F][2][GW]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  for (int e = tid; e < kNParam; e += kFThreads) {
    const float p = params[e];
    if (e < OW2) {
      vec[e] = p;
    } else if (e < OB2) {
      if (MODE >= 1) {
        const int o = b_offset((e - OW2) / kC2, (e - OW2) % kC2);
        mocopci::split_tf32(p, W2s[o], W2s[kC1 * kC2 + o]);
      }
    } else if (e < OW3) {
      vec[SB2 + e - OB2] = p;
    } else if (e < OB3) {
      if (MODE >= 2) {
        const int o = b_offset((e - OW3) / kC3, (e - OW3) % kC3);
        mocopci::split_tf32(p, W3s[o], W3s[kC2 * kC3 + o]);
      }
    } else {
      vec[SB3 + e - OB3] = p;
    }
  }
  for (int e = tid; e < F * 2 * kCS; e += kFThreads) st[e] = stats[e];
  for (int e = tid; e < kFWarps * F * 2 * GW; e += kFThreads) accw[e] = 0.f;
  mocopci::fence_async_shared();
  __syncthreads();
  const uint64_t w2hi = mocopci::wgmma_desc(W2s, kLbo, kSbo);
  const uint64_t w2lo = mocopci::wgmma_desc(W2s + kC1 * kC2, kLbo, kSbo);
  const uint64_t w3hi = mocopci::wgmma_desc(W3s, kLbo, kSbo);
  const uint64_t w3lo = mocopci::wgmma_desc(W3s + kC2 * kC3, kLbo, kSbo);

  float sa[NS][2], sb[NS][2];
  auto clear = [&]() {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) sa[nt][0] = sa[nt][1] = sb[nt][0] = sb[nt][1] = 0.f;
  };
  // the running sums into the warp's row of group f
  auto flush = [&](int f) {
    float* row = accw + (warp * F + f) * 2 * GW;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) group_acc(sa[nt][e], sb[nt][e], row, GW, nt * 8 + 2 * tig + e);
    clear();
  };
  clear();
  int cur = -1;   // the group of the running sums (the tiles walk the groups in order)

  const int Bg = G / F;
  const int tiles_per_g = (P + kFTile - 1) / kFTile;
  for (int t = blockIdx.x; t < G * tiles_per_g; t += gridDim.x) {
    const int g = t / tiles_per_g;
    const int p0 = (t - g * tiles_per_g) * kFTile + warp * 16 + gid;   // rows p0, p0 + 8
    const bool v0 = p0 < P, v1 = p0 + 8 < P;
    const int f = g / Bg;
    if (MODE < 3 && f != cur) {
      if (cur >= 0) flush(cur);
      cur = f;
    }
    const float* mean = st + f * 2 * kCS;
    const float* rstd = mean + kCS;
    float xv[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* xg = x + (static_cast<size_t>(g) * 4 + i) * P;
      xv[0][i] = v0 ? xg[p0] : 0.f;
      xv[1][i] = v1 ? xg[p0 + 8] : 0.f;
    }

    float h1[kC1 / 8][4];
    chain_layer1(xv, vec + OW1, vec + OB1, tig, h1);
    if constexpr (MODE == 0) {
      sum_rows(h1, v0, v1, sa, sb);
      continue;
    }
    chain_activate(h1, tig, [&](int c, float z) {
      const float zh = (z - mean[c]) * rstd[c];
      return fmaxf(fmaf(vec[OG1 + c], zh, vec[OE1 + c]), 0.f);
    });

    // layer 2: z2 = h1 W2 + b2
    float h2[kC2 / 8][4];
    chain_bias(vec + SB2, tig, h2);
    chain_product(h1, w2hi, w2lo, h2);
    if constexpr (MODE == 1) {
      sum_rows(h2, v0, v1, sa, sb);
      continue;
    }
    chain_activate(h2, tig, [&](int c, float z) {
      const float zh = (z - mean[kC1 + c]) * rstd[kC1 + c];
      return fmaxf(fmaf(vec[SG2 + c], zh, vec[SE2 + c]), 0.f);
    });

    // layer 3: z3 = h2 W3 + b3, its group sums (sweep 2) or the channel max
    float z3[kC3 / 8][4];
    chain_bias(vec + SB3, tig, z3);
    chain_product(h2, w3hi, w3lo, z3);
    if constexpr (MODE == 2) {
      sum_rows(z3, v0, v1, sa, sb);
      continue;
    }
    float mx[2];
    chain_channel_max(z3, tig, [&](int o, float z) {
      const int c = kC1 + kC2 + o;
      const float zh = (z - mean[c]) * rstd[c];
      return fmaxf(fmaf(vec[SG3 + o], zh, vec[SE3 + o]), 0.f);
    }, mx);
    if (tig == 0) {
      if (v0) out[static_cast<size_t>(g) * P + p0] = mx[0];
      if (v1) out[static_cast<size_t>(g) * P + p0 + 8] = mx[1];
    }
  }
  if (MODE < 3 && cur >= 0) flush(cur);

  // this block's partial of the group sums (F, 2, GW), the warps in order
  __syncthreads();
  float* pb = partial + static_cast<size_t>(blockIdx.x) * red_size(MODE, F);
  for (int e = tid; e < F * 2 * GW; e += kFThreads) {
    float s = 0.f;
    for (int w = 0; w < kFWarps; ++w) s += accw[w * F * 2 * GW + e];
    pb[e] = s;
  }
}

template <int MODE>
cudaError_t launch_sweep(const float* x, const float* params, const float* stats, float* out,
                         float* partial, float* red, int G, int F, int P, int nblk,
                         cudaStream_t st) {
  const size_t floats = kVecAll + fwd_weight_floats(MODE) + 2 * static_cast<size_t>(F) * kCS +
                        static_cast<size_t>(kFWarps) * F * 2 * group_width(MODE);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = mocopci::allow_smem(fusion_head_fwd_kernel<MODE>, smem);
  if (err != cudaSuccess) return err;
  fusion_head_fwd_kernel<MODE><<<nblk, kFThreads, smem, st>>>(x, params, stats, out, partial, G,
                                                             F, P);
  MOCOPCI_CHECK_LAUNCH();
  const int E = red_size(MODE, F);
  return E > 0 ? mocopci::reduce_partials(partial, red, nblk, E, st) : cudaSuccess;
}

}  // namespace

// One forward sweep.  x (G, 4, P) planes, G = F groups x Bg frame-major;
// params: the 13312 packed floats of fusion_head_train.cuh; stats (F, 2, 256)
// [mean | rstd] of the layers normalised so far.  Sweeps 0-2 write the
// group sums (sum z, sum z^2) of layer 1-3 to red; sweep 3 writes o (G, P) to
// out.  partial: nblk * red_size floats of scratch.
MOCOPCI_API int mocopci_fusion_head_train_fwd(const float* x, const float* params,
                                              const float* stats, float* out, float* partial,
                                              float* red, int mode, int G, int F, int P,
                                              int nblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_sweep<0>(x, params, stats, out, partial, red, G, F, P, nblk, st);
    case 1: return launch_sweep<1>(x, params, stats, out, partial, red, G, F, P, nblk, st);
    case 2: return launch_sweep<2>(x, params, stats, out, partial, red, G, F, P, nblk, st);
    case 3: return launch_sweep<3>(x, params, stats, out, partial, red, G, F, P, nblk, st);
    default: return cudaErrorInvalidValue;
  }
}
