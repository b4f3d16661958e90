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
// against 16 bytes of HBM per pair and sweep.  Design: the products on the
// warpgroup tensor-core instruction (wgmma m64nNk8, TF32) at float32 grade
// (3xTF32: hi and lo parts, three products a k-step; mma_tf32.cuh).  A
// warpgroup owns 64 pairs, the M of the product, each warp 16 of them; two
// warpgroups a block, one block per SM, a fixed grid of blocks striding over
// tiles of 128 pairs.  W2 and W3 are the B operands: split once per block
// into hi and lo planes in shared memory, K-major in 128-byte core
// matrices.  Layer 1 (K = 4) runs on FMAs.  An activation stays in
// registers as accumulator fragments: n-tile ks of it is the next product's
// A fragment of k-step ks with its channels taken in the order (2 tig,
// 2 tig + 1) of the fragment, so the B planes hold W's rows in that order
// and no shuffle moves the activation.  BN, ReLU and the channel max run on
// the fragments.  Each thread keeps its columns' (sum z, sum z^2) in registers
// while the block's tiles stay in one group, and adds them into per-warp
// shared rows (shuffles over lane bits 2-4) when the group changes; the
// warps' rows, then the blocks' partials (a second kernel) are summed in a
// fixed order, so the result repeats bit for bit.
#include "fusion_head_train.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kFWarps = 8;              // two warpgroups
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFTile = 16 * kFWarps;    // pairs per block step
// a B plane of K = 64 input channels: 16 core matrices along K, 128 bytes
// each, then the next 8 output channels
constexpr uint32_t kLbo = 128, kSbo = 16 * 128;

// floats of the split weights a sweep needs: none, W2, or W2 and W3 (hi and
// lo planes each)
__host__ __device__ constexpr int fwd_weight_floats(int mode) {
  return mode == 0 ? 0 : mode == 1 ? 2 * kC1 * kC2 : 2 * (kC1 * kC2 + kC2 * kC3);
}

// float offset in a B plane of weight W[c][n] (input channel c, output n):
// k-step c / 8 holds channel 8 ks + 2 j at its k = j and 8 ks + 2 j + 1 at
// k = 4 + j (the A fragments' order)
__device__ __forceinline__ int b_offset(int c, int n) {
  const int q = c & 7, k = (c & ~7) + ((q & 1) << 2) + (q >> 1);
  return (n >> 3) * (kSbo / 4) + (k >> 2) * (kLbo / 4) + (n & 7) * 4 + (k & 3);
}

// the width of a sweep's per-group sums, and floats of its reduction (its
// block partial and its result)
__host__ __device__ constexpr int group_width(int mode) {
  return mode == 0 ? kC1 : mode == 1 ? kC2 : mode == 2 ? kC3 : 0;
}

__host__ __device__ constexpr int red_size(int mode, int F) { return F * 2 * group_width(mode); }

// acc[NT] += H W over 64 channels for the warpgroup's 64 rows: H held as
// accumulator fragments h[ks][4] (c0 (gid, 2 tig), c1 (gid, 2 tig + 1), c2,
// c3 the same at gid + 8).  K-step ks takes n-tile ks of H as its A fragment
// with the columns tig, tig + 4 standing for channels 8 ks + 2 tig, + 1
// (b_offset); whi, wlo describe W's hi and lo planes.  Three products a
// k-step, the two small terms first.
template <int NT>
__device__ __forceinline__ void product(const float (&h)[kC1 / 8][4], uint64_t whi,
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

    // layer 1 on FMAs, in accumulator layout (element q: row q / 2, column
    // nt * 8 + 2 tig + q % 2)
    float h1[kC1 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC1 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = nt * 8 + 2 * tig + (q & 1);
        float z = vec[OB1 + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) z = fmaf(xv[q >> 1][i], vec[OW1 + i * kC1 + c], z);
        h1[nt][q] = z;
      }
    if constexpr (MODE == 0) {
      sum_rows(h1, v0, v1, sa, sb);
      continue;
    }
#pragma unroll
    for (int nt = 0; nt < kC1 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = nt * 8 + 2 * tig + (q & 1);
        const float zh = (h1[nt][q] - mean[c]) * rstd[c];
        h1[nt][q] = fmaxf(fmaf(vec[OG1 + c], zh, vec[OE1 + c]), 0.f);
      }

    // layer 2: z2 = h1 W2 + b2
    float h2[kC2 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC2 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) h2[nt][q] = vec[SB2 + nt * 8 + 2 * tig + (q & 1)];
    product(h1, w2hi, w2lo, h2);
    if constexpr (MODE == 1) {
      sum_rows(h2, v0, v1, sa, sb);
      continue;
    }
#pragma unroll
    for (int nt = 0; nt < kC2 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = nt * 8 + 2 * tig + (q & 1);
        const float zh = (h2[nt][q] - mean[kC1 + c]) * rstd[kC1 + c];
        h2[nt][q] = fmaxf(fmaf(vec[SG2 + c], zh, vec[SE2 + c]), 0.f);
      }

    // layer 3: z3 = h2 W3 + b3, its group sums (sweep 2) or the channel max
    float z3[kC3 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC3 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) z3[nt][q] = vec[SB3 + nt * 8 + 2 * tig + (q & 1)];
    product(h2, w3hi, w3lo, z3);
    if constexpr (MODE == 2) {
      sum_rows(z3, v0, v1, sa, sb);
      continue;
    }
    float mx[2] = {-1.f, -1.f};
#pragma unroll
    for (int nt = 0; nt < kC3 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = nt * 8 + 2 * tig + (q & 1), c = kC1 + kC2 + o;
        const float zh = (z3[nt][q] - mean[c]) * rstd[c];
        mx[q >> 1] = fmaxf(mx[q >> 1], fmaxf(fmaf(vec[SG3 + o], zh, vec[SE3 + o]), 0.f));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
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
