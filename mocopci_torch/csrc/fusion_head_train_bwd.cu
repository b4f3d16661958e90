// Train fusion head, backward sweeps 4-7, on the tensor cores.
//
// Replaces the backward sweeps of mocopci_tpu/ops/pallas/fusion_head_train.py
// (pallas_call :408).  Per pair the MLP 4 -> 64 -> 64 -> 128 (BatchNorm with
// the forward's per-group statistics, ReLU, the max over the 128 channels) is
// recomputed from the (G, 4, P) planes in every sweep, as on the TPU:
//   sweep 4 sums (dpre3, dpre3 * zh3) per group (dpre = the gradient at the BN
//           output, before ReLU); sweep 5 uses them for dz3 and sums layer 2's
//           pair plus dW3, db3; sweep 6 likewise for layer 1 plus dW2, db2;
//           sweep 7 writes dx and sums dW1, db1.  Channel-max ties split the
//           gradient evenly and relu'(0) = 0, as the TPU kernel.
//
// Bound on the H100: operations.  The VJP from x needs one forward chain and
// two products per layer, about 3 x 25k flops per pair; the four sweeps
// recompute the chain, so they run about 1.9e5 flops of products per pair,
// at float32 grade.  Design: mma.sync m16n8k8 TF32 with each operand split
// into TF32 parts (mma_tf32.cuh).  Sweep 4 runs the forward chain in 6xTF32
// (an exact three-part split, each k-step summed apart and added to the
// accumulator once), so that the routing it decides (the layer-2 ReLU kinks,
// the channel max and its ties) agrees with a float32 chain's, and stores it
// per pair (32 bytes); sweeps 5-7 recompute the chain's values in 3xTF32 (hi
// and lo parts, three products per step), as the backward products, and take
// the routing from sweep 4.  A warp owns 16 pairs, the M of
// the product: z2 = h1 W2, z3 = h2 W3, dh2 = dz3 W3^T and dh1 = dz2 W2^T run
// with the weights as B fragments from shared memory (rows padded so a
// fragment's lanes spread over the banks; split once per block into TF32
// parts, three planes in sweep 4 and (hi, lo) pairs in sweeps 5-7, so no
// weight is split per use); BN, ReLU, the
// channel max with its tie count and dpre run on the accumulator fragments,
// and an accumulator becomes the next product's A fragment by shuffles within
// its quad.  The per-group sums reduce over the fragment's rows (shuffles over
// lane bits 2-4) into per-warp shared rows.  The weight gradients dW3 = h2^T
// dz3 and dW2 = h1^T dz2 are block products over each 128-pair tile (the pair
// tiles staged in shared memory, dz3 in two halves of 64 channels), each warp
// keeping a 16 x 32 slice of each in registers across all of its tiles; dW1
// (4 x 64) stays on FMAs.  8 warps per block, one block per SM (at most 200
// KB of shared memory at three groups, 255 registers a thread); a fixed grid
// of blocks strides over the tiles and the block partials are summed in block
// order, so the result repeats bit for bit.
#include <type_traits>

#include "fusion_head_train.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kBWarps = 8;
constexpr int kBThreads = 32 * kBWarps;
constexpr int kTile = 16 * kBWarps;     // pairs per block step
constexpr int kLdT = 64 + 8;            // pair-tile row (floats)
constexpr int kLdW2 = kC2 + 8;          // sweep 4: hi, mid, lo TF32 planes, padded
constexpr int kLdW3 = kC3 + 8;
constexpr int kPlane = kC1 * kLdW2 + kC2 * kLdW3;
constexpr int kLdS2 = kC2 + 4;          // sweeps 5-7: (hi, lo) TF32 pairs, padded
constexpr int kLdS3 = kC3 + 4;

// words of the shared weights, split once per block into TF32 parts: three
// planes in sweep 4, (hi, lo) pairs in sweeps 5-7
__host__ __device__ constexpr int weight_floats(int mode) {
  return mode == 4 ? 3 * kPlane : 2 * (kC1 * kLdS2 + kC2 * kLdS3);
}

__host__ __device__ constexpr int bwd_width(int mode) {
  return mode == 4 ? kC3 : mode == 5 ? kC2 : mode == 6 ? kC1 : 0;
}

__host__ __device__ constexpr int bwd_red_size(int mode, int F) {
  return mode == 4 ? F * 2 * kC3
       : mode == 5 ? F * 2 * kC2 + kC2 * kC3 + kC3
       : mode == 6 ? F * 2 * kC1 + kC1 * kC2 + kC2
                   : 4 * kC1 + kC1;
}

// The A fragment of k-step ks of a 16-row activation held as accumulator
// fragments c[n-tile][4]: column tig (tig + 4) of n-tile ks sits in quad lane
// tig / 2 (2 + tig / 2), element tig % 2 of its row pair.
__device__ __forceinline__ void c_to_a(const float (&c)[4], float (&a)[4]) {
  const int lane = threadIdx.x & 31, tig = lane & 3, quad = lane & ~3;
  const int s0 = quad | (tig >> 1), s1 = quad | (2 + (tig >> 1));
  const float e0 = __shfl_sync(0xffffffffu, c[0], s0), o0 = __shfl_sync(0xffffffffu, c[1], s0);
  const float e2 = __shfl_sync(0xffffffffu, c[2], s0), o2 = __shfl_sync(0xffffffffu, c[3], s0);
  const float e1 = __shfl_sync(0xffffffffu, c[0], s1), o1 = __shfl_sync(0xffffffffu, c[1], s1);
  const float e3 = __shfl_sync(0xffffffffu, c[2], s1), o3 = __shfl_sync(0xffffffffu, c[3], s1);
  const bool odd = tig & 1;
  a[0] = odd ? o0 : e0;
  a[1] = odd ? o2 : e2;
  a[2] = odd ? o1 : e1;
  a[3] = odd ? o3 : e3;
}

// acc[NT] += A (16 x 8 KS) * W: W [k][n] row-major with row stride ld, or
// read transposed (W^T, W stored [n][k]) when T.  EXACT: W is the hi plane
// of three (hi, mid, lo at kPlane apart), 6xTF32, each k-step's sum added to
// acc apart (sweep 4's forward chain, whose results decide the routing); else
// W holds (hi, lo) TF32 pairs, 3xTF32.
template <int NT, int KS, bool T, bool EXACT, int NA>
__device__ __forceinline__ void product(const float (&a)[NA][4], const float* W, int ld,
                                        float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const uint2* Ws = reinterpret_cast<const uint2*>(W);
  const uint32_t* Wp = reinterpret_cast<const uint32_t*>(W);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    float av[4];
    c_to_a(a[ks], av);
    using FA = typename std::conditional<EXACT, mocopci::FragA3, mocopci::FragA>::type;
    using FB = typename std::conditional<EXACT, mocopci::FragB3, mocopci::FragB>::type;
    FA fa;
    fa.set(av);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int k = ks * 8 + tig, n = nt * 8 + gid;
      const int i0 = T ? n * ld + k : k * ld + n;
      const int i1 = T ? i0 + 4 : i0 + 4 * ld;
      FB fb;
      if constexpr (EXACT) {
        fb.hi[0] = Wp[i0];
        fb.hi[1] = Wp[i1];
        fb.mid[0] = Wp[kPlane + i0];
        fb.mid[1] = Wp[kPlane + i1];
        fb.lo[0] = Wp[2 * kPlane + i0];
        fb.lo[1] = Wp[2 * kPlane + i1];
      } else {
        const uint2 b0 = Ws[i0], b1 = Ws[i1];
        fb.hi[0] = b0.x;
        fb.lo[0] = b0.y;
        fb.hi[1] = b1.x;
        fb.lo[1] = b1.y;
      }
      if constexpr (EXACT) {
        // the k-step's sum apart, then one round-to-nearest add into acc,
        // rather than six roundings of acc by the tensor cores' own adder
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mocopci::mma_6xtf32(t, fa, fb);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += t[i];
      } else {
        mocopci::mma_3xtf32(acc[nt], fa, fb);
      }
    }
  }
}

// acc[OFF + nt] += A^T B over the kTile pairs of a tile: A [pair][kLdT] with
// the 16 columns from m0, B [pair][kLdT] with NT n-tiles from column n0.  The
// tile's product is summed apart and added to acc once (round to nearest), so
// the accumulators of a block's many tiles do not drift with the tensor
// cores' own rounding.
template <int NT, int OFF, int NACC>
__device__ __forceinline__ void tile_product(const float* A, const float* B, int m0, int n0,
                                             float (&acc)[NACC][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float t[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) t[nt][0] = t[nt][1] = t[nt][2] = t[nt][3] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < kTile / 8; ++ks) {
    const float* a = A + (ks * 8 + tig) * kLdT + m0 + gid;
    mocopci::FragA fa;
    fa.set({a[0], a[8], a[4 * kLdT], a[4 * kLdT + 8]});
    const float* b = B + (ks * 8 + tig) * kLdT + n0 + gid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mocopci::FragB fb;
      fb.set(b[nt * 8], b[4 * kLdT + nt * 8]);
      mocopci::mma_3xtf32(t[nt], fa, fb);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[OFF + nt][i] += t[nt][i];
}

// Store n-tiles [NT0, NT0 + NT) of this warp's 16 rows to the pair tile T
// (columns from 0); rows past P as 0.
template <int NT0, int NT, int NC>
__device__ __forceinline__ void stage_rows(float* T, const float (&c)[NC][4], bool v0, bool v1) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float* r0 = T + ((threadIdx.x >> 5) * 16 + gid) * kLdT + 2 * tig;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* q = c[NT0 + nt];
    *reinterpret_cast<float2*>(r0 + nt * 8) = v0 ? make_float2(q[0], q[1]) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(r0 + 8 * kLdT + nt * 8) =
        v1 ? make_float2(q[2], q[3]) : make_float2(0.f, 0.f);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kBThreads, 1) fusion_head_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ params,
    const float* __restrict__ stats, const float* __restrict__ bsum,
    const float* __restrict__ dout, uint32_t* __restrict__ route, float* __restrict__ out,
    float* __restrict__ partial, int G, int F, int P, float inv_s) {
  constexpr int GW = bwd_width(MODE);
  constexpr bool kRoute = MODE == 4;   // this sweep decides the routing
  extern __shared__ float sm[];
  constexpr int LD2 = MODE == 4 ? kLdW2 : kLdS2, LD3 = MODE == 4 ? kLdW3 : kLdS3;
  constexpr int kW = MODE == 4 ? 1 : 2;       // words per weight in a plane
  float* vec = sm;                            // kVecAll
  float* W2s = vec + kVecAll;                 // [kC1][LD2] weights
  float* W3s = W2s + kW * kC1 * LD2;          // [kC2][LD3]
  float* st = vec + kVecAll + weight_floats(MODE);   // [F][2][kCS] mean | rstd
  float* bs = st + F * 2 * kCS;               // [F][2][kCS] Sa | Sb
  float* accw = bs + F * 2 * kCS;             // [kBWarps][F][2][GW]
  float* T0 = accw + kBWarps * F * 2 * GW;    // [kTile][kLdT] dz (sweeps 5-7)
  float* T1 = T0 + kTile * kLdT;              // [kTile][kLdT] h2 / h1 / x
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // a weight split once into TF32 parts: hi, mid, lo planes (sweep 4) or a
  // (hi, lo) pair
  auto put = [&](float* W, int idx, float p) {
    if constexpr (MODE == 4) {
      uint32_t* Wp = reinterpret_cast<uint32_t*>(W);
      mocopci::split3_tf32(p, Wp[idx], Wp[kPlane + idx], Wp[2 * kPlane + idx]);
    } else {
      uint2 hl;
      mocopci::split_tf32(p, hl.x, hl.y);
      reinterpret_cast<uint2*>(W)[idx] = hl;
    }
  };
  for (int e = tid; e < kNParam; e += kBThreads) {
    const float p = params[e];
    if (e < OW2) vec[e] = p;
    else if (e < OB2) put(W2s, (e - OW2) / kC2 * LD2 + (e - OW2) % kC2, p);
    else if (e < OW3) vec[SB2 + e - OB2] = p;
    else if (e < OB3) put(W3s, (e - OW3) / kC3 * LD3 + (e - OW3) % kC3, p);
    else vec[SB3 + e - OB3] = p;
  }
  for (int e = tid; e < F * 2 * kCS; e += kBThreads) {
    st[e] = stats[e];
    bs[e] = MODE >= 5 ? bsum[e] : 0.f;
  }
  for (int e = tid; e < kBWarps * F * 2 * GW; e += kBThreads) accw[e] = 0.f;
  __syncthreads();

  // this warp's tiles of the weight gradients, kept across all of its tiles
  // of pairs: rows 16 (warp % 4) of dW, columns 32 (warp / 4) of each 64
  constexpr int NDW = MODE == 5 ? 8 : MODE == 6 ? 4 : 1;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
  float dw[NDW][4];
#pragma unroll
  for (int nt = 0; nt < NDW; ++nt) dw[nt][0] = dw[nt][1] = dw[nt][2] = dw[nt][3] = 0.f;
  float db[2] = {0.f, 0.f};          // bias gradients of columns tid (and 64 + tid)
  float dw1 = 0.f;                   // sweep 7: dW1[tid / 64][tid % 64]

  const int Bg = G / F;
  const int tiles_per_g = (P + kTile - 1) / kTile;
  for (int t = blockIdx.x; t < G * tiles_per_g; t += gridDim.x) {
    const int g = t / tiles_per_g;
    const int p0 = (t - g * tiles_per_g) * kTile + warp * 16 + gid;   // rows p0, p0 + 8
    const bool v0 = p0 < P, v1 = p0 + 8 < P;
    const int f = g / Bg;
    const float* mean = st + f * 2 * kCS;
    const float* rstd = mean + kCS;
    const float* Sa = bs + f * 2 * kCS;
    const float* Sb = Sa + kCS;
    float* grow = accw + (warp * F + f) * 2 * GW;
    float xv[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* xg = x + (static_cast<size_t>(g) * 4 + i) * P;
      xv[0][i] = v0 ? xg[p0] : 0.f;
      xv[1][i] = v1 ? xg[p0 + 8] : 0.f;
    }

    // layer 1 on FMAs: z1, zh1 and h1 in accumulator layout (element q: row
    // q / 2, column nt * 8 + 2 tig + q % 2)
    auto layer1 = [&](int nt, int q, float& zh, float& pre) {
      const int c = nt * 8 + 2 * tig + (q & 1);
      float z = vec[OB1 + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) z = fmaf(xv[q >> 1][i], vec[OW1 + i * kC1 + c], z);
      zh = (z - mean[c]) * rstd[c];
      pre = fmaf(vec[OG1 + c], zh, vec[OE1 + c]);
    };
    float h1[kC1 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC1 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float zh, pre;
        layer1(nt, q, zh, pre);
        h1[nt][q] = fmaxf(pre, 0.f);
      }
    if (MODE == 6) stage_rows<0, kC1 / 8>(T1, h1, v0, v1);

    // layer 2: z2 = h1 W2 + b2 -> zh2 (kept), h2
    float zh2[kC2 / 8][4], h2[kC2 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC2 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) zh2[nt][q] = vec[SB2 + nt * 8 + 2 * tig + (q & 1)];
    product<kC2 / 8, kC1 / 8, false, kRoute>(h1, W2s, LD2, zh2);
#pragma unroll
    for (int nt = 0; nt < kC2 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = nt * 8 + 2 * tig + (q & 1);
        zh2[nt][q] = (zh2[nt][q] - mean[kC1 + c]) * rstd[kC1 + c];
        h2[nt][q] = fmaxf(fmaf(vec[SG2 + c], zh2[nt][q], vec[SE2 + c]), 0.f);
      }
    if (MODE == 5) stage_rows<0, kC2 / 8>(T1, h2, v0, v1);

    // layer 3: z3 = h2 W3 + b3, then its normalised zh3
    float z3[kC3 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC3 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) z3[nt][q] = vec[SB3 + nt * 8 + 2 * tig + (q & 1)];
    product<kC3 / 8, kC2 / 8, false, kRoute>(h2, W3s, LD3, z3);
#pragma unroll
    for (int nt = 0; nt < kC3 / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = kC1 + kC2 + nt * 8 + 2 * tig + (q & 1);
        z3[nt][q] = (z3[nt][q] - mean[c]) * rstd[c];            // z3 now holds zh3
      }
    // the routing of each row: bit 2 nt + e of this lane's words marks its
    // column nt * 8 + 2 tig + e: m3 where the channel is a max of h3 with
    // pre3 > 0, m2 where pre2 > 0; cnt = the channels at the max
    uint32_t m3[2] = {0u, 0u}, m2[2] = {0u, 0u};
    int cnt[2] = {0, 0};
    uint32_t* rt = route + (static_cast<size_t>(g) * P + p0) * 8 + tig;   // row p0 + 8: + 64
    if constexpr (kRoute) {
      float mx[2] = {-1.f, -1.f};
#pragma unroll
      for (int nt = 0; nt < kC3 / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = nt * 8 + 2 * tig + (q & 1), r = q >> 1;
          const float h = fmaxf(fmaf(vec[SG3 + o], z3[nt][q], vec[SE3 + o]), 0.f);
          if (h > mx[r]) {
            mx[r] = h;
            cnt[r] = 1;
          } else if (h == mx[r]) {
            ++cnt[r];
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float m = __shfl_xor_sync(0xffffffffu, mx[r], off);
          const int k = __shfl_xor_sync(0xffffffffu, cnt[r], off);
          if (m > mx[r]) {
            mx[r] = m;
            cnt[r] = k;
          } else if (m == mx[r]) {
            cnt[r] += k;
          }
        }
#pragma unroll
      for (int nt = 0; nt < kC3 / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = nt * 8 + 2 * tig + (q & 1), r = q >> 1;
          const float pre = fmaf(vec[SG3 + o], z3[nt][q], vec[SE3 + o]);
          if (fmaxf(pre, 0.f) == mx[r] && pre > 0.f) m3[r] |= 1u << (2 * nt + (q & 1));
        }
#pragma unroll
      for (int nt = 0; nt < kC2 / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = nt * 8 + 2 * tig + (q & 1);
          if (fmaf(vec[SG2 + i], zh2[nt][q], vec[SE2 + i]) > 0.f)
            m2[q >> 1] |= 1u << (2 * nt + (q & 1));
        }
      if (v0) {
        rt[0] = m3[0];
        rt[4] = m2[0] | static_cast<uint32_t>(cnt[0]) << 16;
      }
      if (v1) {
        rt[64] = m3[1];
        rt[68] = m2[1] | static_cast<uint32_t>(cnt[1]) << 16;
      }
    } else {
      if (v0) {
        m3[0] = rt[0];
        m2[0] = rt[4] & 0xffffu;
        cnt[0] = rt[4] >> 16;
      }
      if (v1) {
        m3[1] = rt[64];
        m2[1] = rt[68] & 0xffffu;
        cnt[1] = rt[68] >> 16;
      }
    }
    const float d[2] = {
        v0 ? dout[static_cast<size_t>(g) * P + p0] / static_cast<float>(cnt[0]) : 0.f,
        v1 ? dout[static_cast<size_t>(g) * P + p0 + 8] / static_cast<float>(cnt[1]) : 0.f};

    // layer 3 backward: dpre3, its group sums (sweep 4) or dz3
#pragma unroll
    for (int nt = 0; nt < kC3 / 8; ++nt) {
      float dp[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = nt * 8 + 2 * tig + (q & 1), c = kC1 + kC2 + o;
        const float zh = z3[nt][q];
        dp[q] = (m3[q >> 1] >> (2 * nt + (q & 1))) & 1u ? d[q >> 1] : 0.f;
        if (MODE != 4) {
          const bool v = (q >> 1) ? v1 : v0;
          z3[nt][q] = v ? rstd[c] * (dp[q] * vec[SG3 + o] - (Sa[c] + zh * Sb[c]) * inv_s) : 0.f;
        }
      }
      if (MODE == 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          group_acc(dp[e] + dp[2 + e], dp[e] * z3[nt][e] + dp[2 + e] * z3[nt][2 + e], grow, GW,
                    nt * 8 + 2 * tig + e);
      }
    }
    if constexpr (MODE == 4) continue;

    if constexpr (MODE == 5) {
      // dW3 += h2^T dz3 and db3 over the tile, dz3 staged in two halves
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half == 0)
          stage_rows<0, 8>(T0, z3, v0, v1);
        else
          stage_rows<8, 8>(T0, z3, v0, v1);
        __syncthreads();
        if (half == 0)
          tile_product<4, 0>(T1, T0, wm, wn, dw);
        else
          tile_product<4, 4>(T1, T0, wm, wn, dw);
        if (tid < 64) {
          float s = 0.f;
          for (int r = 0; r < kTile; ++r) s += T0[r * kLdT + tid];
          db[half] += s;
        }
        __syncthreads();
      }
    }

    // layer 2 backward: dh2 = dz3 W3^T, dpre2, its group sums (sweep 5) or dz2
    float dh2[kC2 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC2 / 8; ++nt) dh2[nt][0] = dh2[nt][1] = dh2[nt][2] = dh2[nt][3] = 0.f;
    product<kC2 / 8, kC3 / 8, true, false>(z3, W3s, LD3, dh2);
#pragma unroll
    for (int nt = 0; nt < kC2 / 8; ++nt) {
      float dp[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = nt * 8 + 2 * tig + (q & 1), c = kC1 + i;
        const float zh = zh2[nt][q];
        dp[q] = (m2[q >> 1] >> (2 * nt + (q & 1))) & 1u ? dh2[nt][q] : 0.f;
        if (MODE != 5) {
          const bool v = (q >> 1) ? v1 : v0;
          dh2[nt][q] = v ? rstd[c] * (dp[q] * vec[SG2 + i] - (Sa[c] + zh * Sb[c]) * inv_s) : 0.f;
        }
      }
      if (MODE == 5) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          group_acc(dp[e] + dp[2 + e], dp[e] * zh2[nt][e] + dp[2 + e] * zh2[nt][2 + e], grow, GW,
                    nt * 8 + 2 * tig + e);
      }
    }
    if constexpr (MODE == 5) continue;

    if constexpr (MODE == 6) {
      // dW2 += h1^T dz2 and db2 over the tile
      stage_rows<0, kC2 / 8>(T0, dh2, v0, v1);
      __syncthreads();
      tile_product<4, 0>(T1, T0, wm, wn, dw);
      if (tid < 64) {
        float s = 0.f;
        for (int r = 0; r < kTile; ++r) s += T0[r * kLdT + tid];
        db[0] += s;
      }
      __syncthreads();
    }

    // layer 1 backward: dh1 = dz2 W2^T, dpre1 (z1 recomputed from x), its
    // group sums (sweep 6) or dz1, dx and dW1 (sweep 7)
    float dh1[kC1 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC1 / 8; ++nt) dh1[nt][0] = dh1[nt][1] = dh1[nt][2] = dh1[nt][3] = 0.f;
    product<kC1 / 8, kC2 / 8, true, false>(dh2, W2s, LD2, dh1);
    float dx[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < kC1 / 8; ++nt) {
      float dp[4], zhs[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = nt * 8 + 2 * tig + (q & 1);
        float pre;
        layer1(nt, q, zhs[q], pre);
        dp[q] = pre > 0.f ? dh1[nt][q] : 0.f;
        if (MODE == 7) {
          const bool v = (q >> 1) ? v1 : v0;
          const float dz =
              v ? rstd[k] * (dp[q] * vec[OG1 + k] - (Sa[k] + zhs[q] * Sb[k]) * inv_s) : 0.f;
          dh1[nt][q] = dz;
#pragma unroll
          for (int i = 0; i < 4; ++i) dx[q >> 1][i] = fmaf(vec[OW1 + i * kC1 + k], dz, dx[q >> 1][i]);
        }
      }
      if (MODE == 6) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          group_acc(dp[e] + dp[2 + e], dp[e] * zhs[e] + dp[2 + e] * zhs[2 + e], grow, GW,
                    nt * 8 + 2 * tig + e);
      }
    }
    if constexpr (MODE == 6) continue;

    // sweep 7: dx over the quad's columns, then dW1 = x^T dz1, db1 on FMAs
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dx[r][i] += __shfl_xor_sync(0xffffffffu, dx[r][i], 1);
        dx[r][i] += __shfl_xor_sync(0xffffffffu, dx[r][i], 2);
      }
    if (tig == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* og = out + (static_cast<size_t>(g) * 4 + i) * P;
        if (v0) og[p0] = dx[0][i];
        if (v1) og[p0 + 8] = dx[1][i];
      }
    }
    stage_rows<0, kC1 / 8>(T0, dh1, v0, v1);
    if (tig == 0) {
      float* r0 = T1 + (warp * 16 + gid) * kLdT;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        r0[i] = xv[0][i];
        r0[8 * kLdT + i] = xv[1][i];
      }
    }
    __syncthreads();
    {
      const int k = tid & 63, i = tid >> 6;
      float s = 0.f;
      for (int r = 0; r < kTile; ++r) {
        const float dz = T0[r * kLdT + k];
        dw1 = fmaf(T1[r * kLdT + i], dz, dw1);
        s += dz;
      }
      if (tid < 64) db[0] += s;
    }
    __syncthreads();
  }

  // this block's partial: [group sums (F, 2, GW) | dW | db]
  __syncthreads();
  float* pb = partial + static_cast<size_t>(blockIdx.x) * bwd_red_size(MODE, F);
  for (int e = tid; e < F * 2 * GW; e += kBThreads) {
    float s = 0.f;
    for (int w = 0; w < kBWarps; ++w) s += accw[w * F * 2 * GW + e];
    pb[e] = s;
  }
  float* pw = pb + F * 2 * GW;
  if constexpr (MODE == 5 || MODE == 6) {
    constexpr int Cin = MODE == 5 ? kC2 : kC1, Cout = MODE == 5 ? kC3 : kC2;
    float* r0 = pw + (wm + gid) * Cout + wn + 2 * tig;
#pragma unroll
    for (int j = 0; j < NDW; ++j) {
      const int col = (j >> 2) * 64 + (j & 3) * 8;    // half j / 4, n-tile j % 4
      r0[col] = dw[j][0];
      r0[col + 1] = dw[j][1];
      r0[8 * Cout + col] = dw[j][2];
      r0[8 * Cout + col + 1] = dw[j][3];
    }
    if (tid < 64) {
      pw[Cin * Cout + tid] = db[0];
      if (MODE == 5) pw[Cin * Cout + 64 + tid] = db[1];
    }
  } else if constexpr (MODE == 7) {
    pw[tid] = dw1;                                     // dW1[tid / 64][tid % 64]
    if (tid < 64) pw[4 * kC1 + tid] = db[0];
  }
}

template <int MODE>
cudaError_t launch_bwd(const float* x, const float* params, const float* stats,
                       const float* bsum, const float* dout, uint32_t* route, float* out,
                       float* partial, float* red, int G, int F, int P, int nblk,
                       cudaStream_t st) {
  const size_t floats = kVecAll + weight_floats(MODE) + 4 * static_cast<size_t>(F) * kCS +
                        static_cast<size_t>(kBWarps) * F * 2 * bwd_width(MODE) +
                        (MODE >= 5 ? 2 * kTile * kLdT : 0);
  const size_t smem = floats * sizeof(float);
  cudaError_t err = mocopci::allow_smem(fusion_head_bwd_kernel<MODE>, smem);
  if (err != cudaSuccess) return err;
  const float inv_s = 1.f / (static_cast<float>(G / F) * static_cast<float>(P));
  fusion_head_bwd_kernel<MODE><<<nblk, kBThreads, smem, st>>>(x, params, stats, bsum, dout,
                                                              route, out, partial, G, F, P,
                                                              inv_s);
  MOCOPCI_CHECK_LAUNCH();
  return mocopci::reduce_partials(partial, red, nblk, bwd_red_size(MODE, F), st);
}

}  // namespace

// One backward sweep, with the forward's inputs and stats, bsum (F, 2, 256)
// [Sa | Sb] of the layers whose backward sums are known, and dout (G, P).
// Sweep 4 writes the layer-3 group sums to red and each pair's routing (8
// words: the channel-max and ReLU masks of layers 3 and 2, the tie count) to
// route (G * P * 8 int32), which sweeps 5-7 read; sweeps 5, 6 write the
// layer-2 / 1 group sums then dW, db of the layer above; sweep 7 writes dx
// (G, 4, P) to out and dW1, db1 to red.
MOCOPCI_API int mocopci_fusion_head_train_bwd(const float* x, const float* params,
                                              const float* stats, const float* bsum,
                                              const float* dout, uint32_t* route, float* out,
                                              float* partial, float* red, int mode, int G,
                                              int F, int P, int nblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 4: return launch_bwd<4>(x, params, stats, bsum, dout, route, out, partial, red, G, F, P, nblk, st);
    case 5: return launch_bwd<5>(x, params, stats, bsum, dout, route, out, partial, red, G, F, P, nblk, st);
    case 6: return launch_bwd<6>(x, params, stats, bsum, dout, route, out, partial, red, G, F, P, nblk, st);
    case 7: return launch_bwd<7>(x, params, stats, bsum, dout, route, out, partial, red, G, F, P, nblk, st);
    default: return cudaErrorInvalidValue;
  }
}
