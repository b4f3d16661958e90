// The softmax attention forward's two bodies, shared by the eval attention
// (csrc/attention.cu) and the training attention (csrc/attention_train.cu):
// out = (softmax(q k^T * scale) * keep) v in f32 over M keys (the wrappers
// cap M at 16384), in one pass over the keys, streamed through shared memory
// under an online softmax in log2 units.  Each file wraps them in __global__
// kernels of its own name, so a profile tells the two apart.  Template
// flags: DROP applies the dropout keep factor (the hash of (seed, g, row,
// col), attention_train.cu's header), LSE writes each row's log-sum-exp for
// the backward.  The eval kernels set neither and pass kscale = 1: out = acc
// * (1 / den).
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using mocopci::cp_async16;
using mocopci::cp_async16z;
using mocopci::cp_async4;
using mocopci::cp_async4z;
using mocopci::cp_async_commit;
using mocopci::cp_async_wait0;
using mocopci::cp_async_wait1;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The dropout counter's row shift: pair (row, col) hashes (row << s) ^ col
// with s = max(12, ceil(log2 M)), so a column never reaches the row's bits
// and the counter is unique while N <= 2^(32 - s).  Up to 4096 keys s = 12,
// the TPU kernel's counter bit for bit (mocopci_tpu/ops/pallas/
// attention_train.py:48-58); past 4096 the port's own.
__device__ __forceinline__ int row_shift(int M) {
  int s = 12;
  while (s < 31 && (1 << s) < M) ++s;
  return s;
}

// An A fragment from (hi, lo) pairs a0..a3 in the fragment's order.
__device__ __forceinline__ void frag_of_pairs(mocopci::FragA& fa, uint2 a0, uint2 a1, uint2 a2,
                                              uint2 a3) {
  fa.hi[0] = a0.x, fa.lo[0] = a0.y;
  fa.hi[1] = a1.x, fa.lo[1] = a1.y;
  fa.hi[2] = a2.x, fa.lo[2] = a2.y;
  fa.hi[3] = a3.x, fa.lo[3] = a3.y;
}

// ---- forward for head dims D <= 64: one pass over the keys ----
//
// One block per (group, tile of QT queries): QT = 128, or 64 or 32 where the
// grid would not give every SM a block.  LPK lanes a query's head dims, as
// the backward splits a key (1 up to DP = 16, 2 at 32, 4 at 64; D padded
// with zeros to DP = 8, 16, 32 or 64), and KS groups of them its keys: 2
// where even 32-query tiles leave fewer than 128 query lanes an SM, else 1.
// Lane (s, l) holds head dims [l*DT, (l+1)*DT) of its query's q (times scale
// * log2(e)) and of its running numerator acc, and the running max m (in log2
// units) and denominator of key split s, in registers.  The keys and values
// stream through shared memory in tiles of 64, double-buffered by cp.async
// (rows past M zero-filled); split s takes keys s, s + KS, ... of each tile,
// 16 at a time.  Per chunk: the 16 logits (the LPK lanes add their partial
// dots by shuffles, reading k as float4 broadcasts), one max and one rescale
// of acc and the denominator, then per key p = 2^(s - m) into the
// denominator and, where the keep factor keeps the pair, p v into acc (no
// hash at rate 0).  The denominator sums every exp, kept or dropped, so
// dropout acts after the softmax.  At the end the splits merge by a shuffle,
// and out = acc * kscale / denominator and, with LSE, lse = m ln 2 +
// ln(denominator).
// Every output element is summed in one fixed order.  (4 splits, or 2 on
// larger grids, ran up to 5x slower at the step's shapes: each split's share
// of a tile no longer hides the tile's copy.  On the tiny grids 4 or 8
// splits, over tiles of 64 keys or of 256, were slower than 2; taking
// interleaved keys rather than chunks of 16, so that the splits' lanes read
// neighbouring rows instead of one bank, made 2 splits faster.)
constexpr int kFwdKeys = 64;        // keys per tile
constexpr int kFwdChunk = 16;       // keys per online-softmax step
constexpr int kMaxFwdD = 64;
constexpr int kFwdMaxThreads = 128 * 4;
constexpr int kSMs = 132;           // an H100's SMs

template <int DP>
struct FwdTile {
  static constexpr int LPK = DP <= 16 ? 1 : DP / 16;   // lanes per query
  static constexpr int DT = DP / LPK;                   // head dims per lane
  static constexpr size_t smem_bytes = 4 * kFwdKeys * DP * sizeof(float);  // [2][k, v][64][DP]
};

// Queues the copies of key rows [j0, j0 + 64) of k and v into [64][DP]
// tiles (the padded dims are not written); rows past M are filled with zeros.
template <int DP>
__device__ __forceinline__ void stage_keys(const float* __restrict__ kg,
                                           const float* __restrict__ vg, int j0, int M, int D,
                                           float* kt, float* vt) {
  if ((D & 3) == 0) {
    const int D4 = D >> 2;
    for (int e = threadIdx.x; e < kFwdKeys * D4; e += blockDim.x) {
      const int r = e / D4, c = (e - r * D4) << 2;
      const bool ok = j0 + r < M;
      const size_t src = ok ? static_cast<size_t>(j0 + r) * D + c : 0;
      cp_async16z(kt + r * DP + c, kg + src, ok);
      cp_async16z(vt + r * DP + c, vg + src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kFwdKeys * D; e += blockDim.x) {
      const int r = e / D, c = e - r * D;
      const bool ok = j0 + r < M;
      const size_t src = ok ? static_cast<size_t>(j0 + r) * D + c : 0;
      cp_async4z(kt + r * DP + c, kg + src, ok);
      cp_async4z(vt + r * DP + c, vg + src, ok);
    }
  }
}

// KSC: the key splits where fixed when compiled (1), else 0 and KS is read at
// run time (2).  With KS = 1 fixed the key stride folds into the loads'
// offsets; the split instance, compiled with KS fixed too, held fewer key
// rows in flight and ran slower on the tiny grids it serves.
template <int DP, int KSC, bool DROP, bool LSE>
__device__ __forceinline__ void attention_fwd_body(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int N, int M, int D, float scale,
    const int* __restrict__ seed, int thr, float kscale, int ks) {
  const int KS = KSC > 0 ? KSC : ks;
  constexpr int LPK = FwdTile<DP>::LPK, DT = FwdTile<DP>::DT;
  constexpr int TK = kFwdKeys, CH = kFwdChunk;
  extern __shared__ __align__(16) float sm[];
  float* kts = sm;                    // [2][TK][DP]
  float* vts = kts + 2 * TK * DP;     // [2][TK][DP]
  const int tid = threadIdx.x, l = tid % LPK, split = (tid / LPK) % KS;
  const int g = blockIdx.y;
  const int i = blockIdx.x * (blockDim.x / (LPK * KS)) + tid / (LPK * KS);
  const bool row_ok = i < N;
  // the hash of pair (i, j) is fmix32(rg ^ j), rg = (i << row_shift(M)) ^ fmix32(g ^ seed)
  uint32_t rg = 0u;
  if (DROP)
    rg = (static_cast<uint32_t>(i) << row_shift(M)) ^
         fmix32(static_cast<uint32_t>(g) ^ static_cast<uint32_t>(*seed));
  const size_t gk = static_cast<size_t>(g) * M * D;
  const float* kg = k + gk;
  const float* vg = v + gk;
  const int ntiles = (M + TK - 1) / TK;
  stage_keys<DP>(kg, vg, 0, M, D, kts, vts);
  cp_async_commit();

  const float c2 = scale * kLog2e;
  float qr[DT], acc[DT];
#pragma unroll
  for (int e = 0; e < DT; ++e) {
    const int d = l * DT + e;
    qr[e] = row_ok && d < D ? q[(static_cast<size_t>(g) * N + i) * D + d] * c2 : 0.f;
    acc[e] = 0.f;
  }
  if (D < DP) {       // the padded dims of both buffers stay zero (cp.async skips them)
    for (int e = tid; e < 2 * TK * (DP - D); e += blockDim.x) {
      const int r = e / (DP - D), c = D + (e - r * (DP - D));
      kts[r * DP + c] = 0.f;
      vts[r * DP + c] = 0.f;
    }
  }

  // m starts finite: a split that has met no key yet rescales by 2^0 = 1
  float m = -FLT_MAX, den = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int b = t & 1, j0 = t * TK;
    if (t + 1 < ntiles)
      stage_keys<DP>(kg, vg, j0 + TK, M, D, kts + (b ^ 1) * TK * DP, vts + (b ^ 1) * TK * DP);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();        // tile t has landed
    const float* kb = kts + b * TK * DP + l * DT;
    const float* vb = vts + b * TK * DP + l * DT;
    const int nk = min(TK, M - j0);
    for (int jc = 0; jc < nk; jc += KS * CH) {     // the same trips in every lane
      // split s takes keys jc + s, jc + s + KS, ...: the splits' lanes read
      // neighbouring rows, whose shared-memory banks differ
      const int jj = jc + split;
      const float* kr = kb + jj * DP;
      const float* vr = vb + jj * DP;
      const int step = KS * DP;
      float s[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < DT; e += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + c * step + e);
          a = fmaf(qr[e], kv.x, a);
          a = fmaf(qr[e + 1], kv.y, a);
          a = fmaf(qr[e + 2], kv.z, a);
          a = fmaf(qr[e + 3], kv.w, a);
        }
        s[c] = a;
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int c = 0; c < CH; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
      float mc = m;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (jj + c * KS >= nk) s[c] = -__int_as_float(0x7f800000);
        mc = fmaxf(mc, s[c]);
      }
      const float alpha = exp2f(m - mc);
      m = mc;
      den *= alpha;
#pragma unroll
      for (int e = 0; e < DT; ++e) acc[e] *= alpha;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float p = exp2f(s[c] - m);
        den += p;
        if (DROP) {
          const uint32_t h = fmix32(rg ^ static_cast<uint32_t>(j0 + jj + c * KS));
          if (static_cast<int>(h & 0xFFFFFFu) < thr) p = 0.f;
        }
#pragma unroll
        for (int e = 0; e < DT; e += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + c * step + e);
          acc[e] = fmaf(p, vv.x, acc[e]);
          acc[e + 1] = fmaf(p, vv.y, acc[e + 1]);
          acc[e + 2] = fmaf(p, vv.z, acc[e + 2]);
          acc[e + 3] = fmaf(p, vv.w, acc[e + 3]);
        }
      }
    }
    __syncthreads();        // every thread is done with buffer b before tile t + 2 lands in it
  }

  if (KS > 1) {       // split 1's sums into split 0's (the lane LPK up)
    const float mo = __shfl_down_sync(0xffffffffu, m, LPK);
    const float dno = __shfl_down_sync(0xffffffffu, den, LPK);
    const float mn = fmaxf(m, mo), fa = exp2f(m - mn), fb = exp2f(mo - mn);
    den = den * fa + dno * fb;
#pragma unroll
    for (int e = 0; e < DT; ++e)
      acc[e] = acc[e] * fa + __shfl_down_sync(0xffffffffu, acc[e], LPK) * fb;
    m = mn;
  }
  if (row_ok && split == 0) {
    const size_t row = static_cast<size_t>(g) * N + i;
    const float f = kscale / den;
#pragma unroll
    for (int e = 0; e < DT; ++e) {
      const int d = l * DT + e;
      if (d < D) out[row * D + d] = acc[e] * f;
    }
    if (LSE && l == 0) lse[row] = m * 0.6931471805599453f + logf(den);
  }
}

// The one-pass forward's launch shape for G groups of N queries: QT = 128
// queries a block, or 64 or 32 where the grid would not give every SM a
// block; 2 key splits where even 32-query tiles leave fewer than 128 query
// lanes an SM (and the block stays within its threads).  Threads a block:
// QT * LPK * KS.
template <int DP>
inline void one_pass_grid(int G, int N, dim3& grid, int& threads, int& ks) {
  constexpr int LPK = FwdTile<DP>::LPK;
  int qt = 128;
  while (qt > 32 && static_cast<long long>(G) * mocopci::ceil_div(N, qt) < kSMs) qt >>= 1;
  ks = static_cast<long long>(G) * N * LPK < 128LL * kSMs && qt * LPK * 2 <= kFwdMaxThreads
           ? 2
           : 1;
  grid = dim3(mocopci::ceil_div(N, qt), G);
  threads = qt * LPK * ks;
}

// ---- forward for head dims D > 64 (the wide route): one pass on the tensor cores ----
//
// One block per (group, tile of 32 queries, slice of 256 head dims of the
// output), 8 warps.  The keys stream in tiles of 64; each tile's logits sum
// over the head dims in chunks of 64: stage (key tile t, chunk c) brings the
// q chunk ([32][68] floats) and the k chunk ([64][68]) into shared memory by
// cp.async, double-buffered, and the tile's v rows of the slice ([64][264])
// come with stage (t, 1) into their one buffer (with the first stage for
// t = 0), after every warp is done with tile t - 1.  Rows past N or M and
// dims past D are filled with zeros.  Every product runs on mma.sync
// m16n8k8 at float32 grade (3xTF32, operands split by bit masks,
// mma_tf32.cuh).  Per key tile:
//   S = q k^T: warp w holds the 16 x 16 logits of query half w / 4 and keys
//     [16 (w % 4), 16 (w % 4) + 16) in registers over the chunks, then
//     writes them, scaled to log2 units (keys past M at -inf), to shared
//     memory;
//   the online softmax: 8 lanes a query row, 8 keys each; the row max by
//     shuffles, one rescale factor alpha a row (to shared memory), the
//     denominator (kept in registers, the row's 8 lanes alike) times alpha
//     plus every exp, kept or dropped, added over the 8 lanes in a fixed
//     order; P = 2^(s - m) times the keep factor (the numerators only; no
//     hash at rate 0) to shared memory as (hi, lo) TF32 pairs;
//   O = alpha O + P v: warp w holds both query halves x head dims
//     [32 w, 32 w + 32) of the slice, 32 registers a thread.
// At the end out = O kscale / den, and with LSE the slice-0 blocks write lse
// = m ln 2 + ln(den).  Each logit is computed once for a slice of 256 head dims (once
// at the CrossFrameBlock's D = 256).  Each output element has one owner
// summing in a fixed order, so the result repeats bit for bit.
constexpr int kYQ = 32;                    // queries a block
constexpr int kYK = 64;                    // keys a tile
constexpr int kYC = 64;                    // head dims a chunk of the logits
constexpr int kYV = 256;                   // head dims a slice of the output
constexpr int kYWarps = 8;
constexpr int kYThreads = 32 * kYWarps;
constexpr int kYLd = kYC + 4;              // q / k chunk and logit row stride (floats)
constexpr int kYLdV = kYV + 8;             // v row stride (floats)
constexpr int kYLdP = kYK + 4;             // P row stride ((hi, lo) pairs)
constexpr int kYStage = (kYQ + kYK) * kYLd;          // floats a stage: q chunk, k chunk
constexpr size_t kYSmem = (2 * kYStage + kYK * kYLdV + kYQ * kYLd + 2 * kYQ * kYLdP + kYQ) *
                          sizeof(float);

// Queues the copies of rows [r0, r0 + R) and dims [c0, c0 + W) of a (Rows, D)
// matrix into a [R][ld] tile, zero past Rows and D.
template <int R, int W>
__device__ __forceinline__ void stage_y(const float* __restrict__ src, int r0, int Rows, int D,
                                        int c0, float* dst, int ld) {
  if ((D & 3) == 0) {
    for (int e = threadIdx.x; e < R * W / 4; e += kYThreads) {
      const int r = e / (W / 4), c = (e - r * (W / 4)) << 2;
      const bool ok = r0 + r < Rows && c0 + c < D;
      cp_async16z(dst + r * ld + c, src + (ok ? static_cast<size_t>(r0 + r) * D + c0 + c : 0),
                  ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * W; e += kYThreads) {
      const int r = e / W, c = e - r * W;
      const bool ok = r0 + r < Rows && c0 + c < D;
      cp_async4z(dst + r * ld + c, src + (ok ? static_cast<size_t>(r0 + r) * D + c0 + c : 0),
                 ok);
    }
  }
}

template <bool DROP, bool LSE>
__device__ __forceinline__ void attention_fwd_wide_body(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int N, int M, int D, float scale,
    const int* __restrict__ seed, int thr, float kscale) {
  extern __shared__ __align__(16) float sm[];
  float* stg = sm;                                      // [2][q chunk, k chunk]
  float* vs = stg + 2 * kYStage;                        // [kYK][kYLdV] v rows of the slice
  float* ss = vs + kYK * kYLdV;                         // [kYQ][kYLd] logits
  uint2* ps = reinterpret_cast<uint2*>(ss + kYQ * kYLd); // [kYQ][kYLdP] P (hi, lo)
  float* as = reinterpret_cast<float*>(ps + kYQ * kYLdP); // [kYQ] alpha
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int i0 = blockIdx.x * kYQ, d0 = blockIdx.y * kYV, g = blockIdx.z;
  const size_t gq = static_cast<size_t>(g) * N * D, gk = static_cast<size_t>(g) * M * D;
  const float* qg = q + gq;
  const float* kg = k + gk;
  const float* vg = v + gk;
  const int nchunks = (D + kYC - 1) / kYC, ntiles = (M + kYK - 1) / kYK;
  const int nstages = nchunks * ntiles;
  uint32_t gseed = 0u;
  if (DROP) gseed = fmix32(static_cast<uint32_t>(g) ^ static_cast<uint32_t>(*seed));
  const float c2 = scale * kLog2e;
  // the logits: query half mh, keys [16 kq, 16 kq + 16) of the tile
  const int mh = warp >> 2, kq = warp & 3;
  // the softmax: row sr, keys sl + 8 j
  const int sr = tid >> 3, sl = tid & 7;
  const uint32_t rg = DROP ? (static_cast<uint32_t>(i0 + sr) << row_shift(M)) ^ gseed : 0u;

  stage_y<kYQ, kYC>(qg, i0, N, D, 0, stg, kYLd);
  stage_y<kYK, kYC>(kg, 0, M, D, 0, stg + kYQ * kYLd, kYLd);
  stage_y<kYK, kYV>(vg, 0, M, D, d0, vs, kYLdV);
  cp_async_commit();

  float o[2][4][4], s[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[m][n][r] = 0.f;
  // m starts finite, so the first rescale is by 2^(-inf) = 0 of an empty sum
  float mrow = -FLT_MAX, den = 0.f;

  for (int st = 0; st < nstages; ++st) {
    const int t = st / nchunks, c = st - t * nchunks, b = st & 1;
    cp_async_wait0();
    __syncthreads();        // stage st has landed; every warp is done with stage st - 1
    if (st + 1 < nstages) {
      const int t1 = (st + 1) / nchunks, c1 = st + 1 - t1 * nchunks;
      float* nb = stg + (b ^ 1) * kYStage;
      stage_y<kYQ, kYC>(qg, i0, N, D, c1 * kYC, nb, kYLd);
      stage_y<kYK, kYC>(kg, t1 * kYK, M, D, c1 * kYC, nb + kYQ * kYLd, kYLd);
      if (t1 > 0 && c1 == 1) stage_y<kYK, kYV>(vg, t1 * kYK, M, D, d0, vs, kYLdV);
      cp_async_commit();
    }
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
    {                       // S += q_c k_c^T
      const float* qa = stg + b * kYStage + (mh * 16 + gid) * kYLd + tig;
      const float* kb = stg + b * kYStage + kYQ * kYLd + (kq * 16 + gid) * kYLd + tig;
#pragma unroll 4
      for (int kk = 0; kk < kYC; kk += 8) {
        mocopci::FragA fa;
        fa.set_rz({qa[kk], qa[kk + 8 * kYLd], qa[kk + 4], qa[kk + 8 * kYLd + 4]});
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* kn = kb + n * 8 * kYLd + kk;
          mocopci::FragB fb;
          fb.set_rz(kn[0], kn[4]);
          mocopci::mma_3xtf32(s[n], fa, fb);
        }
      }
    }
    if (c + 1 < nchunks) continue;

    const int j0 = t * kYK;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = kq * 16 + n * 8 + 2 * tig + (r & 1);
        ss[(mh * 16 + gid + 8 * (r >> 1)) * kYLd + col] =
            j0 + col < M ? s[n][r] * c2 : -__int_as_float(0x7f800000);
      }
    __syncthreads();        // the tile's logits are complete

    {                       // the online softmax of row sr, keys sl + 8 j
      float x[8], mx = mrow;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = ss[sr * kYLd + sl + 8 * j];
        mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f(mrow - mx);
      mrow = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = sl + 8 * j;
        float p = exp2f(x[j] - mx);
        sum += p;
        if (DROP && p != 0.f) {
          const uint32_t h = fmix32(rg ^ static_cast<uint32_t>(j0 + col));
          if (static_cast<int>(h & 0xFFFFFFu) < thr) p = 0.f;
        }
        uint2 hp;
        mocopci::split_tf32_rz(p, hp.x, hp.y);
        ps[sr * kYLdP + col] = hp;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      den = den * alpha + sum;
      if (sl == 0) as[sr] = alpha;
    }
    __syncthreads();        // P and alpha are complete

    // O = alpha O + P v over the tile's keys: both query halves, dims [32 warp, + 32)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float a0 = as[m * 16 + gid], a1 = as[m * 16 + gid + 8];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        o[m][n][0] *= a0;
        o[m][n][1] *= a0;
        o[m][n][2] *= a1;
        o[m][n][3] *= a1;
      }
    }
    const float* vb = vs + tig * kYLdV + warp * 32 + gid;
#pragma unroll 2
    for (int ks = 0; ks < kYK / 8; ++ks) {
      mocopci::FragA fa[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint2* pa = ps + (m * 16 + gid) * kYLdP + ks * 8 + tig;
        frag_of_pairs(fa[m], pa[0], pa[8 * kYLdP], pa[4], pa[8 * kYLdP + 4]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* vn = vb + ks * 8 * kYLdV + n * 8;
        mocopci::FragB fb;
        fb.set_rz(vn[0], vn[4 * kYLdV]);
#pragma unroll
        for (int m = 0; m < 2; ++m) mocopci::mma_3xtf32(o[m][n], fa[m], fb);
      }
    }
  }

  // den of rows gid (+ 8) of each half: the softmax lanes of row r are tid 8 r .. 8 r + 7
  __syncthreads();
  if (sl == 0) as[sr] = den;
  if (LSE && sl == 0 && blockIdx.y == 0 && i0 + sr < N)
    lse[static_cast<size_t>(g) * N + i0 + sr] = mrow * 0.6931471805599453f + logf(den);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m * 16 + gid + 8 * h, i = i0 + row;
      if (i >= N) continue;
      const float f = kscale / as[row];
      float* orow = out + gq + static_cast<size_t>(i) * D;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int d = d0 + warp * 32 + n * 8 + 2 * tig;
        if (d < D) orow[d] = o[m][n][2 * h] * f;
        if (d + 1 < D) orow[d + 1] = o[m][n][2 * h + 1] * f;
      }
    }
}

}  // namespace
