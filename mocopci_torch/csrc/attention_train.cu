// Training attention: out = (softmax(q k^T * scale) * keep) v in f32, with the
// dropout keep factors a pure function of (seed, g, row, col), and its
// backward (dq, dk, dv) with the same factors rebuilt.
//
// Replaces mocopci_tpu/ops/pallas/attention_train.py: attention_train (:160),
// forward pallas_call :181 and backward pallas_call :206.  The keep factor is
// the TPU kernel's _keep_mask (:46-64) bit for bit: h = fmix32(((row << 12) ^
// col) ^ fmix32(g ^ seed)) in uint32 (murmur3's finaliser), kept where the low
// 24 bits, as int32, are >= int32(rate * 2^24), scaled by f32(1 / (1 - rate)).
//
// Bound on the H100: operations (4*N*M*D flops forward, about 10*N*M*D
// backward, against (N + M)*D*4 bytes per group).  Design:
//   forward, head dims D <= 64: one pass over the keys, streamed through
//             shared memory, with an online softmax (see the block comment
//             above attention_train_fwd_kernel), no hash at rate 0;
//   forward, D > 64 (the "wide" route): one pass over the keys as well,
//             its two products on the tensor cores at float32 grade (see the
//             block comment above attention_train_fwd_wide_kernel); the keep
//             factor is applied to the numerators, and the row's
//             log-sum-exp is written for the backward;
//   backward, head dims D <= 64: one pass over the pairs, each pair's logit,
//             do.v, exp and keep factor computed once (see the block comment
//             above attention_train_bwd_kernel), no hash at rate 0;
//   backward, D > 64 (the wide route): one pass over the pairs as well,
//             its five products on the tensor cores at float32 grade (see the
//             block comment above attention_train_bwd_wide_kernel).
// Every output element is summed in a fixed order by one owner, with no
// atomics, so the result repeats bit for bit.
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

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// every group but the newest has landed (for this thread's copies)
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// gseed = fmix32(g ^ seed)
__device__ __forceinline__ float keep_factor(uint32_t gseed, int row, int col, int thr,
                                             float kscale) {
  const uint32_t ctr = (static_cast<uint32_t>(row) << 12) ^ static_cast<uint32_t>(col);
  const uint32_t h = fmix32(ctr ^ gseed);
  return static_cast<int>(h & 0xFFFFFFu) >= thr ? kscale : 0.f;
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
// (rows past M zero-filled); split s takes chunks s, s + KS, ... of 16 keys
// of each tile.  Per chunk: the 16 logits (the LPK lanes add their partial
// dots by shuffles, reading k as float4 broadcasts), one max and one rescale
// of acc and the denominator, then per key p = 2^(s - m) into the
// denominator and, where the keep factor keeps the pair, p v into acc (no
// hash at rate 0).  The denominator sums every exp, kept or dropped, so
// dropout acts after the softmax.  At the end the splits merge by a shuffle,
// and out = acc * kscale / denominator and lse = m ln 2 + ln(denominator).
// Every output element is summed in one fixed order.  (4 splits, or 2 on
// larger grids, ran up to 5x slower at the step's shapes: each split's share
// of a tile no longer hides the tile's copy.)
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

template <int DP, bool DROP>
__global__ void __launch_bounds__(kFwdMaxThreads) attention_train_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int N, int M, int D, float scale,
    const int* __restrict__ seed, int thr, float kscale, int KS) {
  constexpr int LPK = FwdTile<DP>::LPK, DT = FwdTile<DP>::DT;
  constexpr int TK = kFwdKeys, CH = kFwdChunk;
  extern __shared__ __align__(16) float sm[];
  float* kts = sm;                    // [2][TK][DP]
  float* vts = kts + 2 * TK * DP;     // [2][TK][DP]
  const int tid = threadIdx.x, l = tid % LPK, split = (tid / LPK) % KS;
  const int g = blockIdx.y;
  const int i = blockIdx.x * (blockDim.x / (LPK * KS)) + tid / (LPK * KS);
  const bool row_ok = i < N;
  // the hash of pair (i, j) is fmix32(rg ^ j), rg = (i << 12) ^ fmix32(g ^ seed)
  uint32_t rg = 0u;
  if (DROP)
    rg = (static_cast<uint32_t>(i) << 12) ^
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
      const int jj = jc + split * CH;
      float s[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < DT; e += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kb + (jj + c) * DP + e);
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
        if (jj + c >= nk) s[c] = -__int_as_float(0x7f800000);
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
          const uint32_t h = fmix32(rg ^ static_cast<uint32_t>(j0 + jj + c));
          if (static_cast<int>(h & 0xFFFFFFu) < thr) p = 0.f;
        }
#pragma unroll
        for (int e = 0; e < DT; e += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vb + (jj + c) * DP + e);
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
    if (l == 0) lse[row] = m * 0.6931471805599453f + logf(den);
  }
}

template <int DP, bool DROP>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* out, float* lse,
                       int G, int N, int M, int D, float scale, const int* seed, int thr,
                       float kscale, cudaStream_t st) {
  cudaError_t err = mocopci::allow_smem(attention_train_fwd_kernel<DP, DROP>,
                                        FwdTile<DP>::smem_bytes);
  if (err != cudaSuccess) return err;
  constexpr int LPK = FwdTile<DP>::LPK;
  int qt = 128;
  while (qt > 32 && static_cast<long long>(G) * mocopci::ceil_div(N, qt) < kSMs) qt >>= 1;
  const int ks = static_cast<long long>(G) * N * LPK < 128LL * kSMs ? 2 : 1;
  attention_train_fwd_kernel<DP, DROP>
      <<<dim3(mocopci::ceil_div(N, qt), G), qt * LPK * ks, FwdTile<DP>::smem_bytes, st>>>(
          q, k, v, out, lse, N, M, D, scale, seed, thr, kscale, ks);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t launch_fwd_dp(int DP, const float* q, const float* k, const float* v, float* out,
                          float* lse, int G, int N, int M, int D, float scale, const int* seed,
                          int thr, float kscale, cudaStream_t st) {
  switch (DP) {
    case 8:
      return launch_fwd<8, DROP>(q, k, v, out, lse, G, N, M, D, scale, seed, thr, kscale, st);
    case 16:
      return launch_fwd<16, DROP>(q, k, v, out, lse, G, N, M, D, scale, seed, thr, kscale, st);
    case 32:
      return launch_fwd<32, DROP>(q, k, v, out, lse, G, N, M, D, scale, seed, thr, kscale, st);
    default:
      return launch_fwd<64, DROP>(q, k, v, out, lse, G, N, M, D, scale, seed, thr, kscale, st);
  }
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
// At the end out = O kscale / den, and the slice-0 blocks write lse = m ln 2
// + ln(den).  Each logit is computed once for a slice of 256 head dims (once
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

template <bool DROP>
__global__ void __launch_bounds__(kYThreads, 1) attention_train_fwd_wide_kernel(
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
  const uint32_t rg = DROP ? (static_cast<uint32_t>(i0 + sr) << 12) ^ gseed : 0u;

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
  if (sl == 0 && blockIdx.y == 0 && i0 + sr < N)
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

template <bool DROP>
cudaError_t launch_fwd_wide(const float* q, const float* k, const float* v, float* out,
                            float* lse, int G, int N, int M, int D, float scale, const int* seed,
                            int thr, float kscale, cudaStream_t st) {
  cudaError_t err = mocopci::allow_smem(attention_train_fwd_wide_kernel<DROP>, kYSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(mocopci::ceil_div(N, kYQ), mocopci::ceil_div(D, kYV), G);
  attention_train_fwd_wide_kernel<DROP><<<grid, kYThreads, kYSmem, st>>>(
      q, k, v, out, lse, N, M, D, scale, seed, thr, kscale);
  return cudaGetLastError();
}

// ---- backward for head dims D <= 64: one pass over the pairs ----
//
// prologue  dot[g, i] = do_i . out_i, once per query row.
// main      one block per (group, tile of TK = 64 keys), 256 threads, looping
//           over chunks of 128 queries (q, do, lse, dot), double-buffered in
//           shared memory by cp.async.  D is padded to DP (8, 16, 32 or 64)
//           with zeros.  Thread (s, j, l) holds head dims [l*DT, (l+1)*DT) of
//           key j in registers (k, v and its dk, dv sums; LPK lanes a key) and
//           takes query split s of each chunk.  For each of its queries it
//           computes the pair's logit, do.v, exp and keep factor once (the
//           LPK lanes add their partial dots by shuffles), reading q and do as
//           float4 broadcasts, adds P*keep*do into dv and dS*q into dk, and
//           writes dS = P*(keep*(do.v) - dot) into the chunk's (query x key)
//           tile in shared memory.  The block then multiplies that tile by
//           its keys (a thread owns QM queries x 4 dims, keys in ascending
//           order) into dq_part[g, key tile, i, :].  At the end the query
//           splits' dk, dv are added in split order.  Without dropout the keep
//           factor is left out (it is exactly 1 there), so no hash runs.
// epilogue  dq = scale * the sum of dq_part over the key tiles, in tile order.
// Every pair costs about 5*D FMAs and one exp2 (P = 2^(log2(e) (scale l -
// lse))), and no FMA reads more than one operand from shared memory.  (The five products on
// the tensor cores instead, mma.sync at float32 grade (3xTF32) with 16 or 32
// keys a warp, ran 10-25% slower on an H100 at (80, 2048, 2048, 8): at D = 8
// the per-pair exp, hash and fragment splits outweigh the FMAs they save.)
constexpr int kBwdThreads = 256;
constexpr int kBwdKeys = 64;      // keys per block
constexpr int kBwdQ = 128;        // queries per chunk
constexpr int kMaxBwdD = 64;

template <int DP>
struct BwdTile {
  static constexpr int LPK = DP <= 16 ? 1 : DP / 16;   // lanes per key
  static constexpr int DT = DP / LPK;                   // head dims per lane
  static constexpr int TK = kBwdKeys;
  static constexpr int QS = kBwdThreads / (TK * LPK);   // query splits of a chunk
  static constexpr int QM = DP / 8;                     // dq product: queries per thread
  static constexpr int LDS = TK + 4;                    // row stride of the dS tile
  // [2][128][DP] q, [2][128][DP] do, [2][128] lse, [2][128] dot, [128][LDS] dS, [TK][DP] k
  static constexpr int smem_floats = 4 * kBwdQ * DP + 4 * kBwdQ + kBwdQ * LDS + TK * DP;
  static_assert(QS >= 1 && (kBwdQ / QM) * (DP / 4) == kBwdThreads, "tile shape");
};

// Queues the copies of query rows [i0, i0 + 128) (cut at N): q and do into
// [128][DP] tiles (the padded dims are not written), lse and dot.
template <int DP>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ qg,
                                            const float* __restrict__ dog,
                                            const float* __restrict__ lg,
                                            const float* __restrict__ tg, int i0, int N, int D,
                                            float* qs, float* dos, float* ls, float* ts) {
  const int rows = min(kBwdQ, N - i0);
  if ((D & 3) == 0) {
    const int D4 = D >> 2;
    for (int e = threadIdx.x; e < rows * D4; e += kBwdThreads) {
      const int r = e / D4, c = (e - r * D4) << 2;
      const size_t src = static_cast<size_t>(i0 + r) * D + c;
      cp_async16(qs + r * DP + c, qg + src);
      cp_async16(dos + r * DP + c, dog + src);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += kBwdThreads) {
      const int r = e / D, c = e - r * D;
      const size_t src = static_cast<size_t>(i0 + r) * D + c;
      cp_async4(qs + r * DP + c, qg + src);
      cp_async4(dos + r * DP + c, dog + src);
    }
  }
  for (int e = threadIdx.x; e < rows; e += kBwdThreads) {
    cp_async4(ls + e, lg + i0 + e);
    cp_async4(ts + e, tg + i0 + e);
  }
}

// dot[r] = do_r . out_r over rows r < rows (the backward's per-row constant)
__global__ void __launch_bounds__(256) attention_train_bwd_dot_kernel(
    const float* __restrict__ out, const float* __restrict__ dout, float* __restrict__ dot,
    int rows, int D) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* o = out + static_cast<size_t>(r) * D;
  const float* d = dout + static_cast<size_t>(r) * D;
  float acc = 0.f;
  for (int c = 0; c < D; ++c) acc = fmaf(d[c], o[c], acc);
  dot[r] = acc;
}

template <int DP, bool DROP>
__global__ void __launch_bounds__(kBwdThreads) attention_train_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ lse, const float* __restrict__ dot, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dq_part, int N, int M,
    int D, float scale, const int* __restrict__ seed, int thr, float kscale) {
  using T = BwdTile<DP>;
  constexpr int TK = T::TK, LPK = T::LPK, DT = T::DT, QS = T::QS, QM = T::QM, LDS = T::LDS;
  constexpr int QPS = kBwdQ / QS;                 // queries of a chunk per split
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                                 // [2][kBwdQ][DP]
  float* dos = qs + 2 * kBwdQ * DP;               // [2][kBwdQ][DP]
  float* ls = dos + 2 * kBwdQ * DP;               // [2][kBwdQ]
  float* ts = ls + 2 * kBwdQ;                     // [2][kBwdQ]
  float* dst = ts + 2 * kBwdQ;                    // [kBwdQ][LDS]
  float* ks = dst + kBwdQ * LDS;                  // [TK][DP]
  const int tid = threadIdx.x;
  const int l = tid % LPK, j = (tid / LPK) % TK, s = tid / (LPK * TK);
  const int g = blockIdx.y, kt = blockIdx.x;
  const int jg = kt * TK + j;
  const bool key_ok = jg < M;
  const float c2 = scale * kLog2e;                // P = 2^(c2 l - log2(e) lse)
  uint32_t gseed = 0u;
  if (DROP) gseed = fmix32(static_cast<uint32_t>(g) ^ static_cast<uint32_t>(*seed));
  const size_t gq = static_cast<size_t>(g) * N * D, gk = static_cast<size_t>(g) * M * D;
  const float* qg = q + gq;
  const float* dog = dout + gq;
  const float* lg = lse + static_cast<size_t>(g) * N;
  const float* tg = dot + static_cast<size_t>(g) * N;
  const int nchunks = (N + kBwdQ - 1) / kBwdQ;
  stage_chunk<DP>(qg, dog, lg, tg, 0, N, D, qs, dos, ls, ts);
  cp_async_commit();

  float kr[DT], vr[DT], ak[DT], av[DT];
#pragma unroll
  for (int e = 0; e < DT; ++e) {
    const int d = l * DT + e;
    const bool ok = key_ok && d < D;
    kr[e] = ok ? k[gk + static_cast<size_t>(jg) * D + d] : 0.f;
    vr[e] = ok ? v[gk + static_cast<size_t>(jg) * D + d] : 0.f;
    ak[e] = av[e] = 0.f;
    if (s == 0) ks[j * DP + d] = kr[e];
  }
  if (D < DP) {       // the padded dims of both buffers stay zero (cp.async skips them)
    for (int e = tid; e < 2 * kBwdQ * (DP - D); e += kBwdThreads) {
      const int r = e / (DP - D), c = D + (e - r * (DP - D));
      qs[r * DP + c] = 0.f;
      dos[r * DP + c] = 0.f;
    }
  }

  const int dg = tid % (DP / 4), qg4 = tid / (DP / 4);    // the dq product's tile
  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1, i0 = c * kBwdQ;
    if (c + 1 < nchunks) {
      const int nb = b ^ 1;
      stage_chunk<DP>(qg, dog, lg, tg, i0 + kBwdQ, N, D, qs + nb * kBwdQ * DP,
                      dos + nb * kBwdQ * DP, ls + nb * kBwdQ, ts + nb * kBwdQ);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();        // chunk c has landed; the dq product of c - 1 is done
    const float* qb = qs + b * kBwdQ * DP + l * DT;
    const float* db = dos + b * kBwdQ * DP + l * DT;
    const float* lb = ls + b * kBwdQ;
    const float* tb = ts + b * kBwdQ;
    const int i_end = min((s + 1) * QPS, N - i0);
#pragma unroll 2
    for (int i = s * QPS; i < i_end; ++i) {
      float qi[DT], di[DT];
#pragma unroll
      for (int e = 0; e < DT; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qb + i * DP + e);
        const float4 o = *reinterpret_cast<const float4*>(db + i * DP + e);
        qi[e] = a.x, qi[e + 1] = a.y, qi[e + 2] = a.z, qi[e + 3] = a.w;
        di[e] = o.x, di[e + 1] = o.y, di[e + 2] = o.z, di[e + 3] = o.w;
      }
      float lo = 0.f, da = 0.f;
#pragma unroll
      for (int e = 0; e < DT; ++e) {
        lo = fmaf(qi[e], kr[e], lo);
        da = fmaf(di[e], vr[e], da);
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) {
        lo += __shfl_xor_sync(0xffffffffu, lo, off);
        da += __shfl_xor_sync(0xffffffffu, da, off);
      }
      const float P = key_ok ? exp2f(fmaf(lo, c2, -lb[i] * kLog2e)) : 0.f;
      float pd = P, dsv;
      if (DROP) {
        const float kf = keep_factor(gseed, i0 + i, jg, thr, kscale);
        pd = P * kf;
        dsv = P * (da * kf - tb[i]);
      } else {
        dsv = P * (da - tb[i]);
      }
      if (l == 0) dst[i * LDS + j] = dsv;
#pragma unroll
      for (int e = 0; e < DT; ++e) {
        av[e] = fmaf(pd, di[e], av[e]);
        ak[e] = fmaf(dsv, qi[e], ak[e]);
      }
    }
    __syncthreads();        // the chunk's dS tile is complete
    float acc[QM][4];
#pragma unroll
    for (int m = 0; m < QM; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < TK; jj += 4) {
      float4 kk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kk[u] = *reinterpret_cast<const float4*>(ks + (jj + u) * DP + 4 * dg);
#pragma unroll
      for (int m = 0; m < QM; ++m) {
        const float4 w = *reinterpret_cast<const float4*>(dst + (qg4 * QM + m) * LDS + jj);
        const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[m][0] = fmaf(ws[u], kk[u].x, acc[m][0]);
          acc[m][1] = fmaf(ws[u], kk[u].y, acc[m][1]);
          acc[m][2] = fmaf(ws[u], kk[u].z, acc[m][2]);
          acc[m][3] = fmaf(ws[u], kk[u].w, acc[m][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < QM; ++m) {
      const int i = i0 + qg4 * QM + m;
      if (i < N) {
        float* dst_q = dq_part + ((static_cast<size_t>(g) * gridDim.x + kt) * N + i) * DP + 4 * dg;
        *reinterpret_cast<float4*>(dst_q) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      }
    }
  }

  if (QS > 1) {             // add the query splits' sums in split order
    constexpr int KL = TK * LPK;
    float* red = sm;        // [QS - 1][2 * DT][KL], over the query buffers
    const int kl = tid % KL;
    __syncthreads();
    if (s > 0) {
#pragma unroll
      for (int e = 0; e < DT; ++e) {
        red[((s - 1) * 2 * DT + e) * KL + kl] = ak[e];
        red[((s - 1) * 2 * DT + DT + e) * KL + kl] = av[e];
      }
    }
    __syncthreads();
    if (s == 0) {
      for (int r = 0; r < QS - 1; ++r) {
#pragma unroll
        for (int e = 0; e < DT; ++e) {
          ak[e] += red[(r * 2 * DT + e) * KL + kl];
          av[e] += red[(r * 2 * DT + DT + e) * KL + kl];
        }
      }
    }
  }
  if (s == 0 && key_ok) {
#pragma unroll
    for (int e = 0; e < DT; ++e) {
      const int d = l * DT + e;
      if (d < D) {
        dk[gk + static_cast<size_t>(jg) * D + d] = ak[e] * scale;
        dv[gk + static_cast<size_t>(jg) * D + d] = av[e];
      }
    }
  }
}

// dq[g, i, d] = scale * sum over the key tiles of dq_part[g, t, i, d], in tile order
__global__ void __launch_bounds__(256) attention_train_bwd_dq_kernel(
    const float* __restrict__ part, float* __restrict__ dq, int G, int KT, int N, int D, int DP,
    float scale) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(G) * N * D) return;
  const int d = static_cast<int>(e % D);
  const size_t row = e / D;                       // g * N + i
  const size_t g = row / N, i = row - g * N;
  const float* p = part + (g * KT * N + i) * DP + d;
  float acc = 0.f;
  for (int t = 0; t < KT; ++t) acc += p[static_cast<size_t>(t) * N * DP];
  dq[e] = acc * scale;
}

template <int DP, bool DROP>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* lse,
                       const float* dot, const float* dout, float* dk, float* dv, float* part,
                       int G, int N, int M, int D, float scale, const int* seed, int thr,
                       float kscale, cudaStream_t st) {
  const size_t smem = BwdTile<DP>::smem_floats * sizeof(float);
  cudaError_t err = mocopci::allow_smem(attention_train_bwd_kernel<DP, DROP>, smem);
  if (err != cudaSuccess) return err;
  attention_train_bwd_kernel<DP, DROP>
      <<<dim3(mocopci::ceil_div(M, BwdTile<DP>::TK), G), kBwdThreads, smem, st>>>(
          q, k, v, lse, dot, dout, dk, dv, part, N, M, D, scale, seed, thr, kscale);
  return cudaGetLastError();
}

template <bool DROP>
cudaError_t launch_bwd_dp(int DP, const float* q, const float* k, const float* v,
                          const float* lse, const float* dot, const float* dout, float* dk,
                          float* dv, float* part, int G, int N, int M, int D, float scale,
                          const int* seed, int thr, float kscale, cudaStream_t st) {
  switch (DP) {
    case 8:
      return launch_bwd<8, DROP>(q, k, v, lse, dot, dout, dk, dv, part, G, N, M, D, scale,
                                 seed, thr, kscale, st);
    case 16:
      return launch_bwd<16, DROP>(q, k, v, lse, dot, dout, dk, dv, part, G, N, M, D, scale,
                                  seed, thr, kscale, st);
    case 32:
      return launch_bwd<32, DROP>(q, k, v, lse, dot, dout, dk, dv, part, G, N, M, D, scale,
                                  seed, thr, kscale, st);
    default:
      return launch_bwd<64, DROP>(q, k, v, lse, dot, dout, dk, dv, part, G, N, M, D, scale,
                                  seed, thr, kscale, st);
  }
}

// ---- backward for head dims D > 64 (the wide route): one pass on the tensor cores ----
//
// prologue  dot[g, i] = do_i . out_i, once per query row (the kernel above).
// main      one block per (group, tile of 32 keys, slice of 256 head dims),
//           16 warps, looping over chunks of 16 queries (q and do of the
//           slice, lse, dot), double-buffered in shared memory by cp.async.
//           The block's keys' k and v rows of its slice sit in shared memory
//           split into (hi, lo) TF32 pairs; every product runs on mma.sync
//           m16n8k8 at float32 grade (3xTF32, mma_tf32.cuh).  For each chunk:
//             S = q k^T and dP = do v^T (16 x 32): warp (k half, S or dP,
//               n-tile) sums its half of the head dims, the halves added
//               in order after a shared-memory pass;
//             each pair's P = 2^(log2(e) (scale S - lse)), its keep factor
//               and dS = P (keep dP - dot) once, stored as (hi, lo) pairs;
//             dv += (P keep)^T do and dk += dS^T q: warp w keeps the 32
//               keys x its 16 head dims of both in registers;
//             dq_part[g, key tile, i, :] = dS k over the block's keys.
//           Head dims past the slice (D > 256: a block per slice of dk, dv
//           and dq) enter S and dP from global memory, so every slice
//           recomputes them over the whole D.  Without dropout the keep
//           factor is left out, so no hash runs.
// epilogue  dq = scale * the sum of dq_part over the key tiles, in tile order.
// Every pair's five products (5 D MACs) run once, on the tensor cores; its
// exp and hash once.  Each output element has one owner summing in a fixed
// order, so the result repeats bit for bit.
constexpr int kWWarps = 16;
constexpr int kWThreads = 32 * kWWarps;
constexpr int kWKeys = 32;                 // keys per block
constexpr int kWQ = 16;                    // queries per chunk
constexpr int kWD = 256;                   // head dims per block (its slice)
constexpr int kWDW = kWD / kWWarps;        // a warp's head dims of dk, dv, dq
constexpr int kWNT = kWDW / 8;             // ... in n-tiles
constexpr int kLdKV = kWD + 4;             // (hi, lo) pairs a k / v row
constexpr int kLdQ = kWD + 4;              // floats a q / do row
constexpr int kLdS = kWKeys + 8;           // floats an S / dP row
constexpr int kLdP = kWKeys + 4;           // (hi, lo) pairs a P keep / dS row
static_assert(kWQ * kWKeys == kWThreads, "one pair a thread");
constexpr size_t kWideSmem =
    (2 * kWKeys * kLdKV * 2 + 4 * kWQ * kLdQ + 4 * kWQ + 4 * kWQ * kLdS + 2 * kWQ * kLdP * 2) *
    sizeof(float);

// Queues the copies of query rows [i0, i0 + 16): head dims [d0, d0 + W) of q
// and do into [16][kLdQ] tiles (the dims from W on are not written), lse and
// dot; rows past N are filled with zeros.
__device__ __forceinline__ void stage_wide(const float* __restrict__ qg,
                                           const float* __restrict__ dog,
                                           const float* __restrict__ lg,
                                           const float* __restrict__ tg, int i0, int N, int D,
                                           int d0, int W, float* qs, float* dos, float* ls,
                                           float* ts) {
  if ((D & 3) == 0) {
    const int W4 = W >> 2;
    for (int e = threadIdx.x; e < kWQ * W4; e += kWThreads) {
      const int r = e / W4, c = (e - r * W4) << 2;
      const bool ok = i0 + r < N;
      const size_t src = ok ? static_cast<size_t>(i0 + r) * D + d0 + c : 0;
      cp_async16z(qs + r * kLdQ + c, qg + src, ok);
      cp_async16z(dos + r * kLdQ + c, dog + src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kWQ * W; e += kWThreads) {
      const int r = e / W, c = e - r * W;
      const bool ok = i0 + r < N;
      const size_t src = ok ? static_cast<size_t>(i0 + r) * D + d0 + c : 0;
      cp_async4z(qs + r * kLdQ + c, qg + src, ok);
      cp_async4z(dos + r * kLdQ + c, dog + src, ok);
    }
  }
  for (int e = threadIdx.x; e < kWQ; e += kWThreads) {
    const bool ok = i0 + e < N;
    cp_async4z(ls + e, lg + (ok ? i0 + e : 0), ok);
    cp_async4z(ts + e, tg + (ok ? i0 + e : 0), ok);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(kWThreads, 1) attention_train_bwd_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ lse, const float* __restrict__ dot, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dq_part, int N, int M,
    int D, float scale, const int* __restrict__ seed, int thr, float kscale) {
  extern __shared__ __align__(16) float sm[];
  uint2* kt_s = reinterpret_cast<uint2*>(sm);                     // [kWKeys][kLdKV] k
  uint2* vt_s = kt_s + kWKeys * kLdKV;                            // [kWKeys][kLdKV] v
  float* qd = reinterpret_cast<float*>(vt_s + kWKeys * kLdKV);    // [2][q, do][kWQ][kLdQ]
  float* lt = qd + 4 * kWQ * kLdQ;                                // [2][lse, dot][kWQ]
  float* sdp = lt + 4 * kWQ;                                      // [k half][S, dP][kWQ][kLdS]
  uint2* pds = reinterpret_cast<uint2*>(sdp + 4 * kWQ * kLdS);    // [P keep, dS][kWQ][kLdP]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kt = blockIdx.x, g = blockIdx.y;
  const int j0 = kt * kWKeys, d0 = blockIdx.z * kWD, W = min(kWD, D - d0);
  const float c2 = scale * kLog2e;
  uint32_t gseed = 0u;
  if (DROP) gseed = fmix32(static_cast<uint32_t>(g) ^ static_cast<uint32_t>(*seed));
  const size_t gq = static_cast<size_t>(g) * N * D, gk = static_cast<size_t>(g) * M * D;
  const float* qg = q + gq;
  const float* dog = dout + gq;
  const float* lg = lse + static_cast<size_t>(g) * N;
  const float* tg = dot + static_cast<size_t>(g) * N;
  const int nchunks = (N + kWQ - 1) / kWQ;
  stage_wide(qg, dog, lg, tg, 0, N, D, d0, W, qd, qd + kWQ * kLdQ, lt, lt + kWQ);
  cp_async_commit();

  // the block's k and v rows of its slice, split once; zero past M and W
  for (int e = tid; e < kWKeys * kWD; e += kWThreads) {
    const int r = e / kWD, c = e - r * kWD;
    const bool ok = j0 + r < M && c < W;
    const size_t src = gk + static_cast<size_t>(j0 + r) * D + d0 + c;
    uint2 a, b;
    mocopci::split_tf32(ok ? k[src] : 0.f, a.x, a.y);
    mocopci::split_tf32(ok ? v[src] : 0.f, b.x, b.y);
    kt_s[r * kLdKV + c] = a;
    vt_s[r * kLdKV + c] = b;
  }
  if (W < kWD) {      // the dims past the slice stay zero in both buffers
    for (int e = tid; e < 4 * kWQ * (kWD - W); e += kWThreads) {
      const int r = e / (kWD - W);
      qd[r * kLdQ + W + (e - r * (kWD - W))] = 0.f;
    }
  }

  // S / dP product: this warp's k half, operand (0: S = q k^T, 1: dP = do v^T)
  // and n-tile of keys; its k-steps of the slice, then of the other dims
  const int khalf = warp >> 3, op = (warp >> 2) & 1, snt = warp & 3;
  const int ks_own = (W + 7) >> 3, ks_mid = (ks_own + 1) >> 1;
  const int ks_lo = khalf ? ks_mid : 0, ks_hi = khalf ? ks_own : ks_mid;
  const uint2* bsrc = (op ? vt_s : kt_s) + (snt * 8 + gid) * kLdKV + tig;
  const float* gA = (op ? dog : qg);
  const float* gB = (op ? v : k) + gk;
  const int jB = j0 + snt * 8 + gid;
  // the dk / dv / dq products: this warp's head dims [wd, wd + kWDW) of the slice
  const int wd = warp * kWDW;
  const bool has_dims = wd < W;
  float adk[2][kWNT][4], adv[2][kWNT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kWNT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) adk[m][n][r] = adv[m][n][r] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int b = c & 1, i0 = c * kWQ;
    cp_async_wait0();
    __syncthreads();        // chunk c has landed; every warp is done with chunk c - 1
    if (c + 1 < nchunks) {
      float* nb = qd + (b ^ 1) * 2 * kWQ * kLdQ;
      float* nl = lt + (b ^ 1) * 2 * kWQ;
      stage_wide(qg, dog, lg, tg, i0 + kWQ, N, D, d0, W, nb, nb + kWQ * kLdQ, nl, nl + kWQ);
      cp_async_commit();
    }
    const float* qb = qd + b * 2 * kWQ * kLdQ;
    const float* db = qb + kWQ * kLdQ;
    const float* lb = lt + b * 2 * kWQ;
    const float* tb = lb + kWQ;

    {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* a = (op ? db : qb) + gid * kLdQ + tig;
#pragma unroll 4
      for (int ks = ks_lo; ks < ks_hi; ++ks) {
        const float* ak = a + ks * 8;
        mocopci::FragA fa;
        fa.set({ak[0], ak[8 * kLdQ], ak[4], ak[8 * kLdQ + 4]});
        const uint2 b0 = bsrc[ks * 8], b1 = bsrc[ks * 8 + 4];
        mocopci::FragB fb;
        fb.hi[0] = b0.x, fb.lo[0] = b0.y, fb.hi[1] = b1.x, fb.lo[1] = b1.y;
        mocopci::mma_3xtf32(acc, fa, fb);
      }
      // head dims outside the slice (D > kWD), read from global memory: the
      // k halves take alternate k-steps
      for (int ks = khalf; D > kWD && ks < (D + 7) >> 3; ks += 2) {
        const int dd = ks * 8;
        if (dd >= d0 && dd < d0 + kWD) continue;
        float av[4], bv[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + gid + 8 * (r & 1), col = dd + tig + 4 * (r >> 1);
          av[r] = i < N && col < D ? gA[static_cast<size_t>(i) * D + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = dd + tig + 4 * r;
          bv[r] = jB < M && col < D ? gB[static_cast<size_t>(jB) * D + col] : 0.f;
        }
        mocopci::FragA fa;
        fa.set(av);
        mocopci::FragB fb;
        fb.set(bv[0], bv[1]);
        mocopci::mma_3xtf32(acc, fa, fb);
      }
      float* out_s = sdp + (khalf * 2 + op) * kWQ * kLdS + gid * kLdS + snt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(out_s) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(out_s + 8 * kLdS) = make_float2(acc[2], acc[3]);
    }
    __syncthreads();        // S and dP of the chunk are complete

    {                       // one pair a thread: P keep and dS, split
      const int i = tid / kWKeys, j = tid - i * kWKeys;
      const float* s0 = sdp + i * kLdS + j;
      const float S = s0[0] + s0[2 * kWQ * kLdS];
      const float dP = s0[kWQ * kLdS] + s0[3 * kWQ * kLdS];
      const int ig = i0 + i, jg = j0 + j;
      const float P = ig < N && jg < M ? exp2f(fmaf(S, c2, -lb[i] * kLog2e)) : 0.f;
      float pd = P, dsv;
      if (DROP) {
        const float kf = keep_factor(gseed, ig, jg, thr, kscale);
        pd = P * kf;
        dsv = P * (dP * kf - tb[i]);
      } else {
        dsv = P * (dP - tb[i]);
      }
      uint2 hp, hs;
      mocopci::split_tf32(pd, hp.x, hp.y);
      mocopci::split_tf32(dsv, hs.x, hs.y);
      pds[i * kLdP + j] = hp;
      pds[kWQ * kLdP + i * kLdP + j] = hs;
    }
    __syncthreads();        // the chunk's P keep and dS are complete

    if (has_dims) {
      const uint2* pk = pds;
      const uint2* dsp = pds + kWQ * kLdP;
      // dv += (P keep)^T do, dk += dS^T q: keys are the M, queries the K
#pragma unroll
      for (int ks = 0; ks < kWQ / 8; ++ks) {
        mocopci::FragA fp[2], fs[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int a = (ks * 8 + tig) * kLdP + m * 16 + gid;
          frag_of_pairs(fp[m], pk[a], pk[a + 8], pk[a + 4 * kLdP], pk[a + 4 * kLdP + 8]);
          frag_of_pairs(fs[m], dsp[a], dsp[a + 8], dsp[a + 4 * kLdP], dsp[a + 4 * kLdP + 8]);
        }
#pragma unroll
        for (int n = 0; n < kWNT; ++n) {
          const int o = (ks * 8 + tig) * kLdQ + wd + n * 8 + gid;
          mocopci::FragB fo, fq;
          fo.set(db[o], db[o + 4 * kLdQ]);
          fq.set(qb[o], qb[o + 4 * kLdQ]);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mocopci::mma_3xtf32(adv[m][n], fp[m], fo);
            mocopci::mma_3xtf32(adk[m][n], fs[m], fq);
          }
        }
      }
      // dq_part = dS k over the block's keys: queries the M, keys the K
      float aq[kWNT][4];
#pragma unroll
      for (int n = 0; n < kWNT; ++n) aq[n][0] = aq[n][1] = aq[n][2] = aq[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kWKeys / 8; ++ks) {
        const int a = gid * kLdP + ks * 8 + tig;
        mocopci::FragA fa;
        frag_of_pairs(fa, dsp[a], dsp[a + 8 * kLdP], dsp[a + 4], dsp[a + 8 * kLdP + 4]);
#pragma unroll
        for (int n = 0; n < kWNT; ++n) {
          const uint2* kb = kt_s + (ks * 8 + tig) * kLdKV + wd + n * 8 + gid;
          const uint2 b0 = kb[0], b1 = kb[4 * kLdKV];
          mocopci::FragB fb;
          fb.hi[0] = b0.x, fb.lo[0] = b0.y, fb.hi[1] = b1.x, fb.lo[1] = b1.y;
          mocopci::mma_3xtf32(aq[n], fa, fb);
        }
      }
      float* part = dq_part + ((static_cast<size_t>(g) * gridDim.x + kt) * N) * D + d0;
#pragma unroll
      for (int n = 0; n < kWNT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + gid + 8 * (r >> 1), col = wd + n * 8 + 2 * tig + (r & 1);
          if (i < N && col < W) part[static_cast<size_t>(i) * D + col] = aq[n][r];
        }
    }
  }

  if (has_dims) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < kWNT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + m * 16 + gid + 8 * (r >> 1), col = wd + n * 8 + 2 * tig + (r & 1);
          if (j < M && col < W) {
            const size_t o = gk + static_cast<size_t>(j) * D + d0 + col;
            dk[o] = adk[m][n][r] * scale;
            dv[o] = adv[m][n][r];
          }
        }
  }
}

template <bool DROP>
cudaError_t launch_bwd_wide(const float* q, const float* k, const float* v, const float* lse,
                            const float* dot, const float* dout, float* dk, float* dv,
                            float* part, int G, int N, int M, int D, float scale,
                            const int* seed, int thr, float kscale, cudaStream_t st) {
  cudaError_t err = mocopci::allow_smem(attention_train_bwd_wide_kernel<DROP>, kWideSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(mocopci::ceil_div(M, kWKeys), G, mocopci::ceil_div(D, kWD));
  attention_train_bwd_wide_kernel<DROP><<<grid, kWThreads, kWideSmem, st>>>(
      q, k, v, lse, dot, dout, dk, dv, part, N, M, D, scale, seed, thr, kscale);
  return cudaGetLastError();
}

}  // namespace

// q (G, N, D), k/v (G, M, D) -> out (G, N, D), lse (G, N) for D <= 64, in one
// pass over the keys; M <= 4096; seed: one int32 in device memory (the
// caller's random draw stays on the card).  thr = int32(rate * 2^24), kscale
// = f32(1 / (1 - rate)); rate 0 (thr 0, kscale 1) takes the kernel without
// the keep factor.
MOCOPCI_API int mocopci_attention_train_fwd(const float* q, const float* k, const float* v,
                                            float* out, float* lse, int G, int N, int M, int D,
                                            float scale, const int* seed, int thr,
                                            float kscale, void* stream) {
  if (D < 1 || D > kMaxFwdD) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int DP = D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : 64;
  const bool drop = thr > 0 || kscale != 1.f;
  return drop ? launch_fwd_dp<true>(DP, q, k, v, out, lse, G, N, M, D, scale, seed, thr, kscale,
                                    st)
              : launch_fwd_dp<false>(DP, q, k, v, out, lse, G, N, M, D, scale, seed, thr,
                                     kscale, st);
}

// The wide route, D > 64: the same outputs for any D <= 2048, in one pass
// over the keys on the tensor cores (M <= 4096).  Rate 0 (thr 0, kscale 1)
// takes the kernel without the keep factor.
MOCOPCI_API int mocopci_attention_train_fwd_wide(const float* q, const float* k, const float* v,
                                                 float* out, float* lse, int G, int N, int M,
                                                 int D, float scale, const int* seed, int thr,
                                                 float kscale, void* stream) {
  if (D <= kYC) return cudaErrorInvalidValue;     // the v rows come with each tile's chunk 1
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = thr > 0 || kscale != 1.f;
  return drop ? launch_fwd_wide<true>(q, k, v, out, lse, G, N, M, D, scale, seed, thr, kscale,
                                      st)
              : launch_fwd_wide<false>(q, k, v, out, lse, G, N, M, D, scale, seed, thr, kscale,
                                       st);
}

// The wide route, D > 64: the saved forward (q, k, v, out, lse) and dout ->
// dq, dk, dv for any D <= 2048.  work: f32 scratch of G * ceil(M / 32) * N * D
// + G * N entries: the dq partials, then the rows' dot = do . out.  Dropout
// off (thr 0, kscale 1) takes the kernel without the keep factor.
MOCOPCI_API int mocopci_attention_train_bwd_wide(const float* q, const float* k,
                                                 const float* v, const float* out,
                                                 const float* lse, const float* dout, float* dq,
                                                 float* dk, float* dv, float* work, int G, int N,
                                                 int M, int D, float scale, const int* seed,
                                                 int thr, float kscale, void* stream) {
  if (D < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int KT = mocopci::ceil_div(M, kWKeys);
  float* part = work;
  float* dot = work + static_cast<size_t>(G) * KT * N * D;
  const int rows = G * N;
  attention_train_bwd_dot_kernel<<<mocopci::ceil_div(rows, 256), 256, 0, st>>>(out, dout, dot,
                                                                               rows, D);
  MOCOPCI_CHECK_LAUNCH();
  const bool drop = thr > 0 || kscale != 1.f;
  cudaError_t err = drop ? launch_bwd_wide<true>(q, k, v, lse, dot, dout, dk, dv, part, G, N, M,
                                                 D, scale, seed, thr, kscale, st)
                         : launch_bwd_wide<false>(q, k, v, lse, dot, dout, dk, dv, part, G, N,
                                                  M, D, scale, seed, thr, kscale, st);
  if (err != cudaSuccess) return err;
  const size_t E = static_cast<size_t>(G) * N * D;
  attention_train_bwd_dq_kernel<<<static_cast<unsigned>((E + 255) / 256), 256, 0, st>>>(
      part, dq, G, KT, N, D, D, scale);
  return cudaGetLastError();
}

// The one-pass route, D <= 64: the saved forward and dout -> dq, dk, dv.
// work: f32 scratch of G * ceil(M / 64) * N * DP + G * N entries, DP the padded
// head dim (8, 16, 32 or 64): the dq partials, then the rows' dot = do . out.
// Dropout off (thr 0, kscale 1) takes the kernel without the keep factor.
MOCOPCI_API int mocopci_attention_train_bwd(const float* q, const float* k, const float* v,
                                            const float* out, const float* lse,
                                            const float* dout, float* dq, float* dk, float* dv,
                                            float* work, int G, int N, int M, int D,
                                            float scale, const int* seed, int thr, float kscale,
                                            void* stream) {
  if (D < 1 || D > kMaxBwdD) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int DP = D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : 64;
  const int KT = mocopci::ceil_div(M, kBwdKeys);
  float* part = work;
  float* dot = work + static_cast<size_t>(G) * KT * N * DP;
  const int rows = G * N;
  attention_train_bwd_dot_kernel<<<mocopci::ceil_div(rows, 256), 256, 0, st>>>(out, dout, dot,
                                                                               rows, D);
  MOCOPCI_CHECK_LAUNCH();
  const bool drop = thr > 0 || kscale != 1.f;
  cudaError_t err = drop ? launch_bwd_dp<true>(DP, q, k, v, lse, dot, dout, dk, dv, part, G, N,
                                                M, D, scale, seed, thr, kscale, st)
                         : launch_bwd_dp<false>(DP, q, k, v, lse, dot, dout, dk, dv, part, G,
                                                 N, M, D, scale, seed, thr, kscale, st);
  if (err != cudaSuccess) return err;
  const size_t E = static_cast<size_t>(G) * N * D;
  attention_train_bwd_dq_kernel<<<static_cast<unsigned>((E + 255) / 256), 256, 0, st>>>(
      part, dq, G, KT, N, D, DP, scale);
  return cudaGetLastError();
}
