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
//   forward   one block per (group, tile of 8 queries); the tile's logit rows
//             stay in shared memory (as csrc/attention.cu), the keep factor is
//             applied to the numerators, and the row's log-sum-exp is written
//             for the backward;
//   backward  dk/dv: one block per (group, key tile) looping over query
//             chunks; dq: one block per (group, query tile) looping over key
//             chunks.  Both rebuild the pair quantities P = exp(l - lse),
//             P*keep and P*(keep*(do.v) - do.out) for a (chunk x tile) in
//             shared memory, then accumulate their rows in registers in a
//             fixed order.  Every output element has one owner thread, so no
//             atomics and the result repeats bit for bit.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 8;        // forward query tile
constexpr int kChunk = 64;    // backward: rows of the looped-over operand per step
constexpr int kOwn = 8;       // backward: max accumulator elements per thread

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// gseed = fmix32(g ^ seed)
__device__ __forceinline__ float keep_factor(uint32_t gseed, int row, int col, int thr,
                                             float kscale) {
  const uint32_t ctr = (static_cast<uint32_t>(row) << 12) ^ static_cast<uint32_t>(col);
  const uint32_t h = fmix32(ctr ^ gseed);
  return static_cast<int>(h & 0xFFFFFFu) >= thr ? kscale : 0.f;
}

__global__ void __launch_bounds__(kThreads) attention_train_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int N, int M, int D, float scale,
    const int* __restrict__ seed, int thr, float kscale) {
  extern __shared__ float sm[];
  float* qs = sm;                      // [kTQ][D]
  float* lg = qs + kTQ * D;            // [kTQ][M]  logits, then numerators * keep
  float* red = lg + kTQ * M;           // [kThreads][kTQ]
  float* rsum = red + kThreads * kTQ;  // [kTQ]
  const int g = blockIdx.y;
  const int n0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x;
  const int rows = min(kTQ, N - n0);
  const uint32_t gseed = fmix32(static_cast<uint32_t>(g) ^ static_cast<uint32_t>(*seed));
  const float* qg = q + (static_cast<size_t>(g) * N + n0) * D;
  const float* kg = k + static_cast<size_t>(g) * M * D;
  const float* vg = v + static_cast<size_t>(g) * M * D;

  for (int e = tid; e < kTQ * D; e += kThreads) qs[e] = e < rows * D ? qg[e] : 0.f;
  __syncthreads();

  for (int j = tid; j < M; j += kThreads) {
    float acc[kTQ];
#pragma unroll
    for (int i = 0; i < kTQ; ++i) acc[i] = 0.f;
    const float* kr = kg + static_cast<size_t>(j) * D;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) acc[i] = fmaf(qs[i * D + d], kv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kTQ; ++i) lg[i * M + j] = acc[i] * scale;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int i = warp; i < kTQ; i += kThreads / 32) {
    float m = -__int_as_float(0x7f800000);
    for (int j = lane; j < M; j += 32) m = fmaxf(m, lg[i * M + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int j = lane; j < M; j += 32) {
      const float e = expf(lg[i * M + j] - m);
      lg[i * M + j] = e * keep_factor(gseed, n0 + i, j, thr, kscale);
      s += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      rsum[i] = s;
      if (i < rows) lse[static_cast<size_t>(g) * N + n0 + i] = m + logf(s);
    }
  }
  __syncthreads();

  for (int d0 = 0; d0 < D; d0 += kThreads) {
    const int dw = min(kThreads, D - d0);
    const int js = kThreads / dw;
    const int d = d0 + tid % dw;
    const int sl = tid / dw;
    float acc[kTQ];
#pragma unroll
    for (int i = 0; i < kTQ; ++i) acc[i] = 0.f;
    if (sl < js) {
      for (int j = sl; j < M; j += js) {
        const float vv = vg[static_cast<size_t>(j) * D + d];
#pragma unroll
        for (int i = 0; i < kTQ; ++i) acc[i] = fmaf(lg[i * M + j], vv, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kTQ; ++i) red[tid * kTQ + i] = acc[i];
    __syncthreads();
    for (int e = tid; e < kTQ * dw; e += kThreads) {
      const int i = e / dw, c = e - i * dw;
      float s = 0.f;
      for (int t = 0; t < js; ++t) s += red[(t * dw + c) * kTQ + i];
      if (i < rows) out[(static_cast<size_t>(g) * N + n0 + i) * D + d0 + c] = s / rsum[i];
    }
    __syncthreads();
  }
}

// Loads rows [r0, r0 + n) of a (L, D) operand into dst [n][ld], zero past L.
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int r0, int n, int L,
                                          int D, float* dst, int ld) {
  for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
    const int r = e / D, c = e - (e / D) * D;
    dst[r * ld + c] = r0 + r < L ? src[static_cast<size_t>(r0) * D + e] : 0.f;
  }
}

// Per-row backward constants of query rows [i0, i0 + n): lse and dot = do . out.
__device__ __forceinline__ void load_row_stats(const float* __restrict__ lse_g,
                                               const float* __restrict__ out_g,
                                               const float* dos, int i0, int n, int N, int D,
                                               float* ls, float* dot) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float acc = 0.f, l = 0.f;
    if (i0 + i < N) {
      const float* o = out_g + static_cast<size_t>(i0 + i) * D;
      for (int d = 0; d < D; ++d) acc = fmaf(dos[i * D + d], o[d], acc);
      l = lse_g[i0 + i];
    }
    dot[i] = acc;
    ls[i] = l;
  }
}

// For query rows i < ni (global i0 + i) and key rows j < nj (global j0 + j):
//   PD[i][j] = P * keep,  DL[i][j] = P * (keep * (do_i . v_j) - dot_i),
// with P = exp(scale * q_i . k_j - lse_i); zero outside the (N, M) range.
// Neighbouring threads take neighbouring j, so the k / v tiles are stored
// with a row stride of D + 1: their loads then fall in distinct banks.
__device__ void pair_tile(const float* qs, const float* dos, const float* ks, const float* vs,
                          const float* ls, const float* dot, int ni, int nj, int i0, int j0,
                          int N, int M, int D, float scale, uint32_t gseed, int thr,
                          float kscale, float* PD, float* DL, int ld) {
  const int ldk = D + 1;
  for (int p = threadIdx.x; p < ni * nj; p += blockDim.x) {
    const int i = p / nj, j = p - (p / nj) * nj;
    float pd = 0.f, dl = 0.f;
    if (i0 + i < N && j0 + j < M) {
      float l = 0.f, da = 0.f;
      for (int d = 0; d < D; ++d) {
        l = fmaf(qs[i * D + d], ks[j * ldk + d], l);
        da = fmaf(dos[i * D + d], vs[j * ldk + d], da);
      }
      const float P = expf(l * scale - ls[i]);
      const float kf = keep_factor(gseed, i0 + i, j0 + j, thr, kscale);
      pd = P * kf;
      dl = P * (da * kf - dot[i]);
    }
    if (PD != nullptr) PD[i * ld + j] = pd;
    DL[i * ld + j] = dl;
  }
}

// dk, dv for a tile of TK keys, looping over all queries in chunks.
__global__ void __launch_bounds__(kThreads) attention_train_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ out, const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, int N, int M, int D, int TK, float scale,
    const int* __restrict__ seed, int thr, float kscale) {
  extern __shared__ float sm[];
  float* ks = sm;                       // [TK][D + 1]
  float* vs = ks + TK * (D + 1);        // [TK][D + 1]
  float* qs = vs + TK * (D + 1);        // [kChunk][D]
  float* dos = qs + kChunk * D;         // [kChunk][D]
  float* ls = dos + kChunk * D;         // [kChunk]
  float* dot = ls + kChunk;             // [kChunk]
  float* PD = dot + kChunk;             // [kChunk][TK + 1]
  float* DL = PD + kChunk * (TK + 1);   // [kChunk][TK + 1]
  const int g = blockIdx.y;
  const int j0 = blockIdx.x * TK;
  const int tid = threadIdx.x;
  const uint32_t gseed = fmix32(static_cast<uint32_t>(g) ^ static_cast<uint32_t>(*seed));
  const size_t gq = static_cast<size_t>(g) * N * D, gk = static_cast<size_t>(g) * M * D;
  load_rows(k + gk, j0, TK, M, D, ks, D + 1);
  load_rows(v + gk, j0, TK, M, D, vs, D + 1);
  float adk[kOwn], adv[kOwn];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) adk[u] = adv[u] = 0.f;
  const int E = TK * D;
  for (int i0 = 0; i0 < N; i0 += kChunk) {
    __syncthreads();
    load_rows(q + gq, i0, kChunk, N, D, qs, D);
    load_rows(dout + gq, i0, kChunk, N, D, dos, D);
    __syncthreads();
    load_row_stats(lse + static_cast<size_t>(g) * N, out + gq, dos, i0, kChunk, N, D, ls, dot);
    __syncthreads();
    pair_tile(qs, dos, ks, vs, ls, dot, kChunk, TK, i0, j0, N, M, D, scale, gseed, thr, kscale,
              PD, DL, TK + 1);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      const int e = tid + u * kThreads;
      if (e < E) {
        const int j = e / D, d = e - (e / D) * D;
        float a = adk[u], b = adv[u];
        for (int i = 0; i < kChunk; ++i) {
          b = fmaf(PD[i * (TK + 1) + j], dos[i * D + d], b);
          a = fmaf(DL[i * (TK + 1) + j], qs[i * D + d], a);
        }
        adk[u] = a;
        adv[u] = b;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int e = tid + u * kThreads;
    if (e < E && j0 + e / D < M) {
      dk[gk + static_cast<size_t>(j0) * D + e] = adk[u] * scale;
      dv[gk + static_cast<size_t>(j0) * D + e] = adv[u];
    }
  }
}

// dq for a tile of TQ queries, looping over all keys in chunks.
__global__ void __launch_bounds__(kThreads) attention_train_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ out, const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ dq, int N, int M, int D, int TQ, float scale,
    const int* __restrict__ seed, int thr, float kscale) {
  extern __shared__ float sm[];
  float* qs = sm;                       // [TQ][D]
  float* dos = qs + TQ * D;             // [TQ][D]
  float* ls = dos + TQ * D;             // [TQ]
  float* dot = ls + TQ;                 // [TQ]
  float* ks = dot + TQ;                 // [kChunk][D + 1]
  float* vs = ks + kChunk * (D + 1);    // [kChunk][D + 1]
  float* DL = vs + kChunk * (D + 1);    // [TQ][kChunk + 1]
  const int g = blockIdx.y;
  const int i0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const uint32_t gseed = fmix32(static_cast<uint32_t>(g) ^ static_cast<uint32_t>(*seed));
  const size_t gq = static_cast<size_t>(g) * N * D, gk = static_cast<size_t>(g) * M * D;
  load_rows(q + gq, i0, TQ, N, D, qs, D);
  load_rows(dout + gq, i0, TQ, N, D, dos, D);
  __syncthreads();
  load_row_stats(lse + static_cast<size_t>(g) * N, out + gq, dos, i0, TQ, N, D, ls, dot);
  float adq[kOwn];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) adq[u] = 0.f;
  const int E = TQ * D;
  for (int j0 = 0; j0 < M; j0 += kChunk) {
    __syncthreads();
    load_rows(k + gk, j0, kChunk, M, D, ks, D + 1);
    load_rows(v + gk, j0, kChunk, M, D, vs, D + 1);
    __syncthreads();
    pair_tile(qs, dos, ks, vs, ls, dot, TQ, kChunk, i0, j0, N, M, D, scale, gseed, thr, kscale,
              nullptr, DL, kChunk + 1);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      const int e = tid + u * kThreads;
      if (e < E) {
        const int i = e / D, d = e - (e / D) * D;
        float a = adq[u];
        for (int j = 0; j < kChunk; ++j) a = fmaf(DL[i * (kChunk + 1) + j], ks[j * (D + 1) + d], a);
        adq[u] = a;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int e = tid + u * kThreads;
    if (e < E && i0 + e / D < N) dq[gq + static_cast<size_t>(i0) * D + e] = adq[u] * scale;
  }
}

// rows per tile so that tile * D <= kThreads * kOwn accumulators
inline int tile_rows(int D) { return max(1, min(128, kThreads * kOwn / 2 / D)); }

}  // namespace

// q (G, N, D), k/v (G, M, D) -> out (G, N, D), lse (G, N); M <= 4096; seed: one
// int32 in device memory (the caller's random draw stays on the card).
// thr = int32(rate * 2^24), kscale = f32(1 / (1 - rate)); rate 0: thr 0, kscale 1.
MOCOPCI_API int mocopci_attention_train_fwd(const float* q, const float* k, const float* v,
                                            float* out, float* lse, int G, int N, int M, int D,
                                            float scale, const int* seed, int thr,
                                            float kscale, void* stream) {
  const size_t smem =
      (static_cast<size_t>(kTQ) * (D + M) + kThreads * kTQ + kTQ) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(attention_train_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mocopci::ceil_div(N, kTQ), G);
  attention_train_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, lse, N, M, D, scale, seed, thr, kscale);
  return cudaGetLastError();
}

// Saved forward (q, k, v, out, lse) and dout (G, N, D) -> dq, dk, dv.  D <= 1024.
MOCOPCI_API int mocopci_attention_train_bwd(const float* q, const float* k, const float* v,
                                            const float* out, const float* lse,
                                            const float* dout, float* dq, float* dk, float* dv,
                                            int G, int N, int M, int D, float scale,
                                            const int* seed, int thr, float kscale,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = tile_rows(D);
  const size_t smem_kv =
      (2 * static_cast<size_t>(T) * (D + 1) + 2 * kChunk * static_cast<size_t>(D) + 2 * kChunk +
       2 * kChunk * static_cast<size_t>(T + 1)) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(attention_train_dkv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  attention_train_dkv_kernel<<<dim3(mocopci::ceil_div(M, T), G), kThreads, smem_kv, st>>>(
      q, k, v, out, lse, dout, dk, dv, N, M, D, T, scale, seed, thr, kscale);
  MOCOPCI_CHECK_LAUNCH();
  const size_t smem_q =
      (2 * static_cast<size_t>(T) * D + 2 * T + 2 * kChunk * static_cast<size_t>(D + 1) +
       static_cast<size_t>(T) * (kChunk + 1)) * sizeof(float);
  err = mocopci::allow_smem(attention_train_dq_kernel, smem_q);
  if (err != cudaSuccess) return err;
  attention_train_dq_kernel<<<dim3(mocopci::ceil_div(N, T), G), kThreads, smem_q, st>>>(
      q, k, v, out, lse, dout, dq, N, M, D, T, scale, seed, thr, kscale);
  return cudaGetLastError();
}
