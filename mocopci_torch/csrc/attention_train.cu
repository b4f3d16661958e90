// Training attention: out = (softmax(q k^T * scale) * keep) v in f32, with the
// dropout keep factors a pure function of (seed, g, row, col), and its
// backward (dq, dk, dv) with the same factors rebuilt.
//
// Replaces mocopci_tpu/ops/pallas/attention_train.py: attention_train (:160),
// forward pallas_call :181 and backward pallas_call :206.  The keep factor is
// h = fmix32(((row << s) ^ col) ^ fmix32(g ^ seed)) in uint32 (murmur3's
// finaliser), kept where the low 24 bits, as int32, are >= int32(rate *
// 2^24), scaled by f32(1 / (1 - rate)); s = row_shift(M) = max(12,
// ceil(log2 M)) (attention_fwd.cuh).  Up to 4096 keys s = 12 and h is the TPU
// kernel's _keep_mask (:46-64) bit for bit; past 4096 keys, where the TPU's
// counter would alias (its JAX module takes an XLA path there), the shift
// grows with M so that every pair keeps a counter of its own.
//
// Bound on the H100: operations (4*N*M*D flops forward, about 10*N*M*D
// backward, against (N + M)*D*4 bytes per group).  Design:
//   forward, head dims D <= 64: one pass over the keys, streamed through
//             shared memory, with an online softmax, no hash at rate 0;
//   forward, D > 64 (the "wide" route): one pass over the keys as well,
//             its two products on the tensor cores at float32 grade; the keep
//             factor is applied to the numerators, and the row's
//             log-sum-exp is written for the backward (both bodies, shared
//             with the eval attention, are in attention_fwd.cuh);
//   backward, head dims D <= 64: one pass over the pairs, each pair's logit,
//             do.v, exp and keep factor computed once (see the block comment
//             above attention_train_bwd_kernel), no hash at rate 0;
//   backward, D > 64 (the wide route): one pass over the pairs as well,
//             its five products on the tensor cores at float32 grade (see the
//             block comment above attention_train_bwd_wide_kernel).
// Every output element is summed in a fixed order by one owner, with no
// atomics, so the result repeats bit for bit.
#include "attention_fwd.cuh"

namespace {

// gseed = fmix32(g ^ seed), sh = row_shift(M)
__device__ __forceinline__ float keep_factor(uint32_t gseed, int sh, int row, int col, int thr,
                                             float kscale) {
  const uint32_t ctr = (static_cast<uint32_t>(row) << sh) ^ static_cast<uint32_t>(col);
  const uint32_t h = fmix32(ctr ^ gseed);
  return static_cast<int>(h & 0xFFFFFFu) >= thr ? kscale : 0.f;
}

template <int DP, int KSC, bool DROP>
__global__ void __launch_bounds__(kFwdMaxThreads) attention_train_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int N, int M, int D, float scale,
    const int* __restrict__ seed, int thr, float kscale, int KS) {
  attention_fwd_body<DP, KSC, DROP, true>(q, k, v, out, lse, N, M, D, scale, seed, thr, kscale,
                                          KS);
}

template <bool DROP>
__global__ void __launch_bounds__(kYThreads, 1) attention_train_fwd_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int N, int M, int D, float scale,
    const int* __restrict__ seed, int thr, float kscale) {
  attention_fwd_wide_body<DROP, true>(q, k, v, out, lse, N, M, D, scale, seed, thr, kscale);
}

template <int DP, int KSC, bool DROP>
cudaError_t launch_fwd_splits(const float* q, const float* k, const float* v, float* out,
                              float* lse, int N, int M, int D, float scale, const int* seed,
                              int thr, float kscale, dim3 grid, int threads, int ks,
                              cudaStream_t st) {
  constexpr size_t smem = FwdTile<DP>::smem_bytes;
  cudaError_t err = mocopci::allow_smem(attention_train_fwd_kernel<DP, KSC, DROP>, smem);
  if (err != cudaSuccess) return err;
  attention_train_fwd_kernel<DP, KSC, DROP><<<grid, threads, smem, st>>>(
      q, k, v, out, lse, N, M, D, scale, seed, thr, kscale, ks);
  return cudaGetLastError();
}

template <int DP, bool DROP>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* out, float* lse,
                       int G, int N, int M, int D, float scale, const int* seed, int thr,
                       float kscale, cudaStream_t st) {
  dim3 grid;
  int threads, ks;
  one_pass_grid<DP>(G, N, grid, threads, ks);
  return ks == 1 ? launch_fwd_splits<DP, 1, DROP>(q, k, v, out, lse, N, M, D, scale, seed, thr,
                                                  kscale, grid, threads, ks, st)
                 : launch_fwd_splits<DP, 0, DROP>(q, k, v, out, lse, N, M, D, scale, seed, thr,
                                                  kscale, grid, threads, ks, st);
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
  const int sh = row_shift(M);
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
        const float kf = keep_factor(gseed, sh, i0 + i, jg, thr, kscale);
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
  const int sh = row_shift(M);
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
        const float kf = keep_factor(gseed, sh, ig, jg, thr, kscale);
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
// pass over the keys (M <= 16384); seed: one int32 in device memory (the
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
// over the keys on the tensor cores (M <= 16384).  Rate 0 (thr 0, kscale 1)
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
