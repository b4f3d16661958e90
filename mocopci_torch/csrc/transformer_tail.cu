// Point-transformer tail of the refine head, per query n over its K neighbours:
//   pos_j  = relu((xq - xyz_j) Wd1 + bd1) Wd2 + bd2
//   l_j    = relu(((q - k_j) + pos_j) Wg1 + bg1) Wg2 + bg2
//   a_j    = softmax_j(l_j / sqrt(D))            (per channel)
//   out    = sum_j a_j * (v_j + pos_j)
// with rows [xyz | k | v] gathered from the (B, M, 3+2D) table by idx.
//
// Replaces mocopci_tpu/ops/pallas/transformer_tail.py: transformer_tail
// forward (:212, pallas_call :219), dispatched for N >= 1024
// (nn/transformer.py:54), and its backward (:237, pallas_call :244,
// _bwd_kernel :113).  The forward emits no running (m, l): the backward
// recomputes the whole per-channel softmax over the K neighbours instead.
//
// Bound on the H100: operations, 2*N*K*(3D + 3D^2) flops (3.2 GFLOP at the
// refine head) against N*K*(3+2D)*4 gathered bytes.  Design: one block per
// tile of QT queries; the four weight matrices (3D^2+3D floats, 49 KB at
// D=64) are loaded into shared memory once per block.  Per query the K x D
// activations of each stage stay in shared memory; thread t computes items
// (j, e) with e fastest, so weight reads are conflict-free and activation
// reads are warp broadcasts.  The final per-channel softmax over K is done by
// one thread per channel.  No (N, K, D) tensor is written to HBM.
//
// Backward design: the same per-query recompute, then the chain's VJP with
// transposed weight copies in shared memory; the eight weight/bias gradients
// accumulate in shared memory (one owner thread per element) over a fixed set
// of queries per block and are summed across blocks in block order, so the
// result repeats bit for bit.  Operations bound it (about 2.5x the forward).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 8;

// dst[j][e] = act(sum_f src[j][f] * w[f][e] + b[e]) for j < K, e < D
__device__ __forceinline__ void dense(const float* src, int fin, const float* w,
                                      const float* b, float* dst, int K, int D, bool relu) {
  for (int it = threadIdx.x; it < K * D; it += kThreads) {
    const int j = it / D, e = it - j * D;
    const float* s = src + j * fin;
    float acc = 0.f;
    for (int f = 0; f < fin; ++f) acc = fmaf(s[f], w[f * D + e], acc);
    acc += b[e];
    dst[it] = relu ? fmaxf(acc, 0.f) : acc;
  }
}

__global__ void __launch_bounds__(kThreads) transformer_tail_kernel(
    const float* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ xyzq, const float* __restrict__ q,
    const float* __restrict__ wd1, const float* __restrict__ bd1,
    const float* __restrict__ wd2, const float* __restrict__ bd2,
    const float* __restrict__ wg1, const float* __restrict__ bg1,
    const float* __restrict__ wg2, const float* __restrict__ bg2, float* __restrict__ out,
    int M, int N, int K, int D) {
  extern __shared__ float sm[];
  const int DD = D * D;
  float* s_wd1 = sm;             // [3][D]
  float* s_wd2 = s_wd1 + 3 * D;  // [D][D]
  float* s_wg1 = s_wd2 + DD;
  float* s_wg2 = s_wg1 + DD;
  float* s_b = s_wg2 + DD;       // bd1 | bd2 | bg1 | bg2, [4][D]
  float* rel = s_b + 4 * D;      // [K][3]
  float* qv = rel + 3 * K;       // [D]
  float* A = qv + D;             // [K][D] hidden
  float* P = A + K * D;          // [K][D] pos
  float* G = P + K * D;          // [K][D] gv, then logits
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  for (int e = tid; e < 3 * D; e += kThreads) s_wd1[e] = wd1[e];
  for (int e = tid; e < DD; e += kThreads) {
    s_wd2[e] = wd2[e];
    s_wg1[e] = wg1[e];
    s_wg2[e] = wg2[e];
  }
  for (int e = tid; e < D; e += kThreads) {
    s_b[e] = bd1[e];
    s_b[D + e] = bd2[e];
    s_b[2 * D + e] = bg1[e];
    s_b[3 * D + e] = bg2[e];
  }
  const int W = 3 + 2 * D;
  const float* tb = table + static_cast<size_t>(b) * M * W;
  const float inv = 1.f / sqrtf(static_cast<float>(D));

  for (int qi = 0; qi < kQT; ++qi) {
    const int n = blockIdx.x * kQT + qi;
    if (n >= N) break;
    const size_t bn = static_cast<size_t>(b) * N + n;
    const int* in = idx + bn * K;
    __syncthreads();
    for (int e = tid; e < 3 * K; e += kThreads) {
      const int j = e / 3, c = e - j * 3;
      rel[e] = xyzq[bn * 3 + c] - tb[static_cast<size_t>(in[j]) * W + c];
    }
    for (int e = tid; e < D; e += kThreads) qv[e] = q[bn * D + e];
    __syncthreads();
    dense(rel, 3, s_wd1, s_b, A, K, D, true);
    __syncthreads();
    dense(A, D, s_wd2, s_b + D, P, K, D, false);
    __syncthreads();
    for (int it = tid; it < K * D; it += kThreads) {
      const int j = it / D, e = it - j * D;
      G[it] = (qv[e] - tb[static_cast<size_t>(in[j]) * W + 3 + e]) + P[it];
    }
    __syncthreads();
    dense(G, D, s_wg1, s_b + 2 * D, A, K, D, true);
    __syncthreads();
    dense(A, D, s_wg2, s_b + 3 * D, G, K, D, false);
    __syncthreads();
    for (int e = tid; e < D; e += kThreads) {
      float m = -__int_as_float(0x7f800000);
      for (int j = 0; j < K; ++j) m = fmaxf(m, G[j * D + e] * inv);
      float s = 0.f, acc = 0.f;
      for (int j = 0; j < K; ++j) {
        const float a = expf(G[j * D + e] * inv - m);
        s += a;
        acc = fmaf(a, tb[static_cast<size_t>(in[j]) * W + 3 + D + e] + P[j * D + e], acc);
      }
      out[bn * D + e] = acc / s;
    }
  }
}

// dst[j][f] = sum_e src[j][e] * wt[e][f] for j < K, f < fout (wt = W^T, [D][fout])
__device__ __forceinline__ void dense_t(const float* src, const float* wt, float* dst, int K,
                                        int D, int fout) {
  for (int it = threadIdx.x; it < K * fout; it += kThreads) {
    const int j = it / fout, f = it - j * fout;
    const float* s = src + j * D;
    float acc = 0.f;
    for (int e = 0; e < D; ++e) acc = fmaf(s[e], wt[e * fout + f], acc);
    dst[it] = acc;
  }
}

// acc[f][e] += sum_j act(a[j][f]) * g[j][e]  (f < fin, e < D), and, if bias_acc,
// bias_acc[e] += sum_j g[j][e]; each element owned by one thread.
__device__ __forceinline__ void outer_acc(const float* a, int fin, bool relu, const float* g,
                                          float* acc, float* bias_acc, int K, int D) {
  for (int it = threadIdx.x; it < fin * D; it += kThreads) {
    const int f = it / D, e = it - f * D;
    float s = acc[it];
    for (int j = 0; j < K; ++j) {
      const float x = a[j * fin + f];
      s = fmaf(relu ? fmaxf(x, 0.f) : x, g[j * D + e], s);
    }
    acc[it] = s;
  }
  for (int e = threadIdx.x; e < D; e += kThreads) {
    float s = bias_acc[e];
    for (int j = 0; j < K; ++j) s += g[j * D + e];
    bias_acc[e] = s;
  }
}

// Backward of the tail, one query at a time per block (queries qf = blockIdx.x
// + t*gridDim.x of the flattened (B, N)).  The forward chain is recomputed in
// shared memory, the per-channel softmax over the K neighbours included, so the
// forward's running (m, l) are not needed: the TPU kernel saves them only
// because its forward softmax is online over a k-innermost grid.
__global__ void __launch_bounds__(kThreads) transformer_tail_bwd_kernel(
    const float* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ xyzq, const float* __restrict__ q,
    const float* __restrict__ wd1, const float* __restrict__ bd1,
    const float* __restrict__ wd2, const float* __restrict__ bd2,
    const float* __restrict__ wg1, const float* __restrict__ bg1,
    const float* __restrict__ wg2, const float* __restrict__ bg2,
    const float* __restrict__ dout, float* __restrict__ d_rows, float* __restrict__ dxq,
    float* __restrict__ dq, float* __restrict__ partial, int B, int M, int N, int K, int D) {
  extern __shared__ float sm[];
  const int DD = D * D;
  const int KD = K * D;
  float* s_wd1 = sm;               // [3][D]
  float* s_wd2 = s_wd1 + 3 * D;    // [D][D]
  float* s_wg1 = s_wd2 + DD;
  float* s_wg2 = s_wg1 + DD;
  float* s_b = s_wg2 + DD;         // bd1 | bd2 | bg1 | bg2
  float* t_wd1 = s_b + 4 * D;      // [D][3]  transposed copies
  float* t_wd2 = t_wd1 + 3 * D;    // [D][D]
  float* t_wg1 = t_wd2 + DD;
  float* t_wg2 = t_wg1 + DD;
  float* acc = t_wg2 + DD;         // dwd1 [3][D] | dbd1 | dwd2 [D][D] | dbd2 | dwg1 | dbg1 | dwg2 | dbg2
  float* a_wd1 = acc;
  float* a_bd1 = a_wd1 + 3 * D;
  float* a_wd2 = a_bd1 + D;
  float* a_bd2 = a_wd2 + DD;
  float* a_wg1 = a_bd2 + D;
  float* a_bg1 = a_wg1 + DD;
  float* a_wg2 = a_bg1 + D;
  float* a_bg2 = a_wg2 + DD;
  float* rel = a_bg2 + D;          // [K][3]
  float* drel = rel + 3 * K;       // [K][3]
  float* qv = drel + 3 * K;        // [D]
  float* dov = qv + D;             // [D]
  float* outv = dov + D;           // [D]
  float* H0 = outv + D;            // [K][D] pre-relu hidden of the pos MLP
  float* POS = H0 + KD;
  float* GV = POS + KD;            // q - k + pos
  float* H1 = GV + KD;             // pre-relu hidden of the gamma MLP
  float* A = H1 + KD;              // logits, then softmax weights
  float* WV = A + KD;              // v + pos, then its gradient
  float* DG2 = WV + KD;            // d(logit before the 1/sqrt(D) scale)
  float* DH1 = DG2 + KD;
  float* DGV = DH1 + KD;
  float* DPOS = DGV + KD;
  float* DH0 = DPOS + KD;
  const int tid = threadIdx.x;
  const int nacc = 3 * DD + 7 * D;
  for (int e = tid; e < 3 * D; e += kThreads) {
    s_wd1[e] = wd1[e];
    t_wd1[(e % D) * 3 + e / D] = wd1[e];
  }
  for (int e = tid; e < DD; e += kThreads) {
    const int f = e / D, c = e - f * D;
    s_wd2[e] = wd2[e];
    s_wg1[e] = wg1[e];
    s_wg2[e] = wg2[e];
    t_wd2[c * D + f] = wd2[e];
    t_wg1[c * D + f] = wg1[e];
    t_wg2[c * D + f] = wg2[e];
  }
  for (int e = tid; e < D; e += kThreads) {
    s_b[e] = bd1[e];
    s_b[D + e] = bd2[e];
    s_b[2 * D + e] = bg1[e];
    s_b[3 * D + e] = bg2[e];
  }
  for (int e = tid; e < nacc; e += kThreads) acc[e] = 0.f;
  const int W = 3 + 2 * D;
  const float inv = 1.f / sqrtf(static_cast<float>(D));

  for (int qf = blockIdx.x; qf < B * N; qf += gridDim.x) {
    const int b = qf / N;
    const float* tb = table + static_cast<size_t>(b) * M * W;
    const int* in = idx + static_cast<size_t>(qf) * K;
    __syncthreads();
    for (int e = tid; e < 3 * K; e += kThreads) {
      const int j = e / 3, c = e - j * 3;
      rel[e] = xyzq[static_cast<size_t>(qf) * 3 + c] - tb[static_cast<size_t>(in[j]) * W + c];
    }
    for (int e = tid; e < D; e += kThreads) {
      qv[e] = q[static_cast<size_t>(qf) * D + e];
      dov[e] = dout[static_cast<size_t>(qf) * D + e];
    }
    __syncthreads();
    dense(rel, 3, s_wd1, s_b, H0, K, D, false);
    __syncthreads();
    for (int it = tid; it < KD; it += kThreads) A[it] = fmaxf(H0[it], 0.f);   // scratch: r0
    __syncthreads();
    dense(A, D, s_wd2, s_b + D, POS, K, D, false);
    __syncthreads();
    for (int it = tid; it < KD; it += kThreads) {
      const int j = it / D, e = it - j * D;
      const float* row = tb + static_cast<size_t>(in[j]) * W;
      GV[it] = (qv[e] - row[3 + e]) + POS[it];
      WV[it] = row[3 + D + e] + POS[it];
    }
    __syncthreads();
    dense(GV, D, s_wg1, s_b + 2 * D, H1, K, D, false);
    __syncthreads();
    for (int it = tid; it < KD; it += kThreads) DH1[it] = fmaxf(H1[it], 0.f);  // scratch: r1
    __syncthreads();
    dense(DH1, D, s_wg2, s_b + 3 * D, A, K, D, false);
    __syncthreads();
    // per-channel softmax over j, out, then the softmax VJP
    for (int e = tid; e < D; e += kThreads) {
      float m = -__int_as_float(0x7f800000);
      for (int j = 0; j < K; ++j) m = fmaxf(m, A[j * D + e] * inv);
      float s = 0.f;
      for (int j = 0; j < K; ++j) {
        const float a = expf(A[j * D + e] * inv - m);
        A[j * D + e] = a;
        s += a;
      }
      float o = 0.f;
      for (int j = 0; j < K; ++j) {
        A[j * D + e] /= s;
        o = fmaf(A[j * D + e], WV[j * D + e], o);
      }
      outv[e] = o;
      const float g = dov[e];
      for (int j = 0; j < K; ++j) {
        const float a = A[j * D + e];
        DG2[j * D + e] = a * (g * WV[j * D + e] - g * o) * inv;
        WV[j * D + e] = g * a;                          // d(v + pos)
      }
    }
    __syncthreads();
    dense_t(DG2, t_wg2, DH1, K, D, D);
    __syncthreads();
    for (int it = tid; it < KD; it += kThreads) DH1[it] = H1[it] > 0.f ? DH1[it] : 0.f;
    __syncthreads();
    dense_t(DH1, t_wg1, DGV, K, D, D);
    __syncthreads();
    for (int it = tid; it < KD; it += kThreads) DPOS[it] = DGV[it] + WV[it];
    __syncthreads();
    dense_t(DPOS, t_wd2, DH0, K, D, D);
    __syncthreads();
    for (int it = tid; it < KD; it += kThreads) DH0[it] = H0[it] > 0.f ? DH0[it] : 0.f;
    __syncthreads();
    dense_t(DH0, t_wd1, drel, K, D, 3);
    __syncthreads();
    // d_rows = [-drel | -dgv | d(v + pos)], dxq = sum_j drel, dq = sum_j dgv
    float* dr = d_rows + static_cast<size_t>(qf) * K * W;
    for (int it = tid; it < K * W; it += kThreads) {
      const int j = it / W, c = it - j * W;
      dr[it] = c < 3 ? -drel[j * 3 + c] : (c < 3 + D ? -DGV[j * D + c - 3] : WV[j * D + c - 3 - D]);
    }
    for (int c = tid; c < 3 + D; c += kThreads) {
      float s = 0.f;
      if (c < 3) {
        for (int j = 0; j < K; ++j) s += drel[j * 3 + c];
        dxq[static_cast<size_t>(qf) * 3 + c] = s;
      } else {
        for (int j = 0; j < K; ++j) s += DGV[j * D + c - 3];
        dq[static_cast<size_t>(qf) * D + c - 3] = s;
      }
    }
    outer_acc(rel, 3, false, DH0, a_wd1, a_bd1, K, D);
    outer_acc(H0, D, true, DPOS, a_wd2, a_bd2, K, D);
    outer_acc(GV, D, false, DH1, a_wg1, a_bg1, K, D);
    outer_acc(H1, D, true, DG2, a_wg2, a_bg2, K, D);
  }
  __syncthreads();
  float* pb = partial + static_cast<size_t>(blockIdx.x) * nacc;
  for (int e = tid; e < nacc; e += kThreads) pb[e] = acc[e];
}

}  // namespace

// table (B, M, 3+2D), idx (B, N, K) int32, xyzq (B, N, 3), q (B, N, D),
// wd1 (3, D), wd2/wg1/wg2 (D, D), biases (D) -> out (B, N, D), all f32.
MOCOPCI_API int mocopci_transformer_tail(const float* table, const int* idx,
                                         const float* xyzq, const float* q,
                                         const float* wd1, const float* bd1,
                                         const float* wd2, const float* bd2,
                                         const float* wg1, const float* bg1,
                                         const float* wg2, const float* bg2, float* out,
                                         int B, int M, int N, int K, int D, void* stream) {
  const size_t floats = 3 * static_cast<size_t>(D) + 3 * static_cast<size_t>(D) * D +
                        4 * D + 3 * K + D + 3 * static_cast<size_t>(K) * D;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = mocopci::allow_smem(transformer_tail_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mocopci::ceil_div(N, kQT), B);
  transformer_tail_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, out, M, N, K, D);
  return cudaGetLastError();
}

static size_t transformer_tail_bwd_floats(int K, int D) {
  const size_t DD = static_cast<size_t>(D) * D, KD = static_cast<size_t>(K) * D;
  return 3 * D + 3 * DD + 4 * D + 3 * D + 3 * DD + (3 * DD + 7 * D) + 6 * K + 3 * D + 11 * KD;
}

// Backward of mocopci_transformer_tail given dout (B, N, D): d_rows (B, N, K,
// 3+2D) (the gathered rows' gradient), dxq (B, N, 3), dq (B, N, D), and dw =
// [dwd1 (3, D) | dbd1 | dwd2 (D, D) | dbd2 | dwg1 | dbg1 | dwg2 | dbg2].
// partial: nblk * (3D^2 + 7D) floats of scratch, reduced in block order.
MOCOPCI_API int mocopci_transformer_tail_bwd(
    const float* table, const int* idx, const float* xyzq, const float* q, const float* wd1,
    const float* bd1, const float* wd2, const float* bd2, const float* wg1, const float* bg1,
    const float* wg2, const float* bg2, const float* dout, float* d_rows, float* dxq,
    float* dq, float* dw, float* partial, int B, int M, int N, int K, int D, int nblk,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = transformer_tail_bwd_floats(K, D) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(transformer_tail_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  transformer_tail_bwd_kernel<<<nblk, kThreads, smem, st>>>(
      table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, dout, d_rows, dxq, dq,
      partial, B, M, N, K, D);
  MOCOPCI_CHECK_LAUNCH();
  return mocopci::reduce_partials(partial, dw, nblk, 3 * D * D + 7 * D, st);
}
