// Point-transformer tail of the refine head, per query n over its K neighbours:
//   pos_j  = relu((xq - xyz_j) Wd1 + bd1) Wd2 + bd2
//   l_j    = relu(((q - k_j) + pos_j) Wg1 + bg1) Wg2 + bg2
//   a_j    = softmax_j(l_j / sqrt(D))            (per channel)
//   out    = sum_j a_j * (v_j + pos_j)
// with rows [xyz | k | v] gathered from the (B, M, 3+2D) table by idx.
//
// Replaces mocopci_tpu/ops/pallas/transformer_tail.py: transformer_tail
// forward (:212, pallas_call :219), dispatched for N >= 1024
// (nn/transformer.py:54).  Forward only; the running (m, l) the TPU kernel
// emits for its backward is not needed in eval.
//
// Bound on the H100: operations, 2*N*K*(3D + 3D^2) flops (3.2 GFLOP at the
// refine head) against N*K*(3+2D)*4 gathered bytes.  Design: one block per
// tile of QT queries; the four weight matrices (3D^2+3D floats, 49 KB at
// D=64) are loaded into shared memory once per block.  Per query the K x D
// activations of each stage stay in shared memory; thread t computes items
// (j, e) with e fastest, so weight reads are conflict-free and activation
// reads are warp broadcasts.  The final per-channel softmax over K is done by
// one thread per channel.  No (N, K, D) tensor is written to HBM.
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
