// Softmax attention out = softmax(q k^T * scale) v in f32, for the eval
// attentions (EI cross-attention, Cross_Frame_Att, Multi_Frame_Att).
//
// Replaces mocopci_tpu/ops/pallas/attention.py: fused_attention_pallas (:60,
// pallas_call :88).  Full-row softmax over M <= 4096 keys, as the TPU kernel.
//
// Bound on the H100: at the main-path shapes (head width 8-32 at 2048 tokens,
// 256 at 256 tokens) the work is 4*N*M*D flops against q/k/v/out bytes of
// order (N+M)*D*4, so operations bound it; a dense program that writes the
// (N, M) logits to HBM would make it bytes.  Design: one block per
// (group, tile of TQ queries).  The TQ logit rows live in shared memory
// (TQ*M floats), never in HBM.  Phase 1: each thread takes keys j and forms
// all TQ dot products from one read of k_j (q tile broadcast from shared
// memory).  Phase 2: one warp per row, max / exp / sum.  Phase 3: threads
// split (d, j-slice), accumulate p*v for all TQ rows, reduce the slices in
// shared memory and divide by the row sum.  Plain FMAs, no tensor cores: a
// later version can move phases 1 and 3 to mma.
#include "common.cuh"

namespace {

constexpr int kTQ = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int N, int M, int D, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                    // [kTQ][D]
  float* lg = qs + kTQ * D;          // [kTQ][M]  logits, then exp(logit - max)
  float* red = lg + kTQ * M;         // [kThreads][kTQ] partial sums
  float* rsum = red + kThreads * kTQ;  // [kTQ]
  const int g = blockIdx.y;
  const int n0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x;
  const int rows = min(kTQ, N - n0);
  const float* qg = q + (static_cast<size_t>(g) * N + n0) * D;
  const float* kg = k + static_cast<size_t>(g) * M * D;
  const float* vg = v + static_cast<size_t>(g) * M * D;

  for (int e = tid; e < kTQ * D; e += kThreads) qs[e] = e < rows * D ? qg[e] : 0.f;
  __syncthreads();

  // phase 1: logits
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

  // phase 2: softmax numerators and row sums, one warp per row
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = warp; i < kTQ; i += kThreads / 32) {
    float m = -__int_as_float(0x7f800000);
    for (int j = lane; j < M; j += 32) m = fmaxf(m, lg[i * M + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
    for (int j = lane; j < M; j += 32) {
      const float e = expf(lg[i * M + j] - m);
      lg[i * M + j] = e;
      s += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) rsum[i] = s;
  }
  __syncthreads();

  // phase 3: out[i][d] = sum_j p[i][j] v[j][d] / rsum[i]
  for (int d0 = 0; d0 < D; d0 += kThreads) {
    const int dw = min(kThreads, D - d0);     // columns in this pass
    const int js = kThreads / dw;             // j-slices
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

}  // namespace

// q (G, N, D), k/v (G, M, D) f32 -> out (G, N, D); M <= 4096.
MOCOPCI_API int mocopci_attention(const float* q, const float* k, const float* v, float* out,
                                  int G, int N, int M, int D, float scale, void* stream) {
  const size_t smem =
      (static_cast<size_t>(kTQ) * (D + M) + kThreads * kTQ + kTQ) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(attention_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mocopci::ceil_div(N, kTQ), G);
  attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, N, M, D, scale);
  return cudaGetLastError();
}
