// Cost-volume tail: out[n] = max_j leaky(leaky(tab[idx[n, j]] + base[n]) W + b).
//
// Replaces mocopci_tpu/ops/pallas/cross_tail.py: cross_tail forward (:155,
// pallas_call :161), dispatched for N1 >= 1024 (nn/cross.py:88).  The TPU
// kernel reads materialised k-major rows; this one gathers each row itself
// from the (B, M, C) table, so the (B, K*N1, C) row tensor never exists.
//
// Bound on the H100: operations, 2*N1*K*C*C2 flops (1.6 GFLOP per up_1 call)
// against K*N1*C*4 gathered bytes.  Design: one block per tile of QT queries;
// W (C x C2) is loaded into shared memory once per block and reused for all
// QT*K rows.  Per query the K gathered rows (after the first leaky) sit in
// shared memory; thread t owns output channel t % C2 and neighbour slice
// t / C2, keeps a running max, and the slices are max-reduced in shared
// memory.  The (N1, K, C2) activation is never written.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;

__global__ void __launch_bounds__(kThreads) cross_tail_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ base, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K, int C,
    int C2) {
  extern __shared__ float sm[];
  float* ws = sm;              // [C][C2]
  float* hs = ws + C * C2;     // [K][C]
  float* red = hs + K * C;     // [kThreads]
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  for (int e = tid; e < C * C2; e += kThreads) ws[e] = w[e];
  const int cw = min(C2, kThreads);
  const int js = kThreads / cw;  // neighbour slices
  const int sl = tid / cw;
  const float* tb = tab + static_cast<size_t>(b) * M * C;

  for (int qi = 0; qi < kQT; ++qi) {
    const int n = blockIdx.x * kQT + qi;
    if (n >= N) break;
    const int* in = idx + (static_cast<size_t>(b) * N + n) * K;
    const float* bn = base + (static_cast<size_t>(b) * N + n) * C;
    __syncthreads();
    for (int e = tid; e < K * C; e += kThreads) {
      const int j = e / C, c = e - j * C;
      hs[e] = mocopci::leaky(tb[static_cast<size_t>(in[j]) * C + c] + bn[c]);
    }
    __syncthreads();
    for (int c20 = 0; c20 < C2; c20 += cw) {
      const int c2 = c20 + tid % cw;
      float m = -__int_as_float(0x7f800000);
      if (sl < js && c2 < C2) {
        const float bb = bias[c2];
        for (int j = sl; j < K; j += js) {
          float acc = 0.f;
          const float* h = hs + j * C;
          for (int c = 0; c < C; ++c) acc = fmaf(h[c], ws[c * C2 + c2], acc);
          m = fmaxf(m, mocopci::leaky(acc + bb));
        }
      }
      red[tid] = m;
      __syncthreads();
      if (tid < cw && c20 + tid < C2) {
        float r = red[tid];
        for (int t = 1; t < js; ++t) r = fmaxf(r, red[t * cw + tid]);
        out[(static_cast<size_t>(b) * N + n) * C2 + c20 + tid] = r;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// tab (B, M, C), idx (B, N, K) int32, base (B, N, C), w (C, C2), b (C2)
// -> out (B, N, C2), all f32.
MOCOPCI_API int mocopci_cross_tail(const float* tab, const int* idx, const float* base,
                                   const float* w, const float* b, float* out, int B, int M,
                                   int N, int K, int C, int C2, void* stream) {
  const size_t smem =
      (static_cast<size_t>(C) * C2 + static_cast<size_t>(K) * C + kThreads) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(cross_tail_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mocopci::ceil_div(N, kQT), B);
  cross_tail_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tab, idx, base, w, b, out, M, N, K, C, C2);
  return cudaGetLastError();
}
