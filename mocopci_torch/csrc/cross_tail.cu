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
//
// Backward (cross_tail.py bwd :172, pallas_call :178, _bwd_kernel :81): the
// same recompute per query, gradients to the first j attaining each max (the
// K rows searched in slices side by side); each output channel's gradient
// then lands on one row, added per column by the column's owner thread from
// a transposed copy of W (no bank conflicts); d_rows, d_base, and dW/db as
// per-block partials over a fixed set of queries, summed in block order
// (deterministic).  Operations bound it too.
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

// Backward, one query at a time per block (queries q = blockIdx.x + t*gridDim.x
// of the flattened (B, N)): recompute the K rows, find for each output channel
// the FIRST j whose activation equals the saved max (the TPU kernel's tie rule,
// cross_tail.py:20-31), route dout there only, then d_rows / d_base per query
// and this block's dW / db partial sums, in query order.
__global__ void __launch_bounds__(kThreads) cross_tail_bwd_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ base, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ out,
    const float* __restrict__ dout, float* __restrict__ d_rows, float* __restrict__ d_base,
    float* __restrict__ partial, int B, int M, int N, int K, int C, int C2) {
  extern __shared__ float sm[];
  float* ws = sm;                  // [C][C2]
  float* wt = ws + C * C2;         // [C2][C]  W transposed, for the rows' gradient
  float* dw = wt + C * C2;         // [C][C2]  this block's dW
  float* db = dw + C * C2;         // [C2]     this block's db
  float* gv = db + C2;             // [C2]     dout * leaky'(pre1) at the winning j
  int* jstar = reinterpret_cast<int*>(gv + C2);   // [C2]
  float* hs = reinterpret_cast<float*>(jstar + C2);  // [K][C] pre-activations
  float* dx = hs + K * C;          // [K][C]
  float* gf = dx + K * C;          // [kThreads] a slice's g at its first hit
  int* jf = reinterpret_cast<int*>(gf + kThreads);   // [kThreads] that hit's j
  const int tid = threadIdx.x;
  const int cw = min(C2, kThreads);
  const int ns = kThreads / cw;    // neighbour slices searched side by side
  const int kc = (K + ns - 1) / ns;
  for (int e = tid; e < C * C2; e += kThreads) {
    ws[e] = w[e];
    wt[(e % C2) * C + e / C2] = w[e];
    dw[e] = 0.f;
  }
  for (int e = tid; e < C2; e += kThreads) db[e] = 0.f;

  for (int qf = blockIdx.x; qf < B * N; qf += gridDim.x) {
    const int b = qf / N;
    const int* in = idx + static_cast<size_t>(qf) * K;
    const float* bn = base + static_cast<size_t>(qf) * C;
    const float* tb = tab + static_cast<size_t>(b) * M * C;
    __syncthreads();
    for (int e = tid; e < K * C; e += kThreads) {
      const int j = e / C, c = e - j * C;
      hs[e] = tb[static_cast<size_t>(in[j]) * C + c] + bn[c];
    }
    __syncthreads();
    // the first j whose activation equals the max: slice sl searches rows
    // [sl*kc, (sl+1)*kc) up to its first hit; the lowest slice with a hit wins
    for (int c20 = 0; c20 < C2; c20 += cw) {
      const int c2 = c20 + tid % cw, sl = tid / cw;
      int js = K;
      float g = 0.f;
      if (sl < ns && c2 < C2) {
        const float o = out[static_cast<size_t>(qf) * C2 + c2];
        const float bb = bias[c2];
        for (int j = sl * kc; j < min(K, (sl + 1) * kc); ++j) {
          float acc = 0.f;
          const float* h = hs + j * C;
          for (int c = 0; c < C; ++c) acc = fmaf(mocopci::leaky(h[c]), ws[c * C2 + c2], acc);
          const float pre1 = acc + bb;
          if (mocopci::leaky(pre1) == o) {
            js = j;
            g = dout[static_cast<size_t>(qf) * C2 + c2] * mocopci::dleaky(pre1);
            break;
          }
        }
      }
      jf[tid] = js;
      gf[tid] = g;
      __syncthreads();
      if (tid < cw && c20 + tid < C2) {
        int best = K;
        float bg = 0.f;
        for (int t = 0; t < ns; ++t) {
          if (jf[t * cw + tid] < best) {
            best = jf[t * cw + tid];
            bg = gf[t * cw + tid];
          }
        }
        jstar[c20 + tid] = best < K ? best : -1;
        gv[c20 + tid] = bg;
      }
      __syncthreads();
    }
    // each output channel's gradient goes to one row: thread c owns column c
    // of dx and adds the channels in ascending order
    for (int c = tid; c < C; c += kThreads) {
      for (int j = 0; j < K; ++j) dx[j * C + c] = 0.f;
      for (int c2 = 0; c2 < C2; ++c2) {
        const int js = jstar[c2];
        if (js >= 0) dx[js * C + c] = fmaf(gv[c2], wt[c2 * C + c], dx[js * C + c]);
      }
      for (int j = 0; j < K; ++j) {
        const float d = dx[j * C + c] * mocopci::dleaky(hs[j * C + c]);
        dx[j * C + c] = d;
        d_rows[(static_cast<size_t>(qf) * K + j) * C + c] = d;
      }
    }
    for (int e = tid; e < C * C2; e += kThreads) {
      const int c = e / C2, c2 = e - c * C2;
      const int js = jstar[c2];
      if (js >= 0) dw[e] = fmaf(mocopci::leaky(hs[js * C + c]), gv[c2], dw[e]);
    }
    for (int c2 = tid; c2 < C2; c2 += kThreads) db[c2] += gv[c2];
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float s = 0.f;
      for (int j = 0; j < K; ++j) s += dx[j * C + c];
      d_base[static_cast<size_t>(qf) * C + c] = s;
    }
  }
  __syncthreads();
  float* pb = partial + static_cast<size_t>(blockIdx.x) * (C * C2 + C2);
  for (int e = tid; e < C * C2; e += kThreads) pb[e] = dw[e];
  for (int e = tid; e < C2; e += kThreads) pb[C * C2 + e] = db[e];
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

// Backward of mocopci_cross_tail given its out and dout (B, N, C2):
// d_rows (B, N, K, C) (the gathered rows' gradient, scattered into the table by
// the caller), d_base (B, N, C), dwb = [dW (C, C2) | db (C2)].  partial: nblk *
// (C*C2 + C2) floats of scratch; nblk blocks, reduced in block order.
MOCOPCI_API int mocopci_cross_tail_bwd(const float* tab, const int* idx, const float* base,
                                       const float* w, const float* b, const float* out,
                                       const float* dout, float* d_rows, float* d_base,
                                       float* dwb, float* partial, int B, int M, int N, int K,
                                       int C, int C2, int nblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (3 * static_cast<size_t>(C) * C2 + 3 * static_cast<size_t>(C2) +
                       2 * static_cast<size_t>(K) * C + 2 * kThreads) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(cross_tail_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  cross_tail_bwd_kernel<<<nblk, kThreads, smem, st>>>(tab, idx, base, w, b, out, dout, d_rows,
                                                      d_base, partial, B, M, N, K, C, C2);
  MOCOPCI_CHECK_LAUNCH();
  return mocopci::reduce_partials(partial, dwb, nblk, C * C2 + C2, st);
}
