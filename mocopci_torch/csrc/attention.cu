// Softmax attention out = softmax(q k^T * scale) v in f32, for the eval
// attentions (EI cross-attention, Cross_Frame_Att, Multi_Frame_Att).
//
// Replaces mocopci_tpu/ops/pallas/attention.py: fused_attention_pallas (:60,
// pallas_call :88), over M <= 16384 keys (the wrapper's cap; no dropout
// counter bounds it).
//
// Bound on the H100: operations (4*N*M*D flops against (N + M)*D*4 bytes per
// group).  Design: the training attention's forward without its dropout and
// log-sum-exp (the bodies in attention_fwd.cuh, template flags DROP and LSE
// off), one pass over the keys, which stream through shared memory in tiles
// of 64 under an online softmax, so no block holds a whole row of logits:
//   attention (D <= 64): a thread (or 2 or 4 lanes) a query, its q and
//     numerator in registers, FMAs; 128, 64 or 32 queries a block and 1 or 2
//     key splits, chosen from the grid (attention_fwd.cuh one_pass_grid);
//   attention_wide (D > 64): 32 queries and 256 head dims a block, both
//     products on mma.sync at float32 grade (3xTF32).
// Each output element is summed in a fixed order by one owner, so the result
// repeats bit for bit.
#include "attention_fwd.cuh"

namespace {

template <int DP, int KSC>
__global__ void __launch_bounds__(kFwdMaxThreads) attention_eval_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int N, int M, int D, float scale, int KS) {
  attention_fwd_body<DP, KSC, false, false>(q, k, v, out, nullptr, N, M, D, scale, nullptr, 0,
                                            1.f, KS);
}

__global__ void __launch_bounds__(kYThreads, 1) attention_eval_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int N, int M, int D, float scale) {
  attention_fwd_wide_body<false, false>(q, k, v, out, nullptr, N, M, D, scale, nullptr, 0, 1.f);
}

template <int DP, int KSC>
cudaError_t launch_eval_splits(const float* q, const float* k, const float* v, float* out, int N,
                               int M, int D, float scale, dim3 grid, int threads, int ks,
                               cudaStream_t st) {
  constexpr size_t smem = FwdTile<DP>::smem_bytes;
  cudaError_t err = mocopci::allow_smem(attention_eval_kernel<DP, KSC>, smem);
  if (err != cudaSuccess) return err;
  attention_eval_kernel<DP, KSC><<<grid, threads, smem, st>>>(q, k, v, out, N, M, D, scale, ks);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_eval(const float* q, const float* k, const float* v, float* out, int G, int N,
                        int M, int D, float scale, cudaStream_t st) {
  dim3 grid;
  int threads, ks;
  one_pass_grid<DP>(G, N, grid, threads, ks);
  return ks == 1
             ? launch_eval_splits<DP, 1>(q, k, v, out, N, M, D, scale, grid, threads, ks, st)
             : launch_eval_splits<DP, 0>(q, k, v, out, N, M, D, scale, grid, threads, ks, st);
}

}  // namespace

// q (G, N, D), k/v (G, M, D) f32 -> out (G, N, D) for 1 <= D <= 64, in one
// pass over M <= 16384 keys.
MOCOPCI_API int mocopci_attention(const float* q, const float* k, const float* v, float* out,
                                  int G, int N, int M, int D, float scale, void* stream) {
  if (D < 1 || D > kMaxFwdD) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : 64) {
    case 8: return launch_eval<8>(q, k, v, out, G, N, M, D, scale, st);
    case 16: return launch_eval<16>(q, k, v, out, G, N, M, D, scale, st);
    case 32: return launch_eval<32>(q, k, v, out, G, N, M, D, scale, st);
    default: return launch_eval<64>(q, k, v, out, G, N, M, D, scale, st);
  }
}

// The same for D > 64, on the tensor cores (M <= 16384).
MOCOPCI_API int mocopci_attention_wide(const float* q, const float* k, const float* v,
                                       float* out, int G, int N, int M, int D, float scale,
                                       void* stream) {
  if (D <= kYC) return cudaErrorInvalidValue;     // the v rows come with each tile's chunk 1
  cudaError_t err = mocopci::allow_smem(attention_eval_wide_kernel, kYSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(mocopci::ceil_div(N, kYQ), mocopci::ceil_div(D, kYV), G);
  attention_eval_wide_kernel<<<grid, kYThreads, kYSmem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, N, M, D, scale);
  return cudaGetLastError();
}
