// Farthest point sampling, one thread block per cloud.
//
// Replaces mocopci_tpu/ops/pallas/fps.py: farthest_point_sample_pallas (:419)
// and farthest_point_sample_pyramid_pallas (:477).  The pyramid is a loop of
// launches of this kernel with a gather in between (kernels/fps.py).
//
// Semantics: index 0 first, min-distance initialised to 1e10, each step the
// argmax of the min-distance field with ties to the lowest index (jnp.argmax).
// The squared distance is evaluated as ((dx*dx + dy*dy) + dz*dz) with explicit
// round-to-nearest intrinsics, no FMA contraction, so the indices equal the
// plain PyTorch version's bit for bit.
//
// Bound on the H100: neither bytes (the cloud is read once) nor operations
// (N*npoint*~9 flops) but the npoint-long chain of dependent steps, each a
// block-wide argmax with two barriers.  Design: each thread keeps its
// strided points and their min-distances in registers (PER <= 8 points, so
// N <= 8192 with 1024 threads), the argmax is a warp shuffle tree plus one
// cross-warp pass in shared memory, and nothing but the chosen index leaves
// the block.
#include "common.cuh"

namespace {

template <int PER>
__global__ void __launch_bounds__(1024) fps_kernel(const float* __restrict__ xyz, int N,
                                                   int npoint, int* __restrict__ out) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const float* x = xyz + static_cast<size_t>(b) * N * 3;
  int* o = out + static_cast<size_t>(b) * npoint;

  float px[PER], py[PER], pz[PER], md[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int n = tid + i * T;
    if (n < N) {
      px[i] = x[n * 3 + 0];
      py[i] = x[n * 3 + 1];
      pz[i] = x[n * 3 + 2];
      md[i] = 1e10f;
    } else {
      px[i] = py[i] = pz[i] = 0.f;
      md[i] = -1.f;  // never the argmax: real min-distances are >= 0
    }
  }
  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_last;
  if (tid == 0) o[0] = 0;
  int last = 0;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (T + 31) >> 5;

  for (int s = 1; s < npoint; ++s) {
    const float lx = x[last * 3 + 0], ly = x[last * 3 + 1], lz = x[last * 3 + 2];
    float bv = -2.f;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float dx = __fsub_rn(px[i], lx), dy = __fsub_rn(py[i], ly),
                  dz = __fsub_rn(pz[i], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (md[i] >= 0.f) md[i] = fminf(md[i], d);
      // points of one thread are visited in ascending index: strict > keeps
      // the lowest index on ties
      if (md[i] > bv) {
        bv = md[i];
        bi = tid + i * T;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? s_val[lane] : -2.f;
      bi = lane < nwarps ? s_idx[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_last = bi;
        o[s] = bi;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

template <int PER>
cudaError_t run(const float* xyz, int B, int N, int npoint, int* out, cudaStream_t st) {
  int threads = mocopci::ceil_div(N, PER);
  threads = ((threads + 31) / 32) * 32;
  fps_kernel<PER><<<B, threads, 0, st>>>(xyz, N, npoint, out);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) f32 -> out (B, npoint) int32; N <= 8192, 1 <= npoint <= N.
MOCOPCI_API int mocopci_fps(const float* xyz, int B, int N, int npoint, int* out,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 1024) return run<1>(xyz, B, N, npoint, out, st);
  if (N <= 2048) return run<2>(xyz, B, N, npoint, out, st);
  if (N <= 4096) return run<4>(xyz, B, N, npoint, out, st);
  return run<8>(xyz, B, N, npoint, out, st);
}
