// Cost-volume tail: out[n] = max_j leaky(leaky(tab[idx[n, j]] + base[n]) W + b).
//
// Replaces mocopci_tpu/ops/pallas/cross_tail.py: cross_tail forward (:155,
// pallas_call :161), dispatched for N1 >= 1024 (nn/cross.py:88).  The TPU
// kernel reads materialised k-major rows; this one gathers each row itself
// from the (B, M, C) table, so the (B, K*N1, C) row tensor never exists.
//
// Forward, bound on the H100: operations, 2*N1*K*C*C2 flops (1.6 GFLOP per
// up_1 call) against K*N1*C*4 gathered bytes.  Design: one block per tile of
// QT queries; W (C x C2) is loaded into shared memory once per block and
// reused for all QT*K rows.  Per query the K gathered rows (after the first
// leaky) sit in shared memory; thread t owns output channel t % C2 and
// neighbour slice t / C2, keeps a running max, and the slices are
// max-reduced in shared memory.  The (N1, K, C2) activation is never
// written.  When the caller asks for it (training), the forward also writes
// the first j attaining each max, j*(n, c2): strict > along a slice's
// ascending j, the lowest j on ties across slices, one byte an entry for
// K <= 255.
//
// Backward (cross_tail.py bwd :172, pallas_call :178, _bwd_kernel :81): the
// gradient of each (n, c2) goes to the first j attaining the max (the TPU
// kernel's tie rule, cross_tail.py:20-31).  The TPU kernel recomputes the K x
// C2 pre-activations of every query to find that j, since an HBM round trip
// costs it more; here the forward saved j*, and since out = leaky(pre1 at
// j*), leaky'(pre1 at j*) is 1 where out >= 0 and 0.1 elsewhere.  So the
// backward does only the sparse work, about 2*C*C2 FMAs a query, and bytes
// bound it: the (N, K, C) rows' gradient it writes (100 MB at the train
// step's up_1).  Design: a fixed grid of blocks walks tiles of up to 256 / C
// queries (4 at C = 64); a tile's neighbour rows are gathered by cp.async;
// thread (query, c) adds gv * W[c, c2] into its own row j*(c2), c2
// ascending, in shared memory, then writes its column of d_rows (zeros where a row won no
// channel) and d_base; the block's dW and db are summed per entry in query
// order, and the per-block partials in block order (deterministic).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;

// kArg: also find and write the first j at each max (amax); without it the
// instance is the plain running max
template <typename IdxT, bool kArg>
__global__ void __launch_bounds__(kThreads) cross_tail_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ base, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, IdxT* __restrict__ amax, int M,
    int N, int K, int C, int C2) {
  extern __shared__ float sm[];
  float* ws = sm;              // [C][C2]
  float* hs = ws + C * C2;     // [K][C]
  float* red = hs + K * C;     // [kThreads] a slice's max
  int* redj = reinterpret_cast<int*>(red + kThreads);  // [kThreads] its first j
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
      int jm = K;
      if (sl < js && c2 < C2) {
        const float bb = bias[c2];
        for (int j = sl; j < K; j += js) {
          float acc = 0.f;
          const float* h = hs + j * C;
          for (int c = 0; c < C; ++c) acc = fmaf(h[c], ws[c * C2 + c2], acc);
          const float v = mocopci::leaky(acc + bb);
          if (!kArg) {
            m = fmaxf(m, v);
          } else if (v > m) {   // ascending j: strict > keeps the first j at the max
            m = v;
            jm = j;
          }
        }
      }
      red[tid] = m;
      if (kArg) redj[tid] = jm;
      __syncthreads();
      if (tid < cw && c20 + tid < C2) {
        float r = red[tid];
        int rj = kArg ? redj[tid] : 0;
        for (int t = 1; t < js; ++t) {
          const float v = red[t * cw + tid];
          if (!kArg) {
            r = fmaxf(r, v);
          } else if (v > r || (v == r && redj[t * cw + tid] < rj)) {
            r = v;
            rj = redj[t * cw + tid];
          }
        }
        const size_t o = (static_cast<size_t>(b) * N + n) * C2 + c20 + tid;
        out[o] = r;
        if (kArg) amax[o] = static_cast<IdxT>(rj < K ? rj : 0);
      }
      __syncthreads();
    }
  }
}

constexpr size_t kMaxSmem = 227 * 1024;

inline size_t bwd_smem_floats(int qt, int K, int C, int C2) {
  return 2 * static_cast<size_t>(qt) * K * C + 2 * static_cast<size_t>(C) * C2 + C2 +
         static_cast<size_t>(qt) * C + 2 * static_cast<size_t>(qt) * C2;
}

// queries a backward tile holds: a thread for each (query, channel) column,
// fewer where the tile's rows would not fit shared memory
inline int bwd_tile(int K, int C, int C2) {
  int qt = C < kThreads ? kThreads / C : 1;
  while (qt > 1 && bwd_smem_floats(qt, K, C, C2) * sizeof(float) > kMaxSmem) --qt;
  return qt;
}

// Backward over tiles of qt flattened (B*N) queries, tile t = blockIdx.x +
// i*gridDim.x: gather the rows, route each output channel's gradient to its
// saved j*, write d_rows and d_base, add the tile into this block's dW / db.
template <typename IdxT>
__global__ void __launch_bounds__(kThreads) cross_tail_bwd_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ base, const float* __restrict__ w,
    const float* __restrict__ out, const IdxT* __restrict__ amax,
    const float* __restrict__ dout, float* __restrict__ d_rows, float* __restrict__ d_base,
    float* __restrict__ partial, int BN, int M, int N, int K, int C, int C2, int qt) {
  extern __shared__ float sm[];
  float* rows = sm;                   // [qt][K][C] gathered rows, then x0 = leaky(row + base)
  float* dx = rows + qt * K * C;      // [qt][K][C] the rows' gradient before leaky'
  float* wt = dx + qt * K * C;        // [C2][C]    W transposed
  float* dw = wt + C2 * C;            // [C2][C]    this block's dW, transposed
  float* db = dw + C2 * C;            // [C2]       this block's db
  float* bs = db + C2;                // [qt][C]    base
  float* gv = bs + qt * C;            // [qt][C2]   dout * leaky'(pre1 at j*)
  int* js = reinterpret_cast<int*>(gv + qt * C2);  // [qt][C2] j*
  const int tid = threadIdx.x;
  const bool vec = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(tab) & 15) == 0;
  for (int e = tid; e < C * C2; e += kThreads) {
    const int c = e / C2, c2 = e - c * C2;
    wt[c2 * C + c] = w[e];
    dw[e] = 0.f;
  }
  for (int e = tid; e < C2; e += kThreads) db[e] = 0.f;
  for (int e = tid; e < qt * K * C; e += kThreads) dx[e] = 0.f;

  const int ntiles = (BN + qt - 1) / qt;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int q0 = tile * qt;
    const int nq = min(qt, BN - q0);
    const int* iq = idx + static_cast<size_t>(q0) * K;
    __syncthreads();                  // the previous tile's readers are done
    if (vec) {
      const int cv = C / 4;
      for (int e = tid; e < nq * K * cv; e += kThreads) {
        const int r = e / cv, c = (e - r * cv) * 4;   // r = q * K + j
        const size_t src = (static_cast<size_t>((q0 + r / K) / N) * M + iq[r]) * C + c;
        mocopci::cp_async16(rows + r * C + c, tab + src);
      }
    } else {
      for (int e = tid; e < nq * K * C; e += kThreads) {
        const int r = e / C, c = e - r * C;
        const size_t src = (static_cast<size_t>((q0 + r / K) / N) * M + iq[r]) * C + c;
        mocopci::cp_async4(rows + e, tab + src);
      }
    }
    for (int e = tid; e < nq * C; e += kThreads) bs[e] = base[static_cast<size_t>(q0) * C + e];
    for (int e = tid; e < nq * C2; e += kThreads) {
      const size_t o = static_cast<size_t>(q0) * C2 + e;
      gv[e] = out[o] >= 0.f ? dout[o] : 0.1f * dout[o];
      js[e] = static_cast<int>(amax[o]);
    }
    mocopci::cp_async_commit();
    mocopci::cp_async_wait0();
    __syncthreads();
    // column (q, c): each output channel's gradient lands on its one row j*
    for (int e = tid; e < nq * C; e += kThreads) {
      const int q = e / C, c = e - q * C;
      float* dxc = dx + q * K * C + c;
      float* rc = rows + q * K * C + c;
      const int* jq = js + q * C2;
      const float* gq = gv + q * C2;
      for (int c2 = 0; c2 < C2; ++c2) {
        float* t = dxc + jq[c2] * C;
        *t = fmaf(gq[c2], wt[c2 * C + c], *t);
      }
      const float bb = bs[e];
      float* dr = d_rows + static_cast<size_t>(q0 + q) * K * C + c;
      float s = 0.f;
      for (int j = 0; j < K; ++j) {
        const float p = rc[j * C] + bb;
        const float d = dxc[j * C] * mocopci::dleaky(p);
        dxc[j * C] = 0.f;             // zero again for the next tile
        rc[j * C] = mocopci::leaky(p);
        dr[static_cast<size_t>(j) * C] = d;
        s += d;
      }
      d_base[static_cast<size_t>(q0 + q) * C + c] = s;
    }
    __syncthreads();
    // dW[c, c2] += x0[q][j*(c2)][c] * gv[q][c2], db[c2] += gv[q][c2], q in order
    for (int e = tid; e < C2 * C; e += kThreads) {
      const int c2 = e / C, c = e - c2 * C;
      float acc = dw[e];
      for (int q = 0; q < nq; ++q)
        acc = fmaf(rows[(q * K + js[q * C2 + c2]) * C + c], gv[q * C2 + c2], acc);
      dw[e] = acc;
    }
    for (int c2 = tid; c2 < C2; c2 += kThreads) {
      float acc = db[c2];
      for (int q = 0; q < nq; ++q) acc += gv[q * C2 + c2];
      db[c2] = acc;
    }
  }
  __syncthreads();
  float* pb = partial + static_cast<size_t>(blockIdx.x) * (C * C2 + C2);
  for (int e = tid; e < C * C2; e += kThreads) {
    const int c = e / C2, c2 = e - c * C2;
    pb[e] = dw[c2 * C + c];
  }
  for (int e = tid; e < C2; e += kThreads) pb[C * C2 + e] = db[e];
}

template <typename IdxT, bool kArg>
cudaError_t run_fwd(const float* tab, const int* idx, const float* base, const float* w,
                    const float* b, float* out, void* amax, int B, int M, int N, int K, int C,
                    int C2, cudaStream_t st) {
  const size_t smem =
      (static_cast<size_t>(C) * C2 + static_cast<size_t>(K) * C + 2 * kThreads) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(cross_tail_kernel<IdxT, kArg>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mocopci::ceil_div(N, kQT), B);
  cross_tail_kernel<IdxT, kArg><<<grid, kThreads, smem, st>>>(
      tab, idx, base, w, b, out, static_cast<IdxT*>(amax), M, N, K, C, C2);
  return cudaGetLastError();
}

template <typename IdxT>
cudaError_t run_bwd(const float* tab, const int* idx, const float* base, const float* w,
                    const float* out, const void* amax, const float* dout, float* d_rows,
                    float* d_base, float* partial, int B, int M, int N, int K, int C, int C2,
                    int nblk, cudaStream_t st) {
  const int qt = bwd_tile(K, C, C2);
  const size_t smem = bwd_smem_floats(qt, K, C, C2) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(cross_tail_bwd_kernel<IdxT>, smem);
  if (err != cudaSuccess) return err;
  cross_tail_bwd_kernel<IdxT><<<nblk, kThreads, smem, st>>>(
      tab, idx, base, w, out, static_cast<const IdxT*>(amax), dout, d_rows, d_base, partial,
      B * N, M, N, K, C, C2, qt);
  return cudaGetLastError();
}

}  // namespace

// tab (B, M, C), idx (B, N, K) int32, base (B, N, C), w (C, C2), b (C2)
// -> out (B, N, C2), all f32; amax (B, N, C2), uint8 for K <= 255 else int32,
// the first j at each max, written unless null.
MOCOPCI_API int mocopci_cross_tail(const float* tab, const int* idx, const float* base,
                                   const float* w, const float* b, float* out, void* amax,
                                   int B, int M, int N, int K, int C, int C2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (amax == nullptr)
    return run_fwd<int, false>(tab, idx, base, w, b, out, amax, B, M, N, K, C, C2, st);
  if (K <= 255)
    return run_fwd<uint8_t, true>(tab, idx, base, w, b, out, amax, B, M, N, K, C, C2, st);
  return run_fwd<int, true>(tab, idx, base, w, b, out, amax, B, M, N, K, C, C2, st);
}

// Backward of mocopci_cross_tail given its out, its amax and dout (B, N, C2):
// d_rows (B, N, K, C) (the gathered rows' gradient, scattered into the table by
// the caller), d_base (B, N, C), dwb = [dW (C, C2) | db (C2)].  partial: nblk *
// (C*C2 + C2) floats of scratch; nblk blocks, reduced in block order.
MOCOPCI_API int mocopci_cross_tail_bwd(const float* tab, const int* idx, const float* base,
                                       const float* w, const float* out, const void* amax,
                                       const float* dout, float* d_rows, float* d_base,
                                       float* dwb, float* partial, int B, int M, int N, int K,
                                       int C, int C2, int nblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      K <= 255 ? run_bwd<uint8_t>(tab, idx, base, w, out, amax, dout, d_rows, d_base, partial,
                                  B, M, N, K, C, C2, nblk, st)
               : run_bwd<int>(tab, idx, base, w, out, amax, dout, d_rows, d_base, partial, B, M,
                              N, K, C, C2, nblk, st);
  if (err != cudaSuccess) return err;
  return mocopci::reduce_partials(partial, dwb, nblk, C * C2 + C2, st);
}
