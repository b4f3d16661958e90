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
// Both directions have two routes.  At (K, D) = (16, 64) and (4, 64), the
// model's refine heads, tiles of 128 pair rows with the products on the
// tensor cores at float32 grade (see "the tiled routes" below).  Every other
// (K, D) within shared memory takes a general route on FMAs
// (transformer_tail_general_kernel, transformer_tail_bwd_general_kernel).
#include "common.cuh"
#include "mma_tf32.cuh"

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

// ---- forward, the general route: any (K, D) whose working set fits ----
//
// Bound on the H100 by operations, 2*N*K*(3D + 3D^2) flops on FMAs.  One
// block per tile of QT queries; the four weight matrices (3D^2+3D floats, 49
// KB at D=64) are loaded into shared memory once per block.  Per query the K
// x D activations of each stage stay in shared memory; thread t computes
// items (j, e) with e fastest, so weight reads are conflict-free and
// activation reads are warp broadcasts.  The final per-channel softmax over K
// is done by one thread per channel.  No (N, K, D) tensor is written to HBM.
// Working set: 3 D^2 + 8 D + 3 K + 3 K D floats.
__global__ void __launch_bounds__(kThreads) transformer_tail_general_kernel(
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

// ---- backward, the general route: any (K, D) whose working set fits ----
//
// For the (K, D) the tensor-core kernel below does not take (other refine_k
// or head widths).  One query at a time per block (queries qf = blockIdx.x +
// t*gridDim.x of the flattened (B, N)), 256 threads, everything in shared
// memory: the weights and their transposed copies, the eight weight and bias
// gradients (one owner thread per element, accumulated over the block's
// queries), and the query's K x D activations of each stage.  The forward
// chain is recomputed, the per-channel softmax over the K neighbours included,
// so the forward's running (m, l) are not needed: the TPU kernel saves them
// only because its forward softmax is online over a k-innermost grid.  Every
// product sums over its input channels in order on FMAs, as a float32 GEMM
// does, and the block partials are summed in block order, so the result
// repeats bit for bit.  Working set: 9 D^2 + 20 D + 6 K + 11 K D floats
// (58 112 at most: K <= 28 at D = 64).  Operations bound it, 6 (3 D^2 + 3 D)
// flops a pair on FMAs.
__global__ void __launch_bounds__(kThreads) transformer_tail_bwd_general_kernel(
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

// ---- the tiled routes, (K, D) = (16, 64) and (4, 64) ----
//
// Both directions walk a fixed grid of blocks (one an SM) over tiles of 128
// pair rows (8 queries at K = 16, 32 at K = 4), 8 warps a block, D = 64,
// the weights staged once a block (stage_weights).  Warp w owns rows
// [16 w, 16 w + 16) and their queries: it gathers their [xyz | k | v] rows
// (a row's 131 floats by consecutive lanes) and the queries' q and xyz into
// shared memory by cp.async (gather_rows, gather_queries), and runs the
// chain on its rows as mma.sync m16n8k8 accumulator fragments (16 x 64 in 32
// registers a thread), the weights as B fragments from shared memory.  An
// accumulator is the next product's A fragment as it stands (each k-step's
// k index permuted, chain_product), and every tensor-core operand is split
// into its TF32 hi and lo parts by bit masks (split_tf32_rz), not by the
// conversion unit.  h0 = (xq - xyz) Wd1 + bd1 runs on FMAs (pos_hidden), the
// per-channel softmax over each query's K rows by shuffles over the
// fragment's rows, a query's K rows lying in one warp (query_softmax;
// __expf, __fdividef).
//
// Forward: bound by operations, the three D x D products (6 D^2 flops a
// pair) at 3xTF32 and 20 D + 3 a pair on FMAs.  pos = r0 Wd2 + bd2, h1 =
// (q - k + pos) Wg1 + bg1 and logit = r1 Wg2 + bg2 all at 3xTF32 from
// registers: only k and v are staged, w = v + pos in place of v.  Its ReLU
// masks can differ from the backward's recompute (below) where h0 or h1
// lies within rounding of 0; the first design, pos and h1 on FMAs as the
// backward and only logit at 3xTF32, left the tiny model's exact-mode
// forward off the CPU's by 1.3e-2 at one point (a near tie downstream that
// a 1e-6 relative change of the tail's output can flip,
// scripts/torch_tail_sensitivity.py), while this one passes every card
// check (scripts/torch_variant_timing.py --card-checks).  A warp's chain
// reads only its own rows, so its warps never wait for one another: the
// block's one barrier is after the weights are staged.  A warp's next tile
// is gathered in two cp.async groups into the buffers its current tile
// frees: xyz, k, q and xq once h1 is computed (under the logit and the
// softmax), v once out is summed (under the next tile's h0 and pos).  out
// is written once, from registers; no (N, K, D) tensor reaches HBM.
//
// Backward: the recompute (chain_pos, chain_gate, chain_logit) runs pos =
// r0 Wd2 + bd2 and h1 = (q - k + pos) Wg1 + bg1 on FMAs, each sum over k
// in order and then the bias, as a float32 GEMM sums, so that the ReLU
// masks of h0 and h1 take the plain version's side of a near-zero
// pre-activation (fma_product), and logit at 3xTF32.  (The two
// mask-deciding products at 6xTF32, an exact split, came within 1.5e-6 of
// float64, but the plain version itself flips masks against float64 on most
// random draws at the step's shape, so they differed from it by up to
// 9.3e-3 over max(1, |value|).)
// Bound by operations, the chain's products (the recompute r0 Wd2, gv Wg1,
// r1 Wg2; the VJP dG2 Wg2^T, dh1 Wg1^T, dpos Wd2^T; the weight gradients
// r1^T dG2, gv^T dh1, r0^T dpos), 6 (3 D^2 + 3 D) flops a pair.  dout's
// rows ride along with q:
//   the softmax VJP dlogit = a (dout w - dout out) / sqrt(D) in registers;
//   dr1 = dG2 Wg2^T, dgv = dh1 Wg1^T, dr0 = dpos Wd2^T at 3xTF32 (the weights
//     read transposed), drel = dh0 Wd1^T on FMAs.
// The operands of the weight gradients (r1, dG2, gv, dh1, r0 recomputed,
// dpos) are staged in four [128][72] tile buffers, each a warp's rows
// written by that warp, and after a block barrier every warp computes a 16 x
// 32 slice of X^T dY over the 128 rows at 3xTF32, kept in registers across
// the block's tiles; the bias gradients and dWd1 = rel^T dh0 are column sums
// over the staged rows (4 threads a column, in a fixed order).  Each warp
// writes its rows of d_rows = [-drel | -dgv | d(v + pos)] from the staged
// tile in coalesced rows of 3 + 2D floats, then gathers its next tile; dxq
// and dq are summed per query over its rows in j order.  The block partials
// are summed in block order (reduce_partials), so the result repeats bit for
// bit.
constexpr int kBD = 64;                  // head dim of the tiled routes
constexpr int kBW = 3 + 2 * kBD;         // row width of the table
constexpr int kBRows = 128;              // pair rows a tile
constexpr int kBWarps = 8;
constexpr int kBThreads = 32 * kBWarps;
constexpr int kLdW = kBD + 8;            // weight row stride (floats)
constexpr int kLdT = kBD + 8;            // tile row stride
constexpr int kMaxQT = 32;               // queries a tile, at most (K = 4)
// shared memory, in floats
constexpr int kOffWd2 = 0;
constexpr int kOffWg1 = kOffWd2 + kBD * kLdW;
constexpr int kOffWg2 = kOffWg1 + kBD * kLdW;
constexpr int kOffWd1 = kOffWg2 + kBD * kLdW;       // [3][64]
constexpr int kOffBias = kOffWd1 + 3 * kBD;         // bd1 | bd2 | bg1 | bg2
constexpr int kOffP = kOffBias + 4 * kBD;           // 4 x [128][kLdT]
constexpr int kOffQ = kOffP + 4 * kBRows * kLdT;    // [32][kLdT] q
constexpr int kOffDO = kOffQ + kMaxQT * kLdT;       // [32][kLdT] dout
constexpr int kOffXQ = kOffDO + kMaxQT * kLdT;      // [32][4] query xyz
constexpr int kOffXYZ = kOffXQ + kMaxQT * 4;        // [128][4] gathered xyz
constexpr int kOffRel = kOffXYZ + kBRows * 4;       // [128][4] rel
constexpr int kOffDrel = kOffRel + kBRows * 4;      // [128][4] drel
constexpr int kBwdSmem = (kOffDrel + kBRows * 4) * static_cast<int>(sizeof(float));
// the forward's: the weights as above, then
constexpr int kFOffK = kOffP;                       // [128][kLdT] k
constexpr int kFOffV = kFOffK + kBRows * kLdT;      // v, then w = v + pos
constexpr int kFOffQ = kFOffV + kBRows * kLdT;      // [32][kLdT] q
constexpr int kFOffXQ = kFOffQ + kMaxQT * kLdT;     // [32][4] query xyz
constexpr int kFOffXYZ = kFOffXQ + kMaxQT * 4;      // [128][4] gathered xyz
constexpr int kFwdSmem = (kFOffXYZ + kBRows * 4) * static_cast<int>(sizeof(float));
// the partials' layout: dwd1 [3][D] | dbd1 | dwd2 [D][D] | dbd2 | dwg1 | dbg1 | dwg2 | dbg2
constexpr int kAccWd2 = 4 * kBD, kAccBd2 = kAccWd2 + kBD * kBD;
constexpr int kAccWg1 = kAccBd2 + kBD, kAccBg1 = kAccWg1 + kBD * kBD;
constexpr int kAccWg2 = kAccBg1 + kBD, kAccBg2 = kAccWg2 + kBD * kBD;
constexpr int kNAcc = kAccBg2 + kBD;

// acc (16 x 64, fragments) += A W at 3xTF32: A (16 x 64) this warp's
// accumulator fragments, W [64][kLdW] in shared memory, read transposed (W^T)
// when T.  Each k-step's k index is permuted (the fragment's k = tig and
// tig + 4 take columns 2 tig and 2 tig + 1 of the step), so an accumulator
// fragment is the next product's A fragment as it stands, and W^T is read as
// float2.
template <bool T>
__device__ __forceinline__ void chain_product(const float (&a)[8][4], const float* W,
                                              float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    mocopci::FragA fa;
    fa.set_rz({a[ks][0], a[ks][2], a[ks][1], a[ks][3]});
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int k = ks * 8 + 2 * tig, n = nt * 8 + gid;
      mocopci::FragB fb;
      if constexpr (T) {
        const float2 w = *reinterpret_cast<const float2*>(W + n * kLdW + k);
        fb.set_rz(w.x, w.y);
      } else {
        fb.set_rz(W[k * kLdW + n], W[(k + 1) * kLdW + n]);
      }
      mocopci::mma_3xtf32(acc[nt], fa, fb);
    }
  }
}

// out = A W + b on FMAs for this warp's 16 rows, each sum over k = 0..63 in
// order and then the bias (as a float32 GEMM and its bias add); A rows of a
// [128][kLdT] buffer, W [64][kLdW].  Lane (rg, cg) = (lane / 8, lane % 8)
// owns rows rg + 4 i and columns 4 cg + j, 32 + 4 cg + j (out[i][j], out[i][4
// + j]), so every shared-memory read is a float4 without bank conflicts.
__device__ __forceinline__ void fma_product(const float* A, const float* W, const float* b,
                                            float (&out)[4][8]) {
  const int lane = threadIdx.x & 31, rg = lane >> 3, cg = lane & 7;
  const float* a = A + ((threadIdx.x >> 5) * 16 + rg) * kLdT;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kBD; k += 4) {
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(a + 4 * i * kLdT + k);
      x[i][0] = v.x, x[i][1] = v.y, x[i][2] = v.z, x[i][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* wr = W + (k + u) * kLdW + 4 * cg;
      const float4 w0 = *reinterpret_cast<const float4*>(wr);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + 32);
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) out[i][j] = fmaf(x[i][u], w[j], out[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bj = b[(j >> 2) * 32 + 4 * cg + (j & 3)];
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i][j] += bj;
  }
}

// acc (this warp's 16 x 32 slice, rows m0.., columns n0..) += X^T Y over the
// tile's 128 rows, X and Y [128][kLdT]; the tile's sum added to acc once.
__device__ __forceinline__ void tile_xty(const float* X, const float* Y, int m0, int n0,
                                         float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float t[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) t[nt][0] = t[nt][1] = t[nt][2] = t[nt][3] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < kBRows / 8; ++ks) {
    const float* a = X + (ks * 8 + tig) * kLdT + m0 + gid;
    mocopci::FragA fa;
    fa.set_rz({a[0], a[8], a[4 * kLdT], a[4 * kLdT + 8]});
    const float* b = Y + (ks * 8 + tig) * kLdT + n0 + gid;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mocopci::FragB fb;
      fb.set_rz(b[nt * 8], b[4 * kLdT + nt * 8]);
      mocopci::mma_3xtf32(t[nt], fa, fb);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += t[nt][i];
}

// The column sum of a staged [128][kLdT] buffer for column threadIdx.x / 4:
// 4 threads a column, each over every fourth row, added in a fixed order.
__device__ __forceinline__ float column_sum(const float* P) {
  const int c = threadIdx.x >> 2, part = threadIdx.x & 3;
  float s = 0.f;
#pragma unroll 8
  for (int r = part; r < kBRows; r += 4) s += P[r * kLdT + c];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// This warp's 16 rows (gid and gid + 8 of each fragment) of a [128][kLdT]
// buffer, as 8 accumulator fragments: load or store.
__device__ __forceinline__ void load_rows(const float* P, float (&x)[8][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float* r0 = P + ((threadIdx.x >> 5) * 16 + gid) * kLdT + 2 * tig;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 a = *reinterpret_cast<const float2*>(r0 + nt * 8);
    const float2 b = *reinterpret_cast<const float2*>(r0 + 8 * kLdT + nt * 8);
    x[nt][0] = a.x, x[nt][1] = a.y, x[nt][2] = b.x, x[nt][3] = b.y;
  }
}

__device__ __forceinline__ void store_rows(float* P, const float (&x)[8][4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float* r0 = P + ((threadIdx.x >> 5) * 16 + gid) * kLdT + 2 * tig;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(r0 + nt * 8) = make_float2(x[nt][0], x[nt][1]);
    *reinterpret_cast<float2*>(r0 + 8 * kLdT + nt * 8) = make_float2(x[nt][2], x[nt][3]);
  }
}

// Over the K rows of each query within the fragment's 16 rows (K = 16: all
// of them; K = 4: rows 4m..4m+3), for v0 (row gid) and v1 (row gid + 8).
template <int K>
__device__ __forceinline__ void query_max(float& v0, float& v1) {
  if constexpr (K == 16) {
    v0 = fmaxf(v0, v1);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, off));
    v1 = v0;
  } else {
#pragma unroll
    for (int off = 4; off < 16; off <<= 1) {
      v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, off));
      v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, off));
    }
  }
}

template <int K>
__device__ __forceinline__ void query_sum(float& v0, float& v1) {
  if constexpr (K == 16) {
    v0 += v1;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) v0 += __shfl_xor_sync(0xffffffffu, v0, off);
    v1 = v0;
  } else {
#pragma unroll
    for (int off = 4; off < 16; off <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, off);
      v1 += __shfl_xor_sync(0xffffffffu, v1, off);
    }
  }
}

// r0 = relu(rel Wd1 + bd1) (or h0 itself, unclamped, when !RELU) as fragments
template <bool RELU>
__device__ __forceinline__ void pos_hidden(const float (&rel)[2][3], const float* wd1,
                                           const float* bd1, float (&x)[8][4]) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = nt * 8 + 2 * tig + (i & 1), h = i >> 1;
      const float v =
          fmaf(rel[h][2], wd1[2 * kBD + c], fmaf(rel[h][1], wd1[kBD + c], rel[h][0] * wd1[c])) +
          bd1[c];
      x[nt][i] = RELU ? fmaxf(v, 0.f) : v;
    }
}

// The weights and biases of both tiled routes, into shared memory
// (the D x D matrices at row stride kLdW).
__device__ __forceinline__ void stage_weights(const float* wd1, const float* bd1, const float* wd2,
                                              const float* bd2, const float* wg1, const float* bg1,
                                              const float* wg2, const float* bg2, float* sm) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kBD * kBD; e += kBThreads) {
    const int r = e >> 6, c = e & 63;
    sm[kOffWd2 + r * kLdW + c] = wd2[e];
    sm[kOffWg1 + r * kLdW + c] = wg1[e];
    sm[kOffWg2 + r * kLdW + c] = wg2[e];
  }
  for (int e = tid; e < 3 * kBD; e += kBThreads) sm[kOffWd1 + e] = wd1[e];
  for (int e = tid; e < kBD; e += kBThreads) {
    sm[kOffBias + e] = bd1[e];
    sm[kOffBias + kBD + e] = bd2[e];
    sm[kOffBias + 2 * kBD + e] = bg1[e];
    sm[kOffBias + 3 * kBD + e] = bg2[e];
  }
}

// Queues the copies of columns [c0, c1) of the [xyz | k | v] rows of this
// warp's 16 rows of tile t: xyz into XYZ [128][4], k into Pk and v into Pv
// ([128][kLdT]); the rows of queries past BN are zeroed.
template <int K>
__device__ __forceinline__ void gather_rows(const float* table, const int* idx, int t, int BN,
                                            int N, int M, float* XYZ, float* Pk, float* Pv,
                                            int c0, int c1) {
  constexpr int QT = kBRows / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qf0 = t * QT, nq = min(QT, BN - qf0);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr, qi = r / K;
    float* dk = Pk + r * kLdT - 3;
    float* dv = Pv + r * kLdT - 3 - kBD;
    if (qi < nq) {
      const int qf = qf0 + qi;
      const int row = idx[static_cast<size_t>(qf) * K + (r - qi * K)];
      const float* src = table + (static_cast<size_t>(qf / N) * M + row) * kBW;
      for (int c = c0 + lane; c < c1; c += 32)
        mocopci::cp_async4(c < 3 ? XYZ + r * 4 + c : c < 3 + kBD ? dk + c : dv + c, src + c);
    } else {
      for (int c = c0 + lane; c < c1; c += 32)
        *(c < 3 ? XYZ + r * 4 + c : c < 3 + kBD ? dk + c : dv + c) = 0.f;
    }
  }
}

// Queues the copies of this warp's queries' rows of src (BN, 64) into S
// [32][kLdT] and of their xyz into XQs [32][4] (when xyzq is given); zeros
// past BN.
template <int K>
__device__ __forceinline__ void gather_queries(const float* src, const float* xyzq, int t, int BN,
                                               float* S, float* XQs) {
  constexpr int QT = kBRows / K, QW = 16 / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qf0 = t * QT, nq = min(QT, BN - qf0);
  for (int e = lane; e < QW * (kBD / 4); e += 32) {
    const int qi = warp * QW + e / (kBD / 4), c = (e % (kBD / 4)) * 4;
    if (qi < nq)
      mocopci::cp_async16(S + qi * kLdT + c, src + static_cast<size_t>(qf0 + qi) * kBD + c);
    else
      *reinterpret_cast<float4*>(S + qi * kLdT + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (xyzq == nullptr) return;
  for (int e = lane; e < QW * 3; e += 32) {
    const int qi = warp * QW + e / 3, c = e % 3;
    if (qi < nq)
      mocopci::cp_async4(XQs + qi * 4 + c, xyzq + static_cast<size_t>(qf0 + qi) * 3 + c);
    else
      XQs[qi * 4 + c] = 0.f;
  }
}

// The chain's first part on this warp's rows: rel = xq - xyz (rel[h] of row
// gid + 8 h), h0 = rel Wd1 + bd1 (mask0: bit 4 nt + i where h0 > 0), r0 =
// relu(h0) into Pr0, then pos = r0 Wd2 + bd2 on FMAs at the lane's
// fma_product positions.
template <int K>
__device__ __forceinline__ void chain_pos(const float* XQs, const float* XYZ, const float* sm,
                                          float* Pr0, float (&rel)[2][3], uint32_t& mask0,
                                          float (&pos)[4][8]) {
  const int R0 = (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2), R1 = R0 + 8;
  const int qa = R0 / K, qb = R1 / K;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rel[0][c] = XQs[qa * 4 + c] - XYZ[R0 * 4 + c];
    rel[1][c] = XQs[qb * 4 + c] - XYZ[R1 * 4 + c];
  }
  float x[8][4];
  pos_hidden<false>(rel, sm + kOffWd1, sm + kOffBias, x);
  mask0 = 0u;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mask0 |= static_cast<uint32_t>(x[nt][i] > 0.f) << (4 * nt + i);
      x[nt][i] = fmaxf(x[nt][i], 0.f);
    }
  store_rows(Pr0, x);                              // r0
  __syncwarp();
  fma_product(Pr0, sm + kOffWd2, sm + kOffBias + kBD, pos);
}

// The second: gv = (q - k) + pos into Pk over k and w = v + pos into Pw (v
// read from Pv; Pw may be Pv), then h1 = gv Wg1 + bg1 on FMAs and r1 =
// relu(h1) into Pr1 (which may hold r0: every lane is done with it), each
// lane at its positions of fma_product.
template <int K>
__device__ __forceinline__ void chain_gate(const float* Qs, const float* sm,
                                           const float (&pos)[4][8], float* Pk, const float* Pv,
                                           float* Pw, float* Pr1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 16 + rg + 4 * i;
    const float* qr = Qs + (r / K) * kLdT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 32 * h + 4 * cg;
      const float4 kk = *reinterpret_cast<const float4*>(Pk + r * kLdT + c);
      const float4 vv = *reinterpret_cast<const float4*>(Pv + r * kLdT + c);
      const float4 qq = *reinterpret_cast<const float4*>(qr + c);
      const float* p = pos[i] + 4 * h;
      *reinterpret_cast<float4*>(Pk + r * kLdT + c) =
          make_float4((qq.x - kk.x) + p[0], (qq.y - kk.y) + p[1], (qq.z - kk.z) + p[2],
                      (qq.w - kk.w) + p[3]);
      *reinterpret_cast<float4*>(Pw + r * kLdT + c) =
          make_float4(vv.x + p[0], vv.y + p[1], vv.z + p[2], vv.w + p[3]);
    }
  }
  __syncwarp();
  float o[4][8];
  fma_product(Pk, sm + kOffWg1, sm + kOffBias + 2 * kBD, o);      // h1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 16 + rg + 4 * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = o[i] + 4 * h;
      *reinterpret_cast<float4*>(Pr1 + r * kLdT + 32 * h + 4 * cg) =
          make_float4(fmaxf(p[0], 0.f), fmaxf(p[1], 0.f), fmaxf(p[2], 0.f), fmaxf(p[3], 0.f));
    }
  }
}

// The third: r1 from Pr1 as fragments (y; mask1: bit 4 nt + i where r1 > 0)
// and logit = r1 Wg2 + bg2 at 3xTF32 (x).
__device__ __forceinline__ void chain_logit(const float* Pr1, const float* sm, float (&x)[8][4],
                                            float (&y)[8][4], uint32_t& mask1) {
  const int tig = threadIdx.x & 3;
  __syncwarp();
  load_rows(Pr1, y);
  mask1 = 0u;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) mask1 |= static_cast<uint32_t>(y[nt][i] > 0.f) << (4 * nt + i);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[nt][i] = sm[kOffBias + 3 * kBD + nt * 8 + 2 * tig + (i & 1)];
  chain_product<false>(y, sm + kOffWg2, x);
}

// The per-channel softmax over each query's K rows for one column of the
// fragments: from the scaled logits l0, l1 of rows gid and gid + 8 and their
// w = v + pos, the weights a0, a1 and out o0, o1 of each row's query.
template <int K>
__device__ __forceinline__ void query_softmax(float l0, float l1, float w0, float w1, float& a0,
                                              float& a1, float& o0, float& o1) {
  float m0v = l0, m1v = l1;
  query_max<K>(m0v, m1v);
  a0 = __expf(l0 - m0v);
  a1 = __expf(l1 - m1v);
  float s0 = a0, s1 = a1;
  query_sum<K>(s0, s1);
  a0 = __fdividef(a0, s0);
  a1 = __fdividef(a1, s1);
  o0 = a0 * w0;
  o1 = a1 * w1;
  query_sum<K>(o0, o1);
}

template <int K>
__global__ void __launch_bounds__(kBThreads, 1) transformer_tail_fwd_kernel(
    const float* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ xyzq, const float* __restrict__ q,
    const float* __restrict__ wd1, const float* __restrict__ bd1,
    const float* __restrict__ wd2, const float* __restrict__ bd2,
    const float* __restrict__ wg1, const float* __restrict__ bg1,
    const float* __restrict__ wg2, const float* __restrict__ bg2, float* __restrict__ out,
    int B, int M, int N) {
  constexpr int QT = kBRows / K;          // queries a tile
  extern __shared__ __align__(16) float sm[];
  float* PK = sm + kFOffK;
  float* PV = sm + kFOffV;
  float* Qs = sm + kFOffQ;
  float* XQs = sm + kFOffXQ;
  float* XYZ = sm + kFOffXYZ;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int R0 = (threadIdx.x >> 5) * 16 + gid;   // this thread's rows R0 and R0 + 8
  const int qa = R0 / K, qb = (R0 + 8) / K;       // ... and their queries in the tile
  const float inv = 0.125f;               // 1 / sqrt(64)
  const int BN = B * N;
  const int ntiles = (BN + QT - 1) / QT;
  // a tile's copies in two groups: xyz, k, q and xq, then v
  auto gather_k = [&](int t) {
    gather_rows<K>(table, idx, t, BN, N, M, XYZ, PK, PV, 0, 3 + kBD);
    gather_queries<K>(q, xyzq, t, BN, Qs, XQs);
    mocopci::cp_async_commit();
  };
  auto gather_v = [&](int t) {
    gather_rows<K>(table, idx, t, BN, N, M, XYZ, PK, PV, 3 + kBD, kBW);
    mocopci::cp_async_commit();
  };
  if (static_cast<int>(blockIdx.x) < ntiles) {
    gather_k(blockIdx.x);
    gather_v(blockIdx.x);
  }
  stage_weights(wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, sm);
  __syncthreads();          // the weights are staged: the block's only barrier

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    mocopci::cp_async_wait1();
    __syncwarp();           // this warp's xyz, k, q and xq of the tile have landed
    const float* bias = sm + kOffBias;
    float rel[2][3], x[8][4], y[8][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rel[0][c] = XQs[qa * 4 + c] - XYZ[R0 * 4 + c];
      rel[1][c] = XQs[qb * 4 + c] - XYZ[(R0 + 8) * 4 + c];
    }
    pos_hidden<true>(rel, sm + kOffWd1, bias, x);                   // r0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[nt][i] = bias[kBD + nt * 8 + 2 * tig + (i & 1)];
    chain_product<false>(x, sm + kOffWd2, y);                       // pos
    mocopci::cp_async_wait0();
    __syncwarp();           // and its v
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = R0 + 8 * (i >> 1), c = nt * 8 + 2 * tig + (i & 1);
        x[nt][i] = (Qs[(r / K) * kLdT + c] - PK[r * kLdT + c]) + y[nt][i];     // gv
        PV[r * kLdT + c] += y[nt][i];                                         // w = v + pos
        y[nt][i] = bias[2 * kBD + c];
      }
    chain_product<false>(x, sm + kOffWg1, y);                       // h1
    __syncwarp();           // every lane is done with xyz, k, q and xq
    if (next < ntiles) gather_k(next);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[nt][i] = fmaxf(y[nt][i], 0.f);                           // r1
        x[nt][i] = bias[3 * kBD + nt * 8 + 2 * tig + (i & 1)];
      }
    chain_product<false>(y, sm + kOffWg2, x);                       // logit
    // the per-channel softmax over each query's K rows; x <- out of the row's query
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * tig + e;
        float a0, a1;
        query_softmax<K>(x[nt][e] * inv, x[nt][2 + e] * inv, PV[R0 * kLdT + c],
                         PV[(R0 + 8) * kLdT + c], a0, a1, x[nt][e], x[nt][2 + e]);
      }
    __syncwarp();           // every lane is done with w
    if (next < ntiles) gather_v(next);
    // out: the lanes of each query's first row (gid % K == 0; at K = 16 both
    // of their rows are one query) write its 64 channels as float2 pairs
    if ((gid & (K == 16 ? 7 : K - 1)) == 0) {
      const size_t qf0 = static_cast<size_t>(tile) * QT;
#pragma unroll
      for (int h = 0; h < (K == 16 ? 1 : 2); ++h) {
        const size_t qf = qf0 + (h ? qb : qa);
        if (qf < static_cast<size_t>(BN)) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            *reinterpret_cast<float2*>(out + qf * kBD + nt * 8 + 2 * tig) =
                make_float2(x[nt][2 * h], x[nt][2 * h + 1]);
        }
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kBThreads, 1) transformer_tail_bwd_kernel(
    const float* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ xyzq, const float* __restrict__ q,
    const float* __restrict__ wd1, const float* __restrict__ bd1,
    const float* __restrict__ wd2, const float* __restrict__ bd2,
    const float* __restrict__ wg1, const float* __restrict__ bg1,
    const float* __restrict__ wg2, const float* __restrict__ bg2,
    const float* __restrict__ dout, float* __restrict__ d_rows, float* __restrict__ dxq,
    float* __restrict__ dq, float* __restrict__ partial, int B, int M, int N) {
  constexpr int QT = kBRows / K;          // queries a tile
  constexpr int QW = 16 / K;              // queries a warp
  extern __shared__ __align__(16) float sm[];
  float* Wd2s = sm + kOffWd2;
  float* Wg1s = sm + kOffWg1;
  float* Wg2s = sm + kOffWg2;
  float* wd1s = sm + kOffWd1;
  float* bias = sm + kOffBias;
  float* P0 = sm + kOffP;                 // k, then gv, then dgv
  float* P1 = P0 + kBRows * kLdT;         // v, then r1, then r0
  float* P2 = P1 + kBRows * kLdT;         // r0, then dG2, dh1, dpos, dh0
  float* P3 = P2 + kBRows * kLdT;         // w = v + pos, then its gradient dout a
  float* Qs = sm + kOffQ;
  float* DOs = sm + kOffDO;
  float* XQs = sm + kOffXQ;
  float* XYZ = sm + kOffXYZ;
  float* REL = sm + kOffRel;
  float* DREL = sm + kOffDrel;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int R0 = warp * 16 + gid, R1 = R0 + 8;     // this thread's rows of the fragments
  const int qa = R0 / K, qb = R1 / K;              // ... and their queries in the tile
  const float inv = 0.125f;                        // 1 / sqrt(64)

  stage_weights(wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, sm);
  // the warp's slice of the three D x D weight gradients
  const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
  float aWd2[4][4], aWg1[4][4], aWg2[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) aWd2[nt][i] = aWg1[nt][i] = aWg2[nt][i] = 0.f;
  // column tid / 4's bias gradients and dWd1 column
  float aBd1 = 0.f, aBd2 = 0.f, aBg1 = 0.f, aBg2 = 0.f, aWd1[3] = {0.f, 0.f, 0.f};

  const int BN = B * N;
  const int ntiles = (BN + QT - 1) / QT;
  // Queues the copies of tile t's rows [xyz | k | v] of this warp's 16 rows
  // and the q, dout and xyz of its queries; rows of absent queries are zero.
  auto gather = [&](int t) {
    gather_rows<K>(table, idx, t, BN, N, M, XYZ, P0, P1, 0, kBW);
    gather_queries<K>(q, xyzq, t, BN, Qs, XQs);
    gather_queries<K>(dout, nullptr, t, BN, DOs, nullptr);
    mocopci::cp_async_commit();
  };
  if (static_cast<int>(blockIdx.x) < ntiles) gather(blockIdx.x);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int qf0 = tile * QT;
    const int nq = min(QT, BN - qf0);
    mocopci::cp_async_wait0();
    __syncthreads();        // the tile has landed; the weights and the last tile are done

    // ---- the recompute, on this warp's rows: r0 into P2, gv into P0, w
    // into P3, r1 into P1, the logits in x ----
    float rel[2][3], x[8][4], y[8][4];
    uint32_t mask0, mask1;                  // bit 4 nt + i: h0 (h1) > 0
    {
      float pos[4][8];
      chain_pos<K>(XQs, XYZ, sm, P2, rel, mask0, pos);
      chain_gate<K>(Qs, sm, pos, P0, P1, P3, P1);
    }
    chain_logit(P1, sm, x, y, mask1);
    if (tig == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) REL[R0 * 4 + c] = rel[0][c], REL[R1 * 4 + c] = rel[1][c];
    }
    // the per-channel softmax over each query's K rows, out, and its VJP:
    // x <- dG2 = a (dout w - dout out) / sqrt(D), P3 <- d(v + pos) = dout a
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * tig + e;
        const float w0 = P3[R0 * kLdT + c], w1 = P3[R1 * kLdT + c];
        float a0, a1, o0, o1;
        query_softmax<K>(x[nt][e] * inv, x[nt][2 + e] * inv, w0, w1, a0, a1, o0, o1);
        const float g0 = DOs[qa * kLdT + c], g1 = DOs[qb * kLdT + c];
        x[nt][e] = a0 * (g0 * w0 - g0 * o0) * inv;
        x[nt][2 + e] = a1 * (g1 * w1 - g1 * o1) * inv;
        P3[R0 * kLdT + c] = g0 * a0;
        P3[R1 * kLdT + c] = g1 * a1;
      }
    store_rows(P2, x);                               // dG2
    __syncthreads();        // r1 and dG2 of every row are staged

    // ---- the VJP ----
    tile_xty(P1, P2, m0, n0, aWg2);
    aBg2 += column_sum(P2);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) y[nt][0] = y[nt][1] = y[nt][2] = y[nt][3] = 0.f;
    chain_product<true>(x, Wg2s, y);                 // dr1
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[nt][i] = (mask1 >> (4 * nt + i)) & 1u ? y[nt][i] : 0.f;
    __syncthreads();        // every warp is done with r1 and dG2
    store_rows(P2, y);                               // dh1
    pos_hidden<true>(rel, wd1s, bias, x);
    store_rows(P1, x);                               // r0, as in the recompute
    __syncthreads();
    tile_xty(P0, P2, m0, n0, aWg1);
    aBg1 += column_sum(P2);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) x[nt][0] = x[nt][1] = x[nt][2] = x[nt][3] = 0.f;
    chain_product<true>(y, Wg1s, x);                 // dgv
    load_rows(P3, y);                                // d(v + pos)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[nt][i] += x[nt][i];   // dpos = dgv + d(v + pos)
    __syncthreads();        // every warp is done with gv and dh1
    store_rows(P0, x);                               // dgv
    store_rows(P2, y);                               // dpos
    __syncwarp();
    // dq = sum over the query's rows of dgv, in j order
    for (int e = lane; e < QW * kBD; e += 32) {
      const int qi = warp * QW + e / kBD, c = e % kBD;
      if (qi < nq) {
        float s = 0.f;
        for (int j = 0; j < K; ++j) s += P0[(qi * K + j) * kLdT + c];
        dq[static_cast<size_t>(qf0 + qi) * kBD + c] = s;
      }
    }
    __syncthreads();        // dpos of every row is staged
    tile_xty(P1, P2, m0, n0, aWd2);
    aBd2 += column_sum(P2);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) x[nt][0] = x[nt][1] = x[nt][2] = x[nt][3] = 0.f;
    chain_product<true>(y, Wd2s, x);                 // dr0
    float dr[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = (mask0 >> (4 * nt + i)) & 1u ? x[nt][i] : 0.f;    // dh0
        x[nt][i] = d;
        const int c = nt * 8 + 2 * tig + (i & 1);
#pragma unroll
        for (int f = 0; f < 3; ++f) dr[i >> 1][f] = fmaf(d, wd1s[f * kBD + c], dr[i >> 1][f]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        dr[h][f] += __shfl_xor_sync(0xffffffffu, dr[h][f], 1);
        dr[h][f] += __shfl_xor_sync(0xffffffffu, dr[h][f], 2);
      }
    if (tig == 0) {
#pragma unroll
      for (int f = 0; f < 3; ++f) DREL[R0 * 4 + f] = dr[0][f], DREL[R1 * 4 + f] = dr[1][f];
    }
    __syncthreads();        // every warp is done with r0 and dpos
    store_rows(P2, x);                               // dh0
    __syncwarp();
    // dxq = sum over the query's rows of drel, in j order
    for (int e = lane; e < QW * 3; e += 32) {
      const int qi = warp * QW + e / 3, f = e % 3;
      if (qi < nq) {
        float s = 0.f;
        for (int j = 0; j < K; ++j) s += DREL[(qi * K + j) * 4 + f];
        dxq[static_cast<size_t>(qf0 + qi) * 3 + f] = s;
      }
    }
    // d_rows = [-drel | -dgv | d(v + pos)] of this warp's rows, contiguous
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      if (r >= nq * K) break;
      float* out = d_rows + (static_cast<size_t>(qf0) * K + r) * kBW;
      for (int c = lane; c < kBW; c += 32)
        out[c] = c < 3 ? -DREL[r * 4 + c]
                       : c < 3 + kBD ? -P0[r * kLdT + c - 3] : P3[r * kLdT + c - 3 - kBD];
    }
    __syncwarp();
    if (tile + static_cast<int>(gridDim.x) < ntiles) gather(tile + gridDim.x);
    __syncthreads();        // dh0 of every row is staged
    {                       // dWd1 = rel^T dh0 and dbd1, column tid / 4
      const int c = tid >> 2, part = tid & 3;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int r = part; r < kBRows; r += 4) {
        const float d = P2[r * kLdT + c];
        s[0] = fmaf(REL[r * 4], d, s[0]);
        s[1] = fmaf(REL[r * 4 + 1], d, s[1]);
        s[2] = fmaf(REL[r * 4 + 2], d, s[2]);
        s[3] += d;
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        s[f] += __shfl_xor_sync(0xffffffffu, s[f], 1);
        s[f] += __shfl_xor_sync(0xffffffffu, s[f], 2);
      }
      aWd1[0] += s[0], aWd1[1] += s[1], aWd1[2] += s[2], aBd1 += s[3];
    }
  }

  float* pb = partial + static_cast<size_t>(blockIdx.x) * kNAcc;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = (m0 + gid + 8 * (i >> 1)) * kBD + n0 + nt * 8 + 2 * tig + (i & 1);
      pb[kAccWd2 + o] = aWd2[nt][i];
      pb[kAccWg1 + o] = aWg1[nt][i];
      pb[kAccWg2 + o] = aWg2[nt][i];
    }
  if ((tid & 3) == 0) {
    const int c = tid >> 2;
    pb[c] = aWd1[0];
    pb[kBD + c] = aWd1[1];
    pb[2 * kBD + c] = aWd1[2];
    pb[3 * kBD + c] = aBd1;
    pb[kAccBd2 + c] = aBd2;
    pb[kAccBg1 + c] = aBg1;
    pb[kAccBg2 + c] = aBg2;
  }
}

}  // namespace

// table (B, M, 3+2D), idx (B, N, K) int32, xyzq (B, N, 3), q (B, N, D),
// wd1 (3, D), wd2/wg1/wg2 (D, D), biases (D) -> out (B, N, D), all f32; for
// D = 64 and K = 16 or 4, on nblk blocks.
MOCOPCI_API int mocopci_transformer_tail(const float* table, const int* idx,
                                         const float* xyzq, const float* q,
                                         const float* wd1, const float* bd1,
                                         const float* wd2, const float* bd2,
                                         const float* wg1, const float* bg1,
                                         const float* wg2, const float* bg2, float* out,
                                         int B, int M, int N, int K, int D, int nblk,
                                         void* stream) {
  if (D != kBD || (K != 16 && K != 4) || nblk < 1) return cudaErrorInvalidValue;
  auto kernel = K == 16 ? transformer_tail_fwd_kernel<16> : transformer_tail_fwd_kernel<4>;
  cudaError_t err = mocopci::allow_smem(kernel, kFwdSmem);
  if (err != cudaSuccess) return err;
  kernel<<<nblk, kBThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, out, B, M, N);
  return cudaGetLastError();
}

// The general route of mocopci_transformer_tail: the same output for any
// (K, D) whose working set (3 D^2 + 8 D + 3 K + 3 K D floats) fits in shared
// memory, a block a tile of 8 queries.
MOCOPCI_API int mocopci_transformer_tail_general(const float* table, const int* idx,
                                                 const float* xyzq, const float* q,
                                                 const float* wd1, const float* bd1,
                                                 const float* wd2, const float* bd2,
                                                 const float* wg1, const float* bg1,
                                                 const float* wg2, const float* bg2,
                                                 float* out, int B, int M, int N, int K, int D,
                                                 void* stream) {
  const size_t floats = 3 * static_cast<size_t>(D) + 3 * static_cast<size_t>(D) * D +
                        4 * D + 3 * K + D + 3 * static_cast<size_t>(K) * D;
  const size_t smem = floats * sizeof(float);
  cudaError_t err = mocopci::allow_smem(transformer_tail_general_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mocopci::ceil_div(N, kQT), B);
  transformer_tail_general_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, out, M, N, K, D);
  return cudaGetLastError();
}

// Backward of mocopci_transformer_tail given dout (B, N, D): d_rows (B, N, K,
// 3+2D) (the gathered rows' gradient), dxq (B, N, 3), dq (B, N, D), and dw =
// [dwd1 (3, D) | dbd1 | dwd2 (D, D) | dbd2 | dwg1 | dbg1 | dwg2 | dbg2], for
// D = 64 and K = 16 or 4.  partial: nblk * (3D^2 + 7D) floats of scratch,
// reduced in block order.
MOCOPCI_API int mocopci_transformer_tail_bwd(
    const float* table, const int* idx, const float* xyzq, const float* q, const float* wd1,
    const float* bd1, const float* wd2, const float* bd2, const float* wg1, const float* bg1,
    const float* wg2, const float* bg2, const float* dout, float* d_rows, float* dxq,
    float* dq, float* dw, float* partial, int B, int M, int N, int K, int D, int nblk,
    void* stream) {
  if (D != kBD || (K != 16 && K != 4) || nblk < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = K == 16 ? transformer_tail_bwd_kernel<16> : transformer_tail_bwd_kernel<4>;
  cudaError_t err = mocopci::allow_smem(kernel, kBwdSmem);
  if (err != cudaSuccess) return err;
  kernel<<<nblk, kBThreads, kBwdSmem, st>>>(table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1,
                                             wg2, bg2, dout, d_rows, dxq, dq, partial, B, M, N);
  MOCOPCI_CHECK_LAUNCH();
  return mocopci::reduce_partials(partial, dw, nblk, kNAcc, st);
}

static size_t transformer_tail_bwd_general_floats(int K, int D) {
  const size_t DD = static_cast<size_t>(D) * D, KD = static_cast<size_t>(K) * D;
  return 9 * DD + 20 * static_cast<size_t>(D) + 6 * static_cast<size_t>(K) + 11 * KD;
}

// The general route of mocopci_transformer_tail_bwd: the same outputs for any
// (K, D) whose working set (9 D^2 + 20 D + 6 K + 11 K D floats) fits in shared
// memory; partial: nblk * (3D^2 + 7D) floats of scratch, reduced in block
// order.
MOCOPCI_API int mocopci_transformer_tail_bwd_general(
    const float* table, const int* idx, const float* xyzq, const float* q, const float* wd1,
    const float* bd1, const float* wd2, const float* bd2, const float* wg1, const float* bg1,
    const float* wg2, const float* bg2, const float* dout, float* d_rows, float* dxq,
    float* dq, float* dw, float* partial, int B, int M, int N, int K, int D, int nblk,
    void* stream) {
  if (K < 1 || D < 1 || nblk < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = transformer_tail_bwd_general_floats(K, D) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(transformer_tail_bwd_general_kernel, smem);
  if (err != cudaSuccess) return err;
  transformer_tail_bwd_general_kernel<<<nblk, kThreads, smem, st>>>(
      table, idx, xyzq, q, wd1, bd1, wd2, bd2, wg1, bg1, wg2, bg2, dout, d_rows, dxq, dq,
      partial, B, M, N, K, D);
  MOCOPCI_CHECK_LAUNCH();
  return mocopci::reduce_partials(partial, dw, nblk, 3 * D * D + 7 * D, st);
}
