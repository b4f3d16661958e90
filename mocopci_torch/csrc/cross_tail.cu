// Cost-volume tail: out[n] = max_j leaky(leaky(tab[idx[n, j]] + base[n]) W + b).
//
// Replaces mocopci_tpu/ops/pallas/cross_tail.py: cross_tail forward (:155,
// pallas_call :161), dispatched for N1 >= 1024 (nn/cross.py:88).  The TPU
// kernel reads materialised k-major rows; this one gathers each row itself
// from the (B, M, C) table, so the (B, K*N1, C) row tensor never exists.
//
// Forward, bound on the H100: operations, 2*N1*K*C*C2 flops (1.6 GFLOP per
// up_1 call) against K*N1*C*4 gathered bytes.  Design: a register-tiled
// product over chunks of 128 pair rows.  A unit is QT = 128 / Kp whole
// queries (Kp = K rounded up to 8; one query in chunks of 128 rows where Kp >
// 128), its padded rows (q, j) in order, rows j >= K masked; a fixed grid of
// blocks walks the units.  W (C x C2, zero-padded to 64-column passes) and b
// sit in shared memory for the block's life.  A chunk's rows are gathered
// from the table by cp.async (16-byte pieces where C % 4 == 0 and the table
// and base are aligned, else 4-byte; rows at a stride of an odd count of
// float4s), the next chunk's while this one's products run; on landing each
// element becomes x = leaky(row + base) once, written transposed ([c][row])
// so that a thread reads 8 rows of a column as two 16-byte loads.  Thread
// (row group rg, channel group cg) of 16 x 16 holds the 8 x 4 accumulators of
// rows [8 rg, 8 rg + 8) and channels [4 cg, 4 cg + 4) of the pass: per c, 3
// shared loads for 32 FMAs.  Each accumulator runs acc = fmaf(x[c], W[c, c2],
// acc) for c ascending from 0, then leaky(acc + b): one chain a pair and
// channel, so the bits do not depend on the tiling.  A row
// group's 8 rows belong to one query: the thread keeps each channel's first
// max over them (strict > along ascending j), then the row groups of a query
// are merged in ascending order through shared memory (strict > again, and
// across chunks in a running max), so the argmax, written when the caller
// asks for it (training), is the first j attaining each max; one byte an
// entry for K <= 255.  The (N1, K, C2) activation is never written.
//
// The wide route (cross_tail_wide) takes the tails whose W, transposed x and
// staged rows pass one block's shared memory: C = C2 = 256 at cross3 of a
// 32768-point cloud (L3's 1024 queries; the TPU kernel takes any C).  A
// block a query at a time: its K rows become x = leaky(row + base) in shared
// memory, row-major ([j][c], K padded to 8: coalesced loads, conflict-free
// stores), and each thread runs the chains of two output channels c2 for 32
// rows at once (8 for the rest), acc = fmaf(x[j][c], W[c, c2], acc) for c
// ascending from 0, one broadcast float4 of x feeding 8 FMAs and W's rows
// read from global memory (coalesced over c2, L2-resident) once a query for
// K <= 32; then leaky(acc + b) and the first max over ascending j: the
// tiled kernel's chains, so its bits and argmax.  One or four channels a
// thread, or 16 rows a pass, ran slower (scripts/torch_variant_timing.py
// --only wide).
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
//
// The backward's wide route (cross_tail_bwd_wide) takes the tails whose
// tiled footprint (W and dW transposed, a query's rows and their gradient)
// passes a block's shared memory: C = C2 = 256 at cross3 of a 32768-point
// cloud, about 594 KB.  A fixed grid of blocks walks groups of kBQ queries
// (group u = blockIdx.x + i*gridDim.x), a thread a channel c:
//   gv = dout * leaky'(pre1 at j*) and j* of the group's outputs go to
//     shared memory;
//   c2 ascending, dx[q][j*(q, c2)][c] = fmaf(gv[q][c2], W[c, c2], dx) for
//     the group's queries, W read once a group from a transposed copy in
//     global memory (L2-resident, coalesced over c): the tiled kernel's
//     chain, so its d_rows and d_base bit for bit;
//   row j ascending, p = row + base (the row read from the table), d = dx *
//     leaky'(p) into d_rows and d_base, and x0 = leaky(p) in dx's place;
//   dW[c, c2] += x0[q][j*(q, c2)][c] gv[q][c2] over the group's queries in
//     order, db[c2] += gv[q][c2], into the block's partial (dW transposed),
//     which stays in global memory across its groups, each entry read and
//     written by one thread.
// The partials are summed in block order (deterministic), dW transposed
// back on the way.  Shared memory: the group's x, kBQ * K * C floats (128 KB
// at K = 32, C = 256), and its gv and j*.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The forward's tiles: a chunk of 128 padded pair rows x a pass of 64 output
// channels, 16 row groups of 8 rows x 16 channel groups of 4, a thread each.
constexpr int kFRows = 128;
constexpr int kFCols = 64;
constexpr int kFThreads = 2 * kFRows;    // a thread 8 rows x 4 channels, two a staged row
constexpr int kFRowGroups = kFRows / 8, kFColGroups = kFCols / 4;
static_assert(kFRowGroups * kFColGroups == kFThreads, "the forward's thread tiles");
constexpr int kFXS = kFRows + 4;      // row stride of the transposed x ([c][row])

// K padded to whole row groups
__host__ __device__ inline int fwd_kp(int K) { return (K + 7) & ~7; }
// queries a unit
__host__ __device__ inline int fwd_tile(int K) {
  return fwd_kp(K) >= kFRows ? 1 : kFRows / fwd_kp(K);
}
// the staged rows' stride: C rounded up to an odd count of float4s, so that
// 8 threads reading 16 bytes of 8 consecutive rows hit 32 distinct banks
__host__ __device__ inline int fwd_row_stride(int C) {
  const int s = (C + 3) & ~3;
  return (s >> 2) & 1 ? s : s + 4;
}

inline size_t fwd_smem_floats(int K, int C, int C2) {
  const size_t c2p = static_cast<size_t>(mocopci::ceil_div(C2, kFCols)) * kFCols;
  const size_t qt = fwd_tile(K);
  const size_t rows = static_cast<size_t>(kFRows) * fwd_row_stride(C);
  return c2p * C + static_cast<size_t>(C) * kFXS + rows + ((qt * C + 3) & ~static_cast<size_t>(3)) +
         c2p + 2 * kFRowGroups * kFCols + 2 * c2p;
}

// Queues the copies of a chunk of pair rows (zeros where a row is padding or
// past the queries) and, on a unit's first chunk, the unit's base rows.  Two
// threads a staged row, each reading the row's index once.
__device__ __forceinline__ void stage_tail_chunk(
    const float* __restrict__ tab, const int* __restrict__ idx, const float* __restrict__ base,
    float* rows, float* bs, int q0, int ch, bool vec, int BN, int M, int N, int K, int C) {
  const int Kp = fwd_kp(K), QT = fwd_tile(K), S = fwd_row_stride(C);
  const int W = vec ? C >> 2 : C;       // pieces a row
  const int r = threadIdx.x >> 1;
  const int rho = ch * kFRows + r, q = rho / Kp, j = rho - q * Kp, n = q0 + q;
  const bool ok = q < QT && j < K && n < BN;
  const size_t row =
      ok ? static_cast<size_t>(n / N) * M + idx[static_cast<size_t>(n) * K + j] : 0;
  const float* src = tab + row * C;
  for (int p = threadIdx.x & 1; p < W; p += 2) {
    if (vec) mocopci::cp_async16z(rows + r * S + 4 * p, src + 4 * p, ok);
    else mocopci::cp_async4z(rows + r * S + p, src + p, ok);
  }
  if (ch == 0) {
    for (int e = threadIdx.x; e < QT * W; e += kFThreads) {
      const int qq = e / W, c = vec ? (e - qq * W) << 2 : e - qq * W;
      const bool okb = q0 + qq < BN;
      const size_t sb = okb ? static_cast<size_t>(q0 + qq) * C + c : 0;
      if (vec) mocopci::cp_async16z(bs + qq * C + c, base + sb, okb);
      else mocopci::cp_async4z(bs + qq * C + c, base + sb, okb);
    }
  }
  mocopci::cp_async_commit();
}

// kArg: also find and write the first j at each max (amax); without it the
// instance is the plain running max.  Queries are flattened (B*N), unit u =
// blockIdx.x + i*gridDim.x; step s of a block is its unit s / nchunk, chunk
// s % nchunk.
template <typename IdxT, bool kArg>
__global__ void __launch_bounds__(kFThreads, 2) cross_tail_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ base, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, IdxT* __restrict__ amax, int BN,
    int M, int N, int K, int C, int C2) {
  extern __shared__ __align__(16) float sm[];
  const int Kp = fwd_kp(K), QT = fwd_tile(K), S = fwd_row_stride(C);
  const int npass = mocopci::ceil_div(C2, kFCols), C2P = npass * kFCols;
  const int nchunk = mocopci::ceil_div(QT * Kp, kFRows);
  float* ws = sm;                              // [C][C2P] W, zero past C2
  float* xt = ws + C * C2P;                    // [C][kFXS] x = leaky(row + base)
  float* rows = xt + C * kFXS;                 // [kFRows][S] the chunk's gathered rows
  float* bs = rows + kFRows * S;               // [QT][C] the unit's base rows
  float* bb = bs + ((QT * C + 3) & ~3);        // [C2P] b, zero past C2
  float* redv = bb + C2P;                      // [kFRowGroups][kFCols] a row group's max
  int* redj = reinterpret_cast<int*>(redv + kFRowGroups * kFCols);   // ... its first j
  float* runv = reinterpret_cast<float*>(redj + kFRowGroups * kFCols);  // [C2P] over chunks
  int* runj = reinterpret_cast<int*>(runv + C2P);
  const int tid = threadIdx.x, cg = tid % kFColGroups, rg = tid / kFColGroups;
  const bool vec = (C & 3) == 0 && (reinterpret_cast<uintptr_t>(tab) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(base) & 15) == 0;
  const int bx = blockIdx.x, nb = gridDim.x, nunits = mocopci::ceil_div(BN, QT);
  const int nsteps = (bx < nunits ? mocopci::ceil_div(nunits - bx, nb) : 0) * nchunk;
  // step s: unit bx + (s / nchunk) nb, chunk s % nchunk
  auto unit_q0 = [&](int st) { return (bx + (st / nchunk) * nb) * QT; };
  if (nsteps > 0) stage_tail_chunk(tab, idx, base, rows, bs, bx * QT, 0, vec, BN, M, N, K, C);
  for (int e = tid; e < C * C2P; e += kFThreads) {
    const int c = e / C2P, c2 = e - c * C2P;
    ws[e] = c2 < C2 ? w[c * C2 + c2] : 0.f;
  }
  for (int e = tid; e < C2P; e += kFThreads) bb[e] = e < C2 ? bias[e] : 0.f;

  for (int s = 0; s < nsteps; ++s) {
    const int ch = s % nchunk, q0 = unit_q0(s);
    mocopci::cp_async_wait0();
    __syncthreads();                 // the chunk has landed; every thread is done with xt
    {  // land: x = leaky(row + base), transposed; a warp takes 32 consecutive rows
      const int r = tid % kFRows;
      const float* br = bs + min((ch * kFRows + r) / Kp, QT - 1) * C;
      for (int c = (tid / kFRows) << 2; c < C; c += (kFThreads / kFRows) << 2) {
        const float4 x = *reinterpret_cast<const float4*>(rows + r * S + c);
        const float* b = br + c;
        float* xc = xt + c * kFXS + r;
        xc[0] = mocopci::leaky(x.x + b[0]);
        if (c + 1 < C) xc[kFXS] = mocopci::leaky(x.y + b[1]);
        if (c + 2 < C) xc[2 * kFXS] = mocopci::leaky(x.z + b[2]);
        if (c + 3 < C) xc[3 * kFXS] = mocopci::leaky(x.w + b[3]);
      }
    }
    __syncthreads();                 // xt is complete; the staged rows are free
    if (s + 1 < nsteps)
      stage_tail_chunk(tab, idx, base, rows, bs, unit_q0(s + 1), (s + 1) % nchunk, vec, BN, M,
                       N, K, C);
    // this thread's rows: one query q, neighbours [j0, j0 + 8)
    const int rho0 = ch * kFRows + rg * 8, q = rho0 / Kp, j0 = rho0 - q * Kp;
    const bool qok = q < QT && q0 + q < BN;
    for (int p = 0; p < npass; ++p) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;
      const float* xp = xt + rg * 8;
      const float* wp = ws + p * kFCols + cg * 4;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float4 xa = *reinterpret_cast<const float4*>(xp + c * kFXS);
        const float4 xb = *reinterpret_cast<const float4*>(xp + c * kFXS + 4);
        const float4 wv = *reinterpret_cast<const float4*>(wp + c * C2P);
        const float xr[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(xr[i], wr[k], acc[i][k]);
      }
      const float4 bv = *reinterpret_cast<const float4*>(bb + p * kFCols + cg * 4);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
      float m[4];
      int jm[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) m[k] = -__int_as_float(0x7f800000), jm[k] = K;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!qok || j0 + i >= K) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float v = mocopci::leaky(acc[i][k] + br[k]);
          if (!kArg) {
            m[k] = fmaxf(m[k], v);
          } else if (v > m[k]) {     // ascending j: strict > keeps the first j at the max
            m[k] = v;
            jm[k] = j0 + i;
          }
        }
      }
      *reinterpret_cast<float4*>(redv + rg * kFCols + cg * 4) = make_float4(m[0], m[1], m[2], m[3]);
      if (kArg)
        *reinterpret_cast<int4*>(redj + rg * kFCols + cg * 4) =
            make_int4(jm[0], jm[1], jm[2], jm[3]);
      __syncthreads();
      // merge each (query, channel) over its row groups in ascending order,
      // then over the chunks (a query spans chunks only when it is the unit)
      const int nq = nchunk == 1 ? QT : 1;
      for (int e = tid; e < nq * kFCols; e += kFThreads) {
        const int qq = e / kFCols, cl = e - qq * kFCols, c2 = p * kFCols + cl;
        const int g0 = nchunk == 1 ? qq * Kp / 8 : 0;
        const int g1 = nchunk == 1 ? (qq + 1) * Kp / 8 : kFRowGroups;
        float mv = ch == 0 ? -__int_as_float(0x7f800000) : runv[c2];
        int mj = ch == 0 || !kArg ? K : runj[c2];
        for (int g = g0; g < g1; ++g) {
          const float v = redv[g * kFCols + cl];
          if (!kArg) {
            mv = fmaxf(mv, v);
          } else if (v > mv) {
            mv = v;
            mj = redj[g * kFCols + cl];
          }
        }
        const int n = q0 + qq;
        if (ch + 1 < nchunk) {
          runv[c2] = mv;
          if (kArg) runj[c2] = mj;
        } else if (n < BN && c2 < C2) {
          const size_t o = static_cast<size_t>(n) * C2 + c2;
          out[o] = mv;
          if (kArg) amax[o] = static_cast<IdxT>(mj < K ? mj : 0);
        }
      }
      if (p + 1 < npass) __syncthreads();     // the merge has read red before the next pass
    }
  }
}

constexpr size_t kMaxSmem = 227 * 1024;

constexpr int kWThreads = 128;
constexpr int kWCols = 2;                  // output channels a thread, kWThreads apart

__host__ __device__ inline int wide_cp(int C) { return (C + 3) & ~3; }   // x's row stride

// Rows j0 .. j0 + kJ - 1 of one query's x (xs, stride Cp) against the
// thread's output channels c2[i]: the chains acc = fmaf(x[j][c], W[c, c2],
// acc) for c ascending from 0, then leaky(acc + b) into the running max (and
// the first j at it) over ascending j.
template <int kJ, bool kArg>
__device__ __forceinline__ void wide_rows(const float* xs, int Cp, const float* __restrict__ w,
                                          int C, int C2, const int (&col)[kWCols], int j0,
                                          int K, const float (&bv)[kWCols], float (&m)[kWCols],
                                          int (&mj)[kWCols]) {
  float acc[kWCols][kJ];
#pragma unroll
  for (int i = 0; i < kWCols; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  const float* xr = xs + j0 * Cp;
  int c = 0;
  for (; c + 4 <= C; c += 4) {
    float wv[kWCols][4];
#pragma unroll
    for (int i = 0; i < kWCols; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[i][q] = __ldg(w + static_cast<size_t>(c + q) * C2 + col[i]);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(xr + j * Cp + c);
#pragma unroll
      for (int i = 0; i < kWCols; ++i) {
        acc[i][j] = fmaf(x.x, wv[i][0], acc[i][j]);
        acc[i][j] = fmaf(x.y, wv[i][1], acc[i][j]);
        acc[i][j] = fmaf(x.z, wv[i][2], acc[i][j]);
        acc[i][j] = fmaf(x.w, wv[i][3], acc[i][j]);
      }
    }
  }
  for (; c < C; ++c) {
    float wv[kWCols];
#pragma unroll
    for (int i = 0; i < kWCols; ++i) wv[i] = __ldg(w + static_cast<size_t>(c) * C2 + col[i]);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int i = 0; i < kWCols; ++i) acc[i][j] = fmaf(xr[j * Cp + c], wv[i], acc[i][j]);
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j0 + j >= K) continue;
#pragma unroll
    for (int i = 0; i < kWCols; ++i) {
      const float v = mocopci::leaky(acc[i][j] + bv[i]);
      if (!kArg) {
        m[i] = fmaxf(m[i], v);
      } else if (v > m[i]) {       // ascending j: strict > keeps the first j at the max
        m[i] = v;
        mj[i] = j0 + j;
      }
    }
  }
}

// Wide route: query n = blockIdx.x + i*gridDim.x; thread t takes the output
// channels cb + t + i*kWThreads.
template <typename IdxT, bool kArg>
__global__ void __launch_bounds__(kWThreads) cross_tail_wide_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ base, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, IdxT* __restrict__ amax, int BN,
    int M, int N, int K, int C, int C2) {
  extern __shared__ __align__(16) float xs[];     // [Kp][Cp] x = leaky(row + base)
  const int Kp = fwd_kp(K), Cp = wide_cp(C);
  for (int n = blockIdx.x; n < BN; n += gridDim.x) {
    const int* iq = idx + static_cast<size_t>(n) * K;
    const float* bq = base + static_cast<size_t>(n) * C;
    const size_t tb = static_cast<size_t>(n / N) * M;
    __syncthreads();                 // every thread is done with the last query's x
    for (int e = threadIdx.x; e < Kp * C; e += blockDim.x) {
      const int j = e / C, c = e - j * C;
      xs[j * Cp + c] = j < K ? mocopci::leaky(tab[(tb + iq[j]) * C + c] + bq[c]) : 0.f;
    }
    __syncthreads();
    for (int cb = 0; cb < C2; cb += kWThreads * kWCols) {
      int col[kWCols];
      float bv[kWCols], m[kWCols];
      int mj[kWCols];
#pragma unroll
      for (int i = 0; i < kWCols; ++i) {
        col[i] = min(cb + static_cast<int>(threadIdx.x) + i * kWThreads, C2 - 1);
        bv[i] = bias[col[i]];
        m[i] = -__int_as_float(0x7f800000);
        mj[i] = K;
      }
      int j0 = 0;
      for (; j0 + 32 <= Kp; j0 += 32)
        wide_rows<32, kArg>(xs, Cp, w, C, C2, col, j0, K, bv, m, mj);
      for (; j0 < Kp; j0 += 8) wide_rows<8, kArg>(xs, Cp, w, C, C2, col, j0, K, bv, m, mj);
#pragma unroll
      for (int i = 0; i < kWCols; ++i) {
        const int c2 = cb + static_cast<int>(threadIdx.x) + i * kWThreads;
        if (c2 >= C2) continue;
        const size_t o = static_cast<size_t>(n) * C2 + c2;
        out[o] = m[i];
        if (kArg) amax[o] = static_cast<IdxT>(mj[i] < K ? mj[i] : 0);
      }
    }
  }
}

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

constexpr int kBQ = 4;                  // the wide backward's queries a group
constexpr int kBWThreads = 256;

__host__ __device__ inline size_t bwd_wide_smem_floats(int K, int C, int C2) {
  return static_cast<size_t>(kBQ) * (static_cast<size_t>(K) * C + 2 * C2);
}

// wt[c2 * C + c] = w[c * C2 + c2]
__global__ void __launch_bounds__(256) cross_tail_bwd_wide_transpose_kernel(
    const float* __restrict__ w, float* __restrict__ wt, int C, int C2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= C * C2) return;
  const int c2 = e / C, c = e - c2 * C;
  wt[e] = w[static_cast<size_t>(c) * C2 + c2];
}

template <typename IdxT>
__global__ void __launch_bounds__(kBWThreads) cross_tail_bwd_wide_kernel(
    const float* __restrict__ tab, const int* __restrict__ idx,
    const float* __restrict__ base, const float* __restrict__ wt,
    const float* __restrict__ out, const IdxT* __restrict__ amax,
    const float* __restrict__ dout, float* __restrict__ d_rows, float* __restrict__ d_base,
    float* __restrict__ partial, int BN, int M, int N, int K, int C, int C2) {
  extern __shared__ float sm[];
  float* xs = sm;                                   // [kBQ][K][C] dx, then x0
  float* gv = xs + kBQ * K * C;                     // [kBQ][C2] dout * leaky'(pre1 at j*)
  int* js = reinterpret_cast<int*>(gv + kBQ * C2);  // [kBQ][C2] j*
  const int tid = threadIdx.x;
  float* pb = partial + static_cast<size_t>(blockIdx.x) * (static_cast<size_t>(C) * C2 + C2);
  const int ngroups = (BN + kBQ - 1) / kBQ;
  for (int u = blockIdx.x; u < ngroups; u += gridDim.x) {
    const int q0 = u * kBQ, nq = min(kBQ, BN - q0);
    const bool first = u == static_cast<int>(blockIdx.x);
    __syncthreads();                  // the last group's readers are done
    for (int e = tid; e < nq * C2; e += kBWThreads) {
      const size_t o = static_cast<size_t>(q0) * C2 + e;
      gv[e] = out[o] >= 0.f ? dout[o] : 0.1f * dout[o];
      js[e] = static_cast<int>(amax[o]);
    }
    for (int e = tid; e < nq * K * C; e += kBWThreads) xs[e] = 0.f;
    __syncthreads();
    // dx: each output channel's gradient lands on its one row j*, c2 ascending
    for (int c = tid; c < C; c += kBWThreads) {
      int c2 = 0;
      for (; c2 + 8 <= C2; c2 += 8) {     // 8 of W's entries in flight, then their chains
        float wv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) wv[e] = __ldg(wt + static_cast<size_t>(c2 + e) * C + c);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          for (int q = 0; q < nq; ++q) {
            float* t = xs + (q * K + js[q * C2 + c2 + e]) * C + c;
            *t = fmaf(gv[q * C2 + c2 + e], wv[e], *t);
          }
      }
      for (; c2 < C2; ++c2) {
        const float wv = __ldg(wt + static_cast<size_t>(c2) * C + c);
        for (int q = 0; q < nq; ++q) {
          float* t = xs + (q * K + js[q * C2 + c2]) * C + c;
          *t = fmaf(gv[q * C2 + c2], wv, *t);
        }
      }
      for (int q = 0; q < nq; ++q) {
        const int n = q0 + q;
        const int* iq = idx + static_cast<size_t>(n) * K;
        const float* tb = tab + static_cast<size_t>(n / N) * M * C + c;
        const float bb = base[static_cast<size_t>(n) * C + c];
        float* dr = d_rows + static_cast<size_t>(n) * K * C + c;
        float* xq = xs + q * K * C + c;
        float s = 0.f;
        for (int j = 0; j < K; ++j) {
          const float p = tb[static_cast<size_t>(iq[j]) * C] + bb;
          const float d = xq[j * C] * mocopci::dleaky(p);
          xq[j * C] = mocopci::leaky(p);
          dr[static_cast<size_t>(j) * C] = d;
          s += d;
        }
        d_base[static_cast<size_t>(n) * C + c] = s;
      }
    }
    __syncthreads();                  // x0 of the group is complete
    // dW[c, c2] (transposed: pb[c2 * C + c]) over the group's queries in order
    for (int c = tid; c < C; c += kBWThreads) {
      for (int c2 = 0; c2 < C2; ++c2) {
        float acc = first ? 0.f : pb[static_cast<size_t>(c2) * C + c];
        for (int q = 0; q < nq; ++q)
          acc = fmaf(xs[(q * K + js[q * C2 + c2]) * C + c], gv[q * C2 + c2], acc);
        pb[static_cast<size_t>(c2) * C + c] = acc;
      }
    }
    for (int c2 = tid; c2 < C2; c2 += kBWThreads) {
      float acc = first ? 0.f : pb[static_cast<size_t>(C) * C2 + c2];
      for (int q = 0; q < nq; ++q) acc += gv[q * C2 + c2];
      pb[static_cast<size_t>(C) * C2 + c2] = acc;
    }
  }
}

// dwb = [dW (C, C2) | db (C2)] = the sum of the nblk partials in block order,
// each partial [dW transposed (C2, C) | db (C2)]
__global__ void __launch_bounds__(256) cross_tail_bwd_wide_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dwb, int nblk, int C, int C2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;   // e = c2 * C + c, then db
  const size_t E = static_cast<size_t>(C) * C2 + C2;
  if (e >= static_cast<int>(E)) return;
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b) acc += partial[static_cast<size_t>(b) * E + e];
  if (e < C * C2) {
    const int c2 = e / C, c = e - c2 * C;
    dwb[static_cast<size_t>(c) * C2 + c2] = acc;
  } else {
    dwb[e] = acc;
  }
}

template <typename IdxT>
cudaError_t run_bwd_wide(const float* tab, const int* idx, const float* base, const float* w,
                         const float* out, const void* amax, const float* dout, float* d_rows,
                         float* d_base, float* dwb, float* work, int B, int M, int N, int K,
                         int C, int C2, int nblk, cudaStream_t st) {
  const size_t smem = bwd_wide_smem_floats(K, C, C2) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = mocopci::allow_smem(cross_tail_bwd_wide_kernel<IdxT>, smem);
  if (err != cudaSuccess) return err;
  float* wt = work;
  float* partial = work + static_cast<size_t>(C) * C2;
  cross_tail_bwd_wide_transpose_kernel<<<mocopci::ceil_div(C * C2, 256), 256, 0, st>>>(w, wt, C,
                                                                                        C2);
  MOCOPCI_CHECK_LAUNCH();
  cross_tail_bwd_wide_kernel<IdxT><<<nblk, kBWThreads, smem, st>>>(
      tab, idx, base, wt, out, static_cast<const IdxT*>(amax), dout, d_rows, d_base, partial,
      B * N, M, N, K, C, C2);
  MOCOPCI_CHECK_LAUNCH();
  cross_tail_bwd_wide_reduce_kernel<<<mocopci::ceil_div(C * C2 + C2, 256), 256, 0, st>>>(
      partial, dwb, nblk, C, C2);
  return cudaGetLastError();
}

template <typename IdxT, bool kArg>
cudaError_t run_fwd(const float* tab, const int* idx, const float* base, const float* w,
                    const float* b, float* out, void* amax, int B, int M, int N, int K, int C,
                    int C2, int nblk, cudaStream_t st) {
  const size_t smem = fwd_smem_floats(K, C, C2) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(cross_tail_kernel<IdxT, kArg>, smem);
  if (err != cudaSuccess) return err;
  cross_tail_kernel<IdxT, kArg><<<nblk, kFThreads, smem, st>>>(
      tab, idx, base, w, b, out, static_cast<IdxT*>(amax), B * N, M, N, K, C, C2);
  return cudaGetLastError();
}

template <typename IdxT, bool kArg>
cudaError_t run_wide(const float* tab, const int* idx, const float* base, const float* w,
                     const float* b, float* out, void* amax, int B, int M, int N, int K, int C,
                     int C2, int nblk, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(wide_cp(C)) * fwd_kp(K) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = mocopci::allow_smem(cross_tail_wide_kernel<IdxT, kArg>, smem);
  if (err != cudaSuccess) return err;
  cross_tail_wide_kernel<IdxT, kArg><<<nblk, kWThreads, smem, st>>>(
      tab, idx, base, w, b, out, static_cast<IdxT*>(amax), B * N, M, N, K, C, C2);
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
// the first j at each max, written unless null.  nblk blocks walk the units
// of fwd_tile(K) queries.
MOCOPCI_API int mocopci_cross_tail(const float* tab, const int* idx, const float* base,
                                   const float* w, const float* b, float* out, void* amax,
                                   int B, int M, int N, int K, int C, int C2, int nblk,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (amax == nullptr)
    return run_fwd<int, false>(tab, idx, base, w, b, out, amax, B, M, N, K, C, C2, nblk, st);
  if (K <= 255)
    return run_fwd<uint8_t, true>(tab, idx, base, w, b, out, amax, B, M, N, K, C, C2, nblk, st);
  return run_fwd<int, true>(tab, idx, base, w, b, out, amax, B, M, N, K, C, C2, nblk, st);
}

// As mocopci_cross_tail on the wide route: nblk blocks walk the queries, x
// of K rows (padded to 8) by C (padded to 4) in shared memory.
MOCOPCI_API int mocopci_cross_tail_wide(const float* tab, const int* idx, const float* base,
                                        const float* w, const float* b, float* out, void* amax,
                                        int B, int M, int N, int K, int C, int C2, int nblk,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (amax == nullptr)
    return run_wide<int, false>(tab, idx, base, w, b, out, amax, B, M, N, K, C, C2, nblk, st);
  if (K <= 255)
    return run_wide<uint8_t, true>(tab, idx, base, w, b, out, amax, B, M, N, K, C, C2, nblk,
                                   st);
  return run_wide<int, true>(tab, idx, base, w, b, out, amax, B, M, N, K, C, C2, nblk, st);
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

// The backward's wide route (C = C2 = 256 at cross3 of a 32768-point cloud):
// the same outputs as mocopci_cross_tail_bwd, d_rows and d_base bit for bit.
// work: C * C2 + nblk * (C * C2 + C2) floats of scratch (W transposed, then
// the block partials); nblk blocks walk groups of 4 queries (at most
// ceil(B * N / 4) blocks, so that each writes its partial), reduced in
// block order.
MOCOPCI_API int mocopci_cross_tail_bwd_wide(const float* tab, const int* idx, const float* base,
                                            const float* w, const float* out, const void* amax,
                                            const float* dout, float* d_rows, float* d_base,
                                            float* dwb, float* work, int B, int M, int N, int K,
                                            int C, int C2, int nblk, void* stream) {
  if (nblk < 1 || nblk > mocopci::ceil_div(B * N, kBQ)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return K <= 255 ? run_bwd_wide<uint8_t>(tab, idx, base, w, out, amax, dout, d_rows, d_base,
                                          dwb, work, B, M, N, K, C, C2, nblk, st)
                  : run_bwd_wide<int>(tab, idx, base, w, out, amax, dout, d_rows, d_base, dwb,
                                      work, B, M, N, K, C, C2, nblk, st);
}
