// Exact k-nearest neighbours.
//
// Replaces mocopci_tpu/ops/pallas/knn.py: exact_knn_pallas (:350, pallas_call
// in _exact_knn_call :424), Euclidean and cosine metric.  Result: the k
// smallest (distance, index) pairs in ascending lexicographic order, i.e. ties
// go to the lowest index, as lax.top_k and the Pallas exact kernel give.
//
// Distances: Euclidean with C <= 8 is the direct sum of squared differences
// (as knn.py:_dist_tile does for xyz), accumulated in channel order with
// round-to-nearest intrinsics and no FMA, bit-identical to the plain twin;
// otherwise the dot form, (-2 q.r + |q|^2) + |r|^2 for Euclidean and
// 1 - q.r for cosine, on rows the caller has already normalised.
//
// Bound on the H100: operations.  Every query scans all M reference rows
// (N*M*C multiply-adds plus one compare each); the bytes are small (the
// reference cloud is re-read from shared memory, not from HBM).
//
// Euclidean, C <= 8 (knn_exact_xyz_kernel): a threshold, then one filtered
// scan.  The reference is staged once a block as coordinate planes
// (knn_planes.cuh: the whole cloud when it fits in 96 KB, else chunks, one
// group of queries a block) and the block walks groups of 16 queries, 2 a
// warp (8, 1 a warp, on small grids), as knn_approx.cu does.
//   1. Bins: lane l keeps, for each query, the least distance (its bits, an
//      int whose order is the float's for d >= 0) of the columns c = l + 32 t
//      mod 256, t < 8: 256 bins.  A min is order-free and each bin has one
//      owner.  (knn_approx packs the column into a key's low bits; here the
//      bins keep the whole distance, so the threshold below is exact.)
//   2. Threshold: any k distinct columns bound the k-th neighbour's distance
//      from above, so with tau the k-th least bin (rounds of a warp-wide min,
//      ties counted), every neighbour has d <= tau, and only a bin whose
//      least distance is <= tau can hold one.
//   3. Filtered scan: the warp lists those bins (about k of 256) and walks
//      their columns in every 256-column tile, lanes over (tile, bin) items;
//      each column with bits(d) <= tau goes to the query's candidates in
//      shared memory (kCap of them; an atomic slot, the order irrelevant).
//   4. Output: each candidate's rank among the query's candidates by (d,
//      index) is counted and the first k written.
//   5. Overflow: a query with more than kCap candidates (many points at one
//      distance, say duplicates) takes the declared overflow route in the
//      same kernel: the filtered scan's columns again, each lane keeping a
//      sorted list of the k least (distance, index) of its own, and k rounds
//      of warp-wide mins merge the 32 lists.  Each such query adds one to
//      the caller's counter.
// About 10 instructions a pair for the bins and a fraction of that for the
// filtered scan, and no sorted list a query, whose insertion chains (about
// k (1 + ln(M / k)) of ~200 dependent instructions) stall a whole warp.
//
// Wider or cosine rows (knn_dot_kernel): reference rows are staged through
// shared memory in tiles that every thread of the block reads as broadcasts;
// each thread keeps its sorted k-list in registers (fully unrolled insertion,
// KMAX in {4,8,16,32}), and since the scan visits indices in ascending order a
// candidate enters the list only if it is strictly closer than the current
// k-th.  The (N, M) distance matrix is never written.  A block is 64 queries,
// so the reference is split into up to 16 spans, a block each, until the
// grid fills the card, and a second kernel merges each query's split lists
// (knn_merge_kernel); each pair's distance is the same whatever the split,
// so the result is too.
#include "knn_planes.cuh"

namespace {

template <int KMAX>
struct TopK {
  float d[KMAX];
  int i[KMAX];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      d[p] = __int_as_float(0x7f800000);  // +inf
      i[p] = INT_MAX;
    }
  }

  // ``ci`` is larger than every index held, so an equal distance loses.
  __device__ __forceinline__ void push(float cd, int ci) {
    if (!(cd < d[KMAX - 1])) return;
    insert(cd, ci);
  }

  // any (cd, ci), in any order of indices
  __device__ __forceinline__ void push_any(float cd, int ci) {
    if (!mocopci::lex_less(cd, ci, d[KMAX - 1], i[KMAX - 1])) return;
    insert(cd, ci);
  }

  __device__ __forceinline__ void insert(float cd, int ci) {
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (mocopci::lex_less(cd, ci, d[p], i[p])) {
        const float td = d[p];
        const int ti = i[p];
        d[p] = cd;
        i[p] = ci;
        cd = td;
        ci = ti;
      }
    }
  }

  // the head removed (every entry moves up one); the lists stay sorted
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int p = 0; p + 1 < KMAX; ++p) {
      d[p] = d[p + 1];
      i[p] = i[p + 1];
    }
    d[KMAX - 1] = __int_as_float(0x7f800000);
    i[KMAX - 1] = INT_MAX;
  }
};

// ---- Euclidean, C <= CC <= 8: bins, a threshold, one filtered scan ----
constexpr int kBinNT = 8;                 // bins a lane a query
constexpr int kBinTile = 32 * kBinNT;     // bin b holds the columns c = b mod 256
constexpr int kCap = 64;                  // candidates a query keeps for its sort
constexpr int kMaxK = 32;

// The k-th least of the warp's bins, counted with multiplicity (equal
// distances may sit in several bins): rounds of a warp-wide min, each
// removing every bin that holds it.
__device__ __forceinline__ int kth_least(int (&bins)[kBinNT], int k) {
  for (int left = k;;) {
    int cur = kInf;
#pragma unroll
    for (int t = 0; t < kBinNT; ++t) cur = min(cur, bins[t]);
    const int m = __reduce_min_sync(kFull, cur);
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < kBinNT; ++t) {
      cnt += bins[t] == m;
      bins[t] = bins[t] == m ? kInf : bins[t];
    }
    left -= static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(cnt)));
    if (left <= 0) return m;
  }
}

// out[rank] = index for the candidates of rank < k by (distance bits, index)
__device__ __forceinline__ void rank_out(const uint2* cq, int c, int k, int lane, int* o) {
  for (int e = lane; e < c; e += 32) {
    const uint2 me = cq[e];
    int rank = 0;
    for (int m = 0; m < c; ++m) {
      const uint2 x = cq[m];
      rank += x.x < me.x || (x.x == me.x && x.y < me.y);
    }
    if (rank < k) o[rank] = static_cast<int>(me.y);
  }
}

// The k least of the warp's 32 sorted lists, ascending by (distance, index).
__device__ __forceinline__ void merge_lists(TopK<kMaxK>& top, int k, int lane, int* o) {
  for (int i = 0; i < k; ++i) {
    const unsigned hd = __float_as_uint(top.d[0]);
    const unsigned md = __reduce_min_sync(kFull, hd);
    const int mi = __reduce_min_sync(kFull, hd == md ? top.i[0] : INT_MAX);
    if (lane == 0) o[i] = mi;
    if (hd == md && top.i[0] == mi) top.pop();
  }
}

template <int CC, int QW>
__global__ void __launch_bounds__(kXThreads, 2) knn_exact_xyz_kernel(
    const float* __restrict__ q, const float* __restrict__ r, int N, int M, int C, int k,
    int chunk, int* __restrict__ out, int* __restrict__ overflow) {
  constexpr int kGroup = kXWarps * QW;     // queries a group
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                                                   // [CC][chunk] planes
  uint2* cand = reinterpret_cast<uint2*>(rs + CC * chunk);          // [kGroup][kCap]
  int* ncand = reinterpret_cast<int*>(cand + kGroup * kCap);        // [kGroup]
  unsigned char* blist = reinterpret_cast<unsigned char*>(ncand + kGroup);   // [kGroup][256]
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nchunks = (M + chunk - 1) / chunk;
  const int ngroups = (N + kGroup - 1) / kGroup;
  const float* rb = r + static_cast<size_t>(b) * M * C;
  // each chunk staged (by the whole block where the reference streams), then
  // fn(base, cnt) on it
  auto chunks = [&](auto&& fn) {
    for (int ch = 0; ch < nchunks; ++ch) {
      const int base = ch * chunk;
      if (nchunks > 1) {
        __syncthreads();
        stage_planes(rb, base, M, C, chunk, rs);
        __syncthreads();
      }
      fn(base, min(chunk, M - base));
    }
  };
  if (nchunks == 1) {
    stage_planes(rb, 0, M, C, chunk, rs);
    __syncthreads();
  }
  // groups blockIdx.x, + gridDim.x, ...: one a block when the reference streams
  for (int grp = blockIdx.x; grp < ngroups; grp += gridDim.x) {
    int n[QW];
    float qv[QW][CC];
    int bins[QW][kBinNT];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      n[qi] = grp * kGroup + warp * QW + qi;
#pragma unroll
      for (int c = 0; c < CC; ++c)
        qv[qi][c] = (n[qi] < N && c < C) ? q[(static_cast<size_t>(b) * N + n[qi]) * C + c] : 0.f;
#pragma unroll
      for (int t = 0; t < kBinNT; ++t) bins[qi][t] = kInf;
    }
    // 1. the bins
    chunks([&](int base, int cnt) {
      scan_chunk<kBinNT, CC, QW>(rs, chunk, C, cnt, kBinTile, base, lane, qv,
                                 [&](int qi, int t, float d, int) {
                                   bins[qi][t] = min(bins[qi][t], __float_as_int(d));
                                 });
    });
    // 2. the threshold and the bins that may hold a column within it, listed
    // in (t, lane) order
    int tau[QW], nb[QW];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int slot = warp * QW + qi;
      int copy[kBinNT];
#pragma unroll
      for (int t = 0; t < kBinNT; ++t) copy[t] = bins[qi][t];
      tau[qi] = n[qi] < N ? kth_least(copy, k) : -1;
      nb[qi] = 0;
#pragma unroll
      for (int t = 0; t < kBinNT; ++t) {
        const bool in = bins[qi][t] <= tau[qi];
        const unsigned bal = __ballot_sync(kFull, in);
        if (in) blist[slot * kBinTile + nb[qi] + __popc(bal & ((1u << lane) - 1))] = lane + 32 * t;
        nb[qi] += __popc(bal);
      }
      if (lane == 0) ncand[slot] = 0;
    }
    __syncwarp();
    // the listed bins' columns of a chunk of cnt staged columns: item
    // e = s * nb + i is tile s, listed bin i; lane l takes items l, l + 32,
    // ...; fn(d, col) for each column within the query's threshold
    auto listed = [&](int qi, int base, int cnt, auto&& fn) {
      const int m = nb[qi], ntile = (cnt + kBinTile - 1) / kBinTile;
      if (m == 0) return;
      const unsigned char* bl = blist + (warp * QW + qi) * kBinTile;
      const int ds = 32 / m, di = 32 - ds * m;
      for (int s = lane / m, i = lane - s * m; s < ntile;) {
        const int col = s * kBinTile + bl[i];
        if (col < cnt) {
          float rc[CC];
          staged_row(rs + col, chunk, C, rc);
          const float d = sq_dist(qv[qi], rc, C);
          if (__float_as_int(d) <= tau[qi]) fn(d, base + col);
        }
        s += ds;
        i += di;
        if (i >= m) {
          i -= m;
          ++s;
        }
      }
    };
    // 3. the filtered scan: each column within the threshold to the
    // query's candidates
    chunks([&](int base, int cnt) {
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        const int slot = warp * QW + qi;
        listed(qi, base, cnt, [&](float d, int col) {
          const int e = atomicAdd(ncand + slot, 1);
          if (e < kCap) cand[slot * kCap + e] = make_uint2(__float_as_uint(d), col);
        });
      }
    });
    __syncwarp();
    // 4. the output, by rank among the candidates
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int slot = warp * QW + qi, c = ncand[slot];
      if (n[qi] < N && c <= kCap)
        rank_out(cand + slot * kCap, c, k, lane, out + (static_cast<size_t>(b) * N + n[qi]) * k);
    }
    // 5. the overflow route, for each query that kept more than kCap
    // candidates: the same columns into a sorted list a lane, then merged.
    // A warp takes it alone on a staged cloud; a streamed one is staged by
    // the whole block, so there every warp walks the chunks again.
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const bool mine = n[qi] < N && ncand[warp * QW + qi] > kCap;
      if (!(nchunks > 1 ? __syncthreads_or(mine) : mine)) continue;
      TopK<kMaxK> top;
      top.init();
      chunks([&](int base, int cnt) {
        if (mine) listed(qi, base, cnt, [&](float d, int col) { top.push_any(d, col); });
      });
      if (mine) {
        merge_lists(top, k, lane, out + (static_cast<size_t>(b) * N + n[qi]) * k);
        if (lane == 0) atomicAdd(overflow, 1);
      }
    }
  }
}

constexpr int kDotQ = 64;   // queries (threads) per block
constexpr int kDotR = 32;   // reference rows per tile
constexpr int kMaxSplits = 16;

// Dot form for wide rows: metric 0 = Euclidean, 1 = cosine (pre-normalised).
// Split blockIdx.z scans rows [z span, (z + 1) span); with one split the
// indices go to out, with more each thread's sorted list, (distance bits,
// index) pairs, to part[(b, n, z)][k] for knn_merge_kernel.
template <int KMAX>
__global__ void __launch_bounds__(kDotQ) knn_dot_kernel(
    const float* __restrict__ q, const float* __restrict__ r, int N, int M, int C, int k,
    int metric, int span, int* __restrict__ out, uint2* __restrict__ part) {
  extern __shared__ float sm[];
  float* qs = sm;                  // [C][kDotQ], transposed: conflict-free reads
  float* rs = qs + C * kDotQ;      // [kDotR][C]
  float* rn = rs + kDotR * C;      // [kDotR]
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kDotQ;
  const int n = n0 + tid;
  const float* qb = q + static_cast<size_t>(b) * N * C;
  for (int e = tid; e < kDotQ * C; e += kDotQ) {
    const int row = e / C, c = e - row * C;
    qs[c * kDotQ + row] = (n0 + row < N) ? qb[static_cast<size_t>(n0 + row) * C + c] : 0.f;
  }
  __syncthreads();
  float qn = 0.f;
  for (int c = 0; c < C; ++c) qn += qs[c * kDotQ + tid] * qs[c * kDotQ + tid];
  TopK<KMAX> top;
  top.init();
  const float* rb = r + static_cast<size_t>(b) * M * C;
  const int m1 = min(M, static_cast<int>(blockIdx.z + 1) * span);
  for (int base = blockIdx.z * span; base < m1; base += kDotR) {
    const int cnt = min(kDotR, m1 - base);
    __syncthreads();
    for (int e = tid; e < cnt * C; e += kDotQ) rs[e] = rb[static_cast<size_t>(base) * C + e];
    __syncthreads();
    if (tid < cnt) {
      float s = 0.f;
      for (int c = 0; c < C; ++c) s += rs[tid * C + c] * rs[tid * C + c];
      rn[tid] = s;
    }
    __syncthreads();
    float acc[kDotR];
#pragma unroll
    for (int j = 0; j < kDotR; ++j) acc[j] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float qc = qs[c * kDotQ + tid];
#pragma unroll
      for (int j = 0; j < kDotR; ++j) acc[j] = fmaf(qc, rs[j * C + c], acc[j]);
    }
    if (n < N) {
#pragma unroll
      for (int j = 0; j < kDotR; ++j) {
        if (j < cnt) {
          const float d = metric == 0 ? __fadd_rn(__fadd_rn(-2.f * acc[j], qn), rn[j])
                                      : __fsub_rn(1.f, acc[j]);
          top.push(d, base + j);
        }
      }
    }
  }
  if (n < N && gridDim.z == 1) {
    int* o = out + (static_cast<size_t>(b) * N + n) * k;
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p < k) o[p] = top.i[p];  // static index: the list stays in registers
    }
  } else if (n < N) {
    uint2* o = part + ((static_cast<size_t>(b) * N + n) * gridDim.z + blockIdx.z) * k;
#pragma unroll
    for (int p = 0; p < KMAX; ++p)
      if (p < k) o[p] = make_uint2(__float_as_uint(top.d[p]), static_cast<unsigned>(top.i[p]));
  }
}

// The k least (distance, index) of each query's S sorted split lists, a
// thread a query.
__global__ void __launch_bounds__(128) knn_merge_kernel(const uint2* __restrict__ part, int S,
                                                        int k, int BN, int* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BN) return;
  const uint2* p = part + static_cast<size_t>(t) * S * k;
  int head[kMaxSplits];
  for (int s = 0; s < S; ++s) head[s] = 0;
  for (int o = 0; o < k; ++o) {
    int best = 0, bi = INT_MAX;
    float bd = __int_as_float(0x7f800000);
    for (int s = 0; s < S; ++s) {
      if (head[s] >= k) continue;
      const uint2 e = p[s * k + head[s]];
      const float d = __uint_as_float(e.x);
      const int i = static_cast<int>(e.y);
      if (mocopci::lex_less(d, i, bd, bi)) {
        best = s;
        bd = d;
        bi = i;
      }
    }
    out[static_cast<size_t>(t) * k + o] = bi;
    ++head[best];
  }
}

template <int CC, int QW>
cudaError_t run_xyz(const float* q, const float* r, int B, int N, int M, int C, int k, int chunk,
                    int gx, int* out, int* overflow, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(CC) * chunk * sizeof(float) +
                      kXWarps * QW * (kCap * sizeof(uint2) + sizeof(int) + kBinTile);
  if (chunk < kBinTile || chunk % kBinTile != 0 || CC * chunk * sizeof(float) > kXPlaneBytes)
    return cudaErrorInvalidValue;
  cudaError_t err = mocopci::allow_smem(knn_exact_xyz_kernel<CC, QW>, smem);
  if (err != cudaSuccess) return err;
  knn_exact_xyz_kernel<CC, QW><<<dim3(gx, B), kXThreads, smem, st>>>(q, r, N, M, C, k, chunk,
                                                                    out, overflow);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t run_dot(const float* q, const float* r, int B, int N, int M, int C, int k,
                    int metric, int span, int splits, int* out, uint2* part, cudaStream_t st) {
  if (splits < 1 || splits > kMaxSplits || span < 1 ||
      static_cast<long long>(span) * splits < M || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(C) * (kDotQ + kDotR) + kDotR) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(knn_dot_kernel<KMAX>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mocopci::ceil_div(N, kDotQ), B, splits);
  knn_dot_kernel<KMAX><<<grid, kDotQ, smem, st>>>(q, r, N, M, C, k, metric, span, out, part);
  if (splits == 1) return cudaGetLastError();
  MOCOPCI_CHECK_LAUNCH();
  knn_merge_kernel<<<mocopci::ceil_div(B * N, 128), 128, 0, st>>>(part, splits, k, B * N, out);
  return cudaGetLastError();
}

}  // namespace

// query (B, N, C), ref (B, M, C) f32 -> out (B, N, k) int32.
// metric 0 = Euclidean, 1 = cosine on pre-normalised rows.  k <= 32, C <= 512.
// Euclidean rows of at most 8 channels take the filtered scan: its grid is gx
// x B blocks, each staging chunk reference rows (a multiple of 256, C x chunk
// floats within 96 KB) and walking groups of 8 qw queries, qw (1 or 2) a warp
// (gx groups apart; one group a block when chunk < M); overflow (one int on
// the device) counts the queries that took the overflow route.  Other rows
// take the dot form over gx <= 16 splits of chunk reference rows each, with
// part (B * N * gx * k pairs of ints) for the split lists where gx > 1; qw
// and overflow are not read.
MOCOPCI_API int mocopci_knn(const float* q, const float* r, int B, int N, int M, int C,
                            int k, int metric, int chunk, int gx, int qw, int* out,
                            void* part, int* overflow, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxK || k > M || C < 1 || C > 512) return cudaErrorInvalidValue;
  if (metric == 0 && C <= 8) {
    if (gx < 1 || (qw != 1 && qw != 2)) return cudaErrorInvalidValue;
    if (qw == 2)
      return C == 3 ? run_xyz<3, 2>(q, r, B, N, M, C, k, chunk, gx, out, overflow, st)
                    : run_xyz<8, 2>(q, r, B, N, M, C, k, chunk, gx, out, overflow, st);
    return C == 3 ? run_xyz<3, 1>(q, r, B, N, M, C, k, chunk, gx, out, overflow, st)
                  : run_xyz<8, 1>(q, r, B, N, M, C, k, chunk, gx, out, overflow, st);
  }
  uint2* pt = static_cast<uint2*>(part);
  if (k <= 4) return run_dot<4>(q, r, B, N, M, C, k, metric, chunk, gx, out, pt, st);
  if (k <= 8) return run_dot<8>(q, r, B, N, M, C, k, metric, chunk, gx, out, pt, st);
  if (k <= 16) return run_dot<16>(q, r, B, N, M, C, k, metric, chunk, gx, out, pt, st);
  return run_dot<32>(q, r, B, N, M, C, k, metric, chunk, gx, out, pt, st);
}
