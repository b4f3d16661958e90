// Deterministic scatter-add: out[g, n, c] = sum_s v[g, s, c] * 1[idx[g, s] == n],
// out-of-range and negative targets dropped, each sum taken in ascending
// source position s, so the same inputs give the same bits on every run (and
// the bits of the plain version's index_add_ on the CPU, which adds in that
// order).
//
// Replaces mocopci_tpu/ops/pallas/scatter_bucket.py: bucket_scatter_add_planes
// (:112, pallas_call :133) and its row wrapper bucket_scatter_add (:151).  The
// TPU kernel turns the scatter into radix one-hot matmuls on the MXU; on Hopper
// a counting sort of the targets does the same job without the O(S*N/128)
// one-hot work.
//
// Bound on the H100: bytes (the values read once, the sums written once; a
// few integer passes over the (G, S) targets beside them).  What the design
// pays beyond that: one scattered 4-byte store per source (the fill), one
// scattered gather per value, a fixed cost per launch that dominates the
// small calls, and, since each sum runs in order, one dependent add per
// source of the longest bucket: a kNN table or a Chamfer VJP on real clouds
// sends thousands of sources to a few rows.  Every bucket is summed the same
// way (team_sum_sorted): a team of threads (a warp, 128 threads or a block)
// gathers a chunk of the sorted entries' values into shared rows, all loads
// in flight together, then a thread per channel adds down them in order.
// Two routes, chosen by the sizes:
//   small  (at most kSmallS sources a group, fewer than kSparse a row on
//          average, C <= kCh; a Chamfer VJP) one launch: a block takes
//          kSmallRows rows of a group, counts the sources that target them,
//          scans the counts and fills its buckets in shared memory; a thread
//          sorts a bucket of up to 32 entries (insertion) and sums it, a
//          team of 128 threads each longer one (sorted as in the big pass).
//   counting sort (every other shape) a memset of the counts and five
//          launches:
//   1. count   targets per row: a block counts a chunk of sources in a
//              shared-memory histogram and adds it to the global counts
//              (int atomics: exact whatever the order), or, where the rows
//              outnumber half a chunk or the histogram would not fit, adds
//              each source to the global counts;
//   2. scan    the counts into bucket offsets (one block per group);
//   3. fill    each bucket with its sources: a block reserves a range of each
//              bucket for its chunk (the counts, counted back down to 0, are
//              the cursor) and writes its sources' positions there, in any
//              order within a bucket;
//   4. bucket  one warp per target row of up to 256 sources: the warp sorts
//              the bucket's positions in registers (a bitonic network over
//              shuffles, 1, 2, 4 or 8 entries per lane) into shared memory
//              and sums it in that order, i.e. in ascending s.  A longer
//              bucket is left to:
//   5. big     a block per long bucket: the bucket sorted by the block in
//              shared memory (a bitonic network with every comparator
//              ascending, so the padding to a power of two never moves; in
//              place in the list beyond 4096 entries) and summed.
// No entry reads its bucket.  Values are read as rows (G, S, C) or planes
// (G, C, S).  Every kernel's name starts with scatter_add_.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // the bucket pass: a warp a row
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kBlock = 1024;        // the count, scan, fill and small passes
constexpr int kHistChunk = 16384;   // sources per block of the count and fill
constexpr int kHistBins = 16384;    // rows a shared-memory histogram holds (64 KB)
constexpr int kPer = kHistChunk / kBlock;   // sources per thread of the fill
constexpr int kJ = 8;               // bucket entries per lane held in registers
constexpr int kSpan = 32 * kJ;      // entries sorted in registers
constexpr int kCh = 4;              // channels at most on the small route
constexpr int kWarpRows = 1024;     // values a warp of the bucket pass gathers at a time
constexpr int kBatch = 8;           // values a thread loads before storing them
constexpr int kSmallS = 16384;      // sources a group at most on the small route
constexpr int kSmallRows = 2048;    // rows a block of the small route
constexpr int kSparse = 4;          // the small route below 4 sources a row on average
constexpr int kLaneMax = 32;        // a thread's bucket at most there; longer take a team
constexpr int kSmallTeams = 8;      // teams of a block there, a long bucket each
constexpr int kSmallRowsBuf = 4096; // values the teams gather at a time there
constexpr int kBigThreads = 256;    // the big pass: a block a long bucket
constexpr int kBigKeys = 4096;      // a bucket of the big pass sorted in shared memory
constexpr int kBigRows = 4096;      // values gathered at a time by its sum
constexpr int kBigGrid = 1024;      // blocks of the big pass

__device__ __forceinline__ bool valid(int t, int N) { return t >= 0 && t < N; }

__host__ __device__ inline bool small_route(int S, int C, int N) {
  return S <= kSmallS && C <= kCh && S < kSparse * N;
}

// The count and the fill keep a block's histogram of the N rows in shared
// memory when it fits and a block's chunk of sources outnumbers the rows
// twice (else zeroing and flushing N bins would outweigh the chunk).
__host__ __device__ inline bool use_hist(int S, int N) {
  return N <= kHistBins && (S < kHistChunk ? S : kHistChunk) >= 2 * N;
}

// sources per block of the count and the fill: a histogram's chunk, or one
// per thread where the atomics go to global memory
__host__ __device__ inline int chunk_of(int S, int N) {
  return use_hist(S, N) ? kHistChunk : kBlock;
}

// o[0..N] = exclusive prefix sums of c[0..N) (global or shared memory, not
// the same array) by a block of kBlock threads: each thread sums a run of c,
// the runs are scanned by warp shuffles and then across the warps' totals.
__device__ void block_scan(const int* c, int* o, int N, int* warp_sum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (N + kBlock - 1) / kBlock;
  const int lo = min(tid * per, N), hi = min(lo + per, N);
  int sum = 0;
  for (int n = lo; n < hi; ++n) sum += c[n];
  int incl = sum;                                   // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += up;
    }
    warp_sum[lane] = w;                             // inclusive over the warps
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int n = lo; n < hi; ++n) {
    o[n] = run;
    run += c[n];
  }
  if (tid == kBlock - 1) o[N] = run;
}

// A block counts its chunk of sources into a shared histogram (when N rows
// fit) and adds the nonzero bins to counts[g, :].
__global__ void __launch_bounds__(kBlock) scatter_add_count_kernel(
    const int* __restrict__ idx, int* __restrict__ counts, int S, int N) {
  extern __shared__ int hist[];
  const int g = blockIdx.y;
  const bool local = use_hist(S, N);
  const int chunk = chunk_of(S, N);
  const int s0 = blockIdx.x * chunk, s1 = min(s0 + chunk, S);
  const int* ig = idx + static_cast<size_t>(g) * S;
  int* cg = counts + static_cast<size_t>(g) * N;
  if (local) {
    for (int i = threadIdx.x; i < N; i += kBlock) hist[i] = 0;
    __syncthreads();
  }
  for (int s = s0 + threadIdx.x; s < s1; s += kBlock) {
    const int t = ig[s];
    if (!valid(t, N)) continue;
    if (local)
      atomicAdd(&hist[t], 1);
    else
      atomicAdd(&cg[t], 1);
  }
  if (!local) return;
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += kBlock)
    if (hist[i]) atomicAdd(&cg[i], hist[i]);
}

// offsets[g, 0..N] = exclusive prefix sums of counts[g, :]
__global__ void __launch_bounds__(kBlock) scatter_add_scan_kernel(
    const int* __restrict__ counts, int* __restrict__ offsets, int N) {
  __shared__ int warp_sum[kBlock / 32];
  const int g = blockIdx.x;
  block_scan(counts + static_cast<size_t>(g) * N, offsets + static_cast<size_t>(g) * (N + 1),
             N, warp_sum);
}

// counts[g, t] runs back down to 0 as the buckets fill: a block takes the
// range [counts - h, counts) of bucket t for the h sources of its chunk and
// writes their positions s there.
__global__ void __launch_bounds__(kBlock) scatter_add_fill_kernel(
    const int* __restrict__ idx, const int* __restrict__ offsets, int* __restrict__ counts,
    int* __restrict__ list, int S, int N) {
  extern __shared__ int cursor[];
  const int g = blockIdx.y;
  const bool local = use_hist(S, N);
  const int chunk = chunk_of(S, N);
  const int s0 = blockIdx.x * chunk, s1 = min(s0 + chunk, S);
  const int* ig = idx + static_cast<size_t>(g) * S;
  const int* og = offsets + static_cast<size_t>(g) * (N + 1);
  int* cg = counts + static_cast<size_t>(g) * N;
  int* lg = list + static_cast<size_t>(g) * S;
  int tv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = s0 + i * kBlock + threadIdx.x;
    tv[i] = s < s1 ? ig[s] : -1;
  }
  if (local) {
    for (int i = threadIdx.x; i < N; i += kBlock) cursor[i] = 0;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (valid(tv[i], N)) atomicAdd(&cursor[tv[i]], 1);
    __syncthreads();
#pragma unroll 8
    for (int i = threadIdx.x; i < N; i += kBlock) {
      const int h = cursor[i];
      if (h) cursor[i] = og[i] + atomicSub(&cg[i], h) - h;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = tv[i];
    if (!valid(t, N)) continue;
    const int slot = local ? atomicAdd(&cursor[t], 1) : og[t] + atomicSub(&cg[t], 1) - 1;
    lg[slot] = s0 + i * kBlock + threadIdx.x;
  }
}

// Ascending bitonic sort of 32 * J keys, element e = j * 32 + lane in k[j]:
// strides below 32 pair lanes (shuffles), larger ones registers of a lane.
template <int J>
__device__ __forceinline__ void sort_keys(int (&k)[J]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * J; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int bit = stride >> 5;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (j & bit) continue;
          const bool up = ((j * 32) & size) == 0;
          const int a = k[j], b = k[j | bit];
          k[j] = up ? min(a, b) : max(a, b);
          k[j | bit] = up ? max(a, b) : min(a, b);
        }
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int e = j * 32 + lane;
          const int other = __shfl_xor_sync(0xffffffffu, k[j], stride);
          const bool up = (e & size) == 0, lower = (e & stride) == 0;
          k[j] = lower == up ? min(k[j], other) : max(k[j], other);
        }
      }
    }
  }
}

// A team of n threads of a block (a warp, or several warps with a named
// barrier of their own); tid is the thread's index in the team.
struct Team {
  int tid, n, bar;
};

__device__ __forceinline__ void team_sync(const Team& t) {
  if (t.n == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(t.bar), "r"(t.n) : "memory");
}

// Ascending sort of a[0..L) (shared or global memory) in place by a team, a
// bitonic network whose comparators are all ascending (each merge starts with
// a flip), so elements past L act as +inf and are never touched.
__device__ void team_sort(const Team& t, int* a, int L) {
  int Lp = 1;
  while (Lp < L) Lp <<= 1;
  for (int size = 2; size <= Lp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t.tid; i < Lp / 2; i += t.n) {
        const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
        const int hi = stride == size >> 1 ? lo ^ (size - 1) : lo + stride;
        if (hi < L) {
          const int x = a[lo], y = a[hi];
          if (y < x) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      team_sync(t);
    }
  }
}

// o[c] = sum of v[pos[e], c] over e = 0..L-1 in order, by a team: chunks of
// entries are gathered into the team's shared rows (cap floats) by all its
// threads, then a thread per channel adds down them.
__device__ void team_sum_sorted(const Team& t, const int* pos, int L, const float* vg,
                                float* o, int S, int C, int planes, float* rows, int cap) {
  for (int c0 = 0; c0 < C; c0 += t.n) {
    const int Cp = min(C - c0, t.n);
    const int K = cap / Cp;                      // entries a chunk
    const int de = t.n / Cp, dc = t.n - de * Cp;  // a step of t.n values in (entry, channel)
    float acc = 0.f;
    for (int e0 = 0; e0 < L; e0 += K) {
      const int n = min(K, L - e0);
      int e = t.tid / Cp, c = t.tid - e * Cp;
      for (int i = t.tid; i < n * Cp; i += kBatch * t.n) {
        float val[kBatch];                       // all loads of a batch before its stores
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (i + u * t.n < n * Cp) {
            const size_t s = static_cast<size_t>(pos[e0 + e]);
            val[u] = planes ? vg[static_cast<size_t>(c0 + c) * S + s] : vg[s * C + c0 + c];
          }
          e += de;
          c += dc;
          if (c >= Cp) {
            c -= Cp;
            ++e;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (i + u * t.n < n * Cp) rows[i + u * t.n] = val[u];
      }
      team_sync(t);
      if (t.tid < Cp) {
#pragma unroll 8
        for (int e = 0; e < n; ++e) acc += rows[e * Cp + t.tid];
      }
      team_sync(t);
    }
    if (t.tid < Cp) o[c0 + t.tid] = acc;
  }
}

// A bucket of L <= 32 * J entries sorted by the warp in registers into
// keys[0..L).
template <int J>
__device__ __forceinline__ void sort_to_shared(const int* bucket, int L, int* keys) {
  const int lane = threadIdx.x & 31;
  int key[J];
#pragma unroll
  for (int j = 0; j < J; ++j) key[j] = j * 32 + lane < L ? bucket[j * 32 + lane] : INT_MAX;
  sort_keys<J>(key);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j * 32 + lane < L) keys[j * 32 + lane] = key[j];
  __syncwarp();
}

// One warp per target row n: its bucket sorted in registers into the warp's
// shared keys and summed by team_sum_sorted through its shared rows.  A
// bucket of more than kSpan entries is left to the big pass (its row
// appended to big[], in any order).
__global__ void __launch_bounds__(kThreads) scatter_add_bucket_kernel(
    const float* __restrict__ v, const int* __restrict__ offsets, const int* __restrict__ list,
    float* __restrict__ out, int* __restrict__ big, int* __restrict__ nbig, int S, int C,
    int N, int planes) {
  __shared__ int keys_all[kWarpsPerBlock][kSpan];
  __shared__ float rows_all[kWarpsPerBlock][kWarpRows];
  const int g = blockIdx.y, w = threadIdx.x >> 5;
  const int n = blockIdx.x * kWarpsPerBlock + w;
  if (n >= N) return;
  const int* og = offsets + static_cast<size_t>(g) * (N + 1);
  const int lo = og[n], L = og[n + 1] - lo;
  if (L > kSpan) {
    if ((threadIdx.x & 31) == 0) big[atomicAdd(nbig, 1)] = g * N + n;
    return;
  }
  const int* bucket = list + static_cast<size_t>(g) * S + lo;
  int* keys = keys_all[w];
  if (L <= 32)
    sort_to_shared<1>(bucket, L, keys);
  else if (L <= 64)
    sort_to_shared<2>(bucket, L, keys);
  else if (L <= 128)
    sort_to_shared<4>(bucket, L, keys);
  else
    sort_to_shared<kJ>(bucket, L, keys);
  const Team warp{static_cast<int>(threadIdx.x & 31), 32, 0};
  team_sum_sorted(warp, keys, L, v + static_cast<size_t>(g) * S * C,
                  out + (static_cast<size_t>(g) * N + n) * C, S, C, planes, rows_all[w],
                  kWarpRows);
}

// The big pass: a block per bucket of more than kSpan entries (the blocks
// take the rows of big[] in turn).  The bucket is copied to shared memory
// when it fits (else sorted where it lies), sorted by the block and summed by
// team_sum_sorted.
__global__ void __launch_bounds__(kBigThreads) scatter_add_big_kernel(
    const float* __restrict__ v, const int* __restrict__ offsets, int* list,
    const int* __restrict__ big, const int* __restrict__ nbig, float* __restrict__ out, int S,
    int C, int N, int planes) {
  __shared__ int keys[kBigKeys];
  __shared__ float rows[kBigRows];
  const Team team{static_cast<int>(threadIdx.x), kBigThreads, 1};
  const int count = *nbig;
  for (int b = blockIdx.x; b < count; b += gridDim.x) {
    const int gn = big[b], g = gn / N, n = gn - g * N;
    const int* og = offsets + static_cast<size_t>(g) * (N + 1);
    const int L = og[n + 1] - og[n];
    int* pos = list + static_cast<size_t>(g) * S + og[n];
    if (L <= kBigKeys) {
      for (int i = threadIdx.x; i < L; i += kBatch * kBigThreads) {
        int k[kBatch];                           // all loads of a batch before its stores
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (i + u * kBigThreads < L) k[u] = pos[i + u * kBigThreads];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (i + u * kBigThreads < L) keys[i + u * kBigThreads] = k[u];
      }
      __syncthreads();
      pos = keys;
    }
    team_sort(team, pos, L);
    team_sum_sorted(team, pos, L, v + static_cast<size_t>(g) * S * C,
                    out + (static_cast<size_t>(g) * N + n) * C, S, C, planes, rows, kBigRows);
    __syncthreads();
  }
}

// The small route: a block takes rows [r0, r0 + kSmallRows) of group g and
// does the count, scan and fill of their buckets in shared memory.  A thread
// then sorts a bucket of up to kLaneMax entries (insertion) and sums it, and
// a team of kBlock / kSmallTeams threads each longer one (team_sort,
// team_sum_sorted).
__global__ void __launch_bounds__(kBlock) scatter_add_small_kernel(
    const float* __restrict__ v, const int* __restrict__ idx, float* __restrict__ out, int S,
    int C, int N, int planes) {
  extern __shared__ int sm[];
  __shared__ int warp_sum[kBlock / 32];
  __shared__ int longest[kSmallS / (kLaneMax + 1) + 1], n_longest;
  float* rows = reinterpret_cast<float*>(sm);  // kSmallRowsBuf values for the block sums
  int* cnt = sm + kSmallRowsBuf;        // the rows' counts, then their cursors
  int* off = cnt + kSmallRows;          // kSmallRows + 1 offsets
  int* list = off + kSmallRows + 1;     // the block's sources, bucket by bucket
  const int g = blockIdx.y, r0 = blockIdx.x * kSmallRows;
  const int R = min(kSmallRows, N - r0);
  const int* ig = idx + static_cast<size_t>(g) * S;
  const float* vg = v + static_cast<size_t>(g) * S * C;
  float* og = out + (static_cast<size_t>(g) * N + r0) * C;
  for (int i = threadIdx.x; i < R; i += kBlock) cnt[i] = 0;
  if (threadIdx.x == 0) n_longest = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kBlock) {
    const int t = ig[s];
    if (t >= r0 && t < r0 + R) atomicAdd(&cnt[t - r0], 1);
  }
  __syncthreads();
  block_scan(cnt, off, R, warp_sum);
  __syncthreads();
  for (int i = threadIdx.x; i < R; i += kBlock) cnt[i] = off[i];
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kBlock) {
    const int t = ig[s];
    if (t >= r0 && t < r0 + R) list[atomicAdd(&cnt[t - r0], 1)] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R; i += kBlock) {
    int* b = list + off[i];
    const int L = off[i + 1] - off[i];
    if (L > kLaneMax) {
      longest[atomicAdd(&n_longest, 1)] = i;
      continue;
    }
    for (int a = 1; a < L; ++a) {
      const int x = b[a];
      int k = a - 1;
      for (; k >= 0 && b[k] > x; --k) b[k + 1] = b[k];
      b[k + 1] = x;
    }
    float acc[kCh] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int e = 0; e < L; ++e) {
      const size_t s = static_cast<size_t>(b[e]);
#pragma unroll
      for (int c = 0; c < kCh; ++c)
        if (c < C) acc[c] += planes ? vg[static_cast<size_t>(c) * S + s] : vg[s * C + c];
    }
#pragma unroll
    for (int c = 0; c < kCh; ++c)
      if (c < C) og[static_cast<size_t>(i) * C + c] = acc[c];
  }
  __syncthreads();
  const int team_size = kBlock / kSmallTeams, k0 = threadIdx.x / team_size;
  const Team team{static_cast<int>(threadIdx.x) % team_size, team_size, 1 + k0};
  float* team_rows = rows + k0 * (kSmallRowsBuf / kSmallTeams);
  for (int k = k0; k < n_longest; k += kSmallTeams) {
    const int r = longest[k];
    team_sort(team, list + off[r], off[r + 1] - off[r]);
    team_sum_sorted(team, list + off[r], off[r + 1] - off[r], vg,
                    og + static_cast<size_t>(r) * C, S, C, planes, team_rows,
                    kSmallRowsBuf / kSmallTeams);
  }
}

}  // namespace

// v (G, S, C) rows, or (G, C, S) planes when planes != 0; idx (G, S) int32;
// out (G, N, C) f32.  work: int32 scratch of G * (3 * N + 1 + S) + 1 entries
// (the count of big rows and the counts, zeroed here; the offsets, the bucket
// lists and the big rows; the small route uses none of it).
MOCOPCI_API int mocopci_scatter_add(const float* v, const int* idx, float* out, int* work,
                                    int G, int S, int C, int N, int planes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (small_route(S, C, N)) {
    const size_t smem = sizeof(int) * (kSmallRowsBuf + 2 * kSmallRows + 1 + S);
    if ((err = mocopci::allow_smem(scatter_add_small_kernel, smem)) != cudaSuccess) return err;
    scatter_add_small_kernel<<<dim3(mocopci::ceil_div(N, kSmallRows), G), kBlock, smem, st>>>(
        v, idx, out, S, C, N, planes);
    return cudaGetLastError();
  }
  int* nbig = work;
  int* counts = nbig + 1;
  int* offsets = counts + static_cast<size_t>(G) * N;
  int* list = offsets + static_cast<size_t>(G) * (N + 1);
  int* big = list + static_cast<size_t>(G) * S;
  if ((err = cudaMemsetAsync(nbig, 0, sizeof(int) * (1 + static_cast<size_t>(G) * N), st)) !=
      cudaSuccess)
    return err;
  const size_t hist = use_hist(S, N) ? sizeof(int) * N : 0;
  if ((err = mocopci::allow_smem(scatter_add_count_kernel, hist)) != cudaSuccess) return err;
  if ((err = mocopci::allow_smem(scatter_add_fill_kernel, hist)) != cudaSuccess) return err;
  const dim3 chunks(mocopci::ceil_div(S, chunk_of(S, N)), G);
  scatter_add_count_kernel<<<chunks, kBlock, hist, st>>>(idx, counts, S, N);
  MOCOPCI_CHECK_LAUNCH();
  scatter_add_scan_kernel<<<G, kBlock, 0, st>>>(counts, offsets, N);
  MOCOPCI_CHECK_LAUNCH();
  scatter_add_fill_kernel<<<chunks, kBlock, hist, st>>>(idx, offsets, counts, list, S, N);
  MOCOPCI_CHECK_LAUNCH();
  scatter_add_bucket_kernel<<<dim3(mocopci::ceil_div(N, kWarpsPerBlock), G), kThreads, 0, st>>>(
      v, offsets, list, out, big, nbig, S, C, N, planes);
  MOCOPCI_CHECK_LAUNCH();
  scatter_add_big_kernel<<<kBigGrid, kBigThreads, 0, st>>>(v, offsets, list, big, nbig, out, S,
                                                            C, N, planes);
  return cudaGetLastError();
}
