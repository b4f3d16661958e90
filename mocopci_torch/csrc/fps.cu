// Farthest point sampling, one thread block per cloud; the pyramid in one
// launch.
//
// Replaces mocopci_tpu/ops/pallas/fps.py: farthest_point_sample_pallas (:419)
// by fps_kernel, and farthest_point_sample_pyramid_pallas (:477, one
// pallas_call for every level) by fps_pyramid_kernel: level l samples from
// level l-1's subset, its indices address that subset, and the subsets never
// leave shared memory.
//
// Semantics: index 0 first, min-distance initialised to 1e10, each step the
// argmax of the min-distance field with ties to the lowest index (jnp.argmax).
// The squared distance is evaluated as ((dx*dx + dy*dy) + dz*dz) with explicit
// round-to-nearest intrinsics, no FMA contraction, so the indices equal the
// plain PyTorch version's bit for bit.
//
// Bound on the H100: neither bytes (the cloud is read once) nor operations
// (N*npoint*~9 flops) but the npoint-long chain of dependent steps: a step is
// about 12 instructions a point on one SM plus a block-wide argmax.  Design:
// the cloud's coordinates sit in shared memory as three planes, and each
// thread keeps its strided points and their min-distances in registers: 32
// above 4096 points, 16 above 2048, else 8 (fewer warps make the step's
// reductions cheaper where the arithmetic fills the SM, more threads shorten
// each thread's chain where it does not).  A step takes each warp's argmax
// with __reduce_max_sync on the float bits (min-distances are >= 0, so
// unsigned order is float order) and __reduce_min_sync of the index over the
// lanes at the max; the warp winners go to a shared slot double-buffered by
// the step's parity, and after ONE barrier every warp reduces the slots
// itself (no second barrier, no broadcast).  The winner's coordinates come from shared memory.  A level
// runs on as many threads as its points need (rounded to warps) behind a
// named barrier of that many; the selected points' coordinates go to the
// other shared region, where the next level runs on them.
//
// Above 8192 points (fps_cluster, fps_pyramid_cluster) a cloud no longer fits
// one SM (32768 points and their min-distances are 512 KB), so level 0 runs
// across a thread-block cluster of R <= 8 blocks: block r holds the
// contiguous span [r*S, r*S + S) of the cloud, S = ceil(N / R) <= 8192, in
// its planes and registers as the one-block kernel holds its cloud.  What
// sets a step's pace there is the exchange between the blocks, not the
// arithmetic (2, 4 and 8 blocks took about the same time when each step
// ended in a cluster barrier).  So the exchange is completed by the data: at
// a step each warp's lanes r' < R push the warp's winner (min-distance bits,
// global index, coordinates) into block r''s exchange slot of the step's
// parity with st.async, which completes the bytes on block r''s mbarrier of
// that parity; every warp waits on its own block's mbarrier, not on a
// rendezvous of the cluster, and merges the R x warps entries: largest
// distance first, then the lowest global index, so every block agrees on the
// winner and ties across spans resolve as torch.argmax resolves them.  No
// cluster barrier runs inside the step loop: one before it (the mbarriers
// and the planes ready), one after it (no block exits while a peer may still
// store into its shared memory).  Reducing each block's warps first (one
// block barrier) and pushing only the block's winner, R entries a step, was
// 1-2% slower at 32768 points (scripts/fps_cluster_timing.py builds and
// times that variant beside this source).  The later levels of
// a pyramid (at most 8192 points) run on rank 0 alone, with fps_level, from
// the level-0 winners' coordinates that rank 0 wrote into its level-1 region.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;  // 32 points a thread at N = 8192
constexpr int kMaxBlockN = kMaxThreads * 32;   // points one block holds: a cloud, a span
constexpr int kMaxLevels = 8;
constexpr int kSlotFloats = 2 * 32 * 2;   // the step slots, in floats
constexpr int kMaxCluster = 8;            // the portable cluster size
// the exchange: a slot a sender (a warp of the cluster) in each parity; an
// entry is (distance bits, global index, x, y) and z, 20 bytes in a room of
// 32, and the two mbarriers follow the slots
constexpr int kSlotsPerParity = kMaxCluster * kMaxThreads / 32;
constexpr int kEntryBytes = 20;
constexpr int kEntryFloats = 8;
constexpr int kExchangeFloats = 2 * kSlotsPerParity * kEntryFloats + 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;

struct Levels {
  int n[kMaxLevels];
  int count;
};

// points a thread at a level of n_in points
__host__ __device__ inline int level_per(int n_in) {
  return n_in > 4096 ? 32 : n_in > 2048 ? 16 : 8;
}

__host__ __device__ inline int level_threads(int n_in) {
  const int per = level_per(n_in);
  return ((n_in + per - 1) / per + 31) / 32 * 32;
}

__device__ __forceinline__ void named_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// One level on the n_in points of the planes (X, Y, Z): npoint indices into
// out and, where nx is given, the selected points' coordinates into (nx, ny,
// nz).  Run by the first level_threads(n_in) threads; the others return.
template <int kPer>
__device__ void fps_level(const float* X, const float* Y, const float* Z, int n_in, int npoint,
                          int* __restrict__ out, float* nx, float* ny, float* nz,
                          uint2* slots) {
  const int act = level_threads(n_in);
  const int tid = threadIdx.x;
  if (tid >= act) return;
  const int lane = tid & 31, warp = tid >> 5, nw = act >> 5;
  float px[kPer], py[kPer], pz[kPer], md[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int n = tid + i * act;
    const bool real = n < n_in;
    px[i] = real ? X[n] : 0.f;
    py[i] = real ? Y[n] : 0.f;
    pz[i] = real ? Z[n] : 0.f;
    // a padded point stays at 0 with an index past every real one: it wins
    // no tie against a real point and nothing else
    md[i] = real ? 1e10f : 0.f;
  }
  float lx = X[0], ly = Y[0], lz = Z[0];
  if (tid == 0) {
    out[0] = 0;
    if (nx != nullptr) {
      nx[0] = lx;
      ny[0] = ly;
      nz[0] = lz;
    }
  }
  for (int s = 1; s < npoint; ++s) {
    unsigned bv = 0u, bi = kNone;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float dx = __fsub_rn(px[i], lx), dy = __fsub_rn(py[i], ly),
                  dz = __fsub_rn(pz[i], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      md[i] = fminf(md[i], d);
      // a thread's points ascend with i: strict > keeps the lowest index
      const unsigned v = __float_as_uint(md[i]);
      if (i == 0 || v > bv) {
        bv = v;
        bi = static_cast<unsigned>(tid + i * act);
      }
    }
    const unsigned wm = __reduce_max_sync(kFull, bv);
    const unsigned wi = __reduce_min_sync(kFull, bv == wm ? bi : kNone);
    uint2* slot = slots + (s & 1) * 32;
    if (lane == 0) slot[warp] = make_uint2(wm, wi);
    named_barrier(act);
    // every warp reduces the slots itself; the other parity's slots are the
    // next step's, so no warp overwrites a slot another may still read
    const uint2 e = lane < nw ? slot[lane] : make_uint2(0u, kNone);
    const unsigned m = __reduce_max_sync(kFull, e.x);
    const unsigned win = __reduce_min_sync(kFull, e.x == m ? e.y : kNone);
    lx = X[win];
    ly = Y[win];
    lz = Z[win];
    if (tid == 0) {
      out[s] = static_cast<int>(win);
      if (nx != nullptr) {
        nx[s] = lx;
        ny[s] = ly;
        nz[s] = lz;
      }
    }
  }
}

// Cloud blockIdx.x: the step slots (2 x 32 uint2) first in dynamic shared
// memory, then its (N, 3) points as three planes of capacity N; then lv.count
// levels, level l's (B, n_l) indices at out + B * (n_0 + ... +
// n_{l-1}); the levels alternate between that region and a second one of
// capacity n_0 (each level's points fit the region it is written to, as the
// levels do not grow).
__device__ void fps_cloud(const float* __restrict__ xyz, int N, const Levels& lv,
                          int* __restrict__ out) {
  extern __shared__ float smem[];
  uint2* slots = reinterpret_cast<uint2*>(smem);
  float* sm = smem + kSlotFloats;
  const int b = blockIdx.x, B = gridDim.x;
  const float* x = xyz + static_cast<size_t>(b) * N * 3;
  for (int e = threadIdx.x; e < 3 * N; e += blockDim.x) {
    const int n = e / 3, c = e - n * 3;
    sm[c * N + n] = x[e];
  }
  __syncthreads();
  float* src = sm;
  float* dst = sm + 3 * N;
  int cap_src = N, cap_dst = lv.n[0], n_in = N, off = 0;
  for (int l = 0; l < lv.count; ++l) {
    const int np = lv.n[l];
    float* nx = l + 1 < lv.count ? dst : nullptr;
    int* o = out + static_cast<size_t>(B) * off + static_cast<size_t>(b) * np;
    float *ny = dst + cap_dst, *nz = dst + 2 * cap_dst;
    const float *X = src, *Y = src + cap_src, *Z = src + 2 * cap_src;
    switch (level_per(n_in)) {
      case 32: fps_level<32>(X, Y, Z, n_in, np, o, nx, ny, nz, slots); break;
      case 16: fps_level<16>(X, Y, Z, n_in, np, o, nx, ny, nz, slots); break;
      default: fps_level<8>(X, Y, Z, n_in, np, o, nx, ny, nz, slots);
    }
    __syncthreads();
    off += np;
    n_in = np;
    float* t = src;
    src = dst;
    dst = t;
    const int c = cap_src;
    cap_src = cap_dst;
    cap_dst = c;
  }
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the .shared::cluster address of this block's shared address a in rank's block
__device__ __forceinline__ unsigned map_rank(unsigned a, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// the one arrival of the barrier's current phase, which then completes once
// `bytes` have landed
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// until the phase of the given parity completes; the stores that completed
// it, made by other blocks, are then visible to this thread
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// An entry into the slot at .shared::cluster address `slot` of another block
// (or this one), its 20 bytes completed on that block's mbarrier `bar`.
__device__ __forceinline__ void send_entry(unsigned slot, unsigned bar, unsigned d, unsigned idx,
                                           float x, float y, float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%2, %3, %4, %5}, "
      "[%1];\n"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%6], %7, [%1];\n" ::"r"(slot),
      "r"(bar), "r"(d), "r"(idx), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)),
      "r"(slot + 16), "r"(__float_as_uint(z))
      : "memory");
}

// Level 0 of a cloud across the R blocks of a cluster: this block (rank r)
// holds the n_here points [base, base + n_here) in the planes (X, Y, Z),
// thread t its points t + i * blockDim.  (lx, ly, lz) is the cloud's point 0.
// Rank 0 writes the indices and, where nx is given, the winners'
// coordinates.  xe is the exchange ([2][kSlotsPerParity] entries of
// kEntryFloats), bars its two mbarriers, initialised with the steps 1 and 2
// expected (fps_cloud_cluster).
//
// A step s: every warp stores its winner into slot (s & 1, its rank's
// warp) of every block, completing on that block's mbarrier s & 1, whose
// phase ((s - 1) >> 1) & 1 is step s's.  The slots of a parity need no
// barrier: a peer's step s + 2 store into them needs every step s + 1 entry
// of this block, and a warp sends its own only after it has read step s.
// For the same reason no mbarrier runs two phases ahead of a warp that
// waits on it.
template <int kPer>
__device__ void fps_level_cluster(const float* X, const float* Y, const float* Z, int n_here,
                                  int base, int npoint, float lx, float ly, float lz,
                                  int* __restrict__ out, float* nx, float* ny, float* nz,
                                  float* xe, unsigned long long* bars) {
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int R = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, act = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = act >> 5;
  const int ne = R * nw;   // entries a block receives a step
  const unsigned bytes = static_cast<unsigned>(ne * kEntryBytes);
  float px[kPer], py[kPer], pz[kPer], md[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int n = tid + i * act;
    const bool real = n < n_here;
    px[i] = real ? X[n] : 0.f;
    py[i] = real ? Y[n] : 0.f;
    pz[i] = real ? Z[n] : 0.f;
    md[i] = real ? 1e10f : 0.f;
  }
  // lane q < R sends to rank q: its slot (parity 0, this sender) and its
  // mbarrier 0 there, in .shared::cluster addresses
  const int sender = r * nw + warp;
  const unsigned bar_here = smem_u32(bars);
  const unsigned q = static_cast<unsigned>(lane < R ? lane : 0);
  const unsigned slot_to = map_rank(smem_u32(xe + sender * kEntryFloats), q);
  const unsigned bar_to = map_rank(bar_here, q);
  constexpr unsigned kParityBytes = kSlotsPerParity * kEntryFloats * sizeof(float);
  const bool writer = r == 0 && tid == 0;
  if (writer) {
    out[0] = 0;
    if (nx != nullptr) {
      nx[0] = lx;
      ny[0] = ly;
      nz[0] = lz;
    }
  }
  for (int s = 1; s < npoint; ++s) {
    unsigned bv = 0u, bi = kNone;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float dx = __fsub_rn(px[i], lx), dy = __fsub_rn(py[i], ly),
                  dz = __fsub_rn(pz[i], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      md[i] = fminf(md[i], d);
      const unsigned v = __float_as_uint(md[i]);
      if (i == 0 || v > bv) {
        bv = v;
        bi = static_cast<unsigned>(tid + i * act);
      }
    }
    const unsigned wm = __reduce_max_sync(kFull, bv);
    const unsigned wl = __reduce_min_sync(kFull, bv == wm ? bi : kNone);
    const int p = s & 1;
    if (lane < R) {
      // a padded point (md 0) carries no index: kNone loses every tie
      const bool real = wl < static_cast<unsigned>(n_here);
      send_entry(slot_to + p * kParityBytes, bar_to + 8 * p, wm,
                 real ? static_cast<unsigned>(base) + wl : kNone, real ? X[wl] : 0.f,
                 real ? Y[wl] : 0.f, real ? Z[wl] : 0.f);
    }
    mbar_wait(bar_here + 8 * p, ((s - 1) >> 1) & 1);
    // the phase of step s + 2, expected before warp 0 sends its step s + 1
    // entry: a peer's step s + 2 store needs that entry, so none can land
    // before the expectation
    if (tid == 0 && s + 2 < npoint) mbar_expect(bar_here + 8 * p, bytes);
    const float* ex = xe + p * kSlotsPerParity * kEntryFloats;
    uint2 e = lane < ne ? *reinterpret_cast<const uint2*>(ex + lane * kEntryFloats)
                        : make_uint2(0u, kNone);
    int pos = lane;
    if (lane + 32 < ne) {
      const uint2 f = *reinterpret_cast<const uint2*>(ex + (lane + 32) * kEntryFloats);
      if (f.x > e.x || (f.x == e.x && f.y < e.y)) {
        e = f;
        pos = lane + 32;
      }
    }
    const unsigned m = __reduce_max_sync(kFull, e.x);
    const unsigned win = __reduce_min_sync(kFull, e.x == m ? e.y : kNone);
    const int from = __ffs(__ballot_sync(kFull, e.x == m && e.y == win)) - 1;
    const float* c = ex + __shfl_sync(kFull, pos, from) * kEntryFloats;
    lx = c[2];
    ly = c[3];
    lz = c[4];
    if (writer) {
      out[s] = static_cast<int>(win);
      if (nx != nullptr) {
        nx[s] = lx;
        ny[s] = ly;
        nz[s] = lz;
      }
    }
  }
}

// capacity of a cluster block's planes: its span of S points, and on rank 0
// level 2's points, which take the planes once level 0 is done
__host__ __device__ inline int span_capacity(int S, const Levels& lv) {
  return lv.count > 2 ? max(S, lv.n[1]) : S;
}

// Cloud blockIdx.y across the cluster along x: the exchange slots and the
// two mbarriers, the step slots of the later levels, this block's span of
// S = ceil(N / R) points as three planes, then on rank 0 of a pyramid the
// level-1 region (capacity n_0), where rank 0 runs the later levels alone,
// alternating with the planes.
__device__ void fps_cloud_cluster(const float* __restrict__ xyz, int N, const Levels& lv,
                                  int* __restrict__ out) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int R = static_cast<int>(cluster.num_blocks());
  float* xe = smem;
  auto* bars =
      reinterpret_cast<unsigned long long*>(smem + 2 * kSlotsPerParity * kEntryFloats);
  uint2* slots = reinterpret_cast<uint2*>(smem + kExchangeFloats);
  float* sm = smem + kExchangeFloats + kSlotFloats;
  const int b = blockIdx.y;
  const int S = mocopci::ceil_div(N, R), base = r * S, n_here = max(0, min(S, N - base));
  const int cap = span_capacity(S, lv), cap1 = lv.n[0];
  const float* x = xyz + static_cast<size_t>(b) * N * 3;
  for (int e = threadIdx.x; e < 3 * n_here; e += blockDim.x) {
    const int n = e / 3, c = e - n * 3;
    sm[c * cap + n] = x[3 * base + e];
  }
  if (threadIdx.x == 0) {
    const unsigned bar = smem_u32(bars);
    const int nw = static_cast<int>(blockDim.x) >> 5;
    const unsigned bytes = static_cast<unsigned>(R * nw * kEntryBytes);
    mbar_init(bar);
    mbar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // steps 1 and 2 expected (mbarrier 1, then 0); the loop expects the rest
    if (lv.n[0] > 1) mbar_expect(bar + 8, bytes);
    if (lv.n[0] > 2) mbar_expect(bar, bytes);
  }
  // every block of the cluster has started, initialised its mbarriers (its
  // slots may be written) and holds its planes
  cluster_barrier();
  float* reg = sm + 3 * cap;
  float* nx = r == 0 && lv.count > 1 ? reg : nullptr;
  int* o = out + static_cast<size_t>(b) * lv.n[0];
  const int per = mocopci::ceil_div(S, blockDim.x);
  if (per > 16)
    fps_level_cluster<32>(sm, sm + cap, sm + 2 * cap, n_here, base, lv.n[0], x[0], x[1], x[2],
                          o, nx, reg + cap1, reg + 2 * cap1, xe, bars);
  else if (per > 8)
    fps_level_cluster<16>(sm, sm + cap, sm + 2 * cap, n_here, base, lv.n[0], x[0], x[1], x[2],
                          o, nx, reg + cap1, reg + 2 * cap1, xe, bars);
  else
    fps_level_cluster<8>(sm, sm + cap, sm + 2 * cap, n_here, base, lv.n[0], x[0], x[1], x[2],
                         o, nx, reg + cap1, reg + 2 * cap1, xe, bars);
  // every block has waited for its last step's entries, so every store into
  // its shared memory has landed: after this barrier no block touches
  // another's memory and any may exit.  Rank 0 runs the later levels as
  // fps_cloud runs its levels, alternating between the level-1 region and
  // the planes (the loop is fps_cloud's, not shared with it: sharing it moved
  // the one-block kernels' registers and cost them 3-4% in time,
  // scripts/fps_cluster_timing.py --other)
  cluster_barrier();
  if (r != 0 || lv.count == 1) return;
  float* src = reg;
  float* dst = sm;
  int cap_src = cap1, cap_dst = cap, n_in = lv.n[0], off = lv.n[0];
  const int B = gridDim.y;
  for (int l = 1; l < lv.count; ++l) {
    const int np = lv.n[l];
    float* nx1 = l + 1 < lv.count ? dst : nullptr;
    int* o1 = out + static_cast<size_t>(B) * off + static_cast<size_t>(b) * np;
    float *ny1 = dst + cap_dst, *nz1 = dst + 2 * cap_dst;
    const float *X = src, *Y = src + cap_src, *Z = src + 2 * cap_src;
    switch (level_per(n_in)) {
      case 32: fps_level<32>(X, Y, Z, n_in, np, o1, nx1, ny1, nz1, slots); break;
      case 16: fps_level<16>(X, Y, Z, n_in, np, o1, nx1, ny1, nz1, slots); break;
      default: fps_level<8>(X, Y, Z, n_in, np, o1, nx1, ny1, nz1, slots);
    }
    __syncthreads();
    off += np;
    n_in = np;
    float* t = src;
    src = dst;
    dst = t;
    const int c = cap_src;
    cap_src = cap_dst;
    cap_dst = c;
  }
}

__global__ void __launch_bounds__(kMaxThreads) fps_kernel(const float* __restrict__ xyz, int N,
                                                          Levels lv, int* __restrict__ out) {
  fps_cloud(xyz, N, lv, out);
}

__global__ void __launch_bounds__(kMaxThreads) fps_pyramid_kernel(const float* __restrict__ xyz,
                                                                  int N, Levels lv,
                                                                  int* __restrict__ out) {
  fps_cloud(xyz, N, lv, out);
}

__global__ void __launch_bounds__(kMaxThreads) fps_cluster_kernel(
    const float* __restrict__ xyz, int N, Levels lv, int* __restrict__ out) {
  fps_cloud_cluster(xyz, N, lv, out);
}

__global__ void __launch_bounds__(kMaxThreads) fps_pyramid_cluster_kernel(
    const float* __restrict__ xyz, int N, Levels lv, int* __restrict__ out) {
  fps_cloud_cluster(xyz, N, lv, out);
}

// threads a block needs for the levels it runs: from its own n0 points at
// level 0, then from each level's points for the next
int block_threads(int n0, const Levels& lv) {
  int threads = level_threads(n0);
  for (int l = 0; l + 1 < lv.count; ++l) threads = max(threads, level_threads(lv.n[l]));
  return threads;
}

template <typename Kernel>
cudaError_t run(Kernel kernel, const float* xyz, int B, int N, const Levels& lv, int* out,
                cudaStream_t st) {
  // all of it dynamic, so that allow_smem sees every byte above 48 KB
  const size_t smem =
      (kSlotFloats + 3 * static_cast<size_t>(N + (lv.count > 1 ? lv.n[0] : 0))) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, block_threads(N, lv), smem, st>>>(xyz, N, lv, out);
  return cudaGetLastError();
}

// Level 0 over clusters of R blocks, a cluster a cloud.  Refuses what one
// block cannot hold: a span past kMaxBlockN points, or a later level on more.
template <typename Kernel>
cudaError_t run_cluster(Kernel kernel, const float* xyz, int B, int N, int R, const Levels& lv,
                        int* out, cudaStream_t st) {
  if (R < 1 || R > kMaxCluster) return cudaErrorInvalidValue;
  const int S = mocopci::ceil_div(N, R);
  if (S > kMaxBlockN) return cudaErrorInvalidValue;
  for (int l = 0; l + 1 < lv.count; ++l)
    if (lv.n[l] > kMaxBlockN) return cudaErrorInvalidValue;
  const size_t smem =
      (kExchangeFloats + kSlotFloats +
       3 * static_cast<size_t>(span_capacity(S, lv) + (lv.count > 1 ? lv.n[0] : 0))) *
      sizeof(float);
  cudaError_t err = mocopci::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(R, B);
  config.blockDim = dim3(block_threads(S, lv));
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = R;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, xyz, N, lv, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool levels_from(const int* npoints, int levels, Levels* lv) {
  if (levels < 1 || levels > kMaxLevels) return false;
  *lv = Levels{};
  for (int l = 0; l < levels; ++l) lv->n[l] = npoints[l];
  lv->count = levels;
  return true;
}

}  // namespace

// xyz (B, N, 3) f32 -> out (B, npoint) int32; N <= 8192, 1 <= npoint <= N.
MOCOPCI_API int mocopci_fps(const float* xyz, int B, int N, int npoint, int* out,
                            void* stream) {
  Levels lv{};
  lv.n[0] = npoint;
  lv.count = 1;
  return run(fps_kernel, xyz, B, N, lv, out, static_cast<cudaStream_t>(stream));
}

// xyz (B, N, 3) f32, npoints[levels] on the host (1 <= levels <= 8, N <= 8192,
// 1 <= npoints[l] <= npoints[l-1], npoints[0] <= N) -> out: level l's (B,
// npoints[l]) int32 indices, each addressing level l-1's points, one level
// after the other.
MOCOPCI_API int mocopci_fps_pyramid(const float* xyz, int B, int N, const int* npoints,
                                    int levels, int* out, void* stream) {
  Levels lv;
  if (!levels_from(npoints, levels, &lv)) return cudaErrorInvalidValue;
  return run(fps_pyramid_kernel, xyz, B, N, lv, out, static_cast<cudaStream_t>(stream));
}

// As mocopci_fps, level 0 over a cluster of `cluster` blocks (1 to 8) a
// cloud: ceil(N / cluster) <= 8192.
MOCOPCI_API int mocopci_fps_cluster(const float* xyz, int B, int N, int npoint, int cluster,
                                    int* out, void* stream) {
  Levels lv{};
  lv.n[0] = npoint;
  lv.count = 1;
  return run_cluster(fps_cluster_kernel, xyz, B, N, cluster, lv, out,
                     static_cast<cudaStream_t>(stream));
}

// As mocopci_fps_pyramid, level 0 over a cluster of `cluster` blocks (1 to 8)
// a cloud, the later levels on its first block: ceil(N / cluster) <= 8192 and
// every level but the last <= 8192 points.
MOCOPCI_API int mocopci_fps_pyramid_cluster(const float* xyz, int B, int N, const int* npoints,
                                            int levels, int cluster, int* out, void* stream) {
  Levels lv;
  if (!levels_from(npoints, levels, &lv)) return cudaErrorInvalidValue;
  return run_cluster(fps_pyramid_cluster_kernel, xyz, B, N, cluster, lv, out,
                     static_cast<cudaStream_t>(stream));
}
