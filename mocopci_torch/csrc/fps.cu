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
// its planes and registers as the one-block kernel holds its cloud.  A step:
// each warp's winner (min-distance bits, global index, coordinates) is stored
// into every block's exchange slot of the step's parity through distributed
// shared memory, then ONE cluster barrier (arrive.release, wait.acquire), then
// every warp of every block reduces the R x warps slots itself: largest
// distance first, then the lowest global index, so every block agrees on the
// winner and ties across spans resolve as torch.argmax resolves them.  The
// later levels of a pyramid (at most 8192 points) run on rank 0 alone, with
// fps_level, from the level-0 winners' coordinates that rank 0 wrote into its
// level-1 region.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;  // 32 points a thread at N = 8192
constexpr int kMaxBlockN = kMaxThreads * 32;   // points one block holds: a cloud, a span
constexpr int kMaxLevels = 8;
constexpr int kSlotFloats = 2 * 32 * 2;   // the step slots, in floats
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kMaxEntries = kMaxCluster * kMaxThreads / 32;   // exchange slots a parity
constexpr int kExchangeFloats = 2 * kMaxEntries * (2 + 4);    // [2][64] uint2 + [2][64] float4
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

// Level 0 of a cloud across the R blocks of a cluster: this block (rank r)
// holds the n_here points [base, base + n_here) in the planes (X, Y, Z),
// thread t its points t + i * blockDim.  (lx, ly, lz) is the cloud's point 0.
// Rank 0 writes the indices and, where nx is given, the winners'
// coordinates.  xv and xc are the exchange slots ([2][kMaxEntries] each).
template <int kPer>
__device__ void fps_level_cluster(const float* X, const float* Y, const float* Z, int n_here,
                                  int base, int npoint, float lx, float ly, float lz,
                                  int* __restrict__ out, float* nx, float* ny, float* nz,
                                  uint2* xv, float4* xc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int R = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, act = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = act >> 5, ne = R * nw;
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
    const int par = (s & 1) * kMaxEntries;
    if (lane < R) {
      // a padded point (md 0) carries no index: it never meets a real one
      const bool real = wl < static_cast<unsigned>(n_here);
      const int slot = par + r * nw + warp;
      *cluster.map_shared_rank(xv + slot, lane) =
          make_uint2(wm, real ? static_cast<unsigned>(base) + wl : kNone);
      *cluster.map_shared_rank(xc + slot, lane) =
          real ? make_float4(X[wl], Y[wl], Z[wl], 0.f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cluster_barrier();
    // the other parity's slots are the next step's: no block stores into a
    // slot another may still read
    uint2 e = lane < ne ? xv[par + lane] : make_uint2(0u, kNone);
    int pos = lane;
    if (lane + 32 < ne) {
      const uint2 f = xv[par + lane + 32];
      if (f.x > e.x || (f.x == e.x && f.y < e.y)) {
        e = f;
        pos = lane + 32;
      }
    }
    const unsigned m = __reduce_max_sync(kFull, e.x);
    const unsigned win = __reduce_min_sync(kFull, e.x == m ? e.y : kNone);
    const int from = __ffs(__ballot_sync(kFull, e.x == m && e.y == win)) - 1;
    const float4 c = xc[par + __shfl_sync(kFull, pos, from)];
    lx = c.x;
    ly = c.y;
    lz = c.z;
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

// Cloud blockIdx.y across the cluster along x: the exchange slots, the step
// slots of the later levels, this block's span of S = ceil(N / R) points as
// three planes, then on rank 0 of a pyramid the level-1 region (capacity
// n_0), where rank 0 runs the later levels alone, alternating with the planes.
__device__ void fps_cloud_cluster(const float* __restrict__ xyz, int N, const Levels& lv,
                                  int* __restrict__ out) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int R = static_cast<int>(cluster.num_blocks());
  uint2* xv = reinterpret_cast<uint2*>(smem);
  float4* xc = reinterpret_cast<float4*>(smem + 4 * kMaxEntries);
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
  // every block of the cluster has started (its slots may be written) and
  // holds its planes
  cluster_barrier();
  float* reg = sm + 3 * cap;
  float* nx = r == 0 && lv.count > 1 ? reg : nullptr;
  int* o = out + static_cast<size_t>(b) * lv.n[0];
  const int per = mocopci::ceil_div(S, blockDim.x);
  if (per > 16)
    fps_level_cluster<32>(sm, sm + cap, sm + 2 * cap, n_here, base, lv.n[0], x[0], x[1], x[2],
                          o, nx, reg + cap1, reg + 2 * cap1, xv, xc);
  else if (per > 8)
    fps_level_cluster<16>(sm, sm + cap, sm + 2 * cap, n_here, base, lv.n[0], x[0], x[1], x[2],
                          o, nx, reg + cap1, reg + 2 * cap1, xv, xc);
  else
    fps_level_cluster<8>(sm, sm + cap, sm + 2 * cap, n_here, base, lv.n[0], x[0], x[1], x[2],
                         o, nx, reg + cap1, reg + 2 * cap1, xv, xc);
  // after the last step's cluster barrier no block touches another's memory;
  // rank 0 runs the later levels as fps_cloud runs its levels, alternating
  // between the level-1 region and the planes (the loop is fps_cloud's, not
  // shared with it: sharing it moved the one-block kernels' registers and
  // cost them 3-4% in time, scripts/fps_cluster_timing.py --other)
  if (r != 0 || lv.count == 1) return;
  __syncthreads();
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
