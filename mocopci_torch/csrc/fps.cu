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
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // 32 points a thread at N = 8192
constexpr int kMaxLevels = 8;
constexpr int kSlotFloats = 2 * 32 * 2;   // the step slots, in floats
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

__global__ void __launch_bounds__(kMaxThreads) fps_kernel(const float* __restrict__ xyz, int N,
                                                          Levels lv, int* __restrict__ out) {
  fps_cloud(xyz, N, lv, out);
}

__global__ void __launch_bounds__(kMaxThreads) fps_pyramid_kernel(const float* __restrict__ xyz,
                                                                  int N, Levels lv,
                                                                  int* __restrict__ out) {
  fps_cloud(xyz, N, lv, out);
}

template <typename Kernel>
cudaError_t run(Kernel kernel, const float* xyz, int B, int N, const Levels& lv, int* out,
                cudaStream_t st) {
  // all of it dynamic, so that allow_smem sees every byte above 48 KB
  const size_t smem =
      (kSlotFloats + 3 * static_cast<size_t>(N + (lv.count > 1 ? lv.n[0] : 0))) * sizeof(float);
  cudaError_t err = mocopci::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int threads = level_threads(N);   // the block serves every level
  for (int l = 0; l + 1 < lv.count; ++l) threads = max(threads, level_threads(lv.n[l]));
  kernel<<<B, threads, smem, st>>>(xyz, N, lv, out);
  return cudaGetLastError();
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
  if (levels < 1 || levels > kMaxLevels) return cudaErrorInvalidValue;
  Levels lv{};
  for (int l = 0; l < levels; ++l) lv.n[l] = npoints[l];
  lv.count = levels;
  return run(fps_pyramid_kernel, xyz, B, N, lv, out, static_cast<cudaStream_t>(stream));
}
