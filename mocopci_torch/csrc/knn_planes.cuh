// The reference cloud staged as coordinate planes in shared memory, scanned
// by warps that each take QW queries: shared by the approximate kernel
// (knn_approx.cu) and the exact one (knn.cu) for Euclidean rows of at most 8
// channels.  Lane l of a warp takes columns l, l + 32, ... of a tile, so a
// staged coordinate is read by one lane and serves the warp's QW queries.
// Distances are 0 + sum_c (q_c - r_c)^2 in channel order with round-to-nearest
// intrinsics and no FMA (the leading 0 + x is x exactly), bit-identical to the
// plain twins.  Keys pack a distance and its column: (bits(d) & ~mask) | col,
// compared as signed int32.
#pragma once

#include "common.cuh"

namespace {

constexpr int kInf = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kXWarps = 8;
constexpr int kXThreads = 32 * kXWarps;
constexpr int kXPlaneBytes = 96 * 1024;    // the staged planes, at most

__device__ __forceinline__ int pack(float d, int mask, int col) {
  return (__float_as_int(d) & ~mask) | col;
}

// rows [base, base + min(chunk, M - base)) of the (M, C) reference rb into
// the planes rs[c * chunk + row], by the block's kXThreads threads
__device__ __forceinline__ void stage_planes(const float* __restrict__ rb, int base, int M, int C,
                                             int chunk, float* rs) {
  const int cnt = min(chunk, M - base);
  for (int e = threadIdx.x; e < cnt * C; e += kXThreads) {
    const int row = e / C, c = e - row * C;
    rs[c * chunk + row] = rb[static_cast<size_t>(base) * C + e];
  }
}

// the distance of query qv to reference row rc (the first C of CC channels)
template <int CC>
__device__ __forceinline__ float sq_dist(const float (&qv)[CC], const float (&rc)[CC], int C) {
  float diff = __fsub_rn(qv[0], rc[0]);
  float d = __fmul_rn(diff, diff);
#pragma unroll
  for (int c = 1; c < CC; ++c) {
    if (CC == 3 || c < C) {
      diff = __fsub_rn(qv[c], rc[c]);
      d = __fadd_rn(d, __fmul_rn(diff, diff));
    }
  }
  return d;
}

// the staged column at rt (its planes chunk apart)
template <int CC>
__device__ __forceinline__ void staged_row(const float* rt, int chunk, int C, float (&rc)[CC]) {
#pragma unroll
  for (int c = 0; c < CC; ++c)
    if (CC == 3 || c < C) rc[c] = rt[c * chunk];
}

// One reference tile against the warp's QW queries: f(qi, t, d, col) for the
// lane's columns col0 + 32 t (t < nt, and 32 t < lim where GUARD), their
// coordinates at rt[c * chunk + 32 t].
template <int NT, int CC, int QW, bool GUARD, class F>
__device__ __forceinline__ void scan_tile(const float* rt, int chunk, int C, int nt, int lim,
                                          int col0, const float (&qv)[QW][CC], F&& f) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (GUARD && !(t < nt && 32 * t < lim)) continue;
    float rc[CC];
    staged_row(rt + 32 * t, chunk, C, rc);
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) f(qi, t, sq_dist(qv[qi], rc, C), col0 + 32 * t);
  }
}

// Every staged column of a chunk of cnt columns once, in tiles of tr: lane l
// takes columns s0 + l + 32 t of tile s0 (ascending for each lane), base the
// chunk's first column.
template <int NT, int CC, int QW, class F>
__device__ __forceinline__ void scan_chunk(const float* rs, int chunk, int C, int cnt, int tr,
                                           int base, int lane, const float (&qv)[QW][CC],
                                           F&& f) {
  const int nt = tr >> 5;
  for (int s0 = 0; s0 < cnt; s0 += tr) {
    if (cnt - s0 >= tr && nt == NT)   // a whole tile: no guards
      scan_tile<NT, CC, QW, false>(rs + s0 + lane, chunk, C, NT, tr, base + s0 + lane, qv, f);
    else
      scan_tile<NT, CC, QW, true>(rs + s0 + lane, chunk, C, nt, cnt - s0 - lane,
                                  base + s0 + lane, qv, f);
  }
}

}  // namespace
