// Warp-level tensor-core products at float32 grade: mma.sync m16n8k8 on TF32
// operands.  3xTF32: each float32 operand split into hi = tf32(x) and lo =
// tf32(x - hi), three products per step (lo*hi, hi*lo, then hi*hi; lo*lo
// dropped); each product keeps about 21 bits.  6xTF32, where a result decides
// a branch (a ReLU kink, a max): a third part lo = tf32(x - hi - mid) makes
// the split exact, and six products (every term down to 2^-22 of hi*hi, the
// small ones first) leave only the float32 accumulation's rounding.
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), with gid = lane / 4 and
// tig = lane % 4:
//   A (16 x 8, row)  a0 (gid, tig)  a1 (gid + 8, tig)  a2 (gid, tig + 4)  a3 (gid + 8, tig + 4)
//   B (8 x 8, col)   b0 (tig, gid)  b1 (tig + 4, gid)
//   C (16 x 8)       c0 (gid, 2 tig)  c1 (gid, 2 tig + 1)  c2 (gid + 8, 2 tig)  c3 (gid + 8, 2 tig + 1)
#pragma once

#include <cstdint>

namespace mocopci {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split into hi and lo parts.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
  }
};

// A B fragment split into hi and lo parts.
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
};

// d += a * b at float32 grade (3xTF32): the two small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

__device__ __forceinline__ void split3_tf32(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = to_tf32(x);
  const float r = x - __uint_as_float(hi);
  mid = to_tf32(r);
  lo = to_tf32(r - __uint_as_float(mid));
}

// Fragments split exactly into three TF32 parts.
struct FragA3 {
  uint32_t hi[4], mid[4], lo[4];
  __device__ __forceinline__ void set(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split3_tf32(a[i], hi[i], mid[i], lo[i]);
  }
};

struct FragB3 {
  uint32_t hi[2], mid[2], lo[2];
};

// d += a * b (6xTF32): the terms of 2^-22, then 2^-11, then hi * hi.
__device__ __forceinline__ void mma_6xtf32(float (&d)[4], const FragA3& a, const FragB3& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.mid, b.mid);
  mma_tf32(d, a.mid, b.hi);
  mma_tf32(d, a.hi, b.mid);
  mma_tf32(d, a.hi, b.hi);
}

}  // namespace mocopci
