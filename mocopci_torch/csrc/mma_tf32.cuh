// Tensor-core products at float32 grade: mma.sync m16n8k8 on TF32 operands
// (a warp), and wgmma m64nNk8 (a warpgroup, below).  3xTF32: each float32
// operand split into hi = tf32(x) and lo = tf32(x - hi), three products per
// step (lo*hi, hi*lo, then hi*hi; lo*lo dropped); each product keeps about
// 21 bits.  6xTF32, where a result decides
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

// The same split by bit masks, without the conversion unit (which converts
// 16 values a clock on an SM, an eighth of its FMA rate): hi = x with its low
// 13 bits cleared, lo = the rest likewise, both toward zero, so x - hi - lo is
// below 2^-20 |x| (2^-22 when split_tf32 rounds to nearest).
__device__ __forceinline__ void split_tf32_rz(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
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
  __device__ __forceinline__ void set_rz(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32_rz(a[i], hi[i], lo[i]);
  }
};

// A B fragment split into hi and lo parts.
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, hi[0], lo[0]);
    split_tf32(b1, hi[1], lo[1]);
  }
  __device__ __forceinline__ void set_rz(float b0, float b1) {
    split_tf32_rz(b0, hi[0], lo[0]);
    split_tf32_rz(b1, hi[1], lo[1]);
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

// Warpgroup products (wgmma, sm_90a): D (64 x N) += A (64 x 8) B (8 x N) in
// TF32 with f32 sums, issued by the 4 warps of a warpgroup together and run
// asynchronously.  A in registers: each warp's 16 rows as the mma.sync
// m16n8k8 A fragment above; D as that warp's rows of N / 8 C fragments.  B
// in shared memory, K-major, without swizzle: core matrices of 8 rows (N) x
// 4 elements (K), 128 contiguous bytes each, the two of a k-step lbo bytes
// apart and consecutive groups of 8 rows sbo bytes apart (the descriptor).
// Issue: wgmma_fence() after the last write of A or D, the products, then
// wgmma_commit() and wgmma_wait() before D is read.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory writes by the threads made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[16][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

}  // namespace mocopci
