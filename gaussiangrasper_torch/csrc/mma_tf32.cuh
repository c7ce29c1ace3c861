// Tensor-core products in 3xTF32 and the 8 x 4 pixel warps, shared by the per-tile bodies of the
// compositor kernels (composite_tile in composite_pairs_fwd.cu, grad_tile in
// composite_pairs_bwd.cu).
//
// Precision. A single-pass TF32 product rounds each operand to 10 mantissa bits (relative error
// ~4.9e-4 an element). The bodies take their products in 3xTF32: x = hi + lo with hi = tf32(x)
// (cvt.rna: to nearest, ties away) and lo = x - hi, exact in f32, which the tensor core reads as
// TF32 by dropping its 13 low bits; lo hi + hi lo + hi hi accumulate in f32 (lo lo dropped), ~21
// mantissa bits, f32-grade.
//
// Fragments of mma.sync.m16n8k8 (TF32 operands, f32 accumulators), with groupID gq = lane / 4 and
// threadID_in_group tq = lane % 4: a[0..3] = A[gq][tq], A[gq + 8][tq], A[gq][tq + 4],
// A[gq + 8][tq + 4]; b[0..1] = B[tq][gq], B[tq + 4][gq]; d[0..3] = D[gq][2 tq], D[gq][2 tq + 1],
// D[gq + 8][2 tq], D[gq + 8][2 tq + 1].

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi = tf32(x), lo = x - hi as f32 bits (the tensor core truncates it to TF32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on the tensor cores: m16n8k8, TF32 operands, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 on operands already split (ah + al, bh + bl): lo hi + hi lo + hi hi.
__device__ __forceinline__ void mma_3xtf32_split(float (&d)[4], const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                                 const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// d += a b in 3xTF32 on f32 operands, split here.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                           const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_3xtf32_split(d, ah, al, bh, bl);
}

// The tile pixel of thread lin: warp w covers the 8 x 4 pixel block w of the tile (blocks in
// row-major order), lane l its pixel (l % 8, l / 8); ts is a multiple of 8.
__device__ __forceinline__ int tile_pixel(int lin, int ts) {
  const int w = lin >> 5, l = lin & 31, bw = ts >> 3;
  return ((w / bw) * 4 + (l >> 3)) * ts + (w % bw) * 8 + (l & 7);
}

// The thread of tile pixel p: tile_pixel's inverse.
__device__ __forceinline__ int pixel_thread(int p, int ts) {
  const int x = p % ts, y = p / ts;
  return (((y >> 2) * (ts >> 3) + (x >> 3)) << 5) + ((y & 3) << 3) + (x & 7);
}

}  // namespace
