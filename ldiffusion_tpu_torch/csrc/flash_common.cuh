// Pieces shared by the flash-attention kernels (flash_attention.cu, the
// forward; flash_attention_bwd.cu, the backward): mma.sync m16n8k16 bf16
// tiles and their fragment loads, and the tile loader from the (B, S, H, D)
// layout into shared memory.
//
// Fragment names follow the PTX ISA: g = lane/4 is the row (A, C) or column
// (B) inside a tile, tg = lane%4 picks the column pair. An accumulator (C)
// fragment of two neighbouring 16x8 tiles is, element for element, the A
// fragment of one 16x16 tile, so a product's result feeds the next product
// from registers (pack_bf16 rounds it to bf16 on the way).
//
// Softmax in base 2 (the exp2 formulation of tools/bench_attn_exp2.py): the
// kernels scale scores by scale*log2(e) and exponentiate with exp2f; the
// logsumexp crosses the interface in natural log (lse = ln 2 * (m + log2 l)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [0, 16) x columns [col, col+16) of a row-major bf16
// tile with row stride `stride`.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int stride, int col,
                                       int g, int tg) {
  const bf16* p = tile + col + 2 * tg;
  a[0] = ld32(p + g * stride);
  a[1] = ld32(p + (g + 8) * stride);
  a[2] = ld32(p + g * stride + 8);
  a[3] = ld32(p + (g + 8) * stride + 8);
}

// The B operand of a product whose 8 output columns are rows [n0, n0+8) of a
// row-major tile (k along the row): b0, b1 of the k-step starting at `col`.
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[4], const bf16* tile,
                                         int stride, int n0, int col, int g, int tg) {
  const bf16* p = tile + (n0 + g) * stride + col + 2 * tg;
  mma_bf16(c, a, ld32(p), ld32(p + 8));
}

// Two 16x8 accumulator tiles (n-blocks 2kk and 2kk+1 of a row of scores)
// as the A fragment of k-step kk, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Rows [r0, r0+rows) x columns [0, DP) of a (S, H, D) tensor (row stride rs,
// `src` at the head's first column) into shared memory, zero outside
// [0, limit) x [0, d). TRANS stores column-major (dst[c*stride + r]).
// vec: d % 8 == 0 and 16-byte aligned, so 8 values move per load.
template <int DP, int NT, bool TRANS>
__device__ __forceinline__ void load_tile(bf16* dst, int stride, const bf16* __restrict__ src,
                                          long rs, int r0, int rows, int limit, int d,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int e = tid; e < rows * CH; e += NT) {
      // row-major walk for plain stores (coalesced reads); column-chunk-major
      // for transposed stores, so neighbouring threads store to neighbouring
      // addresses of shared memory
      const int r = TRANS ? e % rows : e / CH;
      const int c = 8 * (TRANS ? e / rows : e % CH);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < limit && c < d)
        val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * rs + c);
      if (TRANS) {
        const bf16* pv = reinterpret_cast<const bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[(c + i) * stride + r] = pv[i];
      } else {
        *reinterpret_cast<uint4*>(dst + r * stride + c) = val;
      }
    }
  } else {
    for (int e = tid; e < rows * DP; e += NT) {
      const int r = e / DP, c = e % DP;
      bf16 val = __float2bfloat16(0.f);
      if (r0 + r < limit && c < d) val = src[(long)(r0 + r) * rs + c];
      dst[TRANS ? c * stride + r : r * stride + c] = val;
    }
  }
}

// f32 counterpart: TRANS stores dst[c*stride + r], else dst[r*stride + c].
template <int DP, int NT, bool TRANS>
__device__ __forceinline__ void load_tile_f32(float* dst, int stride,
                                              const float* __restrict__ src, long rs, int r0,
                                              int rows, int limit, int d) {
  for (int e = threadIdx.x; e < rows * DP; e += NT) {
    const int r = e / DP, c = e % DP;
    float val = 0.f;
    if (r0 + r < limit && c < d) val = src[(long)(r0 + r) * rs + c];
    dst[TRANS ? c * stride + r : r * stride + c] = val;
  }
}

}  // namespace
