// Forward flash attention for Hopper (sm_90a): softmax(Q K^T * scale) V, and
// optionally the per-row logsumexp the backward needs. Two of the forward's
// three routes (ops/attention.py `fwd_route`): "mma" (`flash_fwd_mma`, the
// bf16 shapes TMA cannot address: d % 8 != 0 or unaligned pointers) and
// "f32" (`flash_fwd_f32`). The bf16 path shapes take the "wgmma" route,
// flash_fwd_wgmma.cu, which replaces the same Pallas kernels with TMA and
// wgmma; `flash_fwd_mma` also stays the yardstick it is timed against.
//
// Replaces three Pallas forward kernels of the JAX package,
// ldiffusion_tpu/ops/attention.py `_flash_kernel` (:41, resident K/V streamed
// in block_k chunks), `_flash_kvgrid_kernel` (:102, K/V blocks on the grid,
// m/l/acc in scratch) and `_flash_kernel_lse` (:180, the first one also
// writing lse = m + log l for training). With a non-null `lse` pointer each
// row also writes its logsumexp, (B, H, Sq) float32, in natural log; the
// inference path passes null and writes nothing more. On the TPU the sequential KV grid axis carried the
// online-softmax state between grid steps; here one CTA owns a block of query
// rows of one (batch, head) and walks every KV tile in a loop, so m, l and the
// f32 accumulator never leave the CTA. One kernel covers both Pallas kernels:
// any sequence length (the ragged tail is masked instead of demanding the
// TPU's sq%256 / sk%512), any head dim up to 512.
//
// Layout: q, k, v, o are (B, S, H, D) contiguous, the layout the model's
// projections produce, so no head transpose is materialised: row s of head h
// of batch b starts at ((b*S + s)*H + h)*D.
//
// What bounds it: at the UNet's shapes (S=1024..16384, D=40..160) and the
// VAE's (S=16384, D=512) the work is 4*B*H*S^2*D operations on a few MB of
// input, far above the card's ~295 operations per byte, so the bound is the
// tensor-core rate. The design therefore puts both products on the tensor
// cores and keeps the S x S scores out of device memory:
//
// bf16 (`flash_fwd_mma`): mma.sync m16n8k16 bf16 tiles with
// f32 accumulation. A CTA owns 64 query rows (4 row groups of 16, one warp
// each) and walks 32-key tiles of K and V staged in shared memory (V stored
// transposed, so both products read their B operands as 32-bit words). The
// scores stay in registers: the accumulator fragment of S = Q K^T is, element
// for element, the A fragment of P for P V, so P never touches shared memory.
// P is rounded to bf16 for the P V product (as the Pallas kernel casts p to
// v's dtype); the row sums l use the unrounded f32 p.
//
// d=512: a warp holding 16 rows x 512 f32 outputs would need 256 registers a
// thread. Instead the head dim is split across DS warps per row group (DS=2
// above d=128, DS=4 above d=256): each warp owns a slice of <=128 columns for
// both products. Its S = Q K^T over its slice is a partial sum; the DS
// partials are exchanged through shared memory and added in a fixed order,
// so every warp of a row group sees the same scores, with no recomputation.
// At d=512 the CTA is 16 warps, 64 outputs a thread, 178 KB of dynamic shared
// memory (hence cudaFuncSetAttribute above the 48 KB static limit).
//
// f32 (`flash_fwd_f32`, the exact path the f32 correctness runs use): plain
// f32 FMAs from shared memory, no tensor cores, so f32 inputs keep f32
// products (TF32 would keep about three digits). Each of 256 threads owns NI
// rows x NJ columns of the accumulator in registers; the CTA shrinks to 32
// rows above d=256.
//
// The softmax runs in base 2 with log2(e) folded into the scale (the exp2
// formulation of tools/bench_attn_exp2.py, K7): m is a base-2 running max,
// p = exp2(s*scale*log2(e) - m), and lse = ln 2 * (m + log2 l).
#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int kRG = 4;          // row groups (warps along the query axis) per CTA
constexpr int kBQ = 16 * kRG;   // query rows per CTA
constexpr int kTK = 32;         // keys per K/V tile
constexpr int kVS = kTK + 8;    // row stride of V^T in shared memory (bf16)
constexpr int kXS = kTK + 8;    // row stride of the partial-score exchange (f32)

template <int NK, int DS>
constexpr int mma_smem_bytes() {
  return (kBQ * (16 * NK * DS + 8) + kTK * (16 * NK * DS + 8) + 16 * NK * DS * kVS) * 2 +
         (DS > 1 ? DS * kBQ * kXS * 4 : 0);
}

// NK: 16-column k-steps in a warp's head-dim slice (slice = 16*NK columns).
// DS: warps per row group that split the head dim (DP = DS * slice >= d).
// scale2 = scale * log2(e).
template <int NK, int DS>
__global__ void __launch_bounds__(32 * kRG * DS)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
              int heads, int sq, int sk, int d, float scale2, int vec) {
  constexpr int SL = 16 * NK;
  constexpr int DP = SL * DS;
  constexpr int QS = DP + 8;  // row stride of Q and K tiles: conflict-free fragment reads
  constexpr int NT = 32 * kRG * DS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);         // [kBQ][QS]
  bf16* ks = qs + kBQ * QS;                              // [kTK][QS]
  bf16* vt = ks + kTK * QS;                              // [DP][kVS]  V^T
  float* sx = reinterpret_cast<float*>(vt + DP * kVS);  // [DS][kBQ][kXS] partial S

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp % kRG, ds = warp / kRG;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBQ;
  const long rs = (long)heads * d;
  const long qbase = (long)b * sq * rs + (long)h * d;
  const long kbase = (long)b * sk * rs + (long)h * d;

  load_tile<DP, NT, false>(qs, QS, q + qbase, rs, q0, kBQ, sq, d, vec);
  const bf16* qw = qs + rg * 16 * QS + ds * SL;  // this warp's rows and slice

  float acc[2 * NK][4];  // rows g, g+8; columns ds*SL + 8j + 2tg + {0, 1}
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int n_tiles = (sk + kTK - 1) / kTK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTK;
    __syncthreads();  // the previous tile's K, V^T and partials are no longer read
    load_tile<DP, NT, false>(ks, QS, k + kbase, rs, k0, kTK, sk, d, vec);
    load_tile<DP, NT, true>(vt, kVS, v + kbase, rs, k0, kTK, sk, d, vec);
    __syncthreads();

    // S (16 rows x 32 keys) over this warp's head-dim slice
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const bf16* qa = qw + kk * 16 + 2 * tg;
      const uint32_t a[4] = {ld32(qa + g * QS), ld32(qa + (g + 8) * QS),
                             ld32(qa + g * QS + 8), ld32(qa + (g + 8) * QS + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* kb = ks + (8 * j + g) * QS + ds * SL + kk * 16 + 2 * tg;
        mma_bf16(s[j], a, ld32(kb), ld32(kb + 8));
      }
    }
    if (DS > 1) {  // add the row group's DS partial sums, in the same order in every warp
      float* mine = sx + (ds * kBQ + rg * 16) * kXS;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(mine + g * kXS + 8 * j + 2 * tg) = make_float2(s[j][0], s[j][1]);
        *reinterpret_cast<float2*>(mine + (g + 8) * kXS + 8 * j + 2 * tg) =
            make_float2(s[j][2], s[j][3]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 lo = make_float2(0.f, 0.f), hi = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < DS; ++w) {
          const float* part = sx + (w * kBQ + rg * 16) * kXS + 8 * j + 2 * tg;
          const float2 a = *reinterpret_cast<const float2*>(part + g * kXS);
          const float2 c = *reinterpret_cast<const float2*>(part + (g + 8) * kXS);
          lo.x += a.x; lo.y += a.y; hi.x += c.x; hi.y += c.y;
        }
        s[j][0] = lo.x; s[j][1] = lo.y; s[j][2] = hi.x; s[j][3] = hi.y;
      }
    }

    // Online softmax. Row g's 32 scores sit in the 4 lanes of a quad (same g),
    // so row reductions are xor-shuffles over 1 and 2.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * j + 2 * tg + (e & 1) < sk;
        s[j][e] = valid ? s[j][e] * scale2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile has a valid key
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    // P as the A fragments of the two 16-key steps of P V: n-blocks 2ks and
    // 2ks+1 of S are the low and high 8 keys of step ks
    uint32_t pa[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
      const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
      rsum[0] += p0 + p1;
      rsum[1] += p2 + p3;
      pa[j >> 1][2 * (j & 1)] = pack_bf16(p0, p1);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = l[r] * corr[r] + rsum[r];
    }
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += P V over this warp's output columns
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) {
        const bf16* vb = vt + (ds * SL + 8 * j + g) * kVS + kk * 16 + 2 * tg;
        mma_bf16(acc[j], pa[kk], ld32(vb), ld32(vb + 8));
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rg * 16 + g + 8 * r;
    if (row >= sq) continue;
    if (lse != nullptr && ds == 0 && tg == 0)
      lse[(long)blockIdx.y * sq + row] = kLn2 * (m[r] + log2f(l[r]));
    bf16* orow = o + qbase + (long)row * rs;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      const int c = ds * SL + 8 * j + 2 * tg;
      if (c < d) orow[c] = __float2bfloat16(acc[j][2 * r] / l[r]);
      if (c + 1 < d) orow[c + 1] = __float2bfloat16(acc[j][2 * r + 1] / l[r]);
    }
  }
}

template <int NK, int DS>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int batch, int heads, int sq, int sk, int d, float scale,
                       cudaStream_t st) {
  constexpr int bytes = mma_smem_bytes<NK, DS>();
  static_assert(bytes <= 232448, "tile exceeds the H100's shared memory per block");
  auto kernel = flash_fwd_mma<NK, DS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  kernel<<<grid, 32 * kRG * DS, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, heads, sq, sk, d, scale * kLog2e, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                          int batch, int heads, int sq, int sk, int d, float scale,
                          cudaStream_t st) {
  const int ds = d <= 128 ? 1 : d <= 256 ? 2 : 4;
  const int nk = (d + 16 * ds - 1) / (16 * ds);
#define LDT_CASE(DS, NK) \
  if (ds == DS && nk == NK)                                                   \
    return launch_mma<NK, DS>(q, k, v, o, lse, batch, heads, sq, sk, d, scale, st);
  LDT_CASE(1, 1) LDT_CASE(1, 2) LDT_CASE(1, 3) LDT_CASE(1, 4)
  LDT_CASE(1, 5) LDT_CASE(1, 6) LDT_CASE(1, 7) LDT_CASE(1, 8)
  LDT_CASE(2, 5) LDT_CASE(2, 6) LDT_CASE(2, 7) LDT_CASE(2, 8)
  LDT_CASE(4, 5) LDT_CASE(4, 6) LDT_CASE(4, 7) LDT_CASE(4, 8)
#undef LDT_CASE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16: tx walks columns, ty walks rows
constexpr int kBK = 32;        // key/value rows per tile
constexpr int kKS = kBK + 1;   // padded row stride of K^T and P tiles (no bank conflicts)

template <int BQ, int DP>
constexpr int smem_floats() {
  return DP * BQ + DP * kKS + kBK * DP + BQ * kKS;
}

// NI: query rows per thread (BQ = 16*NI). NJ: head-dim columns per thread
// (D padded to DP = 16*NJ; padding is zero in Q/K/V and never written out).
template <int NI, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int heads, int sq, int sk, int d, float scale2) {
  constexpr int BQ = 16 * NI;
  constexpr int DP = 16 * NJ;
  constexpr int NC = kBK / 16;  // score columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [DP][BQ]   Q^T
  float* ks = qs + DP * BQ;     // [DP][kKS]  K^T
  float* vs = ks + DP * kKS;    // [kBK][DP]  V
  float* ps = vs + kBK * DP;    // [BQ][kKS]  P

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * BQ;
  const long rs = (long)heads * d;  // stride between sequence positions
  const long qbase = (long)b * sq * rs + (long)h * d;
  const long kbase = (long)b * sk * rs + (long)h * d;

  for (int e = tid; e < BQ * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    float val = 0.f;
    if (q0 + r < sq && c < d) val = q[qbase + (long)(q0 + r) * rs + c];
    qs[c * BQ + r] = val;
  }

  float acc[NI][NJ];
  float m[NI], l[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (sk + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int e = tid; e < kBK * DP; e += kThreads) {
      const int r = e / DP, c = e % DP;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < sk && c < d) {
        const long off = kbase + (long)(k0 + r) * rs + c;
        kv = k[off];
        vv = v[off];
      }
      ks[c * kKS + r] = kv;
      vs[r * DP + c] = vv;
    }
    __syncthreads();

    float s[NI][NC];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float qv[NI], kv[NC];
#pragma unroll
      for (int i = 0; i < NI; ++i) qv[i] = qs[dd * BQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) kv[j] = ks[dd * kKS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Online softmax. A row's kBK scores are spread over the 16 lanes that
    // share ty (one half-warp), so row reductions are xor-shuffles over 16.
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const bool valid = k0 + tx + 16 * j < sk;
        s[i][j] = valid ? s[i][j] * scale2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        rsum += p;
        ps[(ty + 16 * i) * kKS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[NI], vv[NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i) pv[i] = ps[(ty + 16 * i) * kKS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    if (lse != nullptr && tx == 0) lse[(long)blockIdx.y * sq + r] = kLn2 * (m[i] + log2f(l[i]));
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[qbase + (long)r * rs + c] = acc[i][j] / l[i];
    }
  }
}

template <int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int batch, int heads, int sq, int sk, int d, float scale,
                       cudaStream_t stream) {
  constexpr int NI = NJ > 16 ? 2 : 4;
  constexpr int BQ = 16 * NI;
  constexpr int bytes = smem_floats<BQ, 16 * NJ>() * (int)sizeof(float);
  static_assert(bytes <= 232448, "tile exceeds the H100's shared memory per block");
  auto kernel = flash_fwd_f32<NI, NJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, batch * heads);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, heads, sq, sk, d, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                         int batch, int heads, int sq, int sk, int d, float scale,
                         cudaStream_t st) {
  const int nj = (d + 15) / 16;
#define LDT_CASE(N) \
  if (nj <= N) return launch_f32<N>(q, k, v, o, lse, batch, heads, sq, sk, d, scale, st);
  LDT_CASE(1)
  LDT_CASE(2)
  LDT_CASE(3)
  LDT_CASE(4)
  LDT_CASE(5)
  LDT_CASE(6)
  LDT_CASE(8)
  LDT_CASE(10)
  LDT_CASE(12)
  LDT_CASE(16)
  LDT_CASE(32)
#undef LDT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: null, or (B, H, Sq) float32 for the
// per-row logsumexp. Returns a cudaError_t (0 on success).
extern "C" int ldt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       void* o, void* lse, int batch, int heads, int sq,
                                       int sk, int d, float scale, int dtype, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || d < 1 || d > 512 ||
      batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return (int)dispatch_f32(q, k, v, o, l, batch, heads, sq, sk, d, scale, st);
  if (dtype == 1) return (int)dispatch_bf16(q, k, v, o, l, batch, heads, sq, sk, d, scale, st);
  return (int)cudaErrorInvalidValue;
}
