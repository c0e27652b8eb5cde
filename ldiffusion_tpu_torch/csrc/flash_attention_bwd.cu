// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q K^T * scale) V from recomputed probabilities.
//
// Replaces the Pallas kernel of the JAX package,
// ldiffusion_tpu/ops/attention.py `_flash_bwd_kernel` (:245, called from
// `_flash_backward_bhsd` :310). With lse = logsumexp of a query row's scaled
// scores (written by the forward) and Delta = rowsum(dO o O) (computed by the
// caller, as the JAX package computes it outside its kernel, :395):
//
//     P = exp(S*scale - lse)         dV = P^T dO       dP = dO V^T
//     dS = P o (dP - Delta) * scale  dK = dS^T Q       dQ = dS K
//
// No S x S matrix is materialised. On the TPU a sequential grid over K/V
// blocks carried dQ in a VMEM scratch from step to step (:293-305); CUDA
// blocks run in no order, and summing dQ across blocks with float atomics
// would change the result from run to run. So the backward is two kernels,
// each the owner of what it sums, with nothing summed across blocks:
//
//   dkdv: a CTA owns a tile of keys of one (batch, head), walks every query
//         tile, and keeps dK and dV in registers;
//   dq:   a CTA owns a tile of query rows, walks every key tile, and keeps dQ
//         in registers.
//
// Both recompute S and dP; that is 2 of the 7 products more than one kernel
// with atomics would do, the price of a deterministic result.
//
// Layout: q, k, v, dO, dq, dk, dv are (B, S, H, D) contiguous as in the
// forward; lse and Delta are (B, H, Sq) float32.
//
// What bounds it: 10*B*H*Sq*Sk*D operations (the JAX cost estimate, :333)
// on a few MB of inputs, far above the card's ~295 operations per byte, so
// the tensor-core rate bounds it, as the forward.
//
// bf16 (`flash_bwd_dkdv_mma`, `flash_bwd_dq_mma`): mma.sync m16n8k16 with f32
// accumulation, the forward's fragment helpers (flash_common.cuh). Each warp
// owns 16 rows (keys in dkdv, queries in dq). A product's B operand must be
// read as 32-bit pairs along its k dimension, so each tile that is read along
// both of its axes is staged twice in shared memory, row-major and transposed
// (Q and dO in dkdv, K in dq). Probabilities and dS go from the accumulator
// fragments of S and dP straight to the A fragments of the next products,
// rounded to bf16 as the Pallas kernel casts them (p to dO's dtype, dS to
// Q's); dS itself is formed from the unrounded f32 P, as there.
//
// Head dims: d <= 160 (SD-v1.5's 40, 80 and 160). A warp keeps 16 rows of dK
// and dV in f32, d/2 registers a thread each: 160 at d = 160, near the
// 255-register limit, so d > 160 (the VAE's single-head d = 512) is refused;
// the caller differentiates that attention with a plain recomputed backward,
// as the JAX package keeps the XLA vjp for its kvgrid kernel (:416-422).
//
// f32 (`flash_bwd_dkdv_f32`, `flash_bwd_dq_f32`): plain FMAs from shared
// memory, as the forward's f32 kernel, so f32 inputs keep f32 products.
//
// Softmax in base 2 (K7's formulation): P = exp2(S*scale*log2(e) -
// lse*log2(e)).
//
// The bf16 shapes TMA can address (d % 8 == 0, aligned pointers) go to the
// Hopper redesign, flash_bwd_wgmma.cu (the "wgmma" route of ops/attention.py
// `bwd_route`); the kernels here keep the "mma" route (d % 8 != 0, unaligned
// views) and the "f32" route.
#include "flash_common.cuh"

namespace {

constexpr int kSmemLimit = 232448;  // H100: dynamic shared memory per block

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kDkvKeys = 16 * kWarps;   // keys per dkdv CTA
constexpr int kDqRows = 16 * kWarps;    // query rows per dq CTA
constexpr int kDqKeys = 32;             // keys per dq K/V tile

// query rows per dkdv inner tile: 64 up to d = 80, 32 above (fewer score
// registers beside the larger dK/dV accumulators)
template <int NK>
__host__ __device__ constexpr int dkdv_bq() {
  return NK <= 5 ? 64 : 32;
}

template <int NK>
constexpr int dkdv_smem_bytes() {
  constexpr int DP = 16 * NK, RS = DP + 8, BQ = dkdv_bq<NK>(), TS = BQ + 8;
  return (2 * kDkvKeys * RS + 2 * BQ * RS + 2 * DP * TS) * 2 + 2 * BQ * 4;
}

template <int NK>
constexpr int dq_smem_bytes() {
  constexpr int DP = 16 * NK, RS = DP + 8, TS = kDqKeys + 8;
  return (2 * kDqRows * RS + 2 * kDqKeys * RS + DP * TS) * 2;
}

// NK: 16-column k-steps of the (padded) head dim, DP = 16*NK >= d.
template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq, int sk,
                   int d, float scale, int vec) {
  constexpr int DP = 16 * NK;
  constexpr int RS = DP + 8;           // row stride of row-major tiles
  constexpr int BQ = dkdv_bq<NK>();
  constexpr int TS = BQ + 8;           // row stride of transposed tiles
  constexpr int NB = BQ / 8;           // 8-query n-blocks of S^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kDkvKeys][RS]
  bf16* vs = ks + kDkvKeys * RS;                 // [kDkvKeys][RS]
  bf16* qs = vs + kDkvKeys * RS;                 // [BQ][RS]
  bf16* os = qs + BQ * RS;                       // [BQ][RS]   dO
  bf16* qt = os + BQ * RS;                       // [DP][TS]   Q^T
  bf16* ot = qt + DP * TS;                       // [DP][TS]   dO^T
  float* lse_s = reinterpret_cast<float*>(ot + DP * TS);  // [BQ] lse*log2(e), +inf past sq
  float* dlt_s = lse_s + BQ;                               // [BQ] Delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kDkvKeys;
  const long rs = (long)heads * d;
  const long qbase = (long)b * sq * rs + (long)h * d;
  const long kbase = (long)b * sk * rs + (long)h * d;
  const long rowbase = (long)blockIdx.y * sq;
  const float scale2 = scale * kLog2e;

  load_tile<DP, kMmaThreads, false>(ks, RS, k + kbase, rs, k0, kDkvKeys, sk, d, vec);
  load_tile<DP, kMmaThreads, false>(vs, RS, v + kbase, rs, k0, kDkvKeys, sk, d, vec);
  const bf16* kw = ks + warp * 16 * RS;  // this warp's 16 keys
  const bf16* vw = vs + warp * 16 * RS;
  const bool key_ok[2] = {k0 + warp * 16 + g < sk, k0 + warp * 16 + g + 8 < sk};

  float dka[2 * NK][4], dva[2 * NK][4];  // rows g, g+8; columns 8j + 2tg + {0, 1}
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int n_tiles = (sq + BQ - 1) / BQ;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous query tile is no longer read
    load_tile<DP, kMmaThreads, false>(qs, RS, q + qbase, rs, q0, BQ, sq, d, vec);
    load_tile<DP, kMmaThreads, false>(os, RS, dout + qbase, rs, q0, BQ, sq, d, vec);
    load_tile<DP, kMmaThreads, true>(qt, TS, q + qbase, rs, q0, BQ, sq, d, vec);
    load_tile<DP, kMmaThreads, true>(ot, TS, dout + qbase, rs, q0, BQ, sq, d, vec);
    for (int i = threadIdx.x; i < BQ; i += kMmaThreads) {
      const bool ok = q0 + i < sq;
      lse_s[i] = ok ? lse[rowbase + q0 + i] * kLog2e : INFINITY;
      dlt_s[i] = ok ? delta[rowbase + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries
    float st[NB][4], dpt[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, kw, RS, kk * 16, g, tg);
      load_a(av, vw, RS, kk * 16, g, tg);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mma_rows(st[j], ak, qs, RS, 8 * j, kk * 16, g, tg);
        mma_rows(dpt[j], av, os, RS, 8 * j, kk * 16, g, tg);
      }
    }

    // P^T and dS^T; element e of n-block j: key row g + 8*(e>>1), query
    // column 8j + 2tg + (e&1)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tg + (e & 1);
        const float p = key_ok[e >> 1] ? exp2f(st[j][e] * scale2 - lse_s[col]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dlt_s[col]) * scale;
      }

    // dV += P^T dO and dK += dS^T Q: k dimension = the BQ queries
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], as[4];
      c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
      c_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) {
        mma_rows(dva[j], ap, ot, TS, 8 * j, kk * 16, g, tg);
        mma_rows(dka[j], as, qt, TS, 8 * j, kk * 16, g, tg);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + 8 * r;
    if (row >= sk) continue;
    bf16* krow = dk + kbase + (long)row * rs;
    bf16* vrow = dv + kbase + (long)row * rs;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      const int c = 8 * j + 2 * tg;
      if (c < d) {
        krow[c] = __float2bfloat16(dka[j][2 * r]);
        vrow[c] = __float2bfloat16(dva[j][2 * r]);
      }
      if (c + 1 < d) {
        krow[c + 1] = __float2bfloat16(dka[j][2 * r + 1]);
        vrow[c + 1] = __float2bfloat16(dva[j][2 * r + 1]);
      }
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int heads, int sq, int sk, int d, float scale, int vec) {
  constexpr int DP = 16 * NK;
  constexpr int RS = DP + 8;
  constexpr int TS = kDqKeys + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kDqRows][RS]
  bf16* os = qs + kDqRows * RS;                  // [kDqRows][RS]  dO
  bf16* ks = os + kDqRows * RS;                  // [kDqKeys][RS]
  bf16* vs = ks + kDqKeys * RS;                  // [kDqKeys][RS]
  bf16* kt = vs + kDqKeys * RS;                  // [DP][TS]       K^T

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kDqRows;
  const long rs = (long)heads * d;
  const long qbase = (long)b * sq * rs + (long)h * d;
  const long kbase = (long)b * sk * rs + (long)h * d;
  const long rowbase = (long)blockIdx.y * sq;
  const float scale2 = scale * kLog2e;

  load_tile<DP, kMmaThreads, false>(qs, RS, q + qbase, rs, q0, kDqRows, sq, d, vec);
  load_tile<DP, kMmaThreads, false>(os, RS, dout + qbase, rs, q0, kDqRows, sq, d, vec);
  const bf16* qw = qs + warp * 16 * RS;
  const bf16* ow = os + warp * 16 * RS;
  float lse2[2], dl[2];  // rows g, g+8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < sq ? lse[rowbase + row] * kLog2e : INFINITY;
    dl[r] = row < sq ? delta[rowbase + row] : 0.f;
  }

  float dqa[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  const int n_tiles = (sk + kDqKeys - 1) / kDqKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kDqKeys;
    __syncthreads();  // the previous key tile is no longer read
    load_tile<DP, kMmaThreads, false>(ks, RS, k + kbase, rs, k0, kDqKeys, sk, d, vec);
    load_tile<DP, kMmaThreads, false>(vs, RS, v + kbase, rs, k0, kDqKeys, sk, d, vec);
    load_tile<DP, kMmaThreads, true>(kt, TS, k + kbase, rs, k0, kDqKeys, sk, d, vec);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 query rows x 32 keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, qw, RS, kk * 16, g, tg);
      load_a(ao, ow, RS, kk * 16, g, tg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_rows(s[j], aq, ks, RS, 8 * j, kk * 16, g, tg);
        mma_rows(dp[j], ao, vs, RS, 8 * j, kk * 16, g, tg);
      }
    }

    // dS; element e of n-block j: query row g + 8*(e>>1), key 8j + 2tg + (e&1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = k0 + 8 * j + 2 * tg + (e & 1) < sk;
        const float p = ok ? exp2f(s[j][e] * scale2 - lse2[r]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[r]) * scale;
      }

    // dQ += dS K: k dimension = the 32 keys
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t as[4];
      c_to_a(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) mma_rows(dqa[j], as, kt, TS, 8 * j, kk * 16, g, tg);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= sq) continue;
    bf16* qrow = dq + qbase + (long)row * rs;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      const int c = 8 * j + 2 * tg;
      if (c < d) qrow[c] = __float2bfloat16(dqa[j][2 * r]);
      if (c + 1 < d) qrow[c + 1] = __float2bfloat16(dqa[j][2 * r + 1]);
    }
  }
}

template <int NK>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, void* dk, void* dv,
                           int batch, int heads, int sq, int sk, int d, float scale,
                           cudaStream_t st) {
  constexpr int kv_bytes = dkdv_smem_bytes<NK>();
  constexpr int q_bytes = dq_smem_bytes<NK>();
  static_assert(kv_bytes <= kSmemLimit && q_bytes <= kSmemLimit,
                "tile exceeds the H100's shared memory per block");
  auto kv_kernel = flash_bwd_dkdv_mma<NK>;
  auto q_kernel = flash_bwd_dq_mma<NK>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) & 15) == 0;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(dout);
  kv_kernel<<<dim3((sk + kDkvKeys - 1) / kDkvKeys, batch * heads), kMmaThreads, kv_bytes, st>>>(
      qb, kb, vb, ob, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, sq,
      sk, d, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3((sq + kDqRows - 1) / kDqRows, batch * heads), kMmaThreads, q_bytes, st>>>(
      qb, kb, vb, ob, lse, delta, static_cast<bf16*>(dq), heads, sq, sk, d, scale, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: FMA
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;  // 16 x 16: tx walks columns, ty walks rows
constexpr int kFT = 32;           // rows of every f32 tile (keys or queries)
constexpr int kFS = kFT + 1;      // padded stride of transposed tiles (no bank conflicts)

template <int DP>
constexpr int dkdv_f32_floats() {
  // K^T, V^T, Q^T, dO^T, Q, dO, P^T, dS^T, lse, Delta
  return 4 * DP * kFS + 2 * kFT * DP + 2 * kFT * kFS + 2 * kFT;
}

template <int DP>
constexpr int dq_f32_floats() {
  // Q^T, dO^T, K^T, V^T, K, dS
  return 4 * DP * kFS + kFT * DP + kFT * kFS;
}

// NJ: head-dim columns per thread (DP = 16*NJ >= d). A thread owns rows ty
// and ty+16 of the CTA's 32 and columns tx + 16j.
template <int NJ>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int heads, int sq, int sk,
                   int d, float scale) {
  constexpr int DP = 16 * NJ;
  extern __shared__ float smem[];
  float* kt = smem;              // [DP][kFS]  K^T
  float* vt = kt + DP * kFS;     // [DP][kFS]  V^T
  float* qt = vt + DP * kFS;     // [DP][kFS]  Q^T
  float* ot = qt + DP * kFS;     // [DP][kFS]  dO^T
  float* qs = ot + DP * kFS;     // [kFT][DP]  Q
  float* os = qs + kFT * DP;     // [kFT][DP]  dO
  float* pt = os + kFT * DP;     // [kFT][kFS] P^T  (key, query)
  float* st = pt + kFT * kFS;    // [kFT][kFS] dS^T
  float* lse_s = st + kFT * kFS; // [kFT] lse*log2(e)
  float* dlt_s = lse_s + kFT;    // [kFT]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int k0 = blockIdx.x * kFT;
  const long rs = (long)heads * d;
  const long qbase = (long)b * sq * rs + (long)h * d;
  const long kbase = (long)b * sk * rs + (long)h * d;
  const long rowbase = (long)blockIdx.y * sq;
  const float scale2 = scale * kLog2e;

  load_tile_f32<DP, kFmaThreads, true>(kt, kFS, k + kbase, rs, k0, kFT, sk, d);
  load_tile_f32<DP, kFmaThreads, true>(vt, kFS, v + kbase, rs, k0, kFT, sk, d);

  float dka[2][NJ], dva[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int n_tiles = (sq + kFT - 1) / kFT;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kFT;
    __syncthreads();  // the previous query tile is no longer read
    load_tile_f32<DP, kFmaThreads, true>(qt, kFS, q + qbase, rs, q0, kFT, sq, d);
    load_tile_f32<DP, kFmaThreads, true>(ot, kFS, dout + qbase, rs, q0, kFT, sq, d);
    load_tile_f32<DP, kFmaThreads, false>(qs, DP, q + qbase, rs, q0, kFT, sq, d);
    load_tile_f32<DP, kFmaThreads, false>(os, DP, dout + qbase, rs, q0, kFT, sq, d);
    if (threadIdx.x < kFT) {
      const bool ok = q0 + threadIdx.x < sq;
      lse_s[threadIdx.x] = ok ? lse[rowbase + q0 + threadIdx.x] * kLog2e : INFINITY;
      dlt_s[threadIdx.x] = ok ? delta[rowbase + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    // S^T (keys ty+16i, queries tx+16j) and dP^T
    float s[2][2], dp[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      const float k0v = kt[dd * kFS + ty], k1v = kt[dd * kFS + ty + 16];
      const float v0v = vt[dd * kFS + ty], v1v = vt[dd * kFS + ty + 16];
      const float q0v = qt[dd * kFS + tx], q1v = qt[dd * kFS + tx + 16];
      const float o0v = ot[dd * kFS + tx], o1v = ot[dd * kFS + tx + 16];
      s[0][0] = fmaf(k0v, q0v, s[0][0]);
      s[0][1] = fmaf(k0v, q1v, s[0][1]);
      s[1][0] = fmaf(k1v, q0v, s[1][0]);
      s[1][1] = fmaf(k1v, q1v, s[1][1]);
      dp[0][0] = fmaf(v0v, o0v, dp[0][0]);
      dp[0][1] = fmaf(v0v, o1v, dp[0][1]);
      dp[1][0] = fmaf(v1v, o0v, dp[1][0]);
      dp[1][1] = fmaf(v1v, o1v, dp[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = ty + 16 * i, col = tx + 16 * j;
        const float p = k0 + key < sk ? exp2f(s[i][j] * scale2 - lse_s[col]) : 0.f;
        pt[key * kFS + col] = p;
        st[key * kFS + col] = p * (dp[i][j] - dlt_s[col]) * scale;
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's queries
#pragma unroll 4
    for (int c = 0; c < kFT; ++c) {
      const float p0 = pt[ty * kFS + c], p1 = pt[(ty + 16) * kFS + c];
      const float s0 = st[ty * kFS + c], s1 = st[(ty + 16) * kFS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float o = os[c * DP + tx + 16 * j], qv = qs[c * DP + tx + 16 * j];
        dva[0][j] = fmaf(p0, o, dva[0][j]);
        dva[1][j] = fmaf(p1, o, dva[1][j]);
        dka[0][j] = fmaf(s0, qv, dka[0][j]);
        dka[1][j] = fmaf(s1, qv, dka[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        dk[kbase + (long)row * rs + c] = dka[i][j];
        dv[kbase + (long)row * rs + c] = dva[i][j];
      }
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(kFmaThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int heads, int sq, int sk, int d, float scale) {
  constexpr int DP = 16 * NJ;
  extern __shared__ float smem[];
  float* qt = smem;              // [DP][kFS]  Q^T
  float* ot = qt + DP * kFS;     // [DP][kFS]  dO^T
  float* kt = ot + DP * kFS;     // [DP][kFS]  K^T
  float* vt = kt + DP * kFS;     // [DP][kFS]  V^T
  float* ks = vt + DP * kFS;     // [kFT][DP]  K
  float* ss = ks + kFT * DP;     // [kFT][kFS] dS (query, key)

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kFT;
  const long rs = (long)heads * d;
  const long qbase = (long)b * sq * rs + (long)h * d;
  const long kbase = (long)b * sk * rs + (long)h * d;
  const long rowbase = (long)blockIdx.y * sq;
  const float scale2 = scale * kLog2e;

  load_tile_f32<DP, kFmaThreads, true>(qt, kFS, q + qbase, rs, q0, kFT, sq, d);
  load_tile_f32<DP, kFmaThreads, true>(ot, kFS, dout + qbase, rs, q0, kFT, sq, d);
  float lse2[2], dl[2];  // rows ty, ty+16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    lse2[i] = row < sq ? lse[rowbase + row] * kLog2e : INFINITY;
    dl[i] = row < sq ? delta[rowbase + row] : 0.f;
  }
  float dqa[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqa[i][j] = 0.f;

  const int n_tiles = (sk + kFT - 1) / kFT;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFT;
    __syncthreads();  // the previous key tile is no longer read
    load_tile_f32<DP, kFmaThreads, true>(kt, kFS, k + kbase, rs, k0, kFT, sk, d);
    load_tile_f32<DP, kFmaThreads, true>(vt, kFS, v + kbase, rs, k0, kFT, sk, d);
    load_tile_f32<DP, kFmaThreads, false>(ks, DP, k + kbase, rs, k0, kFT, sk, d);
    __syncthreads();

    // S (queries ty+16i, keys tx+16j) and dP
    float s[2][2], dp[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      const float q0v = qt[dd * kFS + ty], q1v = qt[dd * kFS + ty + 16];
      const float o0v = ot[dd * kFS + ty], o1v = ot[dd * kFS + ty + 16];
      const float k0v = kt[dd * kFS + tx], k1v = kt[dd * kFS + tx + 16];
      const float v0v = vt[dd * kFS + tx], v1v = vt[dd * kFS + tx + 16];
      s[0][0] = fmaf(q0v, k0v, s[0][0]);
      s[0][1] = fmaf(q0v, k1v, s[0][1]);
      s[1][0] = fmaf(q1v, k0v, s[1][0]);
      s[1][1] = fmaf(q1v, k1v, s[1][1]);
      dp[0][0] = fmaf(o0v, v0v, dp[0][0]);
      dp[0][1] = fmaf(o0v, v1v, dp[0][1]);
      dp[1][0] = fmaf(o1v, v0v, dp[1][0]);
      dp[1][1] = fmaf(o1v, v1v, dp[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = tx + 16 * j;
        const float p = k0 + key < sk ? exp2f(s[i][j] * scale2 - lse2[i]) : 0.f;
        ss[(ty + 16 * i) * kFS + key] = p * (dp[i][j] - dl[i]) * scale;
      }
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 4
    for (int c = 0; c < kFT; ++c) {
      const float s0 = ss[ty * kFS + c], s1 = ss[(ty + 16) * kFS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[c * DP + tx + 16 * j];
        dqa[0][j] = fmaf(s0, kv, dqa[0][j]);
        dqa[1][j] = fmaf(s1, kv, dqa[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) dq[qbase + (long)row * rs + c] = dqa[i][j];
    }
  }
}

template <int NJ>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, void* dk, void* dv,
                           int batch, int heads, int sq, int sk, int d, float scale,
                           cudaStream_t st) {
  constexpr int kv_bytes = dkdv_f32_floats<16 * NJ>() * (int)sizeof(float);
  constexpr int q_bytes = dq_f32_floats<16 * NJ>() * (int)sizeof(float);
  static_assert(kv_bytes <= kSmemLimit && q_bytes <= kSmemLimit,
                "tile exceeds the H100's shared memory per block");
  auto kv_kernel = flash_bwd_dkdv_f32<NJ>;
  auto q_kernel = flash_bwd_dq_f32<NJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q_bytes);
  if (err != cudaSuccess) return err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *of = static_cast<const float*>(dout);
  kv_kernel<<<dim3((sk + kFT - 1) / kFT, batch * heads), kFmaThreads, kv_bytes, st>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), heads, sq,
      sk, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3((sq + kFT - 1) / kFT, batch * heads), kFmaThreads, q_bytes, st>>>(
      qf, kf, vf, of, lse, delta, static_cast<float*>(dq), heads, sq, sk, d, scale);
  return cudaGetLastError();
}

// The 16-column tile count a head dim runs at: ceil(d/16) rounded up to one
// of the compiled widths (1-6, 8, 10); 0 where d is not taken.
int tiles_for(int d) {
  if (d < 1 || d > 160) return 0;
  const int n = (d + 15) / 16;
  return n <= 6 ? n : n <= 8 ? 8 : 10;
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int N>
constexpr int bwd_smem_bytes(int dtype) {
  return dtype == 1 ? cmax(dkdv_smem_bytes<N>(), dq_smem_bytes<N>())
                    : (int)sizeof(float) * cmax(dkdv_f32_floats<16 * N>(),
                                                dq_f32_floats<16 * N>());
}

}  // namespace

// Shared memory (bytes) of the larger of the two kernels at head dim d, or -1
// where d is not taken; ops/attention.py computes the same numbers for its
// routing gate, and a test holds the two equal on the card.
extern "C" int ldt_flash_attention_bwd_smem(int d, int dtype) {
  switch (tiles_for(d)) {
    case 1: return bwd_smem_bytes<1>(dtype);
    case 2: return bwd_smem_bytes<2>(dtype);
    case 3: return bwd_smem_bytes<3>(dtype);
    case 4: return bwd_smem_bytes<4>(dtype);
    case 5: return bwd_smem_bytes<5>(dtype);
    case 6: return bwd_smem_bytes<6>(dtype);
    case 8: return bwd_smem_bytes<8>(dtype);
    case 10: return bwd_smem_bytes<10>(dtype);
    default: return -1;
  }
}

// dq, dk, dv of one attention call. dtype: 0 = float32, 1 = bfloat16; lse and
// delta are (B, H, Sq) float32. Returns a cudaError_t (0 on success).
extern "C" int ldt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, void* dk, void* dv, int batch, int heads,
                                       int sq, int sk, int d, float scale, int dtype,
                                       void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || tiles_for(d) == 0 ||
      batch * heads > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define LDT_CASE(N)                                                                       \
  case N:                                                                                 \
    return (int)(dtype == 1 ? launch_bwd_mma<N>(q, k, v, dout, l, dl, dq, dk, dv, batch,  \
                                                heads, sq, sk, d, scale, st)              \
                            : launch_bwd_f32<N>(q, k, v, dout, l, dl, dq, dk, dv, batch,  \
                                                heads, sq, sk, d, scale, st));
  switch (tiles_for(d)) {
    LDT_CASE(1) LDT_CASE(2) LDT_CASE(3) LDT_CASE(4) LDT_CASE(5) LDT_CASE(6) LDT_CASE(8)
    LDT_CASE(10)
    default: return (int)cudaErrorInvalidValue;
  }
#undef LDT_CASE
}
