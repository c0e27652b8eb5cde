// Forward flash attention for Hopper (sm_90a) with TMA and wgmma:
// softmax(Q K^T * scale) V in bf16, and optionally each row's logsumexp.
//
// Replaces the Pallas forwards of ldiffusion_tpu/ops/attention.py:
// `_flash_kernel` (:41, K1), `_flash_kvgrid_kernel` (:102, K2) and
// `_flash_kernel_lse` (:180, K5), with the exp2 softmax of
// tools/bench_attn_exp2.py `_kernel` (:29, K7). It is the "wgmma" route of
// ops/attention.py `fwd_route`: bf16, d % 8 == 0, d <= 512, 16-byte-aligned
// q/k/v. The other bf16 shapes keep `flash_fwd_mma` and f32 keeps
// `flash_fwd_f32` (flash_attention.cu).
//
// Layout: q, k, v, o are (B, S, H, D) contiguous, as the model's projections
// produce them. Each of q, k, v is a 4-D tensor map, innermost first
// (D, H, S, B) with byte strides 2d, 2Hd, 2SHd; a box is (CW, 1, rows, 1):
// one swizzle atom of CW head-dim columns for `rows` positions of one head.
// TMA writes zeros past d and past S, so the padded head-dim columns and the
// ragged tails cost no branch; keys past sk are still masked to -inf before
// the max. lse, when not null, is (B, H, Sq) f32 in natural log.
//
// What bounds it: 4*B*H*Sq*Sk*D operations on a few MB of input, far above
// the card's ~295 operations per byte at every shape of the model, so the
// bound is the tensor-core rate (989 TFLOP/s bf16). Next come the softmax's
// exp2 on the SFU (16 a clock per SM) and its FP32 bookkeeping, which at
// d = 40 cost about as much as both products.
//
// The design, against what held back the mma.sync kernel (flash_fwd_mma):
//  1. Synchronous loads, no overlap: a producer warpgroup (one thread of it
//     issues) keeps a ring of 2-4 K/V stages in flight with TMA; full/empty
//     mbarriers hand stages to the consumers and back. Q is loaded once.
//     Inside each consumer warpgroup P V overlaps the softmax: S_t is issued,
//     then P V_{t-1}, and tile t's softmax runs while P V_{t-1} is in flight
//     (FlashAttention-3's order; every configuration but the d > 256 split,
//     where the serial order measured faster).
//  2. V transposed element by element into shared memory: V stays as TMA
//     wrote it (keys x head dim); O += P V reads it MN-major through the
//     instruction's transpose of B.
//  3. Fragments built from 32-bit shared loads, Q re-read every tile: wgmma
//     reads Q and K from shared memory through descriptors; no fragment is
//     assembled by hand.
//  4. mma.sync is Ampere's instruction: both products are wgmma (m64nNk16,
//     bf16 in, f32 accumulate). S = Q K^T takes Q and K K-major; P stays in
//     registers (the S accumulator of n-blocks 2kk, 2kk+1 is, element for
//     element, the A fragment of k-step kk), rounded to bf16 where the Pallas
//     kernel casts p; l sums the unrounded f32 p.
//  5. Small tiles: two consumer warpgroups each own 64 query rows (128 a
//     CTA) over key tiles of 128 keys (DP <= 80) or 64 (DP <= 256), 8 or 4
//     times the scores of one step of the mma.sync kernel (64 x 32); the row
//     max and sum use two partials each, to shorten chains of dependent
//     operations. Registers set the tile: setmaxnreg gives each consumer
//     thread 240 (ptxas compiles the consumer code within that budget), and
//     O (DP/2 f32), S (BK/2 f32), P (BK/4 bf16 pairs) and the softmax's
//     temporaries must fit: 128-key tiles spill above DP = 80.
//  6. d = 512's exchange of partial scores every tile: above d = 256 the two
//     consumer warpgroups share the same 64 rows and split O's columns (256
//     each). Each recomputes the full S = Q K^T over all of d rather than
//     exchanging partial sums: no shared-memory round trip and no barrier
//     between the warpgroups on any tile, for 1.5x the tensor-core work of
//     one S and one P V (S and P V each cost 64 x BK x d MACs per row block).
//     Key tiles are 32 keys there, so Q (64 KB) and two K/V stages (64 KB
//     each) fit the 227 KB of shared memory.
//
// Head-dim padding: DP = d rounded up to 16 (d <= 256) or to 384 / 512 (the
// split); the swizzle width is the widest whose atom divides DP (128 B when
// DP % 64 == 0, 64 B when DP % 32 == 0, else 32 B), so no column is padded
// beyond the 16 a k-step needs. SD-v1.5's head dims: 40 -> 48 (32 B), 80 ->
// 80 (32 B), 160 -> 160 (64 B), 512 -> 512 (128 B, split).
//
// The softmax runs in base 2 with log2(e) folded into the scale: m is a
// base-2 running max, p = exp2(s*scale*log2(e) - m), the accumulator is
// rescaled by exp2(m_old - m_new), and lse = ln 2 * (m + log2 l).
//
// Not yet done (performance work for later): ping-pong scheduling of the two
// consumer warpgroups, TMA stores of O, the d = 512 split's registers (ptxas
// spills and serialises its wgmmas: C7512).
#include "flash_common.cuh"

namespace {

constexpr int kSmemMax = 232448;  // H100, bytes of dynamic shared memory a block may use
constexpr int kConsumers = 2;  // consumer warpgroups per CTA (warpgroups 0, 1)
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
// 65536 / 384 threads: 168 registers a thread at launch. setmaxnreg hands the
// producer's share to the consumers: 128 x (168 - 24) freed = 256 x (240 -
// 168) taken, exactly the pool. (An increase the pool cannot serve waits
// forever: keep the three numbers balanced.)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// One compiled configuration: DP padded head-dim columns; SPLIT: the two
// consumer warpgroups share 64 rows and split O's columns (d > 256).
// Mirrored by ops/attention.py `wgmma_config`.
template <int DP, bool SPLIT>
struct Cfg {
  static constexpr int SW = DP % 64 == 0 ? 128 : DP % 32 == 0 ? 64 : 32;  // swizzle bytes
  static constexpr int CW = SW / 2;                         // head-dim columns per atom
  static constexpr int NCH = DP / CW;                       // atoms across the head dim
  static constexpr int BQ = SPLIT ? 64 : 64 * kConsumers;   // query rows per CTA
  static constexpr int OW = SPLIT ? DP / kConsumers : DP;   // O columns per warpgroup
  static constexpr int BK = SPLIT ? 32 : DP <= 80 ? 128 : 64;  // keys per K/V tile
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int TILE_BYTES = BK * DP * 2;            // one K or one V tile
  static constexpr int FIXED = 1024 + Q_BYTES + 256;        // alignment slack, Q, barriers
  static constexpr int STAGES = cmin(4, (kSmemMax - FIXED) / (2 * TILE_BYTES));
  static constexpr int SMEM = FIXED + STAGES * 2 * TILE_BYTES;
  static_assert(DP % 16 == 0 && DP % CW == 0 && OW % CW == 0, "head-dim padding");
  static_assert(STAGES >= 2, "the K/V ring needs two stages");
  static_assert(SMEM <= kSmemMax, "tiles exceed the H100's shared memory per block");
  static_assert((1 + 2 * STAGES) * 8 <= 256, "barrier space");
};

// One consumer warpgroup: 64 query rows x OW output columns, its online
// softmax state, and the two products of a key tile.
template <int DP, bool SPLIT>
struct Consumer {
  using C = Cfg<DP, SPLIT>;
  static constexpr int SW = C::SW, CW = C::CW, BK = C::BK, OW = C::OW;
  static constexpr uint32_t SBO = 8 * SW;  // between 8-row groups of an atom

  float acc[OW / 2];  // O: n-block j holds columns col0 + 8j + 2tg (+1)
  float m[2], l[2], corr[2];  // rows g and g + 8 of this thread's warp
  uint32_t pa[BK / 16][4];    // P as the A fragments of the BK/16 k-steps of P V
  uint32_t q_addr, kv_addr;   // this warpgroup's Q rows; stage 0 of the K/V ring
  int col0, tg, sk;
  float scale2;

  __device__ __forceinline__ uint32_t k_addr(int t) const {
    return kv_addr + (t % C::STAGES) * 2 * C::TILE_BYTES;
  }

  // S (64 x BK) = Q K_t^T, 16 head-dim columns a k-step; committed as one
  // wgmma group, not waited for.
  __device__ __forceinline__ void issue_s(float* sc, int t) const {
    const uint64_t qd = fresh_desc<SW>(q_addr, 16, SBO);
    const uint64_t kd = fresh_desc<SW>(k_addr(t), 16, SBO);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t in_atom = (kk * 16 % CW) * 2, atom = kk * 16 / CW;
      wgmma_ss<BK>(sc, qd + ((atom * C::BQ * SW + in_atom) >> 4),
                   kd + ((atom * BK * SW + in_atom) >> 4), kk > 0);
    }
    wgmma_commit();
  }

  // Online softmax of tile t's scores, in place: sc becomes p = exp2(s *
  // scale2 - m); m, l and corr = exp2(m_old - m_new) move on. Row g's scores
  // sit in the 4 lanes of a quad, so row reductions are xor-shuffles over 1, 2.
  __device__ __forceinline__ void softmax(float* sc, int t) {
    const int k0 = t * BK;
    if (k0 + BK > sk) {  // the last tile: keys past sk (zeros from TMA) are masked
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * tg + (e & 1) >= sk) sc[4 * j + e] = -INFINITY;
    }
    // NP partial maxima and sums a row, so no chain of dependent ops is
    // longer than BK / (4 NP)
    constexpr int NP = 2;
    float mp[NP][2], sp[NP][2];
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mp[i][r] = -INFINITY;
        sp[i][r] = 0.f;
      }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] *= scale2;
        mp[j % NP][e >> 1] = fmaxf(mp[j % NP][e >> 1], sc[4 * j + e]);
      }
    float mx[2], rsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = mp[0][r];
#pragma unroll
      for (int i = 1; i < NP; ++i) mx[r] = fmaxf(mx[r], mp[i][r]);
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile has a valid key
      corr[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = ex2(sc[4 * j + e] - m[e >> 1]);
        sp[j % NP][e >> 1] += sc[4 * j + e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] = sp[0][r];
#pragma unroll
      for (int i = 1; i < NP; ++i) rsum[r] += sp[i][r];
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = l[r] * corr[r] + rsum[r];
    }
  }


  // O *= corr, then O += P V_t over this warpgroup's columns, committed as
  // one wgmma group, not waited for.
  __device__ __forceinline__ void issue_pv(int t) {
#pragma unroll
    for (int j = 0; j < OW / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    reg_fence<OW / 2>(acc);
    const uint64_t vd = fresh_desc<SW>(k_addr(t) + C::TILE_BYTES + (col0 / CW) * BK * SW,
                                       BK * SW, SBO);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      pv_pieces<SW, BK, OW, 0>(acc, pa[kk], vd + ((kk * 16 * SW) >> 4));
    wgmma_commit();
  }
};

// scale2 = scale * log2(e).
template <int DP, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                float* __restrict__ lse, int heads, int sq, int sk, int d, float scale2) {
  using C = Cfg<DP, SPLIT>;
  constexpr int SW = C::SW, CW = C::CW, NCH = C::NCH, BK = C::BK, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // every atom starts on 1024 bytes, a multiple of each swizzle's period
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kv = qs + C::Q_BYTES;  // stage s: K atoms, then V atoms
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv + ST * 2 * C::TILE_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * C::BQ;
  const int n_tiles = (sk + BK - 1) / BK;
  // warp-uniform for the compiler: warpgroups 0 and 1 consume, 2 produces
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every TMA load
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c) tma_load_4d(qs + c * C::BQ * SW, &qmap, qbar, c * CW, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);  // both warpgroups are done with it
        mbar_expect_tx(&full[s], 2 * C::TILE_BYTES);
        unsigned char* ks = kv + s * 2 * C::TILE_BYTES;
        unsigned char* vs = ks + C::TILE_BYTES;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(ks + c * BK * SW, &kmap, &full[s], c * CW, h, t * BK, b);
          tma_load_4d(vs + c * BK * SW, &vmap, &full[s], c * CW, h, t * BK, b);
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    const int wi = wg;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, g = (tid % 32) / 4;
    const int row0 = SPLIT ? 0 : 64 * wi;  // this warpgroup's rows in the CTA's block
    Consumer<DP, SPLIT> w;
    w.col0 = SPLIT ? C::OW * wi : 0;  // and its output columns
    w.tg = tid % 4;
    w.sk = sk;
    w.scale2 = scale2;
    w.q_addr = smem_u32(qs) + row0 * SW;
    w.kv_addr = smem_u32(kv);
#pragma unroll
    for (int i = 0; i < C::OW / 2; ++i) w.acc[i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      w.m[r] = -INFINITY;
      w.l[r] = 0.f;
    }
    mbar_wait(qbar, 0);

    float sc[BK / 2];
    if constexpr (SPLIT) {
      // d > 256: one tile at a time, each stage released as soon as its P V
      // is done (the overlapped order below measured slower here: S over all
      // of d dominates each tile)
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(&full[t % ST], (t / ST) & 1);
        w.issue_s(sc, t);
        wgmma_wait<0>();
        reg_fence<BK / 2>(sc);
        w.softmax(sc, t);
        pack_a<BK>(w.pa, sc);
        w.issue_pv(t);
        wgmma_wait<0>();
        reg_fence<C::OW / 2>(w.acc);
        mbar_arrive(&empty[t % ST]);
      }
    } else {
      // S_t is issued, then P V_{t-1}; tile t's softmax runs while P V_{t-1}
      // is in flight. wgmma groups complete in order, so wait<1> finds S_t
      // done and wait<0> P V_{t-1}; only after it are O, P and stage t-1
      // free. One S tile (f32) and one P tile (bf16) are live.
      mbar_wait(&full[0], 0);
      w.issue_s(sc, 0);
      wgmma_wait<0>();
      reg_fence<BK / 2>(sc);
      w.softmax(sc, 0);
      pack_a<BK>(w.pa, sc);
      for (int t = 1; t < n_tiles; ++t) {
        mbar_wait(&full[t % ST], (t / ST) & 1);
        w.issue_s(sc, t);
        w.issue_pv(t - 1);
        wgmma_wait<1>();
        reg_fence<BK / 2>(sc);
        w.softmax(sc, t);
        wgmma_wait<0>();
        reg_fence<C::OW / 2>(w.acc);
        mbar_arrive(&empty[(t - 1) % ST]);
        pack_a<BK>(w.pa, sc);
      }
      w.issue_pv(n_tiles - 1);
    }
    wgmma_wait<0>();
    reg_fence<C::OW / 2>(w.acc);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + 16 * warp + g + 8 * r;
      if (row >= sq) continue;
      if (lse != nullptr && w.tg == 0 && w.col0 == 0)
        lse[(long)blockIdx.y * sq + row] = kLn2 * (w.m[r] + log2f(w.l[r]));
      const float inv = 1.f / w.l[r];
      bf16* orow = o + (((long)b * sq + row) * heads + h) * d;
#pragma unroll
      for (int j = 0; j < C::OW / 8; ++j) {
        const int c = w.col0 + 8 * j + 2 * w.tg;  // even, and d is a multiple of 8
        if (c < d)
          *reinterpret_cast<uint32_t*>(orow + c) =
              pack_bf16(w.acc[4 * j + 2 * r] * inv, w.acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <int DP, bool SPLIT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                   int heads, int sq, int sk, int d, float scale, cudaStream_t st) {
  using C = Cfg<DP, SPLIT>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, batch, heads, sq, d, C::CW, C::BQ, C::SW) ||
      !make_map(&km, k, batch, heads, sk, d, C::CW, C::BK, C::SW) ||
      !make_map(&vm, v, batch, heads, sk, d, C::CW, C::BK, C::SW))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma<DP, SPLIT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, batch * heads);
  kernel<<<grid, kThreads, C::SMEM, st>>>(qm, km, vm, static_cast<bf16*>(o), lse, heads, sq, sk,
                                          d, scale * kLog2e);
  return cudaGetLastError();
}

// Expands CASE(DP, SPLIT) for the configuration of head dim d (d % 8 == 0,
// <= 512): DP = d rounded up to 16 up to 256, then the split at 384 or 512.
#define LDT_WGMMA_CONFIGS(d, CASE)                                                  \
  if ((d) > 384) CASE(512, true)                                                    \
  if ((d) > 256) CASE(384, true)                                                    \
  switch (((d) + 15) / 16) {                                                        \
    case 1: CASE(16, false) case 2: CASE(32, false) case 3: CASE(48, false)         \
    case 4: CASE(64, false) case 5: CASE(80, false) case 6: CASE(96, false)         \
    case 7: CASE(112, false) case 8: CASE(128, false) case 9: CASE(144, false)      \
    case 10: CASE(160, false) case 11: CASE(176, false) case 12: CASE(192, false)   \
    case 13: CASE(208, false) case 14: CASE(224, false) case 15: CASE(240, false)   \
    case 16: CASE(256, false)                                                       \
  }

bool takes(int d) { return d >= 8 && d <= 512 && d % 8 == 0; }

}  // namespace

// The "wgmma" route: bf16 q/k/v (B, S, H, D) contiguous, d % 8 == 0, d <= 512,
// q/k/v 16-byte aligned. lse: null, or (B, H, Sq) float32. Returns a
// cudaError_t (0 on success); cudaErrorInvalidValue for a shape this route
// does not take, cudaErrorNotSupported where the driver has no tensor maps.
extern "C" int ldt_flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                             void* o, void* lse, int batch, int heads, int sq,
                                             int sk, int d, float scale, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || !takes(d) || batch * heads > 65535 ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) != 0 || ((uintptr_t)o & 3) != 0)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define LDT_LAUNCH(DP, SPLIT) \
  return (int)launch<DP, SPLIT>(q, k, v, o, l, batch, heads, sq, sk, d, scale, st);
  LDT_WGMMA_CONFIGS(d, LDT_LAUNCH)
#undef LDT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the configuration that runs head dim d, or -1
// (ops/attention.py `wgmma_smem_bytes` mirrors it).
extern "C" int ldt_flash_attention_fwd_wgmma_smem(int d) {
  if (!takes(d)) return -1;
#define LDT_SMEM(DP, SPLIT) return Cfg<DP, SPLIT>::SMEM;
  LDT_WGMMA_CONFIGS(d, LDT_SMEM)
#undef LDT_SMEM
  return -1;
}
