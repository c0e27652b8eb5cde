// Flash-attention backward for Hopper (sm_90a) with TMA and wgmma: dQ, dK,
// dV of O = softmax(Q K^T * scale) V in bf16, from recomputed probabilities.
//
// Replaces the Pallas kernel of the JAX package,
// ldiffusion_tpu/ops/attention.py `_flash_bwd_kernel` (:245, called from
// `_flash_backward_bhsd` :310), with the exp2 softmax of
// tools/bench_attn_exp2.py (K7). It is the "wgmma" route of ops/attention.py
// `bwd_route`: bf16, d % 8 == 0, d <= 160, 16-byte-aligned q/k/v/o/dO. The
// other bf16 shapes keep the mma.sync kernels and f32 keeps the FMA kernels
// (flash_attention_bwd.cu). With lse the logsumexp of a query row's scaled
// scores (written by the forward) and Delta = rowsum(dO o O):
//
//     P = exp2(S*scale*log2(e) - lse*log2(e))   dV = P^T dO    dP = dO V^T
//     dS = P o (dP - Delta) * scale             dK = dS^T Q    dQ = dS K
//
// P is rounded to bf16 before dV's product; dS is formed from the unrounded
// f32 P and rounded to bf16 before dK's and dQ's (the Pallas kernel's casts,
// pinned by `plain_attention_bwd`). No S x S matrix is materialised.
//
// Layout: q, k, v, o, dO, dq, dk, dv are (B, S, H, D) contiguous, each of q,
// k, v, dO a 4-D tensor map (D, H, S, B) as in the forward; lse is (B, H, Sq)
// f32 in natural log.
//
// Three steps, two launches:
//  1. `flash_bwd_prep`: Delta = rowsum(dO o O) in f32 and lse2 = lse*log2(e)
//     into (B*H, Sqp) buffers, Sqp = Sq rounded up to 128; +inf and 0 past
//     Sq, so padded query rows give P = 0 with no bounds test.
//  2. `flash_bwd_wgmma`, one grid of two kinds of CTA, each the owner of what
//     it sums (nothing is summed across CTAs, no atomics: the result is
//     bitwise deterministic, as the JAX kernel's dQ scratch is):
//       dK/dV CTAs own 128 keys of one (batch, head) and stream every query
//       tile (Q, dO, and the tile's lse2 and Delta);
//       dQ CTAs own 128 query rows and stream every key tile (K, V).
//     Both recompute S and dP: 7 products where one kernel with a dQ summed
//     by atomics (SDPA's) does 5, and the exponentials twice. One launch holds
//     both kinds, so at 1024 tokens (8 key and 8 query blocks a head) the grid
//     fills 128 of the 132 SMs where either kind alone would fill 64.
//
// What bounds it: 14*B*H*Sq*Sk*DP operations on a few MB of input, far above
// the card's ~295 operations per byte, so the tensor-core rate (989 TFLOP/s
// bf16); then the 2*B*H*Sq*Sk exp2 on the SFU.
//
// The design, against what held back the mma.sync kernels
// (flash_attention_bwd.cu):
//  1. Synchronous tile loads: a producer warpgroup (one thread of it issues)
//     loads the owned tiles once and keeps a ring of 2-4 stages of streamed
//     tiles in flight with TMA (lse2 and Delta by bulk copy); full/empty
//     mbarriers hand stages to the two consumer warpgroups and back. A stage
//     is released as soon as its last product is done.
//  2. Tiles staged twice (row-major and transposed element by element): each
//     tile is stored once as TMA wrote it and read two ways by wgmma, K-major
//     as the B of S^T = K Q^T and dP^T = V dO^T, MN-major (the instruction's
//     transpose of B) as the B of dV += P^T dO and dK += dS^T Q; K likewise
//     in the dQ CTAs (S = Q K^T, then dQ += dS K).
//  3. mma.sync with 16 rows a warp: every product is wgmma (m64nNk16, bf16
//     in, f32 accumulate), 64 rows a warpgroup. P^T and dS^T stay in
//     registers: the accumulator of n-blocks 2kk, 2kk+1 is, element for
//     element, the A fragment of k-step kk of the next product.
//  4. Serial order inside a warpgroup (both S-type products, then P and dS,
//     then the accumulating products); the two consumer warpgroups of a CTA
//     overlap each other. FlashAttention-3's order (tile t's S products
//     issued before tile t-1's accumulating ones, P and dS formed over the
//     latter) measured 1.24x slower at d = 40 (PERF.md).
//
// Registers set the tiles (setmaxnreg: 240 a consumer thread). A dK/dV
// warpgroup holds dK and dV (DP f32 a thread), S^T and dP^T (R, R streamed
// rows a tile) and their bf16 A fragments (R/2): R = 64 up to DP = 64 (144
// at SD-v1.5's d = 40), R = 32 above (128 at d = 80, 208 at d = 160). At R =
// 64, DP = 80 (176) spilled and serialised its wgmmas (ptxas C7512).
//
// Head-dim padding and swizzle as the forward: DP = d rounded up to 16; the
// swizzle is the widest atom that divides DP (40 -> 48 at 32 B, 80 -> 80 at
// 32 B, 160 -> 160 at 64 B). TMA writes zeros past d and past S. Keys past
// sk need no mask in the dK/dV CTAs (a row of dK/dV depends on its own key
// only, and rows past sk are not stored); the dQ CTAs set P to 0 there, as a
// zero-filled key gives exp2(0 - lse2), not 0.
//
// Not yet done (performance work for later): a dQ summed across CTAs in a
// fixed order (5 products, not 7, still deterministic), ping-pong scheduling
// of the two consumer warpgroups, TMA stores, the spills above DP = 96.
#include "flash_common.cuh"

namespace {

constexpr int kSmemMax = 232448;  // H100, bytes of dynamic shared memory a block may use
constexpr int kConsumers = 2;     // consumer warpgroups per CTA (warpgroups 0, 1)
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
// the forward's balance (flash_fwd_wgmma.cu): 128 x (168 - 24) = 256 x (240 - 168)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kOwn = 64 * kConsumers;  // keys (dK/dV CTA) or query rows (dQ CTA) a CTA owns
constexpr int kPrepThreads = 256;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// One compiled configuration: DP padded head-dim columns. Mirrored by
// ops/attention.py `wgmma_bwd_config`.
template <int DP>
struct Cfg {
  static constexpr int SW = DP % 64 == 0 ? 128 : DP % 32 == 0 ? 64 : 32;  // swizzle bytes
  static constexpr int CW = SW / 2;                 // head-dim columns per atom
  static constexpr int NCH = DP / CW;               // atoms across the head dim
  static constexpr int R = DP <= 64 ? 64 : 32;  // rows of a streamed tile
  static constexpr int OWN_BYTES = kOwn * DP * 2;   // one owned tile (K or V; Q or dO)
  static constexpr int TILE_BYTES = R * DP * 2;     // one streamed tile
  static constexpr int ROW_BYTES = 2 * R * 4;       // a stage's lse2 and Delta
  static constexpr int FIXED = 1024 + 2 * OWN_BYTES + 256;  // alignment slack, owned, barriers
  static constexpr int STAGES = cmin(4, (kSmemMax - FIXED) / (2 * TILE_BYTES + ROW_BYTES));
  static constexpr int SMEM = FIXED + STAGES * (2 * TILE_BYTES + ROW_BYTES);
  static_assert(DP % 16 == 0 && DP % CW == 0, "head-dim padding");
  static_assert((R * SW) % 1024 == 0, "every atom starts on 1024 bytes");
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(SMEM <= kSmemMax, "tiles exceed the H100's shared memory per block");
  static_assert((1 + 2 * STAGES) * 8 <= 256, "barrier space");
};

// Shared memory of one CTA: the two owned tiles, the ring's streamed tiles,
// the ring's lse2/Delta rows, the barriers.
template <int DP>
struct Smem {
  using C = Cfg<DP>;
  unsigned char* own;   // tile 0 (K or Q), then tile 1 (V or dO): atoms of kOwn rows
  unsigned char* ring;  // stage s: tile 0 (Q or K), then tile 1 (dO or V): atoms of R rows
  float* rows;          // stage s: lse2[R], then Delta[R]
  uint64_t* own_bar;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    // every atom starts on 1024 bytes, a multiple of each swizzle's period
    own = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    ring = own + 2 * C::OWN_BYTES;
    rows = reinterpret_cast<float*>(ring + C::STAGES * 2 * C::TILE_BYTES);
    own_bar = reinterpret_cast<uint64_t*>(rows + C::STAGES * 2 * C::R);
    full = own_bar + 1;
    empty = full + C::STAGES;
  }
  __device__ __forceinline__ uint32_t stage(int t) const {
    return smem_u32(ring) + (t % C::STAGES) * 2 * C::TILE_BYTES;
  }
};

// The two S-type products of one streamed tile, 64 owned rows x R streamed
// rows each, committed as one wgmma group and waited for: s0 = A0 B0^T and
// s1 = A1 B1^T, A from the owned tiles (K-major, `a0`/`a1` at this
// warpgroup's rows), B from the stage (K-major).
template <int DP>
__device__ __forceinline__ void s_products(float* s0, float* s1, uint32_t a0, uint32_t a1,
                                           uint32_t b0) {
  using C = Cfg<DP>;
  constexpr int SW = C::SW, CW = C::CW, R = C::R;
  constexpr uint32_t SBO = 8 * SW;  // between 8-row groups of an atom
  const uint64_t ad0 = fresh_desc<SW>(a0, 16, SBO), ad1 = fresh_desc<SW>(a1, 16, SBO);
  const uint64_t bd0 = fresh_desc<SW>(b0, 16, SBO);
  const uint64_t bd1 = fresh_desc<SW>(b0 + C::TILE_BYTES, 16, SBO);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t in_atom = (kk * 16 % CW) * 2, atom = kk * 16 / CW;
    const uint32_t ao = (atom * kOwn * SW + in_atom) >> 4, bo = (atom * R * SW + in_atom) >> 4;
    wgmma_ss<R>(s0, ad0 + ao, bd0 + bo, kk > 0);
    wgmma_ss<R>(s1, ad1 + ao, bd1 + bo, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<R / 2>(s0);
  reg_fence<R / 2>(s1);
}

// acc (64 x DP) += a (64 x R, bf16 A fragments) * the stage's tile at `b`
// (R rows x DP, read MN-major); not committed.
template <int DP>
__device__ __forceinline__ void acc_product(float* acc, const uint32_t (&a)[Cfg<DP>::R / 16][4],
                                            uint32_t b) {
  using C = Cfg<DP>;
  constexpr int SW = C::SW, R = C::R;
  const uint64_t bd = fresh_desc<SW>(b, R * SW, 8 * SW);
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) pv_pieces<SW, R, DP, 0>(acc, a[kk], bd + ((kk * 16 * SW) >> 4));
}

// Rows [row0, row0 + 64) of this warpgroup's accumulator, 16 per warp, to a
// (B, S, H, D) bf16 tensor; rows past `seq` and columns past d are not stored.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float* acc, int b, int h,
                                           int heads, int seq, int d, int row0) {
  const int tid = threadIdx.x % 128, tg = tid % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
    if (row >= seq) continue;
    bf16* orow = out + (((long)b * seq + row) * heads + h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * tg;  // even, and d is a multiple of 8
      if (c < d)
        *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// A dK/dV consumer warpgroup: 64 keys, every query tile.
template <int DP>
__device__ __forceinline__ void consume_dkdv(const Smem<DP>& sm, int wi, int n_tiles, float scale2,
                                             float scale, bf16* __restrict__ dk,
                                             bf16* __restrict__ dv, int b, int h, int heads,
                                             int sk, int d, int k0) {
  using C = Cfg<DP>;
  constexpr int R = C::R, SW = C::SW;
  const int tg = threadIdx.x % 4;
  float dka[DP / 2], dva[DP / 2];  // n-block j: columns 8j + 2tg (+1) of rows g, g + 8
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t k_addr = smem_u32(sm.own) + 64 * wi * SW;
  mbar_wait(sm.own_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::STAGES;
    const uint32_t q_addr = sm.stage(t), o_addr = q_addr + C::TILE_BYTES;
    mbar_wait(&sm.full[s], (t / C::STAGES) & 1);
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x R queries
    float st[R / 2], dpt[R / 2];
    s_products<DP>(st, dpt, k_addr, k_addr + C::OWN_BYTES, q_addr);
    // P^T and dS^T; element e of n-block j: key row g + 8(e>>1), query
    // column 8j + 2tg + (e&1)
    const float* lse2 = sm.rows + s * 2 * R;
    const float* delta = lse2 + R;
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * tg);
      const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * tg);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(st[4 * j + e], scale2, -((e & 1) ? l.y : l.x)));
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * scale;
      }
    }
    // dV += P^T dO, then dK += dS^T Q: k dimension = the tile's R queries.
    // dS is packed while dV's product runs, so S^T's registers are free by
    // then (one f32 tile and two bf16 tiles live, not two and two). A stage
    // is released as soon as both products are done.
    uint32_t pa[R / 16][4];
    pack_a<R>(pa, st);
    wgmma_fence();
    acc_product<DP>(dva, pa, o_addr);
    uint32_t da[R / 16][4];
    pack_a<R>(da, dpt);
    wgmma_fence();
    acc_product<DP>(dka, da, q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<DP / 2>(dka);
    reg_fence<DP / 2>(dva);
    mbar_arrive(&sm.empty[s]);
  }
  store_rows<DP>(dk, dka, b, h, heads, sk, d, k0 + 64 * wi);
  store_rows<DP>(dv, dva, b, h, heads, sk, d, k0 + 64 * wi);
}

// A dQ consumer warpgroup: 64 query rows, every key tile.
template <int DP>
__device__ __forceinline__ void consume_dq(const Smem<DP>& sm, int wi, int n_tiles, float scale2,
                                           float scale, const float* __restrict__ lse2,
                                           const float* __restrict__ delta, bf16* __restrict__ dq,
                                           int b, int h, int heads, int sq, int sk, int d, int q0) {
  using C = Cfg<DP>;
  constexpr int R = C::R, SW = C::SW;
  const int tid = threadIdx.x % 128, tg = tid % 4;
  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
  float lr[2], dl[2];  // rows g, g + 8 (padded buffers: no bounds test)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * wi + 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
    lr[r] = lse2[row];
    dl[r] = delta[row];
  }
  const uint32_t q_addr = smem_u32(sm.own) + 64 * wi * SW;
  mbar_wait(sm.own_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::STAGES;
    const uint32_t k_addr = sm.stage(t);
    mbar_wait(&sm.full[s], (t / C::STAGES) & 1);
    // S = Q K^T and dP = dO V^T: 64 query rows x R keys
    float sc[R / 2], dp[R / 2];
    s_products<DP>(sc, dp, q_addr, q_addr + C::OWN_BYTES, k_addr);
    // dS; element e of n-block j: query row g + 8(e>>1), key 8j + 2tg + (e&1)
    const int kt = t * R;
    const bool tail = kt + R > sk;
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(fmaf(sc[4 * j + e], scale2, -lr[r]));
        if (tail && kt + 8 * j + 2 * tg + (e & 1) >= sk) p = 0.f;  // zero-filled keys
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[r]) * scale;
      }
    uint32_t da[R / 16][4];
    pack_a<R>(da, dp);
    // dQ += dS K: k dimension = the tile's R keys
    wgmma_fence();
    acc_product<DP>(dqa, da, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<DP / 2>(dqa);
    mbar_arrive(&sm.empty[s]);
  }
  store_rows<DP>(dq, dqa, b, h, heads, sq, d, q0 + 64 * wi);
}

// Blocks [0, kv_blocks) of the grid's x are dK/dV CTAs, the rest dQ CTAs;
// y is batch * head. scale2 = scale * log2(e). lse2 and delta: (B*H, sqp).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                const float* __restrict__ lse2, const float* __restrict__ delta,
                bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int heads,
                int sq, int sk, int sqp, int d, int kv_blocks, float scale2, float scale) {
  using C = Cfg<DP>;
  constexpr int SW = C::SW, CW = C::CW, R = C::R, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const Smem<DP> sm(smem_raw);

  const bool kv = blockIdx.x < kv_blocks;  // uniform over the CTA
  const int r0 = (kv ? blockIdx.x : blockIdx.x - kv_blocks) * kOwn;  // first owned row
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int n_tiles = ((kv ? sq : sk) + R - 1) / R;
  // warp-uniform for the compiler: warpgroups 0 and 1 consume, 2 produces
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(sm.own_bar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread issues every load
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      const CUtensorMap* own0 = kv ? &kmap : &qmap;
      const CUtensorMap* own1 = kv ? &vmap : &omap;
      const CUtensorMap* str0 = kv ? &qmap : &kmap;
      const CUtensorMap* str1 = kv ? &omap : &vmap;
      mbar_expect_tx(sm.own_bar, 2 * C::OWN_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
#pragma unroll
        for (int i = 0; i < kOwn / R; ++i) {  // the maps' boxes are R rows
          unsigned char* dst = sm.own + c * kOwn * SW + i * R * SW;
          tma_load_4d(dst, own0, sm.own_bar, c * CW, h, r0 + i * R, b);
          tma_load_4d(dst + C::OWN_BYTES, own1, sm.own_bar, c * CW, h, r0 + i * R, b);
        }
      const long row_base = (long)blockIdx.y * sqp;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&sm.empty[s], (t / ST - 1) & 1);  // both warpgroups are done with it
        mbar_expect_tx(&sm.full[s], 2 * C::TILE_BYTES + (kv ? C::ROW_BYTES : 0));
        unsigned char* ts = sm.ring + s * 2 * C::TILE_BYTES;
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(ts + c * R * SW, str0, &sm.full[s], c * CW, h, t * R, b);
          tma_load_4d(ts + C::TILE_BYTES + c * R * SW, str1, &sm.full[s], c * CW, h, t * R, b);
        }
        if (kv) {
          float* rows = sm.rows + s * 2 * R;
          bulk_load(rows, lse2 + row_base + t * R, R * 4, &sm.full[s]);
          bulk_load(rows + R, delta + row_base + t * R, R * 4, &sm.full[s]);
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    if (kv)
      consume_dkdv<DP>(sm, wg, n_tiles, scale2, scale, dk, dv, b, h, heads, sk, d, r0);
    else
      consume_dq<DP>(sm, wg, n_tiles, scale2, scale, lse2 + (long)blockIdx.y * sqp,
                     delta + (long)blockIdx.y * sqp, dq, b, h, heads, sq, sk, d, r0);
  }
}

// One thread a (batch, query row, head), in the memory order of o and dO:
// Delta = rowsum(dO o O) in f32 and lse2 = lse * log2(e) at [b*H + h][i];
// 0 and +inf for i in [sq, sqp). d % 8 == 0, o and dO 16-byte aligned.
__global__ void __launch_bounds__(kPrepThreads)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lse2,
               float* __restrict__ delta, int heads, int sq, int sqp, int d, long n) {
  const long idx = (long)blockIdx.x * kPrepThreads + threadIdx.x;
  if (idx >= n) return;
  const int h = (int)(idx % heads);
  const long bi = idx / heads;
  const int i = (int)(bi % sqp), b = (int)(bi / sqp);
  const long bh = (long)b * heads + h;
  if (i >= sq) {
    lse2[bh * sqp + i] = INFINITY;
    delta[bh * sqp + i] = 0.f;
    return;
  }
  const long off = (((long)b * sq + i) * heads + h) * d;
  float acc = 0.f;
  for (int c = 0; c < d; c += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + off + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + c);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float2 of = __bfloat1622float2(op[m]), gf = __bfloat1622float2(gp[m]);
      acc = fmaf(gf.x, of.x, acc);
      acc = fmaf(gf.y, of.y, acc);
    }
  }
  delta[bh * sqp + i] = acc;
  lse2[bh * sqp + i] = lse[bh * sq + i] * kLog2e;
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

int padded_rows(int sq) { return (sq + kOwn - 1) / kOwn * kOwn; }

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* scratch, void* dq, void* dk, void* dv, int batch,
                   int heads, int sq, int sk, int d, float scale, cudaStream_t st) {
  using C = Cfg<DP>;
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, q, batch, heads, sq, d, C::CW, C::R, C::SW) ||
      !make_map(&km, k, batch, heads, sk, d, C::CW, C::R, C::SW) ||
      !make_map(&vm, v, batch, heads, sk, d, C::CW, C::R, C::SW) ||
      !make_map(&om, dout, batch, heads, sq, d, C::CW, C::R, C::SW))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_wgmma<DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int sqp = padded_rows(sq);
  float* lse2 = scratch;
  float* delta = scratch + (long)batch * heads * sqp;
  const long n = (long)batch * sqp * heads;
  flash_bwd_prep<<<(unsigned)((n + kPrepThreads - 1) / kPrepThreads), kPrepThreads, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse2, delta, heads, sq,
      sqp, d, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kv_blocks = (sk + kOwn - 1) / kOwn, q_blocks = sqp / kOwn;
  kernel<<<dim3(kv_blocks + q_blocks, batch * heads), kThreads, C::SMEM, st>>>(
      qm, km, vm, om, lse2, delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), heads, sq, sk, sqp, d, kv_blocks, scale * kLog2e, scale);
  return cudaGetLastError();
}

// Expands CASE(DP) for the configuration of head dim d (d % 8 == 0, <= 160).
#define LDT_WGMMA_BWD_CONFIGS(d, CASE)                                      \
  switch (((d) + 15) / 16) {                                                \
    case 1: CASE(16) case 2: CASE(32) case 3: CASE(48) case 4: CASE(64)     \
    case 5: CASE(80) case 6: CASE(96) case 7: CASE(112) case 8: CASE(128)   \
    case 9: CASE(144) case 10: CASE(160)                                    \
  }

bool takes(int d) { return d >= 8 && d <= 160 && d % 8 == 0; }

}  // namespace

// The "wgmma" route: bf16 q/k/v/o/dout (B, S, H, D) contiguous, d % 8 == 0,
// d <= 160, each 16-byte aligned; lse (B, H, Sq) float32; scratch: 2 * B * H
// * Sqp float32 (Sqp = Sq rounded up to 128), 16-byte aligned, for lse2 and
// Delta. Returns a cudaError_t (0 on success); cudaErrorInvalidValue for a
// shape this route does not take, cudaErrorNotSupported where the driver has
// no tensor maps.
extern "C" int ldt_flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const void* lse,
                                             void* scratch, void* dq, void* dk, void* dv,
                                             int batch, int heads, int sq, int sk, int d,
                                             float scale, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || sk < 1 || !takes(d) || batch * heads > 65535 ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
        (uintptr_t)scratch) & 15) != 0 ||
      (((uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
#define LDT_LAUNCH(DP) \
  return (int)launch<DP>(q, k, v, o, dout, l, sc, dq, dk, dv, batch, heads, sq, sk, d, scale, st);
  LDT_WGMMA_BWD_CONFIGS(d, LDT_LAUNCH)
#undef LDT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the configuration that runs head dim d, or -1
// (ops/attention.py `wgmma_bwd_config` mirrors it).
extern "C" int ldt_flash_attention_bwd_wgmma_smem(int d) {
  if (!takes(d)) return -1;
#define LDT_SMEM(DP) return Cfg<DP>::SMEM;
  LDT_WGMMA_BWD_CONFIGS(d, LDT_SMEM)
#undef LDT_SMEM
  return -1;
}
