// GroupNorm (+ optional SiLU) over NHWC for Hopper (sm_90a): two routes.
//
// Replaces the Pallas kernels of ldiffusion_tpu/ops/groupnorm.py:
//   `_gn_kernel` (:82, K3: one VMEM residency per batch row, x read once and
//   y written once) by the resident route, and `_gn_stats_kernel` (:147, K4a)
//   and `_gn_apply_kernel` (:168, K4b), the streamed pair for rows too large
//   for VMEM, by the streamed route. ops/groupnorm.py `gn_route` picks one;
//   csrc/groupnorm.cu (the first, three-kernel version) stays reachable only
//   as the "v1" yardstick.
//
// The function is `_xla_groupnorm_silu` / `_stats_to_affine` (:41-79): f32
// math, the single-pass variance max(E[x^2] - E[x]^2, 0), mul = rstd*scale,
// add = bias - mean*mul, y = x*mul + add (then SiLU), y in x's dtype. scale
// and bias are read in their own dtype (f32 or bf16), so the wrapper casts
// nothing. Every sum is taken in a fixed order: two calls give the same bits.
//
// What bounds it: a few operations an element, so device memory. The
// function must read x once and write y once (2 passes).
//
// 1. Resident route (`gn_resident`, one launch). Groups are independent, so
//    a batch row splits into slices of `gpc` whole groups (w = gpc*C/G
//    channels, w*itemsize a multiple of 16 bytes and >= min_slice where the
//    group width allows). One thread-block cluster of `cs` CTAs owns a
//    (batch row, slice); its CTAs split the spatial rows. Each CTA loads its
//    rows x slice into shared memory with TMA (a 3-D tensor map (C, HW, B),
//    boxes of up to 256 rows, one mbarrier a box, so the statistics start on
//    the first box while the others land), folds per-channel f32 sums and
//    sums of squares into per-group partials (one warp a group, fixed
//    order), and after a cluster barrier reads every CTA's partials through
//    distributed shared memory in rank order: all CTAs get the same mean and
//    rstd, with no atomics, no global scratch and no finalize launch. It then
//    applies x*mul + add (+ SiLU) from shared memory and stores y with
//    16-byte stores: x is read once and y written once. Up to 200 KB of x a
//    CTA and 16 CTAs a cluster (non-portable size), so a slice holds up to
//    3.2 MB. `resident_config` picks the narrowest slice, then the smallest
//    cluster that fits and gives at least 128 CTAs (at least 8 rows a CTA).
// 2. Streamed route (`gn_stream_stats` + `gn_stream_apply`, two launches):
//    for what the resident route does not take. The stats kernel reads x
//    with 16-byte loads (four in flight a thread) in row chunks (about 528
//    CTAs in all), writes per-chunk group partials to a workspace, and the
//    last CTA of a batch row to finish (a counter, one atomicAdd a CTA after
//    a __threadfence) folds the chunks in a fixed order into mul/add and
//    leaves the counter at zero. The apply kernel keeps one channel vector a
//    thread over its whole grid-stride loop (the stride is whole rows), with
//    mul/add loaded once. Its floor is 3 passes at the largest maps (x read
//    twice; a 256 MB row cannot stay on chip); up to the 50 MB L2 the second
//    read mostly hits L2.
// The streamed route has a scalar variant (V = 1) for C*itemsize not a
// multiple of 16 or pointers off the 16-byte grid, which TMA's strides
// cannot take either; those shapes always stream.
#include <cooperative_groups.h>

#include <algorithm>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBoxRows = 256;       // TMA's largest box dimension
constexpr int kDataMax = 200 * 1024;  // bytes of x a resident CTA holds
constexpr int kTargetCtas = 128;    // the resident route's cluster choice aims here
constexpr int kMaxCluster = 16;
constexpr int kMinRows = 8;      // the least spatial rows a resident CTA is cut to
constexpr int kSmemMax = 232448;
constexpr int kApplyCtas = 132 * 4;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// V values from p: one 16-byte access where V values fill 16 bytes.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = to_f(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = to_f(p[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_f<T>(f[k]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = from_f<T>(f[k]);
  }
}

template <int V>
__device__ __forceinline__ void accumulate(float (&s)[V], float (&q)[V], const float (&f)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] += f[k];
    q[k] = fmaf(f[k], f[k], q[k]);
  }
}

// y = x*mul + add, then x*sigmoid(x) in f32 with the fast exponential.
template <bool SILU, int V>
__device__ __forceinline__ void affine(float (&f)[V], const float (&mul)[V], const float (&add)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    f[k] = fmaf(f[k], mul[k], add[k]);
    if (SILU) f[k] = __fdividef(f[k], 1.f + __expf(-f[k]));
  }
}

// One box of a 3-D tensor map (innermost coordinate first) into shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The two halves of a cluster barrier: arrive (release) early, wait (acquire)
// where the CTA must not run ahead.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// resident route
// ---------------------------------------------------------------------------

struct ResCfg {
  int gpc;    // groups a slice
  int cs;     // CTAs a cluster
  int rpc;    // spatial rows a CTA
  int br;     // rows a TMA box (a multiple of 8, so every box starts 128-byte aligned)
  int nbox;   // boxes a CTA
  int smem;   // dynamic shared memory, bytes
};

// ops/groupnorm.py `gn_resident_config` mirrors this choice.
bool resident_config(int b, int hw, int c, int groups, int itemsize, int min_slice, ResCfg* cfg) {
  if (b < 1 || b > 65535 || hw < 1 || c < 1 || groups < 1 || groups > kThreads || c % groups ||
      (c * itemsize) % 16)
    return false;
  const int cpg = c / groups;
  int gpc = groups;  // the whole row where no narrower slice is wide enough
  for (int d = 1; d <= groups; ++d) {
    const int bytes = d * cpg * itemsize;
    if (groups % d == 0 && bytes % 16 == 0 && bytes >= min_slice) {
      gpc = d;
      break;
    }
  }
  const int w = gpc * cpg;
  if (w > kBoxRows) return false;  // one box column: slices up to 256 channels
  const int sb = w * itemsize, nslice = groups / gpc;
  const int rg = kThreads / (sb / 16);
  bool found = false;
  for (int cs = 1; cs <= kMaxCluster && (cs == 1 || cs * kMinRows <= hw); cs *= 2) {
    const int rpc = (hw + cs - 1) / cs;
    const int nbox = (rpc + kBoxRows - 1) / kBoxRows;
    const int br = ((rpc + nbox - 1) / nbox + 7) / 8 * 8;
    const long data = (long)nbox * br * sb;
    if (data > kDataMax) continue;
    cfg->gpc = gpc;
    cfg->cs = cs;
    cfg->rpc = rpc;
    cfg->br = br;
    cfg->nbox = nbox;
    // alignment slack, x, the box barriers, the channel partials [2][w][rg],
    // the warps' partials [2][max(8, gpc)], the group partials and the group
    // statistics [gpc][2] each
    cfg->smem = 128 + (int)data + 8 * nbox + 4 * (2 * rg * w + 2 * max(8, gpc) + 4 * gpc);
    found = true;
    if ((long)b * nslice * cs >= kTargetCtas) break;
  }
  return found && cfg->smem <= kSmemMax;
}

// grid (cs, G/gpc, B), cluster (cs, 1, 1), kThreads threads.
template <typename T, typename ST, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_resident(const __grid_constant__ CUtensorMap xmap, T* __restrict__ y,
            const ST* __restrict__ scale, const ST* __restrict__ bias, int hw, int c, int cpg,
            int gpc, int rpc, int br, float eps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int tid = threadIdx.x, b = blockIdx.z;
  const int w = gpc * cpg, c0 = blockIdx.y * w;
  const int nv = w / V, rg = kThreads / nv;
  const int v = tid % nv, g = tid / nv;
  const int r0 = rank * rpc;
  const int nrows = max(0, min(rpc, hw - r0));
  const int boxes = (nrows + br - 1) / br;
  const int nbox = (rpc + br - 1) / br;
  T* data = reinterpret_cast<T*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (size_t)nbox * br * w * sizeof(T));
  float* red = reinterpret_cast<float*>(bars + nbox);  // sums [w][rg], then squares
  float* wsum = red + 2 * rg * w;                       // [max(8, gpc)][sum, squares]
  float* parts = wsum + 2 * max(8, gpc);                // [gpc][sum, squares]
  float* stat = parts + 2 * gpc;                        // [gpc][mean, rstd]

  if (tid == 0) {
    for (int i = 0; i < boxes; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    for (int i = 0; i < boxes; ++i) {
      mbar_expect_tx(&bars[i], (uint32_t)(br * w * sizeof(T)));
      tma_load_3d(data + (size_t)i * br * w, &xmap, &bars[i], c0, r0 + i * br, b);
    }
  }
  // scale and bias of this thread's channels, read while the boxes land
  float sc[V], bi[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sc[k] = g < rg ? to_f(scale[c0 + v * V + k]) : 0.f;
    bi[k] = g < rg ? to_f(bias[c0 + v * V + k]) : 0.f;
  }
  __syncthreads();

  // per-channel sums over this CTA's rows: thread (v, g) takes channel
  // vector v of rows g, g + rg, ..., box by box as the boxes land
  if (g < rg) {
    float s[V], q[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
    for (int i = 0; i < boxes; ++i) {
      mbar_wait(&bars[i], 0);
      const int rend = min(nrows, (i + 1) * br);
      for (int r = i * br + g; r < rend; r += rg) {
        float f[V];
        load_vec<T, V>(data + (size_t)r * w + v * V, f);
        accumulate<V>(s, q, f);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[(v * V + k) * rg + g] = s[k];
      red[(w + v * V + k) * rg + g] = q[k];
    }
  }
  __syncthreads();
  // per-group partials of this CTA: a group's terms (its channels x row
  // groups) are contiguous; wpg warps a group, each a fixed stride of them
  // and a butterfly, then the warps' sums in order
  const int warp = tid / 32, lane = tid % 32;
  const int wpg = gpc < kThreads / 32 ? (kThreads / 32) / gpc : 1;
  for (int k = warp; k < gpc * wpg; k += kThreads / 32) {
    const int gg = k / wpg, j = k % wpg;
    const float* ts_p = red + gg * cpg * rg;
    float ts = 0.f, tq = 0.f;
    for (int t = j * 32 + lane; t < cpg * rg; t += wpg * 32) {
      ts += ts_p[t];
      tq += ts_p[w * rg + t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ts += __shfl_xor_sync(0xffffffffu, ts, o);
      tq += __shfl_xor_sync(0xffffffffu, tq, o);
    }
    if (lane == 0) {
      wsum[2 * k] = ts;
      wsum[2 * k + 1] = tq;
    }
  }
  __syncthreads();
  if (tid < gpc) {
    float ts = 0.f, tq = 0.f;
    for (int j = 0; j < wpg; ++j) {
      ts += wsum[2 * (tid * wpg + j)];
      tq += wsum[2 * (tid * wpg + j) + 1];
    }
    parts[2 * tid] = ts;
    parts[2 * tid + 1] = tq;
  }
  cluster.sync();
  // every CTA folds the cluster's partials in rank order: the same bits in all
  if (tid < gpc) {
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* p = cluster.map_shared_rank(parts, (unsigned)k);
      ts += p[2 * tid];
      tq += p[2 * tid + 1];
    }
    const float n = (float)hw * (float)cpg;
    const float mean = ts / n;
    const float var = fmaxf(tq / n - mean * mean, 0.f);
    stat[2 * tid] = mean;
    stat[2 * tid + 1] = rsqrtf(var + eps);
  }
  cluster_arrive();  // this CTA's reads of the others' partials are done
  __syncthreads();

  if (g < rg) {
    float mul[V], add[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int gi = (v * V + k) / cpg;
      mul[k] = stat[2 * gi + 1] * sc[k];
      add[k] = bi[k] - stat[2 * gi] * mul[k];
    }
    T* yb = y + ((size_t)b * hw + r0) * c + c0 + v * V;
    for (int r = g; r < nrows; r += rg) {
      float f[V];
      load_vec<T, V>(data + (size_t)r * w + v * V, f);
      affine<SILU, V>(f, mul, add);
      store_vec<T, V>(yb + (size_t)r * c, f);
    }
  }
  cluster_wait();  // no CTA leaves while another may still read its partials
}

// (C, HW, B) in x's type; a box is (w, br, 1).
bool make_gn_map(CUtensorMap* map, const void* x, int b, int hw, int c, int itemsize, int w,
                 int br) {
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)hw, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)c * itemsize, (cuuint64_t)hw * c * itemsize};
  const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)br, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      itemsize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return encode_tiled()(map, type, 3, const_cast<void*>(x), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, typename ST, bool SILU>
cudaError_t launch_resident(const void* x, const void* scale, const void* bias, void* y, int b,
                            int hw, int c, int groups, float eps, int min_slice,
                            cudaStream_t st) {
  ResCfg cfg;
  if (!resident_config(b, hw, c, groups, (int)sizeof(T), min_slice, &cfg))
    return cudaErrorInvalidValue;
  const int cpg = c / groups;
  CUtensorMap map;
  if (!make_gn_map(&map, x, b, hw, c, (int)sizeof(T), cfg.gpc * cpg, cfg.br))
    return cudaErrorInvalidValue;
  auto kernel = gn_resident<T, ST, SILU>;
  // the attributes once (raised as needed), the launch check once for each
  // cluster size and larger shared memory
  static int attr_smem = 0;
  static int checked[5] = {0, 0, 0, 0, 0};
  int ci = 0;
  while ((1 << ci) < cfg.cs) ++ci;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(cfg.cs, groups / cfg.gpc, b);
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = cfg.smem;
  lc.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cfg.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  cudaError_t err;
  if (attr_smem == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (cfg.smem > attr_smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
    if (err != cudaSuccess) return err;
    attr_smem = cfg.smem;
  }
  if (cfg.smem > checked[ci]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &lc);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    checked[ci] = cfg.smem;
  }
  T* yp = static_cast<T*>(y);
  const ST* sp = static_cast<const ST*>(scale);
  const ST* bp = static_cast<const ST*>(bias);
  void* args[] = {&map, &yp, &sp, &bp, &hw, &c, (void*)&cpg, &cfg.gpc, &cfg.rpc, &cfg.br, &eps};
  err = cudaLaunchKernelExC(&lc, (const void*)kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// streamed route
// ---------------------------------------------------------------------------

// grid (n_chunks, B). Thread (v, g) takes channel vector v of rows g, g + rg,
// ... of its chunk (where a row has more vectors than the CTA threads, each
// thread takes vectors tid, tid + kThreads, ... of every row). Each chunk
// writes group partials (B, n_chunks, G). Dynamic shared memory:
// max(2*(rg + 1)*c, 2*(parts + 1)*G) floats.
template <typename T, typename ST, int V>
__global__ void __launch_bounds__(kThreads)
gn_stream_stats(const T* __restrict__ x, const ST* __restrict__ scale,
                const ST* __restrict__ bias, float* __restrict__ psum, float* __restrict__ psq,
                float* __restrict__ mul, float* __restrict__ add, unsigned* __restrict__ counter,
                int hw, int c, int groups, int rows_per_chunk, float eps) {
  extern __shared__ float red[];  // sums [rg][c], then squares; then the fold's
  __shared__ bool last;
  const int tid = threadIdx.x, chunk = blockIdx.x, n_chunks = gridDim.x, b = blockIdx.y;
  const int nv = c / V;
  const bool wide = nv > kThreads;
  const int rg = wide ? 1 : kThreads / nv, g = wide ? 0 : tid / nv;
  const int r0 = chunk * rows_per_chunk, r1 = min(hw, r0 + rows_per_chunk);
  const T* xb = x + (size_t)b * hw * c;
  if (g < rg) {
    for (int v = wide ? tid : tid % nv; v < nv; v += kThreads) {
      float s[V], q[V];
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
      const T* p = xb + v * V;
      int r = r0 + g;
      for (; r + 3 * rg < r1; r += 4 * rg) {  // four loads in flight
        float f0[V], f1[V], f2[V], f3[V];
        load_vec<T, V>(p + (size_t)r * c, f0);
        load_vec<T, V>(p + (size_t)(r + rg) * c, f1);
        load_vec<T, V>(p + (size_t)(r + 2 * rg) * c, f2);
        load_vec<T, V>(p + (size_t)(r + 3 * rg) * c, f3);
        accumulate<V>(s, q, f0);
        accumulate<V>(s, q, f1);
        accumulate<V>(s, q, f2);
        accumulate<V>(s, q, f3);
      }
      for (; r < r1; r += rg) {
        float f[V];
        load_vec<T, V>(p + (size_t)r * c, f);
        accumulate<V>(s, q, f);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        red[g * c + v * V + k] = s[k];
        red[(rg + g) * c + v * V + k] = q[k];
      }
    }
  }
  __syncthreads();
  // channel sums over the row groups, then group sums over the channels
  float* csum = red + 2 * rg * c;  // [2][c]
  for (int ch = tid; ch < c; ch += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < rg; ++k) {
      ts += red[k * c + ch];
      tq += red[(rg + k) * c + ch];
    }
    csum[ch] = ts;
    csum[c + ch] = tq;
  }
  __syncthreads();
  const int cpg = c / groups;
  for (int gi = tid; gi < groups; gi += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int ch = gi * cpg; ch < (gi + 1) * cpg; ++ch) {
      ts += csum[ch];
      tq += csum[c + ch];
    }
    psum[((size_t)b * n_chunks + chunk) * groups + gi] = ts;
    psq[((size_t)b * n_chunks + chunk) * groups + gi] = tq;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counter[b], 1u) == (unsigned)(n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last CTA of the row: group totals over the chunks, `parts` threads a
  // group (each a fixed stride of chunks), combined in order
  const int parts = groups < kThreads ? kThreads / groups : 1;
  for (int e = tid; e < parts * groups; e += kThreads) {
    const int gi = e % groups, part = e / groups;
    float ts = 0.f, tq = 0.f;
#pragma unroll 8
    for (int k = part; k < n_chunks; k += parts) {  // eight loads in flight
      const size_t o = ((size_t)b * n_chunks + k) * groups + gi;
      ts += __ldcg(psum + o);
      tq += __ldcg(psq + o);
    }
    red[e] = ts;
    red[parts * groups + e] = tq;
  }
  __syncthreads();
  const float n = (float)hw * (float)cpg;
  for (int gi = tid; gi < groups; gi += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int part = 0; part < parts; ++part) {
      ts += red[part * groups + gi];
      tq += red[(parts + part) * groups + gi];
    }
    const float mean = ts / n;
    const float var = fmaxf(tq / n - mean * mean, 0.f);
    red[2 * parts * groups + 2 * gi] = mean;
    red[2 * parts * groups + 2 * gi + 1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float* stat = red + 2 * parts * groups;
  for (int ch = tid; ch < c; ch += kThreads) {
    const int gi = ch / cpg;
    const float mu = stat[2 * gi + 1] * to_f(scale[ch]);
    mul[(size_t)b * c + ch] = mu;
    add[(size_t)b * c + ch] = to_f(bias[ch]) - stat[2 * gi] * mu;
  }
  if (tid == 0) counter[b] = 0u;  // ready for the next call
}

// grid (blocks, B): thread (v, g) of block bx takes channel vector v of rows
// bx*rg + g, then every gridDim.x*rg rows.
template <typename T, int V, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_stream_apply(const T* __restrict__ x, const float* __restrict__ mul,
                const float* __restrict__ add, T* __restrict__ y, int hw, int c) {
  const int tid = threadIdx.x, b = blockIdx.y;
  const int nv = c / V;
  const bool wide = nv > kThreads;
  const int rg = wide ? 1 : kThreads / nv, g = wide ? 0 : tid / nv;
  if (g >= rg) return;
  const int step = gridDim.x * rg;
  const size_t row0 = (size_t)b * hw;
  for (int v = wide ? tid : tid % nv; v < nv; v += kThreads) {
    float m[V], a[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      m[k] = mul[(size_t)b * c + v * V + k];
      a[k] = add[(size_t)b * c + v * V + k];
    }
    const T* px = x + row0 * c + v * V;
    T* py = y + row0 * c + v * V;
    int r = blockIdx.x * rg + g;
    for (; r + 3 * step < hw; r += 4 * step) {
      float f0[V], f1[V], f2[V], f3[V];
      load_vec<T, V>(px + (size_t)r * c, f0);
      load_vec<T, V>(px + (size_t)(r + step) * c, f1);
      load_vec<T, V>(px + (size_t)(r + 2 * step) * c, f2);
      load_vec<T, V>(px + (size_t)(r + 3 * step) * c, f3);
      affine<SILU, V>(f0, m, a);
      affine<SILU, V>(f1, m, a);
      affine<SILU, V>(f2, m, a);
      affine<SILU, V>(f3, m, a);
      store_vec<T, V>(py + (size_t)r * c, f0);
      store_vec<T, V>(py + (size_t)(r + step) * c, f1);
      store_vec<T, V>(py + (size_t)(r + 2 * step) * c, f2);
      store_vec<T, V>(py + (size_t)(r + 3 * step) * c, f3);
    }
    for (; r < hw; r += step) {
      float f[V];
      load_vec<T, V>(px + (size_t)r * c, f);
      affine<SILU, V>(f, m, a);
      store_vec<T, V>(py + (size_t)r * c, f);
    }
  }
}

template <typename T, typename ST, int V>
cudaError_t launch_stream(const void* x, const void* scale, const void* bias, void* y,
                          float* psum, float* psq, float* mul, float* add, unsigned* counter,
                          int b, int hw, int c, int groups, int n_chunks, int rows, float eps,
                          int silu, cudaStream_t st) {
  const int nv = c / V;
  const int rg = nv > kThreads ? 1 : kThreads / nv;
  const int parts = groups < kThreads ? kThreads / groups : 1;
  const size_t smem = sizeof(float) * std::max<size_t>(2 * (size_t)(rg + 1) * c,
                                                       2 * (size_t)(parts + 1) * groups);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  auto stats = gn_stream_stats<T, ST, V>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stats, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  stats<<<dim3(n_chunks, b), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const ST*>(scale), static_cast<const ST*>(bias), psum,
      psq, mul, add, counter, hw, c, groups, rows, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long blocks = (hw + rg - 1) / rg;
  const long cap = kApplyCtas / b > 0 ? kApplyCtas / b : 1;
  if (blocks > cap) blocks = cap;
  const dim3 grid((unsigned)blocks, b);
  if (silu)
    gn_stream_apply<T, V, true><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), mul, add,
                                                          static_cast<T*>(y), hw, c);
  else
    gn_stream_apply<T, V, false><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), mul, add,
                                                           static_cast<T*>(y), hw, c);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype / sdtype: 0 = float32, 1 = bfloat16 (x and y; scale and bias).
// x, y: (B, HW, C) contiguous, 16-byte aligned, C*itemsize a multiple of 16.
// scale, bias: (C,). Returns a cudaError_t (0 on success):
// cudaErrorInvalidValue for a shape the route does not take,
// cudaErrorInvalidConfiguration where the cluster cannot be scheduled,
// cudaErrorNotSupported where the driver has no tensor maps.
extern "C" int ldt_groupnorm_resident(const void* x, const void* scale, const void* bias, void* y,
                                      int batch, int hw, int c, int groups, float eps, int silu,
                                      int dtype, int sdtype, int min_slice, void* stream) {
  if (!aligned16(x) || !aligned16(y) || dtype < 0 || dtype > 1 || sdtype < 0 || sdtype > 1)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LDT_RES(T, ST, S) \
  return (int)launch_resident<T, ST, S>(x, scale, bias, y, batch, hw, c, groups, eps, min_slice, st);
  if (dtype == 0 && sdtype == 0) { if (silu) LDT_RES(float, float, true) LDT_RES(float, float, false) }
  if (dtype == 0 && sdtype == 1) { if (silu) LDT_RES(float, bf16, true) LDT_RES(float, bf16, false) }
  if (dtype == 1 && sdtype == 0) { if (silu) LDT_RES(bf16, float, true) LDT_RES(bf16, float, false) }
  if (silu) LDT_RES(bf16, bf16, true)
  LDT_RES(bf16, bf16, false)
#undef LDT_RES
}

// The streamed route. psum, psq: (B, n_chunks, G) f32 scratch; mul, add:
// (B, C) f32 scratch; counter: B unsigned ints, zero on entry, left at zero.
// vec = 1: 16-byte accesses (x, y 16-byte aligned, C*itemsize a multiple of
// 16); vec = 0: the scalar variant. n_chunks*rows must cover HW exactly once
// rounded up: (n_chunks - 1)*rows < HW <= n_chunks*rows.
extern "C" int ldt_groupnorm_stream(const void* x, const void* scale, const void* bias, void* y,
                                    float* psum, float* psq, float* mul, float* add,
                                    unsigned* counter, int batch, int hw, int c, int groups,
                                    int n_chunks, int rows, float eps, int silu, int dtype,
                                    int sdtype, int vec, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (batch < 1 || batch > 65535 || hw < 1 || c < 1 || groups < 1 || c % groups ||
      n_chunks < 1 || rows < 1 || (long)n_chunks * rows < hw || (long)(n_chunks - 1) * rows >= hw ||
      dtype < 0 || dtype > 1 || sdtype < 0 || sdtype > 1)
    return (int)cudaErrorInvalidValue;
  if (vec && ((c * itemsize) % 16 || !aligned16(x) || !aligned16(y)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LDT_STR(T, ST, V)                                                                   \
  return (int)launch_stream<T, ST, V>(x, scale, bias, y, psum, psq, mul, add, counter, batch, hw, \
                                      c, groups, n_chunks, rows, eps, silu, st);
  if (dtype == 0 && sdtype == 0) { if (vec) LDT_STR(float, float, 4) LDT_STR(float, float, 1) }
  if (dtype == 0 && sdtype == 1) { if (vec) LDT_STR(float, bf16, 4) LDT_STR(float, bf16, 1) }
  if (dtype == 1 && sdtype == 0) { if (vec) LDT_STR(bf16, float, 8) LDT_STR(bf16, float, 1) }
  if (vec) LDT_STR(bf16, bf16, 8)
  LDT_STR(bf16, bf16, 1)
#undef LDT_STR
}

// The resident route's choice for a shape: out = {gpc, cs, rows a CTA, box
// rows, boxes, smem bytes}; returns 1, or 0 where the route does not take the
// shape (ops/groupnorm.py `gn_resident_config` mirrors it).
extern "C" int ldt_groupnorm_resident_config(int batch, int hw, int c, int groups, int dtype,
                                             int min_slice, int* out) {
  ResCfg cfg;
  if (!resident_config(batch, hw, c, groups, dtype == 0 ? 4 : 2, min_slice, &cfg)) return 0;
  const int vals[6] = {cfg.gpc, cfg.cs, cfg.rpc, cfg.br, cfg.nbox, cfg.smem};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 1;
}
