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
//
// The backward (dx, dscale, dbias for an output gradient dy) replaces no
// Pallas kernel: the JAX package's `_gn_bwd` (:319-323) takes XLA's vjp of
// `_xla_groupnorm_silu`. The statistics are recomputed from x in the
// forward's single-pass form; with xh = (x - mean)*rstd, y = xh*scale + bias,
// dz = dy*SiLU'(y) (dy without SiLU) and g = scale*dz:
//   dx = rstd*(g - mean_group(g) - xh*mean_group(g*xh)),
//   dscale_c = sum_{b,hw} dz*xh, dbias_c = sum_{b,hw} dz,
// the xh term dropped where the clamp of the variance held (its gradient is
// 0 there). f32 math, dx in x's type, dscale and dbias in the parameters'.
// What bounds it: bytes again; read x and dy, write dx, and a group sum
// before anything can be written. The same two routes, by the same rule:
// 3. Resident backward (`gn_resident_bwd`): a cluster holds x and dy of its
//    (batch row, slice) in shared memory (TMA, up to 100 KB of each a CTA),
//    exchanges the statistics' and then the g and g*xh group partials over
//    distributed shared memory, and writes dx: x and dy read once, dx
//    written once (~6 bytes an element in bf16). Per-channel dscale/dbias
//    partials of each CTA go to a workspace, folded by `gn_finalize_bwd`
//    (only where the parameters want a gradient).
// 4. Streamed backward, for the maps too large for a cluster: statistics
//    (`gn_stream_bwd_stats`, chunk partials; `gn_finalize_bwd_stats` folds
//    them), per-chunk channel partials of dz*xh and dz
//    (`gn_stream_bwd_partials`), their fold (`gn_finalize_bwd`: the group
//    means and dscale/dbias), then `gn_apply_bwd`: x read three times, dy
//    twice, dx written once (~12 bytes an element in bf16; under the 50 MB
//    L2 the re-reads mostly hit it).
// Every cross-CTA sum is a fixed-order fold of partials, with no atomics:
// two calls give the same bits.
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
constexpr int kBwdMinSlice = 128;  // the backward's narrowest slice: MIN_SLICE_BYTES

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

// ops/groupnorm.py `gn_resident_config` mirrors this choice. The backward
// (`bwd`) holds x and dy: 200 KB of the two a CTA, and its own buffers.
bool resident_config(int b, int hw, int c, int groups, int itemsize, int min_slice, ResCfg* cfg,
                     bool bwd = false) {
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
    const long data = (long)nbox * br * sb * (bwd ? 2 : 1);
    if (data > kDataMax) continue;
    cfg->gpc = gpc;
    cfg->cs = cs;
    cfg->rpc = rpc;
    cfg->br = br;
    cfg->nbox = nbox;
    // alignment slack, x, the box barriers, the channel partials [2][w][rg],
    // the warps' partials [2][max(8, gpc)], the group partials and the group
    // statistics [gpc][2] each; the backward: x and dy, a barrier a box of
    // each, the row groups' partials [2][rg][w], the channel sums [2][w],
    // two exchanges' group partials [2][gpc][2] and the group terms [gpc][4]
    cfg->smem = bwd ? 128 + (int)data + 16 * nbox + 4 * (2 * rg * w + 2 * w + 8 * gpc)
                    : 128 + (int)data + 8 * nbox + 4 * (2 * rg * w + 2 * max(8, gpc) + 4 * gpc);
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
  return encode_map(map, type, 3, x, dims, strides, box, elem, CU_TENSOR_MAP_SWIZZLE_NONE);
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// dz = dy*SiLU'(y), SiLU'(y) = s*(1 + y*(1 - s)) with s = sigmoid(y) and
// y = xh*scale + bias; dz = dy without SiLU.
template <bool SILU>
__device__ __forceinline__ float grad_z(float dy, float xh, float sc, float bi) {
  if (!SILU) return dy;
  const float y = fmaf(xh, sc, bi);
  const float s = 1.f / (1.f + __expf(-y));
  return dy * s * fmaf(y, 1.f - s, 1.f);
}

// dx of one element: rstd*scale*dz - (c1 + c2*xh), c1 = rstd*mean_group(g)
// and c2 = rstd*mean_group(g*xh) (0 where the variance's clamp held).
__device__ __forceinline__ float grad_x(float dz, float xh, float rs, float sc, float c1,
                                        float c2) {
  return fmaf(rs * sc, dz, -fmaf(c2, xh, c1));
}

// grid (cs, G/gpc, B), cluster (cs, 1, 1), kThreads threads: as
// `gn_resident`, with dy beside x in shared memory. Where pa is not null,
// each CTA writes its channels' partials of dz*xh (pa) and dz (pb) to row
// b*cs + rank of (B*cs, C).
template <typename T, typename ST, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_resident_bwd(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
                T* __restrict__ dx, const ST* __restrict__ scale, const ST* __restrict__ bias,
                float* __restrict__ pa, float* __restrict__ pb, int hw, int c, int cpg, int gpc,
                int rpc, int br, float eps) {
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
  const size_t box = (size_t)br * w;
  T* xs = reinterpret_cast<T*>(base);
  T* dys = xs + nbox * box;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dys + nbox * box);  // x's boxes, then dy's
  float* red = reinterpret_cast<float*>(bars + 2 * nbox);          // [2][rg][w]
  float* chan = red + 2 * rg * w;                                  // [2][w]
  float* parts = chan + 2 * w;                                     // [2 exchanges][gpc][2]
  float* stat = parts + 4 * gpc;                                   // [gpc][mean, rstd, c1, c2]
  const float n = (float)hw * (float)cpg;

  if (tid == 0) {
    for (int i = 0; i < boxes; ++i) {
      mbar_init(&bars[i], 1);
      mbar_init(&bars[nbox + i], 1);
    }
    mbar_fence_init();
    for (int i = 0; i < boxes; ++i) {
      mbar_expect_tx(&bars[i], (uint32_t)(box * sizeof(T)));
      tma_load_3d(xs + i * box, &xmap, &bars[i], c0, r0 + i * br, b);
    }
    for (int i = 0; i < boxes; ++i) {
      mbar_expect_tx(&bars[nbox + i], (uint32_t)(box * sizeof(T)));
      tma_load_3d(dys + i * box, &dymap, &bars[nbox + i], c0, r0 + i * br, b);
    }
  }
  float sc[V], bi[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sc[k] = g < rg ? to_f(scale[c0 + v * V + k]) : 0.f;
    bi[k] = g < rg ? to_f(bias[c0 + v * V + k]) : 0.f;
  }
  __syncthreads();

  // 1. the statistics: per-channel sums over this CTA's rows (thread (v, g)
  // takes channel vector v of rows g, g + rg, ... of each box), channel
  // totals, this CTA's group partials, then the cluster's in rank order
  if (g < rg) {
    float s[V], q[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
    for (int i = 0; i < boxes; ++i) {
      mbar_wait(&bars[i], 0);
      const int rend = min(nrows, (i + 1) * br);
      for (int r = i * br + g; r < rend; r += rg) {
        float f[V];
        load_vec<T, V>(xs + (size_t)r * w + v * V, f);
        accumulate<V>(s, q, f);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[g * w + v * V + k] = s[k];
      red[(rg + g) * w + v * V + k] = q[k];
    }
  }
  __syncthreads();
  for (int ch = tid; ch < w; ch += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < rg; ++k) {
      ts += red[k * w + ch];
      tq += red[(rg + k) * w + ch];
    }
    chan[ch] = ts;
    chan[w + ch] = tq;
  }
  __syncthreads();
  if (tid < gpc) {
    float ts = 0.f, tq = 0.f;
    for (int ch = tid * cpg; ch < (tid + 1) * cpg; ++ch) {
      ts += chan[ch];
      tq += chan[w + ch];
    }
    parts[2 * tid] = ts;
    parts[2 * tid + 1] = tq;
  }
  cluster.sync();
  if (tid < gpc) {
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* p = cluster.map_shared_rank(parts, (unsigned)k);
      ts += p[2 * tid];
      tq += p[2 * tid + 1];
    }
    const float mean = ts / n;
    const float var = tq / n - mean * mean;
    stat[4 * tid] = mean;
    stat[4 * tid + 1] = rsqrtf(fmaxf(var, 0.f) + eps);
    stat[4 * tid + 2] = var >= 0.f ? 1.f : 0.f;  // whether the clamp let the variance through
  }
  __syncthreads();

  // 2. per-channel sums of dz*xh and dz over this CTA's rows, then the
  // group partials of scale*(both), exchanged as the statistics were
  float mu[V], rs[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int gi = (v * V + k) / cpg;
    mu[k] = g < rg ? stat[4 * gi] : 0.f;
    rs[k] = g < rg ? stat[4 * gi + 1] : 0.f;
  }
  if (g < rg) {
    float a[V], s[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = s[k] = 0.f;
    for (int i = 0; i < boxes; ++i) {
      mbar_wait(&bars[nbox + i], 0);
      const int rend = min(nrows, (i + 1) * br);
      for (int r = i * br + g; r < rend; r += rg) {
        float f[V], d[V];
        load_vec<T, V>(xs + (size_t)r * w + v * V, f);
        load_vec<T, V>(dys + (size_t)r * w + v * V, d);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (f[k] - mu[k]) * rs[k];
          const float dz = grad_z<SILU>(d[k], xh, sc[k], bi[k]);
          a[k] = fmaf(dz, xh, a[k]);
          s[k] += dz;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[g * w + v * V + k] = a[k];
      red[(rg + g) * w + v * V + k] = s[k];
    }
  }
  __syncthreads();
  for (int ch = tid; ch < w; ch += kThreads) {
    float ta = 0.f, ts = 0.f;
    for (int k = 0; k < rg; ++k) {
      ta += red[k * w + ch];
      ts += red[(rg + k) * w + ch];
    }
    chan[ch] = ta;
    chan[w + ch] = ts;
    if (pa != nullptr) {
      const size_t o = ((size_t)b * cs + rank) * c + c0 + ch;
      pa[o] = ta;
      pb[o] = ts;
    }
  }
  __syncthreads();
  float* parts2 = parts + 2 * gpc;
  if (tid < gpc) {
    float ta = 0.f, ts = 0.f;
    for (int ch = tid * cpg; ch < (tid + 1) * cpg; ++ch) {
      const float s = to_f(scale[c0 + ch]);
      ta = fmaf(s, chan[ch], ta);
      ts = fmaf(s, chan[w + ch], ts);
    }
    parts2[2 * tid] = ta;
    parts2[2 * tid + 1] = ts;
  }
  cluster.sync();  // also: every CTA has finished reading the others' first partials
  if (tid < gpc) {
    float ta = 0.f, ts = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* p = cluster.map_shared_rank(parts2, (unsigned)k);
      ta += p[2 * tid];
      ts += p[2 * tid + 1];
    }
    const float r = stat[4 * tid + 1];
    const float keep = stat[4 * tid + 2];
    stat[4 * tid + 2] = r * (ts / n);
    stat[4 * tid + 3] = r * keep * (ta / n);
  }
  cluster_arrive();  // this CTA's reads of the others' partials are done
  __syncthreads();

  // 3. dx from shared memory
  if (g < rg) {
    float c1[V], c2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int gi = (v * V + k) / cpg;
      c1[k] = stat[4 * gi + 2];
      c2[k] = stat[4 * gi + 3];
    }
    T* dxb = dx + ((size_t)b * hw + r0) * c + c0 + v * V;
    for (int r = g; r < nrows; r += rg) {
      float f[V], d[V];
      load_vec<T, V>(xs + (size_t)r * w + v * V, f);
      load_vec<T, V>(dys + (size_t)r * w + v * V, d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (f[k] - mu[k]) * rs[k];
        f[k] = grad_x(grad_z<SILU>(d[k], xh, sc[k], bi[k]), xh, rs[k], sc[k], c1[k], c2[k]);
      }
      store_vec<T, V>(dxb + (size_t)r * c, f);
    }
  }
  cluster_wait();  // no CTA leaves while another may still read its partials
}

// grid (n_chunks, B): as `gn_stream_stats`, the chunk's group partials of
// sum x and sum x^2 into psum, psq (B, n_chunks, G), without the fold.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_stream_bwd_stats(const T* __restrict__ x, float* __restrict__ psum, float* __restrict__ psq,
                    int hw, int c, int groups, int rows_per_chunk) {
  extern __shared__ float red[];  // sums [rg][c], then squares; then [2][c]
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
  float* csum = red + 2 * rg * c;
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
}

constexpr int kFoldThreads = 128;

// grid (G, B), kFoldThreads threads: the chunk partials of (b, group) folded
// in a fixed order into stat (B, G, 4): mean, rstd, whether the clamp let
// the variance through (1 or 0).
__global__ void __launch_bounds__(kFoldThreads)
gn_finalize_bwd_stats(const float* __restrict__ psum, const float* __restrict__ psq,
                      float* __restrict__ stat, int n_chunks, float n, float eps) {
  __shared__ float wsum[2][kFoldThreads / 32];
  const int tid = threadIdx.x, gi = blockIdx.x, groups = gridDim.x, b = blockIdx.y;
  float ts = 0.f, tq = 0.f;
  for (int k = tid; k < n_chunks; k += kFoldThreads) {
    const size_t o = ((size_t)b * n_chunks + k) * groups + gi;
    ts += psum[o];
    tq += psq[o];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ts += __shfl_xor_sync(0xffffffffu, ts, o);
    tq += __shfl_xor_sync(0xffffffffu, tq, o);
  }
  if (tid % 32 == 0) {
    wsum[0][tid / 32] = ts;
    wsum[1][tid / 32] = tq;
  }
  __syncthreads();
  if (tid == 0) {
    ts = tq = 0.f;
    for (int k = 0; k < kFoldThreads / 32; ++k) {
      ts += wsum[0][k];
      tq += wsum[1][k];
    }
    const float mean = ts / n;
    const float var = tq / n - mean * mean;
    float* s = stat + ((size_t)b * groups + gi) * 4;
    s[0] = mean;
    s[1] = rsqrtf(fmaxf(var, 0.f) + eps);
    s[2] = var >= 0.f ? 1.f : 0.f;
  }
}

// grid (n_chunks, B): the chunk's per-channel sums of dz*xh and dz into row
// b*n_chunks + chunk of pa, pb (B*n_chunks, C); stat as
// `gn_finalize_bwd_stats` leaves it.
template <typename T, typename ST, int V, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_stream_bwd_partials(const T* __restrict__ x, const T* __restrict__ dy,
                       const ST* __restrict__ scale, const ST* __restrict__ bias,
                       const float* __restrict__ stat, float* __restrict__ pa,
                       float* __restrict__ pb, int hw, int c, int groups, int rows_per_chunk) {
  extern __shared__ float red[];  // dz*xh [rg][c], then dz
  const int tid = threadIdx.x, chunk = blockIdx.x, n_chunks = gridDim.x, b = blockIdx.y;
  const int nv = c / V, cpg = c / groups;
  const bool wide = nv > kThreads;
  const int rg = wide ? 1 : kThreads / nv, g = wide ? 0 : tid / nv;
  const int r0 = chunk * rows_per_chunk, r1 = min(hw, r0 + rows_per_chunk);
  const size_t row0 = (size_t)b * hw;
  if (g < rg) {
    for (int v = wide ? tid : tid % nv; v < nv; v += kThreads) {
      float mu[V], rs[V], sc[V], bi[V], a[V], s[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int ch = v * V + k;
        const float* st = stat + ((size_t)b * groups + ch / cpg) * 4;
        mu[k] = st[0];
        rs[k] = st[1];
        sc[k] = to_f(scale[ch]);
        bi[k] = to_f(bias[ch]);
        a[k] = s[k] = 0.f;
      }
      const T* px = x + row0 * c + v * V;
      const T* pd = dy + row0 * c + v * V;
      int r = r0 + g;
      for (; r + rg < r1; r += 2 * rg) {  // two rows of x and dy in flight
        float f0[V], f1[V], d0[V], d1[V];
        load_vec<T, V>(px + (size_t)r * c, f0);
        load_vec<T, V>(pd + (size_t)r * c, d0);
        load_vec<T, V>(px + (size_t)(r + rg) * c, f1);
        load_vec<T, V>(pd + (size_t)(r + rg) * c, d1);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh0 = (f0[k] - mu[k]) * rs[k], xh1 = (f1[k] - mu[k]) * rs[k];
          const float dz0 = grad_z<SILU>(d0[k], xh0, sc[k], bi[k]);
          const float dz1 = grad_z<SILU>(d1[k], xh1, sc[k], bi[k]);
          a[k] = fmaf(dz1, xh1, fmaf(dz0, xh0, a[k]));
          s[k] += dz0;
          s[k] += dz1;
        }
      }
      for (; r < r1; r += rg) {
        float f[V], d[V];
        load_vec<T, V>(px + (size_t)r * c, f);
        load_vec<T, V>(pd + (size_t)r * c, d);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (f[k] - mu[k]) * rs[k];
          const float dz = grad_z<SILU>(d[k], xh, sc[k], bi[k]);
          a[k] = fmaf(dz, xh, a[k]);
          s[k] += dz;
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        red[g * c + v * V + k] = a[k];
        red[(rg + g) * c + v * V + k] = s[k];
      }
    }
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += kThreads) {
    float ta = 0.f, ts = 0.f;
    for (int k = 0; k < rg; ++k) {
      ta += red[k * c + ch];
      ts += red[(rg + k) * c + ch];
    }
    pa[((size_t)b * n_chunks + chunk) * c + ch] = ta;
    pb[((size_t)b * n_chunks + chunk) * c + ch] = ts;
  }
}

// grid (G), kThreads threads: the channel partials of the group's channels
// (rows b*nparts .. b*nparts + nparts - 1 of pa, pb (B*nparts, C)) folded
// over the parts in a fixed order, as many batch rows at once as the
// threads cover. Where gstat is not null: gstat (B, G, 4) = mean, rstd, c1,
// c2 of `grad_x`, from stat (B, G, 4) as `gn_finalize_bwd_stats` leaves it.
// Where dscale is not null: dscale_c, dbias_c, the sums over the batch rows
// in order, in ST. Shared memory: 4*max(kThreads, cpg) + 2*cpg floats.
template <typename ST>
__global__ void __launch_bounds__(kThreads)
gn_finalize_bwd(const float* __restrict__ pa, const float* __restrict__ pb,
                const ST* __restrict__ scale, const float* __restrict__ stat,
                float* __restrict__ gstat, ST* __restrict__ dscale, ST* __restrict__ dbias,
                int batch, int nparts, int c, float n) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, gi = blockIdx.x, groups = gridDim.x;
  const int cpg = c / groups, c0 = gi * cpg;
  const int span = max(kThreads, cpg);
  const int rows = max(1, kThreads / cpg);  // batch rows a pass
  float* red = sm;                // [2][lanes * items]
  float* tot = red + 2 * span;    // [2][items]: the pass's (batch row, channel) totals
  float* acc = tot + 2 * span;    // [2][cpg]: the sums over the batch rows
  for (int b0 = 0; b0 < batch; b0 += rows) {
    const int nb = min(rows, batch - b0), items = nb * cpg;
    const int lanes = items < kThreads ? kThreads / items : 1;
    for (int e = tid; e < lanes * items; e += kThreads) {
      const int it = e % items, lane = e / items;
      const size_t row = (size_t)(b0 + it / cpg) * nparts;
      float ta = 0.f, ts = 0.f;
      for (int k = lane; k < nparts; k += lanes) {
        const size_t o = (row + k) * c + c0 + it % cpg;
        ta += pa[o];
        ts += pb[o];
      }
      red[e] = ta;
      red[lanes * items + e] = ts;
    }
    __syncthreads();
    for (int it = tid; it < items; it += kThreads) {
      float ta = 0.f, ts = 0.f;
      for (int lane = 0; lane < lanes; ++lane) {
        ta += red[lane * items + it];
        ts += red[(lanes + lane) * items + it];
      }
      tot[it] = ta;
      tot[items + it] = ts;
    }
    __syncthreads();
    if (gstat != nullptr) {
      for (int r = tid; r < nb; r += kThreads) {
        float ga = 0.f, gs = 0.f;
        for (int cl = 0; cl < cpg; ++cl) {
          const float s = to_f(scale[c0 + cl]);
          ga = fmaf(s, tot[r * cpg + cl], ga);
          gs = fmaf(s, tot[items + r * cpg + cl], gs);
        }
        const size_t o = ((size_t)(b0 + r) * groups + gi) * 4;
        gstat[o] = stat[o];
        gstat[o + 1] = stat[o + 1];
        gstat[o + 2] = stat[o + 1] * (gs / n);
        gstat[o + 3] = stat[o + 1] * stat[o + 2] * (ga / n);
      }
    }
    for (int cl = tid; cl < cpg; cl += kThreads) {
      float ta = b0 == 0 ? 0.f : acc[cl], ts = b0 == 0 ? 0.f : acc[cpg + cl];
      for (int r = 0; r < nb; ++r) {
        ta += tot[r * cpg + cl];
        ts += tot[items + r * cpg + cl];
      }
      acc[cl] = ta;
      acc[cpg + cl] = ts;
    }
    __syncthreads();  // red and tot serve the next pass
  }
  if (dscale != nullptr) {
    for (int cl = tid; cl < cpg; cl += kThreads) {
      dscale[c0 + cl] = from_f<ST>(acc[cl]);
      dbias[c0 + cl] = from_f<ST>(acc[cpg + cl]);
    }
  }
}

// grid (blocks, B): thread (v, g) of block bx takes channel vector v of rows
// bx*rg + g, then every gridDim.x*rg rows, as `gn_stream_apply`; gstat as
// `gn_finalize_bwd` leaves it.
template <typename T, typename ST, int V, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply_bwd(const T* __restrict__ x, const T* __restrict__ dy, const ST* __restrict__ scale,
             const ST* __restrict__ bias, const float* __restrict__ gstat, T* __restrict__ dx,
             int hw, int c, int groups) {
  const int tid = threadIdx.x, b = blockIdx.y;
  const int nv = c / V, cpg = c / groups;
  const bool wide = nv > kThreads;
  const int rg = wide ? 1 : kThreads / nv, g = wide ? 0 : tid / nv;
  if (g >= rg) return;
  const int step = gridDim.x * rg;
  const size_t row0 = (size_t)b * hw;
  for (int v = wide ? tid : tid % nv; v < nv; v += kThreads) {
    float mu[V], rs[V], sc[V], bi[V], c1[V], c2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ch = v * V + k;
      const float* st = gstat + ((size_t)b * groups + ch / cpg) * 4;
      mu[k] = st[0];
      rs[k] = st[1];
      c1[k] = st[2];
      c2[k] = st[3];
      sc[k] = to_f(scale[ch]);
      bi[k] = to_f(bias[ch]);
    }
    const T* px = x + row0 * c + v * V;
    const T* pd = dy + row0 * c + v * V;
    T* po = dx + row0 * c + v * V;
    int r = blockIdx.x * rg + g;
    for (; r + step < hw; r += 2 * step) {  // two rows of x and dy in flight
      float f0[V], f1[V], d0[V], d1[V];
      load_vec<T, V>(px + (size_t)r * c, f0);
      load_vec<T, V>(pd + (size_t)r * c, d0);
      load_vec<T, V>(px + (size_t)(r + step) * c, f1);
      load_vec<T, V>(pd + (size_t)(r + step) * c, d1);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh0 = (f0[k] - mu[k]) * rs[k], xh1 = (f1[k] - mu[k]) * rs[k];
        f0[k] = grad_x(grad_z<SILU>(d0[k], xh0, sc[k], bi[k]), xh0, rs[k], sc[k], c1[k], c2[k]);
        f1[k] = grad_x(grad_z<SILU>(d1[k], xh1, sc[k], bi[k]), xh1, rs[k], sc[k], c1[k], c2[k]);
      }
      store_vec<T, V>(po + (size_t)r * c, f0);
      store_vec<T, V>(po + (size_t)(r + step) * c, f1);
    }
    for (; r < hw; r += step) {
      float f[V], d[V];
      load_vec<T, V>(px + (size_t)r * c, f);
      load_vec<T, V>(pd + (size_t)r * c, d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = (f[k] - mu[k]) * rs[k];
        f[k] = grad_x(grad_z<SILU>(d[k], xh, sc[k], bi[k]), xh, rs[k], sc[k], c1[k], c2[k]);
      }
      store_vec<T, V>(po + (size_t)r * c, f);
    }
  }
}

// The fold of dscale/dbias partials (and, where gstat is not null, the
// group terms): one CTA a group.
template <typename ST>
cudaError_t launch_finalize(const float* pa, const float* pb, const ST* scale, const float* stat,
                            float* gstat, ST* dscale, ST* dbias, int b, int nparts, int c,
                            int groups, float n, cudaStream_t st) {
  const int cpg = c / groups;
  const size_t smem = sizeof(float) * (4 * (size_t)std::max(kThreads, cpg) + 2 * (size_t)cpg);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  auto fin = gn_finalize_bwd<ST>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fin, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fin<<<groups, kThreads, smem, st>>>(pa, pb, scale, stat, gstat, dscale, dbias, b, nparts, c, n);
  return cudaGetLastError();
}

template <typename T, typename ST, bool SILU>
cudaError_t launch_resident_bwd(const void* x, const void* dy, const void* scale, const void* bias,
                                void* dx, float* pa, float* pb, void* dscale, void* dbias, int b,
                                int hw, int c, int groups, float eps, cudaStream_t st) {
  ResCfg cfg;
  if (!resident_config(b, hw, c, groups, (int)sizeof(T), kBwdMinSlice, &cfg, true))
    return cudaErrorInvalidValue;
  const int cpg = c / groups;
  CUtensorMap xmap, dymap;
  if (!make_gn_map(&xmap, x, b, hw, c, (int)sizeof(T), cfg.gpc * cpg, cfg.br) ||
      !make_gn_map(&dymap, dy, b, hw, c, (int)sizeof(T), cfg.gpc * cpg, cfg.br))
    return cudaErrorInvalidValue;
  auto kernel = gn_resident_bwd<T, ST, SILU>;
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
  T* dxp = static_cast<T*>(dx);
  const ST* sp = static_cast<const ST*>(scale);
  const ST* bp = static_cast<const ST*>(bias);
  float* pap = dscale != nullptr ? pa : nullptr;
  void* args[] = {&xmap, &dymap, &dxp, &sp, &bp, &pap, &pb, &hw, &c, (void*)&cpg, &cfg.gpc,
                  &cfg.rpc, &cfg.br, &eps};
  err = cudaLaunchKernelExC(&lc, (const void*)kernel, args);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || dscale == nullptr) return err;
  return launch_finalize<ST>(pa, pb, sp, nullptr, nullptr, static_cast<ST*>(dscale),
                             static_cast<ST*>(dbias), b, cfg.cs, c, groups,
                             (float)hw * (float)cpg, st);
}

template <typename T, typename ST, int V, bool SILU>
cudaError_t launch_stream_bwd(const T* x, const T* dy, const ST* scale, const ST* bias, T* dx,
                              float* psum, float* psq, float* stat, float* pa, float* pb,
                              float* gstat, ST* dscale, ST* dbias, int b, int hw, int c,
                              int groups, int n_chunks, int rows, float eps, cudaStream_t st) {
  const int nv = c / V;
  const int rg = nv > kThreads ? 1 : kThreads / nv;
  const size_t smem = sizeof(float) * 2 * (size_t)(rg + 1) * c;
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  auto stats = gn_stream_bwd_stats<T, V>;
  auto partials = gn_stream_bwd_partials<T, ST, V, SILU>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stats, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(partials, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float n = (float)hw * (float)(c / groups);
  stats<<<dim3(n_chunks, b), kThreads, smem, st>>>(x, psum, psq, hw, c, groups, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_bwd_stats<<<dim3(groups, b), kFoldThreads, 0, st>>>(psum, psq, stat, n_chunks, n,
                                                                   eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  partials<<<dim3(n_chunks, b), kThreads, smem, st>>>(x, dy, scale, bias, stat, pa, pb, hw, c,
                                                      groups, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_finalize<ST>(pa, pb, scale, stat, gstat, dscale, dbias, b, n_chunks, c, groups, n,
                            st);
  if (err != cudaSuccess) return err;
  long blocks = (hw + rg - 1) / rg;
  const long cap = kApplyCtas / b > 0 ? kApplyCtas / b : 1;
  if (blocks > cap) blocks = cap;
  gn_apply_bwd<T, ST, V, SILU><<<dim3((unsigned)blocks, b), kThreads, 0, st>>>(
      x, dy, scale, bias, gstat, dx, hw, c, groups);
  return cudaGetLastError();
}

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

// The backward's resident route. dy as x; dx: (B, HW, C) like x; pa, pb:
// (B*cs, C) f32 scratch (cs the cluster size of `ldt_groupnorm_resident_bwd_config`);
// dscale, dbias: (C,) in sdtype, or both null where the parameters want no
// gradient (then pa, pb are not touched). Returns as `ldt_groupnorm_resident`.
extern "C" int ldt_groupnorm_resident_bwd(const void* x, const void* dy, const void* scale,
                                          const void* bias, void* dx, float* pa, float* pb,
                                          void* dscale, void* dbias, int batch, int hw, int c,
                                          int groups, float eps, int silu, int dtype, int sdtype,
                                          void* stream) {
  if (!aligned16(x) || !aligned16(dy) || !aligned16(dx) || dtype < 0 || dtype > 1 || sdtype < 0 ||
      sdtype > 1 || (dscale == nullptr) != (dbias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LDT_RESB(T, ST, S)                                                                       \
  return (int)launch_resident_bwd<T, ST, S>(x, dy, scale, bias, dx, pa, pb, dscale, dbias, batch, \
                                            hw, c, groups, eps, st);
  if (dtype == 0 && sdtype == 0) { if (silu) LDT_RESB(float, float, true) LDT_RESB(float, float, false) }
  if (dtype == 0 && sdtype == 1) { if (silu) LDT_RESB(float, bf16, true) LDT_RESB(float, bf16, false) }
  if (dtype == 1 && sdtype == 0) { if (silu) LDT_RESB(bf16, float, true) LDT_RESB(bf16, float, false) }
  if (silu) LDT_RESB(bf16, bf16, true)
  LDT_RESB(bf16, bf16, false)
#undef LDT_RESB
}

// The backward's streamed route. psum, psq: (B, n_chunks, G); stat, gstat:
// (B, G, 4); pa, pb: (B*n_chunks, C); all f32 scratch. dscale, dbias as
// `ldt_groupnorm_resident_bwd`; n_chunks, rows and vec as
// `ldt_groupnorm_stream`.
extern "C" int ldt_groupnorm_stream_bwd(const void* x, const void* dy, const void* scale,
                                        const void* bias, void* dx, float* psum, float* psq,
                                        float* stat, float* pa, float* pb, float* gstat,
                                        void* dscale, void* dbias, int batch, int hw, int c,
                                        int groups, int n_chunks, int rows, float eps, int silu,
                                        int dtype, int sdtype, int vec, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (batch < 1 || batch > 65535 || hw < 1 || c < 1 || groups < 1 || groups > 65535 ||
      c % groups || n_chunks < 1 || rows < 1 || (long)n_chunks * rows < hw ||
      (long)(n_chunks - 1) * rows >= hw || dtype < 0 || dtype > 1 || sdtype < 0 || sdtype > 1 ||
      (dscale == nullptr) != (dbias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vec && ((c * itemsize) % 16 || !aligned16(x) || !aligned16(dy) || !aligned16(dx)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LDT_STRB(T, ST, V, S)                                                                    \
  return (int)launch_stream_bwd<T, ST, V, S>(                                                    \
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const ST*>(scale),        \
      static_cast<const ST*>(bias), static_cast<T*>(dx), psum, psq, stat, pa, pb, gstat,         \
      static_cast<ST*>(dscale), static_cast<ST*>(dbias), batch, hw, c, groups, n_chunks, rows,   \
      eps, st);
#define LDT_STRB_V(T, ST, V) \
  if (silu) LDT_STRB(T, ST, V, true) LDT_STRB(T, ST, V, false)
  if (dtype == 0 && sdtype == 0) { if (vec) { LDT_STRB_V(float, float, 4) } LDT_STRB_V(float, float, 1) }
  if (dtype == 0 && sdtype == 1) { if (vec) { LDT_STRB_V(float, bf16, 4) } LDT_STRB_V(float, bf16, 1) }
  if (dtype == 1 && sdtype == 0) { if (vec) { LDT_STRB_V(bf16, float, 8) } LDT_STRB_V(bf16, float, 1) }
  if (vec) { LDT_STRB_V(bf16, bf16, 8) }
  LDT_STRB_V(bf16, bf16, 1)
#undef LDT_STRB_V
#undef LDT_STRB
}

// The backward resident route's choice, as `ldt_groupnorm_resident_config`
// (ops/groupnorm.py `gn_resident_config(..., backward=True)` mirrors it).
extern "C" int ldt_groupnorm_resident_bwd_config(int batch, int hw, int c, int groups, int dtype,
                                                 int* out) {
  ResCfg cfg;
  if (!resident_config(batch, hw, c, groups, dtype == 0 ? 4 : 2, kBwdMinSlice, &cfg, true))
    return 0;
  const int vals[6] = {cfg.gpc, cfg.cs, cfg.rpc, cfg.br, cfg.nbox, cfg.smem};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 1;
}
