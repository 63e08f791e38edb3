// int4 weight-only dequant-matmul for Hopper (sm_90a): one launch per call.
//
// Replaces sesameai_tts_tpu/ops/quant.py::quant4_matmul_pallas (body
// _q4mv_kernel_factory): y (S, F) = bf16(x) (S, D) @ dequant4(q4, scale),
// where q4 (D/2, F) packs two signed nibbles per byte in the split-half
// layout (byte [d, f] holds row d in its low nibble and row d + D/2 in its
// high nibble) and scale (G, F) holds one f32 scale per group of D/G rows:
// groups 0..G/2-1 cover the low half, G/2..G-1 the high half, so packed
// row d belongs to group d / (D/G) of each half.  For every group the
// kernel takes the partial dot of the nibbles (integers, exact in f32)
// with bf16 x in f32, multiplies that partial sum by the group's scale and
// adds it to an f32 sum; the result is cast to bf16.  A bf16 x nibble
// product is exact in f32, so the arithmetic is the TPU kernel's up to the
// order of the f32 sums.
//
// What bounds it: at decode sizes (S = 1 on every path) the packed weight
// bytes, D*F/2 per call; x, the scales and y are a few KB.  The decoder's
// small shapes (0.5-1 MB) take well under a microsecond at 3.35 TB/s, so
// there the floor is the chain of latencies: the launch, one DRAM round
// trip, the reductions and one cluster barrier.
//
// What the design does about it (quant_matmul.cu's design, for nibbles and
// group scales):
//  * one launch per call.  Grid (splits, column tiles, S tiles) with
//    thread-block clusters of `splits` blocks along x: the blocks of a
//    cluster split the packed rows.  A reduce-scatter finishes the sum:
//    each block leaves its scaled partial of every 4-column vector in the
//    shared memory of the vector's owner block (distributed shared
//    memory), one cluster barrier, and each owner adds the blocks'
//    partials in rank order and casts.  No workspace, no counter, no
//    atomics: the result is bit-deterministic and a CUDA-graph replay
//    needs no reset;
//  * the geometry (ops/quant.py::_q4mm_geometry) takes the narrowest
//    column tile (32 columns at S = 1) and the fewest splits (clusters of
//    up to 16, non-portable) whose grid reaches a block per 4 KB of packed
//    weight, that aim held between one and two blocks per SM: small
//    clusters keep the barrier short (the w13 shapes need none: their 512
//    column tiles alone put ~4 blocks on each SM);
//  * a pair of lanes owns VEC = 16 neighbouring columns (fewer at wider S
//    tiles) and reads them as one 16-byte ld.global.nc per packed row (16
//    columns x 2 weight rows; both lanes ask for the same bytes, one
//    request): the even lane takes the low nibbles against x's low half,
//    the odd lane the high nibbles against its high half, so a lane holds
//    one f32 sum per column.  That keeps a block within 128 registers a
//    thread, so four blocks fit on an SM and the clusters of a grid fit on
//    the card at once.  `tpr` pairs cover a tile row, the block's 64 / tpr
//    row groups walk the split's rows, and every lane keeps U = 4 rows of
//    loads in flight, issuing the next 4 before it uses the current ones.
//    Other layouts measured slower at S = 1 on the card (PERF.md):
//    16 columns a thread with both nibbles (208 registers: two blocks an
//    SM, and clusters of 9-11 waited for a second wave), the pair layout
//    with 8 rows in flight (three blocks an SM), 8 columns a thread by
//    8-byte loads, and a per-lane cp.async ring of 16 rows in shared
//    memory;
//  * x is read straight from global memory beside the weight loads (a
//    warp's lanes share its rows, so L1 broadcasts them): no staging pass
//    and no __syncthreads before the reduction;
//  * nibble -> f32 without an I2F: one shift and one LOP3 bias the four
//    low (or high) nibbles of a word to n + 8 in [0, 15], PRMT moves each
//    into the mantissa of 2^23 and one FADD removes 2^23 + 8, which is
//    exact;
//  * scale groups: a split may lie inside one group (G = 2, the trunks'
//    default, puts all rows of a half in one group) or span several.  A
//    lane keeps an f32 partial for the group its rows are in, and when its
//    rows leave the group multiplies it by the group's scale (read when
//    the group began) and adds it into its running sum; so each group a
//    block touches is scaled in that block, on each lane's share of it,
//    before the block's sums.
//  S above 8 is tiled over grid.z and each S tile re-reads the weight:
//  correct, and slow at S = 64, which no path runs (the int4 prefill takes
//  the dense bf16 shadow).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;  // blocks of a cluster (non-portable above 8)
constexpr unsigned FULL = 0xffffffffu;

template <int VEC> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = uint32_t; };

// The nibble biased into byte I of `biased` (n + 8, in [0, 15]) as the
// float n: 0x4B0000uu is 2^23 + uu exactly.
template <int I>
__device__ __forceinline__ float nibble_value(uint32_t biased) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | I)) - 8388616.f;
}

// y[0..3] = bf16(sum) (8-byte aligned)
__device__ __forceinline__ void store4(__nv_bfloat16* y, float4 sum) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x, sum.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z, sum.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(y) = packed;
}

// U packed rows r0, r0 + step, ... of this lane's columns, and the x
// values of this lane's half for each of them (0 past the split's end)
template <int S_TILE, int VEC, int U>
__device__ __forceinline__ void fetch(typename Vec<VEC>::type (&w)[U], float (&xv)[U][S_TILE],
                                      const __nv_bfloat16* __restrict__ x,
                                      const int8_t* __restrict__ q4, int r0, int step, int k_end,
                                      bool active, int f, int s0, int S, int D, int F, int half) {
  using W = typename Vec<VEC>::type;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = r0 + u * step;
    const bool ok = r < k_end;
    W v{};
    if (ok && active) v = __ldg(reinterpret_cast<const W*>(q4 + static_cast<size_t>(r) * F + f));
    w[u] = v;
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
      xv[u][s] = ok && s0 + s < S
                     ? __bfloat162float(x[static_cast<size_t>(s0 + s) * D + half * (D / 2) + r])
                     : 0.f;
    }
  }
}

// Block (split, column tile, S tile): over packed rows [split *
// rows_per_split, +rows_per_split) for its S_TILE rows of x and tpr * VEC
// columns, the group-scaled partial sums; then the cluster's fixed-order
// sum and the cast.  The cluster is the `splits` blocks along x.  The two
// lanes of a pair load the same 16 bytes (one request) and take one half
// each: the even lane the low nibbles against x's low half, the odd lane
// the high nibbles against its high half.
template <int S_TILE, int VEC>
__global__ void __launch_bounds__(THREADS, 4)
q4mm_cluster(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int S, int D, int F,
             int G, int tpr, int rows_per_split) {
  using W = typename Vec<VEC>::type;
  constexpr int WORDS = VEC / 4;
  constexpr int U = S_TILE == 1 ? 4 : 2;  // rows in flight per lane, twice over
  constexpr int COLS = 16 * VEC;          // the widest column tile of this VEC (16 pairs)
  __shared__ __align__(16) float part[WARPS][S_TILE][COLS];
  // the cluster's partials of the vectors this block finishes: splits * per
  // 4-vectors, per = ceil(S_TILE * ct / 4 / splits)
  __shared__ __align__(16) float recv[S_TILE * COLS + 4 * MAX_CLUSTER];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int D2 = D / 2;
  const int gs = D / G;  // packed rows per group
  const int ct = tpr * VEC;
  const int col0 = blockIdx.y * ct;
  const int s0 = blockIdx.z * S_TILE;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int half = lane & 1;  // 0: low nibbles, 1: high nibbles
  const int pair = static_cast<int>(threadIdx.x) >> 1;
  const int step = (THREADS / 2) / tpr;  // row groups of the block
  const int f = col0 + (pair % tpr) * VEC;
  const bool active = f < F;
  const int k_begin = split * rows_per_split;
  const int k_end = min(D2, k_begin + rows_per_split);

  // acc: the running sum of scaled groups; dot: the current group's
  // partial dot of this lane's nibbles; sc: that group's scales
  float acc[S_TILE][VEC], dot[S_TILE][VEC], sc[VEC];
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[s][e] = dot[s][e] = 0.f;
  }
  auto load_scales = [&](int g) {
    const float* row = scale + static_cast<size_t>(half * (G / 2) + g) * F + f;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 a = active ? __ldg(reinterpret_cast<const float4*>(row + e))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[e] = a.x, sc[e + 1] = a.y, sc[e + 2] = a.z, sc[e + 3] = a.w;
    }
  };
  auto flush = [&]() {
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc[s][e] = fmaf(dot[s][e], sc[e], acc[s][e]);
        dot[s][e] = 0.f;
      }
    }
  };

  W wa[U];
  float xa[U][S_TILE];
  int r0 = k_begin + pair / tpr;
  int g = min(r0, D2 - 1) / gs;  // the group of the lane's first row
  int g_end = (g + 1) * gs;
  fetch<S_TILE, VEC, U>(wa, xa, x, q4, r0, step, k_end, active, f, s0, S, D, F, half);
  load_scales(g);
  for (; r0 < k_end; r0 += U * step) {
    W wb[U];
    float xb[U][S_TILE];
    fetch<S_TILE, VEC, U>(wb, xb, x, q4, r0 + U * step, step, k_end, active, f, s0, S, D, F,
                          half);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * step;
      if (r >= k_end) break;  // the split's last rows (near-uniform in a warp)
      if (r >= g_end) {       // the rows left the group: scale it, start the next
        flush();
        g = r / gs;
        g_end = (g + 1) * gs;
        load_scales(g);
      }
      const uint32_t* words = reinterpret_cast<const uint32_t*>(&wa[u]);
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        const uint32_t biased = ((words[k] >> (4 * half)) & 0x0F0F0F0Fu) ^ 0x08080808u;
        const float wf[4] = {nibble_value<0>(biased), nibble_value<1>(biased),
                             nibble_value<2>(biased), nibble_value<3>(biased)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int s = 0; s < S_TILE; ++s) {
            dot[s][4 * k + i] = fmaf(xa[u][s], wf[i], dot[s][4 * k + i]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      wa[u] = wb[u];
#pragma unroll
      for (int s = 0; s < S_TILE; ++s) xa[u][s] = xb[u][s];
    }
  }
  flush();

  // the two halves of a pair, then the warp's row groups (pairs tpr apart)
  // by a butterfly, then the block's warps in shared memory, in warp order
  for (int o = 1; o < 32; o = o == 1 ? 2 * tpr : 2 * o) {
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[s][e] += __shfl_xor_sync(FULL, acc[s][e], o);
    }
  }
  if (lane < 2 * tpr && half == 0) {
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(&part[warp][s][(lane >> 1) * VEC + e]) =
            make_float4(acc[s][e], acc[s][e + 1], acc[s][e + 2], acc[s][e + 3]);
      }
    }
  }
  // Reduce-scatter over the cluster, in 4-column vectors: block `owner`
  // finishes vectors [owner * per, +per) of the tile's S_TILE x ct/4; every
  // block leaves its partial of them in the owner's shared memory at slot
  // `split`.  One cluster barrier, and nothing is read remotely after it.
  const int ct4_shift = __ffs(ct / 4) - 1;  // tpr and VEC are powers of two
  const int n4 = S_TILE << ct4_shift;
  const int per = (n4 + splits - 1) / splits;
  __syncthreads();
  for (int vi = threadIdx.x; vi < n4; vi += THREADS) {
    const int s = vi >> ct4_shift;
    const int col = (vi & ((1 << ct4_shift) - 1)) * 4;
    float4 sum = *reinterpret_cast<const float4*>(&part[0][s][col]);
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 p = *reinterpret_cast<const float4*>(&part[w][s][col]);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const int owner = vi / per;
    float4* slot = reinterpret_cast<float4*>(&recv[(split * per + vi - owner * per) * 4]);
    *(splits == 1 ? slot : cluster.map_shared_rank(slot, owner)) = sum;
  }
  if (splits == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
  const int v_end = min(n4, (split + 1) * per);
  for (int vi = split * per + static_cast<int>(threadIdx.x); vi < v_end; vi += THREADS) {
    const int j = vi - split * per;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {  // in rank order
      if (k < splits) {
        const float4 p = *reinterpret_cast<const float4*>(&recv[(k * per + j) * 4]);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
    }
    const int s = vi >> ct4_shift;
    const int col = (vi & ((1 << ct4_shift) - 1)) * 4;
    if (s0 + s < S && col0 + col < F) store4(y + static_cast<size_t>(s0 + s) * F + col0 + col, sum);
  }
}

template <int S_TILE, int VEC>
cudaError_t launch(const void* x, const void* q4, const void* scale, void* y, int S, int D, int F,
                   int G, int splits, int rows_per_split, int tpr, cudaStream_t stream) {
  auto kernel = q4mm_cluster<S_TILE, VEC>;
  // clusters above 8 blocks must be allowed first; set once per
  // instantiation (on its first call, before any graph capture)
  static bool non_portable = false;
  if (splits > 8 && !non_portable) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  const int ct = tpr * VEC;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, (F + ct - 1) / ct, (S + S_TILE - 1) / S_TILE);
  config.blockDim = dim3(THREADS);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q4),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), S, D, F, G, tpr,
      rows_per_split);
  const cudaError_t last = cudaGetLastError();  // read and clear
  return err != cudaSuccess ? err : last;
}

}  // namespace

// x (S, D) bf16, q4 (D/2, F) int8, scale (G, F) f32, y (S, F) bf16, all
// contiguous, q4 and scale 16-byte aligned.  G even and D % G == 0; (s_tile,
// vec) one of (1, 16), (1, 8), (2, 16), (2, 8), (4, 8), (8, 4) with F % vec
// == 0; tpr (lane pairs per tile row) divides 16; 1 <= splits <= 16 with
// every split of rows_per_split packed rows non-empty.  Launches on
// `stream` and returns the launch's error (0 on success).
extern "C" int quant4_matmul(const void* x, const void* q4, const void* scale, void* y, int S,
                             int D, int F, int G, int splits, int rows_per_split, int tpr, int vec,
                             int s_tile, void* stream) {
  if (S <= 0 || D <= 0 || D % 2 != 0 || F <= 0 || G <= 0 || G % 2 != 0 || D % G != 0 ||
      vec <= 0 || F % vec != 0 || tpr <= 0 || 16 % tpr != 0 || splits < 1 ||
      splits > MAX_CLUSTER || rows_per_split <= 0 || (splits - 1) * rows_per_split >= D / 2 ||
      splits * rows_per_split < D / 2 || (F + tpr * vec - 1) / (tpr * vec) > 65535 ||
      (S + s_tile - 1) / s_tile > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = s_tile * 100 + vec;
  switch (key) {
    case 116: return launch<1, 16>(x, q4, scale, y, S, D, F, G, splits, rows_per_split, tpr, st);
    case 108: return launch<1, 8>(x, q4, scale, y, S, D, F, G, splits, rows_per_split, tpr, st);
    case 208: return launch<2, 8>(x, q4, scale, y, S, D, F, G, splits, rows_per_split, tpr, st);
    case 216: return launch<2, 16>(x, q4, scale, y, S, D, F, G, splits, rows_per_split, tpr, st);
    case 408: return launch<4, 8>(x, q4, scale, y, S, D, F, G, splits, rows_per_split, tpr, st);
    case 804: return launch<8, 4>(x, q4, scale, y, S, D, F, G, splits, rows_per_split, tpr, st);
    default: return cudaErrorInvalidValue;
  }
}
