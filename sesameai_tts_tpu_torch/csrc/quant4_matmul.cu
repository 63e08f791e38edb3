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
// Two routes, chosen by ops/quant.py from S alone: S = 1 (single-stream
// decode) runs `q4mm_cluster` on the CUDA cores; 2 <= S <= 64 (a B-slot
// int4 serving pool runs S = B) runs `q4mm_mma` on the tensor cores.  Both
// read the packed weight once per call, split its rows over a thread-block
// cluster and finish by quant_matmul.cu's reduce-scatter through
// distributed shared memory, in rank order: no workspace, no counter, no
// atomics, bit-deterministic, and a CUDA-graph replay needs no reset.
//
// What bounds it: the packed weight bytes, D*F/2 per call; x, the scales
// and y are a few KB.  The decoder's small shapes (0.5-1 MB) take well
// under a microsecond at 3.35 TB/s, so there the floor is the chain of
// latencies: the launch, one DRAM round trip, the reductions and one
// cluster barrier.  A packed byte holds two weights, so a product does 4*S
// FLOP a byte: on the CUDA cores the FMAs, not the bytes, set the pace
// from S = 2 on.  On the tensor cores what is left is the nibble -> bf16
// conversion, ~1.5 instructions a weight whatever S is.
//
// The S = 1 route (q4mm_cluster; quant_matmul.cu's design, for nibbles and
// group scales):
//  * grid (splits, column tiles, S) with clusters of `splits` blocks along
//    x; the geometry (ops/quant.py::_q4mm_geometry) takes the narrowest
//    column tile (32 columns) and the fewest splits (clusters of up to 16,
//    non-portable) whose grid reaches a block per 4 KB of packed weight,
//    that aim held between one and two blocks per SM: small clusters keep
//    the barrier short (the w13 shapes need none: their 512 column tiles
//    alone put ~4 blocks on each SM);
//  * a pair of lanes owns VEC = 16 neighbouring columns (8 when F % 16 !=
//    0) and reads them as one 16-byte ld.global.nc per packed row (16
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
//
// The 2 <= S <= 64 route (q4mm_mma; quant_matmul.cu's qmm_mma, for
// nibbles): mma.sync.m16n8k16 bf16 -> f32 with the weight as A (16 columns
// are M, 16 packed rows K) and x as B (8 rows of S are N), fragments built
// in registers from one 8- or 4-byte ld.global.nc per packed row and
// lane (lane (g, t): packed rows 4t..4t+3 of a k-step, 2 * MT columns;
// q4 keeps its split-half layout).
//  * nibble -> bf16 without an f32 step: one XOR of the loaded word biases
//    every nibble to n + 8; a PRMT puts the bytes of two neighbouring rows
//    side by side, and per fragment register a shift and a LOP3 place two
//    nibbles in the mantissas of the bf16 pair 0x4300 (128 + n + 8) and one
//    bf16x2 FMA removes 136, exactly (n + 8 < 128).
//  * Each byte feeds two products: the low nibbles against x's low half
//    and the high nibbles against its high half, in two sets of f32
//    accumulators (the halves have scales of their own).
//  * Scale groups: D / G is a multiple of 16, so a 16-row k-step lies in
//    one group.  When a warp's k-steps leave a group it multiplies each
//    set by its group's scales (low half: g, high half: G/2 + g), adds
//    both into its running sum in shared memory (a slice of its own) and
//    clears them; the warps' sums then meet in warp order, so each group is
//    scaled inside every warp that touches it before any sum across warps.
//  * As in qmm_mma: x's two halves go through a shared-memory ring of
//    chunks by cp.async (one __syncthreads a chunk); at a chunk's start
//    every lane issues its loads of the next chunk's U = 16 / MT k-steps
//    into a second set of registers; a block is WN groups of 4 warps, WK
//    along the rows and 4 / WK along F, the groups splitting the n-tiles
//    (ops/quant.py::_q4mm_mma_plan).

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

// Block (split, column tile, row of x): over packed rows [split *
// rows_per_split, +rows_per_split) for its S_TILE = 1 row of x and tpr * VEC
// columns, the group-scaled partial sums; then the cluster's fixed-order
// sum and the cast.  The cluster is the `splits` blocks along x.  The two
// lanes of a pair load the same 16 bytes (one request) and take one half
// each: the even lane the low nibbles against x's low half, the odd lane
// the high nibbles against its high half.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 4)
q4mm_cluster(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4,
             const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int S, int D, int F,
             int G, int tpr, int rows_per_split) {
  constexpr int S_TILE = 1;  // grid.z walks the rows of x (S = 1 on every launch)
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

template <int VEC>
cudaError_t launch(const void* x, const void* q4, const void* scale, void* y, int S, int D, int F,
                   int G, int splits, int rows_per_split, int tpr, cudaStream_t stream) {
  auto kernel = q4mm_cluster<VEC>;
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
  config.gridDim = dim3(splits, (F + ct - 1) / ct, S);
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

// ---------------------------------------------------------------------------
// The tensor-core route, 2 <= S <= 64
// ---------------------------------------------------------------------------

constexpr int MAX_SMEM = 232448;  // 227 KB: the most dynamic shared memory a block may have

// a lane's 2 * MT bytes of one packed row
template <int MT> struct Row;
template <> struct Row<4> { using type = uint2; };
template <> struct Row<2> { using type = uint32_t; };

__device__ __forceinline__ uint32_t word(uint2 v, int k) { return k == 0 ? v.x : v.y; }
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }

// x's two halves are staged in a ring of NS chunks of KC = 16 * U * WK
// packed rows (one round of every warp's U k-steps), each row padded to
// x_stride(KC) bf16 as in quant_matmul.cu.
constexpr int NS = 3;
__host__ __device__ constexpr int x_stride(int kc) { return (kc + 63) / 64 * 64 + 16; }

// Dynamic shared memory of q4mm_mma: the x ring (NS chunks of x's low and
// high halves, sp rows each), then the warps' running sums (wk x sp x cols
// f32), then the cluster's partials of the vectors the block finishes,
// splits * ceil(S * cols / 4 / splits) 4-vectors.
__host__ __device__ __forceinline__ int q4mm_mma_part_offset(int sp, int kc) {
  return NS * 2 * sp * x_stride(kc) * 2;  // a multiple of 32
}
__host__ __device__ __forceinline__ int q4mm_mma_recv_offset(int sp, int cols, int wk, int kc) {
  return q4mm_mma_part_offset(sp, kc) + wk * sp * cols * 4;
}
__host__ __device__ __forceinline__ int q4mm_mma_smem(int S, int sp, int cols, int wk, int kc,
                                                     int splits) {
  const int n4 = S * cols / 4;
  return q4mm_mma_recv_offset(sp, cols, wk, kc) + splits * ((n4 + splits - 1) / splits) * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the cluster barrier in two halves: every block arrives when it starts and
// waits before its first remote write
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// d += a (16 x 16 bf16, row-major) b (16 x 8 bf16, column-major), in f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The nibbles in bits 0-3 and 16-19 of v, biased to n + 8 in [0, 15] by
// the load's XOR, as the bf16 pair (n, n'): 0x43xx is the bf16 128 + xx for
// xx < 128, and one bf16x2 FMA removes 136, exactly.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// x rows [0, sp) x columns [c0, c0 + 8 * chunks) into xs (row stride rs) by
// the block's `threads` threads: zero at rows >= S and at columns >= c0 +
// valid.  16-byte aligned rows go by 16-byte cp.async, anything else one
// value at a time.
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, int rs,
                                        const __nv_bfloat16* __restrict__ x, int S, int D, int sp,
                                        int c0, int valid, int chunks, int threads) {
  const bool vec = D % 8 == 0 && c0 % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int i = threadIdx.x; i < sp * chunks; i += threads) {
    const int n = i / chunks;
    const int c = 8 * (i - n * chunks);
    __nv_bfloat16* dst = xs + n * rs + c;
    const __nv_bfloat16* src = x + static_cast<size_t>(n) * D + c0 + c;
    if (vec && c + 8 <= valid) {
      cp_async16(smem_u32(dst), n < S ? static_cast<const void*>(src) : x, n < S);
    } else {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = n < S && c + e < valid ? __bfloat162float(src[e]) : 0.f;
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                  pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
  }
}

// Block (split, column tile): over packed rows [split * rows_per_split,
// +rows_per_split), every row of x against 4 / WK * 16 * MT columns, the
// low nibbles against x's low half and the high nibbles against its high
// half in two sets of accumulators; at each scale group its rows leave, a
// warp multiplies each set by its group's scales and adds both into its
// running sum in shared memory.  Then the warps' sums in warp order, the
// cluster's fixed-order sum and the cast.  The block is WN groups of 4
// warps; warp w of a group takes columns (w / WK) * 16 * MT.., every WK-th
// 16-row k-step from w % WK, and the group's NT / WN n-tiles; a k-step
// never crosses a group (D / G is a multiple of 16).
template <int MT, int NT, int WK, int WN>
__global__ void __launch_bounds__(THREADS * WN)
q4mm_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4,
         const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int S, int D, int F,
         int G, int rows_per_split) {
  using R = typename Row<MT>::type;
  constexpr int NTH = THREADS * WN;   // the block's threads
  constexpr int NTW = NT / WN;        // n-tiles a warp
  constexpr int WC = WARPS / WK;
  constexpr int COLS = WC * 16 * MT;  // the block's columns
  constexpr int C4 = COLS / 4;        // a power of two
  constexpr int SP = 8 * NT;          // rows of x staged
  constexpr int U = 16 / MT;          // k-steps of loads in flight per lane
  constexpr int KC = 16 * U * WK;     // packed rows a chunk of the x ring holds
  constexpr int XS = x_stride(KC);
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  if (splits > 1) cluster_arrive_relaxed();
  const int warp = threadIdx.x / 32 % WARPS;
  const int n0 = threadIdx.x / THREADS * NTW;  // the warp's first n-tile
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;  // the fragment's group: m rows gid, gid + 8, n row gid
  const int t = lane & 3;
  const int wk = warp % WK;
  const int wc = warp / WK;
  const int col0 = blockIdx.y * COLS;
  const int f = col0 + wc * 16 * MT + gid * 2 * MT;  // the lane's first column
  const bool active = f < F;
  const int D2 = D / 2;
  const int gs = D / G;  // packed rows per scale group
  const int k_begin = split * rows_per_split;
  const int k_end = min(D2, k_begin + rows_per_split);
  const int steps = (k_end - k_begin + 15) / 16;
  const int chunks = (steps + U * WK - 1) / (U * WK);
  // chunk c's slot of the ring: x's low half at xs + slot, its high half SP * XS on
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* part = reinterpret_cast<float*>(smem + q4mm_mma_part_offset(SP, KC));

  // packed rows k_begin + 16 s + 4 t + i (i < 4) of the lane's columns;
  // zeros past the split
  auto load = [&](R (&w)[4], int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = k_begin + 16 * s + 4 * t + i;
      R v{};
      if (active && r < k_end) v = __ldg(reinterpret_cast<const R*>(q4 + static_cast<size_t>(r) * F + f));
      w[i] = v;
    }
  };
  // x's two halves, rows [0, SP), of chunk c into its slot (one cp.async group)
  auto stage = [&](int c) {
    if (c < chunks) {
      const int c0 = k_begin + c * KC;
      __nv_bfloat16* slot = xs + (c % NS) * 2 * SP * XS;
      stage_x(slot, XS, x, S, D, SP, c0, min(KC, k_end - c0), KC / 8, NTH);
      stage_x(slot + SP * XS, XS, x, S, D, SP, D2 + c0, min(KC, k_end - c0), KC / 8, NTH);
    }
    cp_async_commit();
  };

  float lo[MT][NTW][4], hi[MT][NTW][4];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[j][n][e] = hi[j][n][e] = 0.f;
    }
  }
  // the lane's entries of its warp's running sum: x rows 8n + 2t (+1) of
  // its 2 * MT columns
  float* mine = part + wk * SP * COLS + wc * 16 * MT + gid * 2 * MT;
  bool first = true;
  auto flush = [&](int grp) {  // scale group grp's partials into the running sum
    float sl[2 * MT], sh[2 * MT];
#pragma unroll
    for (int c = 0; c < 2 * MT; c += 4) {
      const float4 a = active ? __ldg(reinterpret_cast<const float4*>(
                                    scale + static_cast<size_t>(grp) * F + f + c))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b = active ? __ldg(reinterpret_cast<const float4*>(
                                    scale + static_cast<size_t>(G / 2 + grp) * F + f + c))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      sl[c] = a.x, sl[c + 1] = a.y, sl[c + 2] = a.z, sl[c + 3] = a.w;
      sh[c] = b.x, sh[c + 1] = b.y, sh[c + 2] = b.z, sh[c + 3] = b.w;
    }
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = mine + (8 * (n0 + n) + 2 * t + h) * COLS;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // column 2j + e
            const int c = 2 * j + e;
            const float prev = first ? 0.f : row[c];
            row[c] = fmaf(hi[j][n][2 * e + h], sh[c], fmaf(lo[j][n][2 * e + h], sl[c], prev));
            lo[j][n][2 * e + h] = hi[j][n][2 * e + h] = 0.f;
          }
        }
      }
    }
    first = false;
  };

  int group = k_begin / gs;
  // chunk c from the rows in `cur`, while the next chunk's rows load into `next`
  auto run_chunk = [&](int c, R (&cur)[U][4], R (&next)[U][4]) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // chunk c's x is in, and every warp is done with chunk c - 1
    stage(c + NS - 1);
#pragma unroll
    for (int u = 0; u < U; ++u) load(next[u], (c + 1) * U * WK + u * WK + wk);
    const __nv_bfloat16* xc = xs + (c % NS) * 2 * SP * XS;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = u * WK + wk;  // the k-step within the chunk
      const int s = c * U * WK + k;
      if (s >= steps) break;  // uniform in the warp
      const int grp = (k_begin + 16 * s) / gs;
      if (grp != group) {  // the warp's rows left a group: scale it
        flush(group);
        group = grp;
      }
      uint32_t b_lo[NTW][2], b_hi[NTW][2];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int off = (8 * (n0 + n) + gid) * XS + 16 * k + 4 * t;
        const uint2 vl = *reinterpret_cast<const uint2*>(xc + off);
        const uint2 vh = *reinterpret_cast<const uint2*>(xc + SP * XS + off);
        b_lo[n][0] = vl.x;
        b_lo[n][1] = vl.y;
        b_hi[n][0] = vh.x;
        b_hi[n][1] = vh.y;
      }
#pragma unroll
      for (int j = 0; j < MT; ++j) {  // m-tile j: columns 2j (row gid) and 2j + 1 (row gid + 8)
        const int wd = j / 2;
        // bytes 2j, 2j + 1 of rows 4t, 4t + 1 (and of 4t + 2, 4t + 3) side by side
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        const uint32_t p01 = __byte_perm(word(cur[u][0], wd) ^ 0x88888888u,
                                         word(cur[u][1], wd) ^ 0x88888888u, sel);
        const uint32_t p23 = __byte_perm(word(cur[u][2], wd) ^ 0x88888888u,
                                         word(cur[u][3], wd) ^ 0x88888888u, sel);
        const uint32_t a_lo[4] = {nibble_pair(p01), nibble_pair(p01 >> 8), nibble_pair(p23),
                                  nibble_pair(p23 >> 8)};
        const uint32_t a_hi[4] = {nibble_pair(p01 >> 4), nibble_pair(p01 >> 12),
                                  nibble_pair(p23 >> 4), nibble_pair(p23 >> 12)};
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          mma_bf16(lo[j][n], a_lo, b_lo[n][0], b_lo[n][1]);
          mma_bf16(hi[j][n], a_hi, b_hi[n][0], b_hi[n][1]);
        }
      }
    }
  };
  R wa[U][4], wb[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) load(wa[u], u * WK + wk);
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) stage(c);
  for (int c = 0; c < chunks; c += 2) {  // the two buffers in turn
    run_chunk(c, wa, wb);
    if (c + 1 < chunks) run_chunk(c + 1, wb, wa);
  }
  flush(group);
  cp_async_wait<0>();

  // Reduce-scatter over the cluster, as q4mm_cluster's: block `owner`
  // finishes vectors [owner * per, +per) of the tile's S x COLS / 4.
  float* recv = reinterpret_cast<float*>(smem + q4mm_mma_recv_offset(SP, COLS, WK, KC));
  const int n4 = S * C4;
  const int per = (n4 + splits - 1) / splits;
  __syncthreads();
  if (splits > 1) cluster_wait();
  for (int vi = threadIdx.x; vi < n4; vi += NTH) {
    const int s = vi / C4;
    const int col = (vi % C4) * 4;
    float4 sum = *reinterpret_cast<const float4*>(part + s * COLS + col);
#pragma unroll
    for (int k = 1; k < WK; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(part + (k * SP + s) * COLS + col);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const int owner = vi / per;
    float4* slot = reinterpret_cast<float4*>(recv + (split * per + vi - owner * per) * 4);
    *(splits == 1 ? slot : cluster.map_shared_rank(slot, owner)) = sum;
  }
  if (splits == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
  const int v_end = min(n4, (split + 1) * per);
  for (int vi = split * per + static_cast<int>(threadIdx.x); vi < v_end; vi += NTH) {
    const int j = vi - split * per;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {  // in rank order
      if (k < splits) {
        const float4 p = *reinterpret_cast<const float4*>(recv + (k * per + j) * 4);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
    }
    const int s = vi / C4;
    const int col = (vi % C4) * 4;
    if (col0 + col < F) store4(y + static_cast<size_t>(s) * F + col0 + col, sum);
  }
}

template <int MT, int NT, int WK, int WN>
cudaError_t launch_mma(const void* x, const void* q4, const void* scale, void* y, int S, int D,
                       int F, int G, int splits, int rows_per_split, int smem,
                       cudaStream_t stream) {
  auto kernel = q4mm_mma<MT, NT, WK, WN>;
  constexpr int COLS = WARPS / WK * 16 * MT;
  // set once per instantiation, on its first call (before any graph
  // capture): clusters above 8 blocks, and up to 227 KB of shared memory
  static bool ready = false;
  if (!ready) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    }
    if (err != cudaSuccess) return err;
    ready = true;
  }
  if (smem < q4mm_mma_smem(S, 8 * NT, COLS, WK, 16 * (16 / MT) * WK, splits)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, (F + COLS - 1) / COLS, 1);
  config.blockDim = dim3(THREADS * WN);
  config.dynamicSmemBytes = smem;
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
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), S, D, F, G,
      rows_per_split);
  const cudaError_t last = cudaGetLastError();  // read and clear
  return err != cudaSuccess ? err : last;
}

}  // namespace

// The S = 1 route.  x (S, D) bf16, q4 (D/2, F) int8, scale (G, F) f32, y
// (S, F) bf16, all contiguous, q4 and scale 16-byte aligned.  G even and D
// % G == 0; vec (16, or 8) divides F; tpr (lane pairs per tile row)
// divides 16; 1 <= splits <= 16 with every split of rows_per_split packed
// rows non-empty.  Launches on `stream` and returns the launch's error (0
// on success).
extern "C" int quant4_matmul(const void* x, const void* q4, const void* scale, void* y, int S,
                             int D, int F, int G, int splits, int rows_per_split, int tpr, int vec,
                             void* stream) {
  if (S <= 0 || D <= 0 || D % 2 != 0 || F <= 0 || G <= 0 || G % 2 != 0 || D % G != 0 ||
      (vec != 16 && vec != 8) || F % vec != 0 || tpr <= 0 || 16 % tpr != 0 || splits < 1 ||
      splits > MAX_CLUSTER || rows_per_split <= 0 || (splits - 1) * rows_per_split >= D / 2 ||
      splits * rows_per_split < D / 2 || (F + tpr * vec - 1) / (tpr * vec) > 65535 ||
      S > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec == 16 ? launch<16>(x, q4, scale, y, S, D, F, G, splits, rows_per_split, tpr, st)
                   : launch<8>(x, q4, scale, y, S, D, F, G, splits, rows_per_split, tpr, st);
}

// The tensor-core route.  The same operands, 2 <= S <= 8 * nt, D / G a
// multiple of 16; (mt, nt, wk, wn) one of the cases below with F % (2 * mt)
// == 0; rows_per_split a multiple of 16, 1 <= splits <= 16 with every split
// non-empty; smem at least q4mm_mma_smem's bytes and at most 227 KB.
extern "C" int quant4_matmul_mma(const void* x, const void* q4, const void* scale, void* y,
                                 int S, int D, int F, int G, int splits, int rows_per_split,
                                 int mt, int nt, int wk, int wn, int smem, void* stream) {
  const int cols = wk > 0 ? WARPS / wk * 16 * mt : 0;  // the block's columns
  if (S < 2 || S > 8 * nt || D <= 0 || D % 2 != 0 || F <= 0 || G <= 0 || G % 2 != 0 ||
      D % G != 0 || (D / G) % 16 != 0 || mt <= 0 || cols <= 0 || F % (2 * mt) != 0 || wn < 1 ||
      nt % wn != 0 || splits < 1 || splits > MAX_CLUSTER || rows_per_split <= 0 ||
      rows_per_split % 16 != 0 || (splits - 1) * rows_per_split >= D / 2 ||
      splits * rows_per_split < D / 2 || (F + cols - 1) / cols > 65535 || smem > MAX_SMEM ||
      reinterpret_cast<uintptr_t>(q4) % 16 != 0 || reinterpret_cast<uintptr_t>(scale) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define Q4MM_MMA_CASE(MT, NT, WK, WN)                                                          \
  case MT * 1000 + NT * 100 + WK * 10 + WN:                                                    \
    return launch_mma<MT, NT, WK, WN>(x, q4, scale, y, S, D, F, G, splits, rows_per_split, smem, \
                                      st);
  switch (mt * 1000 + nt * 100 + wk * 10 + wn) {
    Q4MM_MMA_CASE(4, 1, 4, 1)  // S <= 8
    Q4MM_MMA_CASE(4, 2, 4, 1)  // S <= 16
    Q4MM_MMA_CASE(2, 4, 2, 1)  // S <= 32
    Q4MM_MMA_CASE(2, 8, 1, 2)  // S <= 64
    default: return cudaErrorInvalidValue;
  }
#undef Q4MM_MMA_CASE
}
