// int8 weight-only dequant-matmul for Hopper (sm_90a): one launch per call.
//
// Replaces sesameai_tts_tpu/ops/quant.py::quant_matmul_pallas (body
// _qmv_kernel): y (S, F) = (bf16(x) (S, D) @ bf16(q) (D, F)) * scale (F,),
// products of bf16 values accumulated in f32, the per-column scale applied
// in f32 on the sum, and the result cast to x's dtype.  int8 -> bf16 is
// exact, and a bf16 x small-integer product is exact in f32, so the
// arithmetic is the TPU kernel's up to the order of the f32 sum.
//
// Two routes, chosen by ops/quant.py from S alone:
//  * S = 1 (single-stream decode): `qmm_cluster`, a GEMV on the CUDA cores;
//  * 2 <= S <= 64 (a serving pool's slots, a mesh prompt's prefill rows):
//    `qmm_mma`, on the tensor cores.
// Both read the weight once per call, split D over a thread-block cluster
// and finish the sum by a reduce-scatter through distributed shared memory:
// each block leaves its partial of every 4-column vector in the shared
// memory of the vector's owner block, one cluster barrier, and each owner
// adds the blocks' partials in rank order from its own shared memory.  No
// workspace, no counter, no atomics: the result is bit-deterministic, and a
// CUDA-graph replay needs no reset.  The decoder's small shapes (1-2 MB)
// need the split to fill 132 SMs.
//
// What bounds it: the int8 weight bytes, D*F per call; x, scale and y are a
// few KB (S = 64: up to 1 MB of x, read from L2).  The decoder's small
// shapes take well under a microsecond at 3.35 TB/s, so there the floor is
// the chain of latencies: the launch, one DRAM round trip, the reductions
// and one cluster barrier.  On the CUDA cores a product does 2*S FLOP per
// weight byte; at ~67 TFLOP/s of f32 FMA the instruction stream, not the
// bytes, sets the pace from S = 2 on (S = 8: 16 FLOP a byte, S = 64: 128).
// The bf16 tensor cores (989 TFLOP/s, ~295 FLOP a byte) keep S = 64
// bytes-bound; what is left on the CUDA cores is the int8 -> bf16
// conversion, ~2.5 instructions a weight whatever S is.
//
// The S = 1 route (qmm_cluster):
//  * grid (splits, column tiles, S) with clusters of `splits` blocks along
//    x; the geometry (ops/quant.py::_qmm_geometry) narrows the column tile
//    and raises the cluster size (up to 16, non-portable) until every
//    flagship shape puts at least two blocks on each SM;
//  * each thread owns VEC = 16 neighbouring columns (8 when F % 16 != 0)
//    and reads them as one 16-byte ld.global.nc per weight row; `tpr`
//    threads cover a tile row, the block's THREADS / tpr row groups walk
//    the split's rows.  Every thread keeps U rows of loads in flight and
//    issues the next U before it uses the current ones (up to 16 KB in
//    flight per block, from the block's first instruction on: there is no
//    barrier before the first weight load);
//  * x is read straight from global memory beside the weight loads (a
//    warp's lanes share its rows, so L1 broadcasts them) and rounded to
//    bf16 in registers: no staging pass and no __syncthreads;
//  * int8 -> f32 without an I2F: the byte, its sign bit flipped, is
//    permuted (PRMT) into the mantissa of 2^23 and one FADD removes
//    2^23 + 128, which is exact;
//  * a block reduces its row groups by warp shuffles, then its four warps
//    in shared memory, both in a fixed order; the owner reads its scales
//    before the cluster barrier.
//
// The 2 <= S <= 64 route (qmm_mma), mma.sync.m16n8k16 bf16 -> f32 with A
// and B swapped: the weight is A (16 columns of F are M, 16 rows of D are
// K), x is B (8 rows of S are N).  S = 8 fills one n-tile, S = 64 is eight
// n-tiles that share each A fragment; a lane keeps 4 f32 per (m-tile,
// n-tile), 32-64 in all.
//  * Weight fragments straight from global memory into registers, no
//    shared-memory pass: the product does not care which column is which
//    row of A, nor which row of D is which k of a step, as long as A and B
//    agree.  So lane (g, t) of a warp takes rows 4t..4t+3 of a 16-row
//    k-step and 2*MT neighbouring columns (one 16-, 8- or 4-byte
//    ld.global.nc a row: the warp's 8 lanes of a row read 16*MT contiguous
//    bytes); column 2j of its chunk is row g of m-tile j, column 2j + 1 row
//    g + 8, and rows 4t, 4t+1 / 4t+2, 4t+3 are the k pairs {2t, 2t+1} /
//    {2t+8, 2t+9} of the fragment.  The layout of q stays (D, F) as
//    convert.py, the dequant branch and the plain versions read it.
//  * int8 -> bf16: the PRMT + FADD above gives the f32 value, an integer of
//    at most 8 bits, whose top half is its bf16 exactly; one PRMT packs two
//    of them into a fragment register.
//  * Loads in flight: a chunk is one round of every warp's U = 16 / MT
//    k-steps (KC = 16 * U * WK rows of D).  At a chunk's start every lane
//    issues all its loads of the next chunk into a second set of registers
//    (4 KB a warp), then converts and multiplies the current chunk; the
//    two sets take turns.  One set refilled k-step by k-step, right after
//    each k-step's use, left about one memory latency exposed per k-step:
//    72.8 against 32.2 us at S = 64 (decoder.w13 on one split, PERF.md).
//  * x: the block's rows of every S row go through shared memory as bf16
//    in a ring of NS = 3 chunks (cp.async for bf16 x, two chunks ahead;
//    f32 x rounded to bf16 on the way in, the kernel contract bf16(x)),
//    zero past S and past the split; a B fragment is one 8-byte shared load
//    (rows 4t..4t+3 of x row g), the row stride padded to 32 bytes past a
//    multiple of 128 so a half-warp's loads hit distinct banks.  One
//    __syncthreads a chunk, and the ring's size does not depend on the
//    split, so the plan may give a split all of D.
//  * A block is 4 warps: WK along D (each takes every WK-th k-step of the
//    split) times 4 / WK along F, MT m-tiles a warp (ops/quant.py::
//    _qmm_mma_plan picks MT, NT, WK by S so the accumulators stay <= 64 a
//    lane, and from S = 17 on widens the block in F so that its x rows stay
//    small beside its weight bytes).  The warps' sums meet in shared memory
//    (over the x ring) in warp order, then the cluster's reduce-scatter,
//    the scale in f32, the cast.
//  * What bounds it now: at S <= 8 the loads in flight (the decoder's
//    shapes sit near the launch and barrier floor, as at S = 1).  At
//    S = 64 the products: 16 mma.sync a warp per 512 weight bytes, ~100
//    TFLOP/s on the card at best, the largest single stage
//    (csrc/probes/qmm_stage_costs.py); wgmma is the next step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COLS = 256;     // widest column tile (tpr * VEC)
constexpr int MAX_CLUSTER = 16;   // blocks of a cluster (non-portable above 8)
constexpr int MAX_SMEM = 232448;  // 227 KB: the most dynamic shared memory a block may have
constexpr unsigned FULL = 0xffffffffu;

template <int VEC> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };

__device__ __forceinline__ float bf16_value(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// y[0..3] = sum * sc, cast to y's type (8- or 16-byte aligned)
__device__ __forceinline__ void store4(__nv_bfloat16* y, float4 sum, float4 sc) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x * sc.x, sum.y * sc.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z * sc.z, sum.w * sc.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(y) = packed;
}
__device__ __forceinline__ void store4(float* y, float4 sum, float4 sc) {
  *reinterpret_cast<float4*>(y) =
      make_float4(sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w);
}

// Byte I of `flipped` (an int8 with its sign bit flipped, i.e. b + 128)
// as the float b: 0x4B0000uu is 2^23 + uu exactly.
template <int I>
__device__ __forceinline__ float int8_value(uint32_t flipped) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | I)) - 8388736.f;
}

template <typename T, int S_TILE, int VEC, int U>
__device__ __forceinline__ void fetch(typename Vec<VEC>::type (&w)[U], float (&xv)[U][S_TILE],
                                      const T* __restrict__ x, const int8_t* __restrict__ q,
                                      int r0, int step, int k_end, bool active, int f, int s0,
                                      int S, int D, int F) {
  using W = typename Vec<VEC>::type;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = r0 + u * step;
    const bool ok = r < k_end;
    W v{};
    if (ok && active) v = __ldg(reinterpret_cast<const W*>(q + static_cast<size_t>(r) * F + f));
    w[u] = v;
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
      xv[u][s] = ok && s0 + s < S ? bf16_value(x[static_cast<size_t>(s0 + s) * D + r]) : 0.f;
    }
  }
}

// Block (split, column tile, row of x): partial sums over rows [split *
// rows_per_split, +rows_per_split) of D for its S_TILE = 1 row of x and
// tpr * VEC columns of q, then the cluster's fixed-order sum, the scale and
// the cast.  The cluster is the `splits` blocks along x.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
qmm_cluster(const T* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, T* __restrict__ y, int S, int D, int F, int tpr,
            int rows_per_split) {
  constexpr int S_TILE = 1;  // grid.z walks the rows of x (S = 1 on every launch)
  using W = typename Vec<VEC>::type;
  constexpr int WORDS = VEC / 4;
  constexpr int U = S_TILE <= 2 ? 8 : S_TILE == 4 ? 4 : 2;  // rows in flight per thread
  __shared__ __align__(16) float part[WARPS][S_TILE][MAX_COLS];
  // the cluster's partials of the vectors this block finishes: splits * per
  // 4-vectors, per = ceil(S_TILE * ct / 4 / splits)
  __shared__ __align__(16) float recv[S_TILE * MAX_COLS + 4 * MAX_CLUSTER];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int ct = tpr * VEC;
  const int col0 = blockIdx.y * ct;
  const int s0 = blockIdx.z * S_TILE;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = threadIdx.x % tpr;
  const int step = THREADS / tpr;  // row groups of the block
  const int f = col0 + c * VEC;
  const bool active = f < F;
  const int k_begin = split * rows_per_split;
  const int k_end = min(D, k_begin + rows_per_split);

  float acc[S_TILE][VEC];
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[s][e] = 0.f;
  }

  W wa[U];
  float xa[U][S_TILE];
  int r0 = k_begin + static_cast<int>(threadIdx.x) / tpr;
  fetch<T, S_TILE, VEC, U>(wa, xa, x, q, r0, step, k_end, active, f, s0, S, D, F);
  for (; r0 < k_end; r0 += U * step) {
    W wb[U];
    float xb[U][S_TILE];
    fetch<T, S_TILE, VEC, U>(wb, xb, x, q, r0 + U * step, step, k_end, active, f, s0, S, D, F);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r0 + u * step >= k_end) break;  // the split's last rows (near-uniform in a warp)
      const uint32_t* words = reinterpret_cast<const uint32_t*>(&wa[u]);
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        const uint32_t fl = words[k] ^ 0x80808080u;
        const float wf[4] = {int8_value<0>(fl), int8_value<1>(fl), int8_value<2>(fl),
                             int8_value<3>(fl)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int s = 0; s < S_TILE; ++s) acc[s][4 * k + i] = fmaf(xa[u][s], wf[i], acc[s][4 * k + i]);
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

  // the warp's row groups (lanes tpr apart) by a butterfly, then the
  // block's warps in shared memory, in warp order
  for (int o = 16; o >= tpr; o >>= 1) {
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[s][e] += __shfl_xor_sync(FULL, acc[s][e], o);
    }
  }
  if (lane < tpr) {
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(&part[warp][s][lane * VEC + e]) =
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
  const int v_first = split * per + static_cast<int>(threadIdx.x);
  const int v_end = min(n4, (split + 1) * per);
  float4 sc = make_float4(0.f, 0.f, 0.f, 0.f);  // this thread's first scales, read early
  if (v_first < v_end) {
    const int col = (v_first & ((1 << ct4_shift) - 1)) * 4;
    if (col0 + col < F) sc = __ldg(reinterpret_cast<const float4*>(scale + col0 + col));
  }
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
  for (int vi = v_first; vi < v_end; vi += THREADS) {
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
    if (s0 + s < S && col0 + col < F) {
      if (vi != v_first) sc = __ldg(reinterpret_cast<const float4*>(scale + col0 + col));
      store4(y + static_cast<size_t>(s0 + s) * F + col0 + col, sum, sc);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y, int S, int D, int F,
                   int splits, int rows_per_split, int tpr, cudaStream_t stream) {
  auto kernel = qmm_cluster<T, VEC>;
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
      &config, kernel, static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(y), S, D, F, tpr, rows_per_split);
  const cudaError_t last = cudaGetLastError();  // read and clear
  return err != cudaSuccess ? err : last;
}

// ---------------------------------------------------------------------------
// The tensor-core route, 2 <= S <= 64
// ---------------------------------------------------------------------------

// a lane's 2 * MT bytes of one weight row
template <int MT> struct Row;
template <> struct Row<8> { using type = uint4; };
template <> struct Row<4> { using type = uint2; };
template <> struct Row<2> { using type = uint32_t; };

__device__ __forceinline__ uint32_t word(uint4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(uint2 v, int k) { return k == 0 ? v.x : v.y; }
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }

// x is staged in a ring of NS chunks of KC = 16 * U * WK rows of D (one
// round of every warp's U k-steps), each row padded to x_stride(KC) bf16:
// 2 * stride = 32 (mod 128) bytes (or 96 for KC = 32), so the four x rows
// of a half-warp's B loads lie in distinct banks.
constexpr int NS = 3;
__host__ __device__ constexpr int x_stride(int kc) { return (kc + 63) / 64 * 64 + 16; }

// Dynamic shared memory of qmm_mma: [0, a) the x ring (NS chunks of sp
// rows), which the warps' partial sums (wk x sp x cols f32) replace after
// the loop, a rounded up to 16 bytes; then the cluster's partials of the
// vectors the block finishes, splits * ceil(S * cols / 4 / splits)
// 4-vectors.
__host__ __device__ __forceinline__ int qmm_mma_recv_offset(int sp, int cols, int wk, int kc) {
  const int ring = NS * sp * x_stride(kc) * 2;
  const int part = wk * sp * cols * 4;
  return ((ring > part ? ring : part) + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int qmm_mma_smem(int S, int sp, int cols, int wk, int kc,
                                                    int splits) {
  const int n4 = S * cols / 4;
  return qmm_mma_recv_offset(sp, cols, wk, kc) + splits * ((n4 + splits - 1) / splits) * 16;
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
// waits before its first remote write, so no block writes into the shared
// memory of a block that has not started
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

// byte `byte` of `flipped` (b + 128) as the f32 b (see int8_value)
__device__ __forceinline__ float int8_f32(uint32_t flipped, int byte) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | byte)) - 8388736.f;
}
// two f32 integers of at most 8 bits as a bf16 pair (lo in the low half):
// their top halves, which are their bf16 values exactly
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// eight x values from global into shared memory as bf16 (`valid` false: zeros)
__device__ __forceinline__ void copy8(__nv_bfloat16* dst, const __nv_bfloat16* src, bool valid,
                                      const void* base) {
  cp_async16(smem_u32(dst), valid ? static_cast<const void*>(src) : base, valid);
}
__device__ __forceinline__ void copy8(__nv_bfloat16* dst, const float* src, bool valid,
                                      const void*) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 lo = valid ? __ldg(reinterpret_cast<const float4*>(src)) : zero;
  const float4 hi = valid ? __ldg(reinterpret_cast<const float4*>(src) + 1) : zero;
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                                              pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
}

// x rows [0, sp) x columns [c0, c0 + 8 * chunks) into xs (row stride rs) as
// bf16 by the block's `threads` threads: zero at rows >= S and at columns
// >= c0 + valid.  16-byte aligned rows go by 8-element copies (cp.async
// for bf16), anything else one value at a time.
template <typename T>
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, int rs, const T* __restrict__ x,
                                        int S, int D, int sp, int c0, int valid, int chunks,
                                        int threads) {
  const bool vec = D % 8 == 0 && c0 % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int i = threadIdx.x; i < sp * chunks; i += threads) {
    const int n = i / chunks;
    const int c = 8 * (i - n * chunks);
    __nv_bfloat16* dst = xs + n * rs + c;
    const T* src = x + static_cast<size_t>(n) * D + c0 + c;
    if (vec && c + 8 <= valid) {
      copy8(dst, src, n < S, x);
    } else {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = n < S && c + e < valid ? bf16_value(src[e]) : 0.f;
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                  pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
  }
}

// Block (split, column tile): over rows [split * rows_per_split,
// +rows_per_split) of D, every row of x against 4 / WK * 16 * MT columns;
// then the cluster's fixed-order sum, the scale and the cast.  Warp w takes
// columns (w / WK) * 16 * MT.. and every WK-th 16-row k-step from w % WK.
template <typename T, int MT, int NT, int WK>
__global__ void __launch_bounds__(THREADS)
qmm_mma(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
        T* __restrict__ y, int S, int D, int F, int rows_per_split) {
  using R = typename Row<MT>::type;
  constexpr int WC = WARPS / WK;
  constexpr int COLS = WC * 16 * MT;  // the block's columns
  constexpr int C4 = COLS / 4;        // a power of two
  constexpr int SP = 8 * NT;          // rows of x staged
  constexpr int U = 16 / MT;          // k-steps of loads in flight per lane
  constexpr int KC = 16 * U * WK;     // rows of D a chunk of the x ring holds
  constexpr int XS = x_stride(KC);
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  if (splits > 1) cluster_arrive_relaxed();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;  // the fragment's group: m rows gid, gid + 8, n row gid
  const int t = lane & 3;
  const int wk = warp % WK;
  const int wc = warp / WK;
  const int col0 = blockIdx.y * COLS;
  const int f = col0 + wc * 16 * MT + gid * 2 * MT;  // the lane's first column
  const bool active = f < F;
  const int k_begin = split * rows_per_split;
  const int k_end = min(D, k_begin + rows_per_split);
  const int steps = (k_end - k_begin + 15) / 16;
  const int chunks = (steps + U * WK - 1) / (U * WK);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);

  // rows k_begin + 16 s + 4 t + i (i < 4) of the lane's columns; zeros past the split
  auto load = [&](R (&w)[4], int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = k_begin + 16 * s + 4 * t + i;
      R v{};
      if (active && r < k_end) v = __ldg(reinterpret_cast<const R*>(q + static_cast<size_t>(r) * F + f));
      w[i] = v;
    }
  };
  // x rows [0, SP) of chunk c into its slot of the ring (one cp.async group)
  auto stage = [&](int c) {
    if (c < chunks) {
      const int c0 = k_begin + c * KC;
      stage_x(xs + (c % NS) * SP * XS, XS, x, S, D, SP, c0, min(KC, k_end - c0), KC / 8,
              THREADS);
    }
    cp_async_commit();
  };
  float acc[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
  }
  // chunk c from the rows in `cur`, while the next chunk's rows load into `next`
  auto run_chunk = [&](int c, R (&cur)[U][4], R (&next)[U][4]) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // chunk c's x is in, and every warp is done with chunk c - 1
    stage(c + NS - 1);
#pragma unroll
    for (int u = 0; u < U; ++u) load(next[u], (c + 1) * U * WK + u * WK + wk);
    const __nv_bfloat16* xc = xs + (c % NS) * SP * XS;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = u * WK + wk;  // the k-step within the chunk
      if (c * U * WK + k >= steps) break;  // uniform in the warp
      uint32_t b[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint2 v = *reinterpret_cast<const uint2*>(xc + (8 * n + gid) * XS + 16 * k + 4 * t);
        b[n][0] = v.x;
        b[n][1] = v.y;
      }
#pragma unroll
      for (int j = 0; j < MT; ++j) {  // m-tile j: columns 2j (row gid) and 2j + 1 (row gid + 8)
        const int wd = j / 2;
        const int byte = 2 * (j & 1);
        uint32_t fl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) fl[i] = word(cur[u][i], wd) ^ 0x80808080u;
        const uint32_t a[4] = {bf16_pair(int8_f32(fl[0], byte), int8_f32(fl[1], byte)),
                               bf16_pair(int8_f32(fl[0], byte + 1), int8_f32(fl[1], byte + 1)),
                               bf16_pair(int8_f32(fl[2], byte), int8_f32(fl[3], byte)),
                               bf16_pair(int8_f32(fl[2], byte + 1), int8_f32(fl[3], byte + 1))};
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(acc[j][n], a, b[n][0], b[n][1]);
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

  // the warps' sums over the x ring: lane (gid, t) holds x rows 8n + 2t
  // (+1) of its 2 * MT columns
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = part + (wk * SP + 8 * n + 2 * t + h) * COLS + wc * 16 * MT + gid * 2 * MT;
#pragma unroll
      for (int j = 0; j < MT; j += 2) {
        *reinterpret_cast<float4*>(row + 2 * j) =
            make_float4(acc[j][n][h], acc[j][n][2 + h], acc[j + 1][n][h], acc[j + 1][n][2 + h]);
      }
    }
  }
  // Reduce-scatter over the cluster, as qmm_cluster's: block `owner`
  // finishes vectors [owner * per, +per) of the tile's S x COLS / 4.
  float* recv = reinterpret_cast<float*>(smem + qmm_mma_recv_offset(SP, COLS, WK, KC));
  const int n4 = S * C4;
  const int per = (n4 + splits - 1) / splits;
  const int v_first = split * per + static_cast<int>(threadIdx.x);
  const int v_end = min(n4, (split + 1) * per);
  float4 sc = make_float4(0.f, 0.f, 0.f, 0.f);  // this thread's first scales, read early
  if (v_first < v_end && col0 + (v_first % C4) * 4 < F) {
    sc = __ldg(reinterpret_cast<const float4*>(scale + col0 + (v_first % C4) * 4));
  }
  __syncthreads();
  if (splits > 1) cluster_wait();
  for (int vi = threadIdx.x; vi < n4; vi += THREADS) {
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
  for (int vi = v_first; vi < v_end; vi += THREADS) {
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
    if (col0 + col < F) {
      if (vi != v_first) sc = __ldg(reinterpret_cast<const float4*>(scale + col0 + col));
      store4(y + static_cast<size_t>(s) * F + col0 + col, sum, sc);
    }
  }
}

template <typename T, int MT, int NT, int WK>
cudaError_t launch_mma(const void* x, const void* q, const void* scale, void* y, int S, int D,
                       int F, int splits, int rows_per_split, int smem, cudaStream_t stream) {
  auto kernel = qmm_mma<T, MT, NT, WK>;
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
  if (smem < qmm_mma_smem(S, 8 * NT, COLS, WK, 16 * (16 / MT) * WK, splits)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, (F + COLS - 1) / COLS, 1);
  config.blockDim = dim3(THREADS);
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
      &config, kernel, static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(y), S, D, F, rows_per_split);
  const cudaError_t last = cudaGetLastError();  // read and clear
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t dispatch_mma(const void* x, const void* q, const void* scale, void* y, int S, int D,
                         int F, int splits, int rows_per_split, int mt, int nt, int wk, int smem,
                         cudaStream_t stream) {
#define QMM_MMA_CASE(MT, NT, WK)                                                              \
  case MT * 100 + NT * 10 + WK:                                                               \
    return launch_mma<T, MT, NT, WK>(x, q, scale, y, S, D, F, splits, rows_per_split, smem, \
                                     stream);
  switch (mt * 100 + nt * 10 + wk) {
    QMM_MMA_CASE(4, 1, 4)  // S <= 8
    QMM_MMA_CASE(8, 2, 4)  // S <= 16
    QMM_MMA_CASE(4, 2, 4)  // S <= 16, F % 16 != 0
    QMM_MMA_CASE(4, 4, 2)  // S <= 32
    QMM_MMA_CASE(2, 8, 1)  // S <= 64
    default: return cudaErrorInvalidValue;
  }
#undef QMM_MMA_CASE
}

}  // namespace

// The S = 1 route.  x (S, D) bf16 or f32, q (D, F) int8, scale (F,) f32, y
// (S, F) in x's dtype, all contiguous.  vec (16, or 8) divides F; tpr
// divides 32 and tpr * vec <= 256; 1 <= splits <= 16 with splits *
// rows_per_split >= D and every split non-empty.  Launches on `stream` and
// returns the launch's error (0 on success).
extern "C" int quant_matmul(const void* x, const void* q, const void* scale, void* y, int S,
                            int D, int F, int splits, int rows_per_split, int tpr, int vec,
                            int x_is_bf16, void* stream) {
  if (S <= 0 || D <= 0 || F <= 0 || (vec != 16 && vec != 8) || F % vec != 0 || tpr <= 0 ||
      32 % tpr != 0 || tpr * vec > MAX_COLS || splits < 1 || splits > MAX_CLUSTER ||
      rows_per_split <= 0 || (F + tpr * vec - 1) / (tpr * vec) > 65535 || S > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return vec == 16 ? launch<__nv_bfloat16, 16>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, st)
                     : launch<__nv_bfloat16, 8>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, st);
  }
  return vec == 16 ? launch<float, 16>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, st)
                   : launch<float, 8>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, st);
}

// The tensor-core route.  The same operands, 2 <= S <= 8 * nt, q and scale
// 16-byte aligned; (mt, nt, wk) one of dispatch_mma's cases with F % (2
// * mt) == 0; rows_per_split a multiple of 16, 1 <= splits <= 16 with every
// split non-empty; smem at least qmm_mma_smem's bytes and at most 227 KB.
extern "C" int quant_matmul_mma(const void* x, const void* q, const void* scale, void* y, int S,
                                int D, int F, int splits, int rows_per_split, int mt, int nt,
                                int wk, int smem, int x_is_bf16, void* stream) {
  const int cols = wk > 0 ? WARPS / wk * 16 * mt : 0;  // the block's columns
  if (S < 2 || S > 8 * nt || D <= 0 || F <= 0 || mt <= 0 || cols <= 0 || F % (2 * mt) != 0 ||
      splits < 1 || splits > MAX_CLUSTER || rows_per_split <= 0 || rows_per_split % 16 != 0 ||
      (splits - 1) * rows_per_split >= D || splits * rows_per_split < D ||
      (F + cols - 1) / cols > 65535 || smem > MAX_SMEM ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(scale) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return dispatch_mma<__nv_bfloat16>(x, q, scale, y, S, D, F, splits, rows_per_split, mt, nt,
                                       wk, smem, st);
  }
  return dispatch_mma<float>(x, q, scale, y, S, D, F, splits, rows_per_split, mt, nt, wk, smem,
                             st);
}
