// int8 weight-only dequant-matmul for Hopper (sm_90a): one launch per call.
//
// Replaces sesameai_tts_tpu/ops/quant.py::quant_matmul_pallas (body
// _qmv_kernel): y (S, F) = (bf16(x) (S, D) @ bf16(q) (D, F)) * scale (F,),
// products of bf16 values accumulated in f32, the per-column scale applied
// in f32 on the sum, and the result cast to x's dtype.  int8 -> f32 is
// exact, and a bf16 x small-integer product is exact in f32, so the
// arithmetic is the TPU kernel's up to the order of the f32 sum.
//
// What bounds it: at decode sizes (S <= 8) the int8 weight bytes, D*F per
// call; x, scale and y are a few KB.  The decoder's small shapes (1-2 MB)
// take well under a microsecond at 3.35 TB/s, so there the floor is the
// chain of latencies: the launch, one DRAM round trip, the reductions and
// one cluster barrier.
//
// What the design does about it:
//  * one launch per call.  Grid (splits, column tiles, S tiles) with
//    thread-block clusters of `splits` blocks along x: the blocks of a
//    cluster split the reduction over D.  A reduce-scatter finishes it:
//    each block leaves its partial of every 4-column vector in the shared
//    memory of the vector's owner block (distributed shared memory), one
//    cluster barrier, and each owner adds the blocks' partials in rank
//    order from its own shared memory.  No workspace, no counter, no
//    atomics: the result is bit-deterministic, and a CUDA-graph replay
//    needs no reset;
//  * the geometry (ops/quant.py::_qmm_geometry) narrows the column tile
//    and raises the cluster size (up to 16, non-portable) until every
//    flagship shape puts at least two blocks on each SM at S = 1;
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
//  S above 8 is tiled over grid.z, and each S tile re-reads the weight:
//  correct, and slow at S = 64, which no path runs (prefill takes the dense
//  bf16 shadow).

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

// Block (split, column tile, S tile): partial sums over rows [split *
// rows_per_split, +rows_per_split) of D for its S_TILE rows of x and
// tpr * VEC columns of q, then the cluster's fixed-order sum, the scale and
// the cast.  The cluster is the `splits` blocks along x.
template <typename T, int S_TILE, int VEC>
__global__ void __launch_bounds__(THREADS)
qmm_cluster(const T* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, T* __restrict__ y, int S, int D, int F, int tpr,
            int rows_per_split) {
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

template <typename T, int S_TILE, int VEC>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y, int S, int D, int F,
                   int splits, int rows_per_split, int tpr, cudaStream_t stream) {
  auto kernel = qmm_cluster<T, S_TILE, VEC>;
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
      &config, kernel, static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(y), S, D, F, tpr, rows_per_split);
  const cudaError_t last = cudaGetLastError();  // read and clear
  return err != cudaSuccess ? err : last;
}

template <typename T, int VEC>
cudaError_t dispatch_s(const void* x, const void* q, const void* scale, void* y, int S, int D,
                       int F, int splits, int rows_per_split, int tpr, int s_tile,
                       cudaStream_t stream) {
  switch (s_tile) {
    case 1: return launch<T, 1, VEC>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, stream);
    case 2: return launch<T, 2, VEC>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, stream);
    case 4: return launch<T, 4, VEC>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, stream);
    case 8: return launch<T, 8, VEC>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* q, const void* scale, void* y, int S, int D,
                     int F, int splits, int rows_per_split, int tpr, int vec, int s_tile,
                     cudaStream_t stream) {
  if (vec == 16) {
    return dispatch_s<T, 16>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, s_tile, stream);
  }
  return dispatch_s<T, 8>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, s_tile, stream);
}

}  // namespace

// x (S, D) bf16 or f32, q (D, F) int8, scale (F,) f32, y (S, F) in x's
// dtype, all contiguous.  vec (16, or 8) divides F; tpr divides 32 and
// tpr * vec <= 256; 1 <= splits <= 16 with splits * rows_per_split >= D
// and every split non-empty; s_tile in {1, 2, 4, 8}.  Launches on
// `stream` and returns the launch's error (0 on success).
extern "C" int quant_matmul(const void* x, const void* q, const void* scale, void* y, int S,
                            int D, int F, int splits, int rows_per_split, int tpr, int vec,
                            int s_tile, int x_is_bf16, void* stream) {
  if (S <= 0 || D <= 0 || F <= 0 || (vec != 16 && vec != 8) || F % vec != 0 || tpr <= 0 ||
      32 % tpr != 0 || tpr * vec > MAX_COLS || splits < 1 || splits > MAX_CLUSTER ||
      rows_per_split <= 0 || (F + tpr * vec - 1) / (tpr * vec) > 65535 ||
      (S + s_tile - 1) / s_tile > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return dispatch<__nv_bfloat16>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, vec,
                                   s_tile, st);
  }
  return dispatch<float>(x, q, scale, y, S, D, F, splits, rows_per_split, tpr, vec, s_tile, st);
}
