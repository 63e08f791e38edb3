// int8 weight-only dequant-matmul for Hopper (sm_90a).
//
// Replaces sesameai_tts_tpu/ops/quant.py::quant_matmul_pallas (body
// _qmv_kernel): y (S, F) = (bf16(x) (S, D) @ bf16(q) (D, F)) * scale (F,),
// products of bf16 values accumulated in f32, the per-column scale applied
// in f32 on the sum, and the result cast to x's dtype.  int8 -> bf16 is
// exact for |q| <= 127, and a bf16 x bf16 product is exact in f32, so the
// arithmetic is the TPU kernel's up to the order of the f32 sum.
//
// What bounds it: at decode sizes (S <= 64) the kernel is bound by the
// int8 weight bytes, D*F per launch; x, scale and y are a few KB.  The
// weight stays int8 in device memory and is never materialized in bf16.
//
// What the design does about it:
//  * each thread owns 8 neighbouring output columns and reads them as one
//    8-byte load per weight row, so a warp reads 256 contiguous bytes of a
//    row of the row-major (D, F) weight: every load is coalesced;
//  * every thread issues ROW_UNROLL such loads before it uses any, to keep
//    enough bytes in flight;
//  * the block's rows of x are staged once in shared memory, already
//    rounded to bf16; all threads read the same x value (a broadcast);
//  * the reduction over D is split across blocks (grid.y) so that even
//    F = 1024 puts work on all SMs; each split writes f32 partial sums to
//    a workspace, and a second kernel adds the splits in a fixed order,
//    applies the scale and casts.  No atomics: results are deterministic.
//  S above 8 is tiled over grid.z; each S tile re-reads the weight tile.
// wgmma, TMA and a pipelined ring are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int COLS_PER_THREAD = 8;
constexpr int COLS_PER_BLOCK = THREADS * COLS_PER_THREAD;  // 512
constexpr int ROW_UNROLL = 8;
constexpr int X_CHUNK = 512;  // rows of x staged in shared memory per pass

__device__ __forceinline__ float bf16_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int S_TILE>
__device__ __forceinline__ void fma_row(float (&acc)[S_TILE][COLS_PER_THREAD],
                                        uint2 w,
                                        float (*xs)[X_CHUNK], int r) {
  float wf[COLS_PER_THREAD];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    wf[c] = static_cast<float>(static_cast<int8_t>((w.x >> (8 * c)) & 0xff));
    wf[c + 4] = static_cast<float>(static_cast<int8_t>((w.y >> (8 * c)) & 0xff));
  }
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
    const float xv = xs[s][r];
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) {
      acc[s][c] = fmaf(xv, wf[c], acc[s][c]);
    }
  }
}

// Partial sums over rows [split * rows_per_split, +rows_per_split) of D
// for S_TILE rows of x and COLS_PER_BLOCK columns of q.
template <typename T, int S_TILE>
__global__ void __launch_bounds__(THREADS)
qmm_partial(const T* __restrict__ x, const int8_t* __restrict__ q,
            float* __restrict__ ws, int S, int D, int F, int rows_per_split) {
  __shared__ float xs[S_TILE][X_CHUNK];
  const int f0 = blockIdx.x * COLS_PER_BLOCK + threadIdx.x * COLS_PER_THREAD;
  const int split = blockIdx.y;
  const int s0 = blockIdx.z * S_TILE;
  const int k_begin = split * rows_per_split;
  const int k_end = min(D, k_begin + rows_per_split);
  const bool active = f0 < F;

  float acc[S_TILE][COLS_PER_THREAD];
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) acc[s][c] = 0.f;
  }

  for (int kc = k_begin; kc < k_end; kc += X_CHUNK) {
    const int rows = min(X_CHUNK, k_end - kc);
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int i = threadIdx.x; i < S_TILE * X_CHUNK; i += THREADS) {
      const int s = i / X_CHUNK;
      const int r = i - s * X_CHUNK;
      float v = 0.f;
      if (s0 + s < S && r < rows) {
        v = bf16_value(x[static_cast<size_t>(s0 + s) * D + kc + r]);
      }
      xs[s][r] = v;
    }
    __syncthreads();
    if (active) {
      const int8_t* qp = q + static_cast<size_t>(kc) * F + f0;
      int r = 0;
      for (; r + ROW_UNROLL <= rows; r += ROW_UNROLL) {
        uint2 w[ROW_UNROLL];
#pragma unroll
        for (int u = 0; u < ROW_UNROLL; ++u) {
          w[u] = __ldg(reinterpret_cast<const uint2*>(
              qp + static_cast<size_t>(r + u) * F));
        }
#pragma unroll
        for (int u = 0; u < ROW_UNROLL; ++u) fma_row<S_TILE>(acc, w[u], xs, r + u);
      }
      for (; r < rows; ++r) {
        const uint2 w = __ldg(
            reinterpret_cast<const uint2*>(qp + static_cast<size_t>(r) * F));
        fma_row<S_TILE>(acc, w, xs, r);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
    if (s0 + s < S) {
      float4* out = reinterpret_cast<float4*>(
          ws + (static_cast<size_t>(split) * S + s0 + s) * F + f0);
      out[0] = make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
      out[1] = make_float4(acc[s][4], acc[s][5], acc[s][6], acc[s][7]);
    }
  }
}

// y[s, f] = cast((sum over splits of ws[split, s, f]) * scale[f]).
template <typename T>
__global__ void qmm_reduce(const float* __restrict__ ws,
                           const float* __restrict__ scale, T* __restrict__ y,
                           int S, int F, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * F) return;
  const size_t plane = static_cast<size_t>(S) * F;
  float sum = 0.f;
  for (int k = 0; k < splits; ++k) sum += ws[k * plane + i];
  store(y + i, sum * scale[i % F]);
}

template <typename T, int S_TILE>
void launch(const void* x, const void* q, const void* scale, void* y, void* ws,
            int S, int D, int F, int splits, int rows_per_split,
            cudaStream_t stream) {
  const dim3 grid((F + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK, splits,
                  (S + S_TILE - 1) / S_TILE);
  qmm_partial<T, S_TILE><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<float*>(ws), S, D, F, rows_per_split);
  const int n = S * F;
  qmm_reduce<T><<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale),
      static_cast<T*>(y), S, F, splits);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* q, const void* scale, void* y,
                     void* ws, int S, int D, int F, int splits,
                     int rows_per_split, int s_tile, cudaStream_t stream) {
  switch (s_tile) {
    case 1: launch<T, 1>(x, q, scale, y, ws, S, D, F, splits, rows_per_split, stream); break;
    case 2: launch<T, 2>(x, q, scale, y, ws, S, D, F, splits, rows_per_split, stream); break;
    case 4: launch<T, 4>(x, q, scale, y, ws, S, D, F, splits, rows_per_split, stream); break;
    case 8: launch<T, 8>(x, q, scale, y, ws, S, D, F, splits, rows_per_split, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x (S, D) bf16 or f32, q (D, F) int8, scale (F,) f32, y (S, F) in x's
// dtype, ws (splits, S, F) f32 scratch.  All contiguous; F % 8 == 0;
// splits * rows_per_split >= D and every split non-empty.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int quant_matmul(const void* x, const void* q, const void* scale,
                            void* y, void* ws, int S, int D, int F, int splits,
                            int rows_per_split, int s_tile, int x_is_bf16,
                            void* stream) {
  if (S <= 0 || D <= 0 || F <= 0 || F % COLS_PER_THREAD != 0 || splits <= 0 ||
      splits > 65535 || rows_per_split <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return dispatch<__nv_bfloat16>(x, q, scale, y, ws, S, D, F, splits,
                                   rows_per_split, s_tile, st);
  }
  return dispatch<float>(x, q, scale, y, ws, S, D, F, splits, rows_per_split,
                         s_tile, st);
}
