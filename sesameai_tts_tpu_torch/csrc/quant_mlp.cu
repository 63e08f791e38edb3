// Fused int8 SwiGLU MLP for Hopper (sm_90a).
//
// Replaces sesameai_tts_tpu/ops/quant.py::quant_mlp_pallas (body
// _qmlp_kernel_factory): y (S, Dout) = silu(x@W1*s1) * (x@W3*s3) @ W2 * s2
// with all three weights int8.  q13 (D, 2F) holds w1 in columns [0, F) and
// w3 in [F, 2F), s13 (2F,) their per-column scales, q2 (F, Dout) and s2
// (Dout,) the down projection.  The dtype walk is the unfused sequence's:
//   a1 = (x @ bf16(q1)) * s1 and a3 = (x @ bf16(q3)) * s3, f32 sums;
//   h  = bf16(bf16(silu(f32(bf16(a1)))) * bf16(a3));
//   y  = bf16((sum over intermediate tiles of h_tile @ bf16(q2_tile)) * s2),
// the tile sums in f32.  x is bf16; int8 -> f32 is exact and so is a
// bf16 x bf16 product in f32, so the w13 half is the unfused kernel's up
// to the order of its f32 sums, and the w2 contraction differs only in
// the order of f32 sums.
//
// What bounds it: at decode sizes (S <= 64) the int8 weight bytes,
// 2*D*F + F*Dout per launch, plus the f32 partials of the intermediate
// tiles, which the design keeps small (below).
//
// What the design does about it:
//  * one block per (S tile, intermediate tile of BI columns): it streams
//    the w1 and w3 column tiles and the matching w2 row tile once, and the
//    hidden h of its tile lives only in shared memory, so it never reaches
//    device memory;
//  * phase 1 (w13): 512 threads = (2*BI/8 column groups) x (row slices);
//    each thread owns 8 neighbouring columns of w1 or w3 and reads them as
//    one 8-byte load per row, 16 rows in flight at S <= 2 (8 above, where
//    the accumulators take the registers), so the w1 and w3 tiles are read
//    in 64- or 256-byte contiguous runs; the row slices' partial sums are
//    added in shared memory in a fixed order.  One 512-thread block per SM
//    keeps up to 64 KB of weight loads in flight;
//  * phase 2 (w2): each thread owns 8 neighbouring output columns of a
//    slice of the tile's BI rows of w2, again one 8-byte load per row;
//  * each tile writes its (S, Dout) f32 partial to a workspace and a second
//    kernel adds the tiles in a fixed order, applies s2 and casts.  No
//    atomics: results are deterministic.  The workspace moves
//    2 * 4 * S * Dout bytes per tile, so the wrapper widens BI (fewer
//    tiles) when S is large;
//  * the S tile's rows of x are staged once in shared memory, rounded to
//    bf16; blockIdx.x walks the S tiles so that the S tiles of one
//    intermediate tile run together and share its weights in L2.
// wgmma, TMA and a pipelined ring are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int COLS_PER_THREAD = 8;
constexpr int ROW_UNROLL = 8;  // rows per load batch; 2x at S_TILE <= 2

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void decode8(uint2 w, float (&wf)[COLS_PER_THREAD]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    wf[c] = static_cast<float>(static_cast<int8_t>((w.x >> (8 * c)) & 0xff));
    wf[c + 4] = static_cast<float>(static_cast<int8_t>((w.y >> (8 * c)) & 0xff));
  }
}

template <int S_TILE>
__device__ __forceinline__ void fma8(float (&acc)[S_TILE][COLS_PER_THREAD], uint2 w,
                                     const float* v, int stride) {
  float wf[COLS_PER_THREAD];
  decode8(w, wf);
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
    const float xv = v[s * stride];
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) acc[s][c] = fmaf(xv, wf[c], acc[s][c]);
  }
}

// Shared memory: region A (max(S_TILE*D, THREADS*8*S_TILE) floats) holds the
// staged x during phase 1 and the row slices' partial sums afterwards;
// region H (S_TILE*BI floats) holds h.
template <int S_TILE, int BI>
__global__ void __launch_bounds__(THREADS)
qmlp_partial(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q13,
             const float* __restrict__ s13, const int8_t* __restrict__ q2,
             float* __restrict__ ws, int S, int D, int F, int Dout) {
  extern __shared__ float smem[];
  constexpr int CG1 = 2 * BI / COLS_PER_THREAD;  // phase-1 column groups
  constexpr int RS1 = THREADS / CG1;             // phase-1 row slices
  constexpr int UNROLL1 = S_TILE <= 2 ? 2 * ROW_UNROLL : ROW_UNROLL;
  static_assert(THREADS % CG1 == 0, "BI must give whole row slices");
  const int region_a = max(S_TILE * D, THREADS * COLS_PER_THREAD * S_TILE);
  float* xs = smem;              // [S_TILE][D]
  float* red = smem;             // [slices][S_TILE][cols]
  float* hs = smem + region_a;   // [S_TILE][BI]
  const int s0 = blockIdx.x * S_TILE;
  const int tile = blockIdx.y;
  const int t = threadIdx.x;

  for (int i = t; i < S_TILE * D; i += THREADS) {
    const int s = i / D;
    xs[i] = s0 + s < S ? __bfloat162float(x[static_cast<size_t>(s0) * D + i]) : 0.f;
  }
  __syncthreads();

  // ---- phase 1: the w1 and w3 column tiles -------------------------------
  const int cg = t % CG1;
  const int rs = t / CG1;
  const int half = CG1 / 2;
  const int col1 = cg < half ? tile * BI + cg * COLS_PER_THREAD
                             : F + tile * BI + (cg - half) * COLS_PER_THREAD;
  const size_t ld13 = static_cast<size_t>(2) * F;
  float acc[S_TILE][COLS_PER_THREAD];
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) acc[s][c] = 0.f;
  }
  // rows in batches of UNROLL1 (D % 16 == 0), slices interleaved by batch
  for (int r0 = rs * UNROLL1; r0 < D; r0 += RS1 * UNROLL1) {
    uint2 w[UNROLL1];
#pragma unroll
    for (int u = 0; u < UNROLL1; ++u) {
      w[u] = __ldg(reinterpret_cast<const uint2*>(q13 + (r0 + u) * ld13 + col1));
    }
#pragma unroll
    for (int u = 0; u < UNROLL1; ++u) fma8<S_TILE>(acc, w[u], xs + r0 + u, D);
  }
  __syncthreads();  // every thread is done reading xs: region A becomes red
  {
    const int lcol = cg * COLS_PER_THREAD;  // w1 cols [0, BI), w3 [BI, 2BI)
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
      for (int c = 0; c < COLS_PER_THREAD; ++c) {
        red[(rs * S_TILE + s) * (2 * BI) + lcol + c] = acc[s][c];
      }
    }
  }
  __syncthreads();
  for (int i = t; i < S_TILE * BI; i += THREADS) {
    const int s = i / BI;
    const int j = i - s * BI;
    float a1 = 0.f, a3 = 0.f;
    for (int k = 0; k < RS1; ++k) {
      a1 += red[(k * S_TILE + s) * (2 * BI) + j];
      a3 += red[(k * S_TILE + s) * (2 * BI) + BI + j];
    }
    a1 *= s13[tile * BI + j];
    a3 *= s13[F + tile * BI + j];
    const float g = bf16_round(a1);
    const float act = bf16_round(g / (1.f + expf(-g)));
    hs[i] = bf16_round(act * bf16_round(a3));
  }
  __syncthreads();  // h is complete and region A is free again

  // ---- phase 2: the tile's BI rows of w2 ---------------------------------
  const int cg2 = Dout / COLS_PER_THREAD;
  const int rs2 = max(1, THREADS / cg2);
  const int rows2 = (BI + rs2 - 1) / rs2;
  const int8_t* q2t = q2 + static_cast<size_t>(tile) * BI * Dout;
  for (int item = t; item < (rs2 == 1 ? cg2 : rs2 * cg2);
       item += (rs2 == 1 ? THREADS : rs2 * cg2)) {
    const int c2 = item % cg2;
    const int slice = item / cg2;
    const int r_begin = slice * rows2;
    const int r_end = min(BI, r_begin + rows2);
    float acc2[S_TILE][COLS_PER_THREAD];
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
      for (int c = 0; c < COLS_PER_THREAD; ++c) acc2[s][c] = 0.f;
    }
    const int8_t* qp = q2t + c2 * COLS_PER_THREAD;
    int r = r_begin;
    for (; r + ROW_UNROLL <= r_end; r += ROW_UNROLL) {
      uint2 w[ROW_UNROLL];
#pragma unroll
      for (int u = 0; u < ROW_UNROLL; ++u) {
        w[u] = __ldg(reinterpret_cast<const uint2*>(
            qp + static_cast<size_t>(r + u) * Dout));
      }
#pragma unroll
      for (int u = 0; u < ROW_UNROLL; ++u) fma8<S_TILE>(acc2, w[u], hs + r + u, BI);
    }
    for (; r < r_end; ++r) {
      const uint2 w = __ldg(
          reinterpret_cast<const uint2*>(qp + static_cast<size_t>(r) * Dout));
      fma8<S_TILE>(acc2, w, hs + r, BI);
    }
    if (rs2 == 1) {  // the thread holds whole sums: straight to the workspace
#pragma unroll
      for (int s = 0; s < S_TILE; ++s) {
        if (s0 + s < S) {
          float4* out = reinterpret_cast<float4*>(
              ws + (static_cast<size_t>(tile) * S + s0 + s) * Dout + c2 * COLS_PER_THREAD);
          out[0] = make_float4(acc2[s][0], acc2[s][1], acc2[s][2], acc2[s][3]);
          out[1] = make_float4(acc2[s][4], acc2[s][5], acc2[s][6], acc2[s][7]);
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
        for (int c = 0; c < COLS_PER_THREAD; ++c) {
          red[(slice * S_TILE + s) * Dout + c2 * COLS_PER_THREAD + c] = acc2[s][c];
        }
      }
    }
  }
  if (rs2 == 1) return;
  __syncthreads();
  for (int i = t; i < S_TILE * Dout; i += THREADS) {
    const int s = i / Dout;
    if (s0 + s >= S) continue;
    float sum = 0.f;
    for (int k = 0; k < rs2; ++k) sum += red[k * S_TILE * Dout + i];
    ws[(static_cast<size_t>(tile) * S + s0) * Dout + i] = sum;
  }
}

// y[s, o] = bf16((sum over tiles, in order, of ws[tile, s, o]) * s2[o]).
__global__ void qmlp_reduce(const float* __restrict__ ws, const float* __restrict__ s2,
                            __nv_bfloat16* __restrict__ y, int S, int Dout, int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * Dout) return;
  const size_t plane = static_cast<size_t>(S) * Dout;
  float sum = 0.f;
  for (int k = 0; k < tiles; ++k) sum += ws[k * plane + i];
  y[i] = __float2bfloat16_rn(sum * s2[i % Dout]);
}

template <int S_TILE, int BI>
cudaError_t launch(const void* x, const void* q13, const void* s13, const void* q2,
                   const void* s2, void* y, void* ws, int S, int D, int F, int Dout,
                   cudaStream_t stream) {
  const size_t region_a = max(S_TILE * D, THREADS * COLS_PER_THREAD * S_TILE);
  const size_t smem = (region_a + S_TILE * BI) * sizeof(float);
  if (smem > 232448) return cudaErrorInvalidValue;  // 227 KB per block
  auto kernel = qmlp_partial<S_TILE, BI>;
  // above 48 KB a block's dynamic shared memory must be allowed first; set
  // once per instantiation (on the first call, before any graph capture)
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int tiles = F / BI;
  const dim3 grid((S + S_TILE - 1) / S_TILE, tiles);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q13),
      static_cast<const float*>(s13), static_cast<const int8_t*>(q2),
      static_cast<float*>(ws), S, D, F, Dout);
  const int n = S * Dout;
  qmlp_reduce<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(s2),
      static_cast<__nv_bfloat16*>(y), S, Dout, tiles);
  return cudaGetLastError();
}

template <int BI>
cudaError_t dispatch(const void* x, const void* q13, const void* s13, const void* q2,
                     const void* s2, void* y, void* ws, int S, int D, int F, int Dout,
                     int s_tile, cudaStream_t st) {
  switch (s_tile) {
    case 1: return launch<1, BI>(x, q13, s13, q2, s2, y, ws, S, D, F, Dout, st);
    case 2: return launch<2, BI>(x, q13, s13, q2, s2, y, ws, S, D, F, Dout, st);
    case 4: return launch<4, BI>(x, q13, s13, q2, s2, y, ws, S, D, F, Dout, st);
    case 8: return launch<8, BI>(x, q13, s13, q2, s2, y, ws, S, D, F, Dout, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (S, D) bf16, q13 (D, 2F) int8, s13 (2F,) f32, q2 (F, Dout) int8, s2
// (Dout,) f32, y (S, Dout) bf16, ws (F / block_i, S, Dout) f32 scratch.  All
// contiguous; D % 16 == 0, F % block_i == 0, Dout % 8 == 0; block_i is 64
// or 256.  Launches on `stream` and returns the launch's CUDA error (0 on
// success).
extern "C" int quant_mlp(const void* x, const void* q13, const void* s13,
                         const void* q2, const void* s2, void* y, void* ws, int S,
                         int D, int F, int Dout, int block_i, int s_tile,
                         void* stream) {
  if (S <= 0 || D <= 0 || F <= 0 || Dout <= 0 || D % (2 * ROW_UNROLL) != 0 ||
      Dout % COLS_PER_THREAD != 0 || block_i <= 0 || F % block_i != 0 ||
      F / block_i > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_i) {
    case 64: return dispatch<64>(x, q13, s13, q2, s2, y, ws, S, D, F, Dout, s_tile, st);
    case 256: return dispatch<256>(x, q13, s13, q2, s2, y, ws, S, D, F, Dout, s_tile, st);
    default: return cudaErrorInvalidValue;
  }
}
