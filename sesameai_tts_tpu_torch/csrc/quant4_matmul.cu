// int4 weight-only dequant-matmul for Hopper (sm_90a).
//
// Replaces sesameai_tts_tpu/ops/quant.py::quant4_matmul_pallas (body
// _q4mv_kernel_factory): y (S, F) = bf16(x) (S, D) @ dequant4(q4, scale),
// where q4 (D/2, F) packs two signed nibbles per byte in the split-half
// layout (byte [d, f] holds row d in its low nibble and row d + D/2 in its
// high nibble) and scale (G, F) holds one f32 scale per group of D/G rows:
// groups 0..G/2-1 cover the low half, G/2..G-1 the high half.  For every
// group the kernel takes the partial dot of the nibbles (decoded to
// integers, exact in f32) with bf16 x in f32, multiplies that partial sum
// by the group's scale and adds it to an f32 sum; the result is cast to
// bf16.  A bf16 x bf16 product is exact in f32, so the arithmetic is the
// TPU kernel's up to the order of the f32 sums.
//
// What bounds it: at decode sizes (S <= 64) the packed weight bytes,
// D*F/2 per launch; x, the scales and y are a few KB.  The weight stays
// packed in device memory and is never materialized in bf16.
//
// What the design does about it:
//  * each thread owns 8 neighbouring output columns and reads them as one
//    8-byte load per packed row, so a warp reads 256 contiguous bytes of a
//    row of the row-major (D/2, F) weight; each byte feeds two rows of the
//    product, d (low nibble, against the low half of x) and d + D/2 (high
//    nibble, against the high half);
//  * every thread issues ROW_UNROLL such loads before it uses any;
//  * both halves of the block's rows of x are staged once in shared
//    memory, rounded to bf16;
//  * the reduction over the packed rows is split across blocks (grid.y),
//    and every split lies inside one scale group: a block keeps the low-
//    and high-half partial dots of its rows in f32, scales them by their
//    two groups' scales once at the end, and writes the scaled partial to
//    a workspace.  A second kernel adds the splits in a fixed order and
//    casts.  No atomics: results are deterministic.
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
constexpr int X_CHUNK = 256;  // packed rows of x staged per pass (each half)

template <int S_TILE>
__device__ __forceinline__ void fma_row(float (&acc_lo)[S_TILE][COLS_PER_THREAD],
                                        float (&acc_hi)[S_TILE][COLS_PER_THREAD],
                                        uint2 w, float (*xs_lo)[X_CHUNK],
                                        float (*xs_hi)[X_CHUNK], int r) {
  float lo[COLS_PER_THREAD], hi[COLS_PER_THREAD];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    // byte c of each word moved to the top 8 bits; the arithmetic right
    // shifts sign-extend the low nibble (after 4 more bits left) and the
    // high nibble
    const uint32_t bx = w.x << (24 - 8 * c);
    const uint32_t by = w.y << (24 - 8 * c);
    lo[c] = static_cast<float>(static_cast<int32_t>(bx << 4) >> 28);
    hi[c] = static_cast<float>(static_cast<int32_t>(bx) >> 28);
    lo[c + 4] = static_cast<float>(static_cast<int32_t>(by << 4) >> 28);
    hi[c + 4] = static_cast<float>(static_cast<int32_t>(by) >> 28);
  }
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
    const float xl = xs_lo[s][r];
    const float xh = xs_hi[s][r];
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) {
      acc_lo[s][c] = fmaf(xl, lo[c], acc_lo[s][c]);
      acc_hi[s][c] = fmaf(xh, hi[c], acc_hi[s][c]);
    }
  }
}

// Split `split` = (group g, part k): packed rows [g*group + k*rows_per_split,
// +rows_per_split) clipped to the group's end, for S_TILE rows of x and
// COLS_PER_BLOCK columns.  Writes (lo partial)*scale[g] + (hi partial)*
// scale[G/2 + g] to ws[split].
template <int S_TILE>
__global__ void __launch_bounds__(THREADS)
q4mm_partial(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q4,
             const float* __restrict__ scale, float* __restrict__ ws, int S, int D,
             int F, int G, int parts, int rows_per_split) {
  __shared__ float xs_lo[S_TILE][X_CHUNK];
  __shared__ float xs_hi[S_TILE][X_CHUNK];
  const int D2 = D / 2;
  const int G2 = G / 2;
  const int group = D / G;  // packed rows per group
  const int f0 = blockIdx.x * COLS_PER_BLOCK + threadIdx.x * COLS_PER_THREAD;
  const int split = blockIdx.y;
  const int g = split / parts;
  const int k = split - g * parts;
  const int s0 = blockIdx.z * S_TILE;
  const int k_begin = g * group + k * rows_per_split;
  const int k_end = min((g + 1) * group, k_begin + rows_per_split);
  const bool active = f0 < F;

  float acc_lo[S_TILE][COLS_PER_THREAD];
  float acc_hi[S_TILE][COLS_PER_THREAD];
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
    for (int c = 0; c < COLS_PER_THREAD; ++c) {
      acc_lo[s][c] = 0.f;
      acc_hi[s][c] = 0.f;
    }
  }

  for (int kc = k_begin; kc < k_end; kc += X_CHUNK) {
    const int rows = min(X_CHUNK, k_end - kc);
    __syncthreads();  // the previous chunk's reads of xs are done
    for (int i = threadIdx.x; i < S_TILE * X_CHUNK; i += THREADS) {
      const int s = i / X_CHUNK;
      const int r = i - s * X_CHUNK;
      float vl = 0.f, vh = 0.f;
      if (s0 + s < S && r < rows) {
        const size_t row = static_cast<size_t>(s0 + s) * D + kc + r;
        vl = __bfloat162float(x[row]);
        vh = __bfloat162float(x[row + D2]);
      }
      xs_lo[s][r] = vl;
      xs_hi[s][r] = vh;
    }
    __syncthreads();
    if (active) {
      const int8_t* qp = q4 + static_cast<size_t>(kc) * F + f0;
      int r = 0;
      for (; r + ROW_UNROLL <= rows; r += ROW_UNROLL) {
        uint2 w[ROW_UNROLL];
#pragma unroll
        for (int u = 0; u < ROW_UNROLL; ++u) {
          w[u] = __ldg(reinterpret_cast<const uint2*>(
              qp + static_cast<size_t>(r + u) * F));
        }
#pragma unroll
        for (int u = 0; u < ROW_UNROLL; ++u) {
          fma_row<S_TILE>(acc_lo, acc_hi, w[u], xs_lo, xs_hi, r + u);
        }
      }
      for (; r < rows; ++r) {
        const uint2 w = __ldg(
            reinterpret_cast<const uint2*>(qp + static_cast<size_t>(r) * F));
        fma_row<S_TILE>(acc_lo, acc_hi, w, xs_lo, xs_hi, r);
      }
    }
  }

  if (!active) return;
  float s_lo[COLS_PER_THREAD], s_hi[COLS_PER_THREAD];
#pragma unroll
  for (int c = 0; c < COLS_PER_THREAD; ++c) {
    s_lo[c] = scale[static_cast<size_t>(g) * F + f0 + c];
    s_hi[c] = scale[static_cast<size_t>(G2 + g) * F + f0 + c];
  }
#pragma unroll
  for (int s = 0; s < S_TILE; ++s) {
    if (s0 + s < S) {
      float v[COLS_PER_THREAD];
#pragma unroll
      for (int c = 0; c < COLS_PER_THREAD; ++c) {
        v[c] = acc_lo[s][c] * s_lo[c] + acc_hi[s][c] * s_hi[c];
      }
      float4* out = reinterpret_cast<float4*>(
          ws + (static_cast<size_t>(split) * S + s0 + s) * F + f0);
      out[0] = make_float4(v[0], v[1], v[2], v[3]);
      out[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// y[s, f] = bf16(sum over splits, in order, of ws[split, s, f]).
__global__ void q4mm_reduce(const float* __restrict__ ws,
                            __nv_bfloat16* __restrict__ y, int S, int F,
                            int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * F) return;
  const size_t plane = static_cast<size_t>(S) * F;
  float sum = 0.f;
  for (int k = 0; k < splits; ++k) sum += ws[k * plane + i];
  y[i] = __float2bfloat16_rn(sum);
}

template <int S_TILE>
void launch(const void* x, const void* q4, const void* scale, void* y, void* ws,
            int S, int D, int F, int G, int parts, int rows_per_split,
            cudaStream_t stream) {
  const int splits = (G / 2) * parts;
  const dim3 grid((F + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK, splits,
                  (S + S_TILE - 1) / S_TILE);
  q4mm_partial<S_TILE><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q4),
      static_cast<const float*>(scale), static_cast<float*>(ws), S, D, F, G,
      parts, rows_per_split);
  const int n = S * F;
  q4mm_reduce<<<(n + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(y), S, F,
      splits);
}

}  // namespace

// x (S, D) bf16, q4 (D/2, F) int8, scale (G, F) f32, y (S, F) bf16, ws
// (G/2 * parts, S, F) f32 scratch.  All contiguous; F % 8 == 0; G even and
// D % G == 0; every group of D/G packed rows is cut into `parts` splits of
// rows_per_split rows, none empty.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int quant4_matmul(const void* x, const void* q4, const void* scale,
                             void* y, void* ws, int S, int D, int F, int G,
                             int parts, int rows_per_split, int s_tile,
                             void* stream) {
  if (S <= 0 || D <= 0 || F <= 0 || F % COLS_PER_THREAD != 0 || G <= 0 ||
      G % 2 != 0 || D % G != 0 || parts <= 0 || rows_per_split <= 0 ||
      (parts - 1) * rows_per_split >= D / G || parts * rows_per_split < D / G ||
      (G / 2) * parts > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s_tile) {
    case 1: launch<1>(x, q4, scale, y, ws, S, D, F, G, parts, rows_per_split, st); break;
    case 2: launch<2>(x, q4, scale, y, ws, S, D, F, G, parts, rows_per_split, st); break;
    case 4: launch<4>(x, q4, scale, y, ws, S, D, F, G, parts, rows_per_split, st); break;
    case 8: launch<8>(x, q4, scale, y, ws, S, D, F, G, parts, rows_per_split, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
