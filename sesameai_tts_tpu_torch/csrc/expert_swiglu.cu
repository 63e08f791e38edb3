// Grouped int8 weight-only expert SwiGLU for Hopper (sm_90a): the routed
// FFN of a mixture-of-experts layer for 1-64 rows, in three launches.
//
// Replaces no TPU kernel: the JAX package has no routed FFN.  It was added
// for the LFM2-MoE backbone (models/hybrid.py), whose 22 routed layers of
// 32 experts (top 4) are most of a frame-step's weight bytes.
//
//   y[n] = sum_j  w[n, j] * (silu(x[n] W1_e) * (x[n] W3_e)) W2_e,   e = ids[n, j]
//
// with W13_e (D, 2F) and W2_e (F, D) int8, one f32 scale a column, and the
// routing (ids (N, k) int64, w (N, k) f32) read from device memory, so the
// call can sit in a captured CUDA graph.
//
// What bounds it: the expert weights.  At 16 rows and top 4 a layer hits
// ~28 of 32 experts, 11 MB each in int8; the activations are kilobytes.  So
// the design reads each hit expert's weights once and spends nothing on an
// expert no row chose:
//   expert_up_kernel   grid (F/64, E): a block holds 64 columns of W1 and
//     the 64 matching columns of W3 of expert blockIdx.y.  It first gathers
//     the (row, choice) pairs routed to its expert, in ascending order
//     (warp ballots), and exits at once if there are none.  Then it streams
//     its (D, 128) int8 tile in chunks of 64 rows: each chunk's 8 KB and
//     the chunk's activations of the routed rows are loaded into registers
//     while the previous chunk is multiplied from shared memory.  A thread
//     owns one column and one half of every chunk's rows, and keeps one f32
//     sum per routed row; the halves are added in a fixed order, the W3
//     half handed to the W1 thread of the same column, and h = silu(a1) *
//     a3 written to an f32 workspace (N*k, F), one row a pair.
//   expert_down_kernel grid (D/128, E): the same walk over W2's (F, 128)
//     tile against h's rows of the pairs routed to the expert; each pair's
//     product times its routing weight goes to an f32 workspace (N*k, D).
//     Every pair is routed to exactly one expert, so every row of it is
//     written, and no block adds to another's output: no atomics.
//   expert_sum_kernel: y[n] = part[n, 0] + part[n, 1] + ... in that order,
//     cast to bf16.  The result does not depend on the schedule.
// Experts' blocks with no pairs return after the gather.  A thread's sums
// for rows past the expert's count are skipped by a per-block switch on the
// rows rounded up to 4, 8, 16, 32 or 64 (padded with zeros), so the common
// case of 1-4 rows an expert costs 4 FMAs a weight.
//
// The up kernel's block x = 0 of each hit expert adds 1 to stats[0] and
// raises stats[1] to its row count (int32 atomics: an exact count whatever
// their order), when stats is given: the pool's experts_hit and
// expert_rows_max counters, accumulated inside the graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 128;  // weight columns a block streams
constexpr int KC = 64;     // weight rows a chunk
constexpr int HALF = KC / 2;
constexpr int MAXP = 512;  // (row, choice) pairs: N <= 64, k <= 8
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// the pairs p < P with ids[p] == e, ascending, into s_pair → their count
// (the same in every thread)
__device__ int gather_pairs(const int64_t* __restrict__ ids, int P, int e, int* s_pair,
                            int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n = 0;
  for (int base = 0; base < P; base += THREADS) {
    const int p = base + threadIdx.x;
    const bool hit = p < P && ids[p] == e;
    const unsigned m = __ballot_sync(FULL, hit);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int off = n, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (hit) s_pair[off + __popc(m & ((1u << lane) - 1u))] = p;
    n += total;
    __syncthreads();
  }
  return n;
}

// acc[r] += w[kk][col] * xs[kk][r] for the thread's half of a chunk, r < NB
template <int NB, int MAXR>
__device__ __forceinline__ void fma_chunk(float (&acc)[MAXR], const int8_t* ws, const float* xs,
                                          int col, int half) {
#pragma unroll 4
  for (int kk = half * HALF; kk < half * HALF + HALF; ++kk) {
    const float w = static_cast<float>(ws[kk * COLS + col]);
    const float4* xv = reinterpret_cast<const float4*>(xs + kk * MAXR);
#pragma unroll
    for (int r4 = 0; r4 < NB / 4; ++r4) {
      const float4 v = xv[r4];
      acc[4 * r4 + 0] = fmaf(w, v.x, acc[4 * r4 + 0]);
      acc[4 * r4 + 1] = fmaf(w, v.y, acc[4 * r4 + 1]);
      acc[4 * r4 + 2] = fmaf(w, v.z, acc[4 * r4 + 2]);
      acc[4 * r4 + 3] = fmaf(w, v.w, acc[4 * r4 + 3]);
    }
  }
}

// The block's (K, 128) int8 tile of expert e (columns seg_a..seg_a+63 and
// seg_b..seg_b+63 of its (K, ldq) matrix) against the activations of its n
// pairs (rows of `in`: the pair's row of x when `up`, else the pair's own
// row) → acc[r] (r < n): the thread's column, both halves summed, in half 0.
// Leaves s_pair's first n entries, returns through acc; the caller's
// epilogue uses `red` (MAXR x COLS floats) over the dead tile buffers.
template <int MAXR, bool UP, typename TIn>
__device__ __forceinline__ void stream_tile(float (&acc)[MAXR], const TIn* __restrict__ in,
                                            int in_ld, int k, const int8_t* __restrict__ qe,
                                            int K, int ldq, int seg_a, int seg_b, int n,
                                            const int* s_pair, unsigned char* smem) {
  constexpr int XR = MAXR * KC / THREADS;  // activation loads a thread a chunk
  int8_t* ws = reinterpret_cast<int8_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + KC * COLS);
  const int tid = threadIdx.x, col = tid & (COLS - 1), half = tid >> 7;
  const int nb = n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : 64;
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  int4 wr[2];
  float xr[XR];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int L = tid + i * THREADS, row = L >> 3, part = L & 7;
      const int c = ((part >> 2) ? seg_b : seg_a) + (part & 3) * 16;
      wr[i] = __ldg(reinterpret_cast<const int4*>(qe + static_cast<size_t>(k0 + row) * ldq + c));
    }
#pragma unroll
    for (int i = 0; i < XR; ++i) {
      const int j = tid + i * THREADS, r = j / KC, kk = j % KC;
      float v = 0.f;
      if (r < n) {
        const int row = UP ? s_pair[r] / k : s_pair[r];
        v = to_f32(in[static_cast<size_t>(row) * in_ld + k0 + kk]);
      }
      xr[i] = v;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int L = tid + i * THREADS, row = L >> 3, part = L & 7;
      *reinterpret_cast<int4*>(ws + row * COLS + (part >> 2) * 64 + (part & 3) * 16) = wr[i];
    }
#pragma unroll
    for (int i = 0; i < XR; ++i) {
      const int j = tid + i * THREADS, r = j / KC, kk = j % KC;
      if (r < nb) xs[kk * MAXR + r] = xr[i];
    }
  };

  const int chunks = K / KC;
  load(0);
  for (int c = 0; c < chunks; ++c) {
    if (c) __syncthreads();  // the last chunk's products are done with the tile
    store();
    __syncthreads();
    if (c + 1 < chunks) load((c + 1) * KC);  // in flight while this chunk multiplies
    switch (nb) {
      case 4: fma_chunk<4, MAXR>(acc, ws, xs, col, half); break;
      case 8: if constexpr (MAXR >= 8) fma_chunk<8, MAXR>(acc, ws, xs, col, half); break;
      case 16: if constexpr (MAXR >= 16) fma_chunk<16, MAXR>(acc, ws, xs, col, half); break;
      case 32: if constexpr (MAXR >= 32) fma_chunk<32, MAXR>(acc, ws, xs, col, half); break;
      default: if constexpr (MAXR >= 64) fma_chunk<64, MAXR>(acc, ws, xs, col, half); break;
    }
  }
  __syncthreads();  // the tile buffers are dead: red overlaps them
  float* red = reinterpret_cast<float*>(smem);
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < n) red[r * COLS + col] = acc[r];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < n) acc[r] += red[r * COLS + col];
  }
  __syncthreads();
}

template <int MAXR>
__global__ void __launch_bounds__(THREADS)
expert_up_kernel(const __nv_bfloat16* __restrict__ x, const int64_t* __restrict__ ids, int P,
                 int k, const int8_t* __restrict__ q13, const float* __restrict__ s13, int D,
                 int F, float* __restrict__ h, int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_pair[MAXP];
  __shared__ int s_warp[WARPS];
  const int e = blockIdx.y;
  const int n = gather_pairs(ids, P, e, s_pair, s_warp);
  if (n == 0) return;
  if (stats != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(stats, 1);
    atomicMax(stats + 1, n);
  }
  const int seg_a = blockIdx.x * 64, seg_b = F + seg_a;
  float acc[MAXR];
  stream_tile<MAXR, true>(acc, x, D, k, q13 + static_cast<size_t>(e) * D * 2 * F, D, 2 * F,
                          seg_a, seg_b, n, s_pair, smem);
  float* red = reinterpret_cast<float*>(smem);
  const int col = threadIdx.x & (COLS - 1), half = threadIdx.x >> 7;
  const float* se = s13 + static_cast<size_t>(e) * 2 * F;
  if (half == 0 && col >= 64) {  // a3 to the W1 thread of the same column
    const float s = se[seg_b + col - 64];
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < n) red[r * COLS + col] = acc[r] * s;
  }
  __syncthreads();
  if (half == 0 && col < 64) {
    const float s = se[seg_a + col];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < n) {
        const float a1 = acc[r] * s;
        const float a3 = red[r * COLS + col + 64];
        h[static_cast<size_t>(s_pair[r]) * F + seg_a + col] = a1 / (1.f + expf(-a1)) * a3;
      }
    }
  }
}

template <int MAXR>
__global__ void __launch_bounds__(THREADS)
expert_down_kernel(const float* __restrict__ h, const int64_t* __restrict__ ids,
                   const float* __restrict__ wts, int P, const int8_t* __restrict__ q2,
                   const float* __restrict__ s2, int D, int F, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_pair[MAXP];
  __shared__ int s_warp[WARPS];
  const int e = blockIdx.y;
  const int n = gather_pairs(ids, P, e, s_pair, s_warp);
  if (n == 0) return;
  const int seg_a = blockIdx.x * COLS;
  float acc[MAXR];
  stream_tile<MAXR, false>(acc, h, F, 1, q2 + static_cast<size_t>(e) * F * D, F, D, seg_a,
                           seg_a + 64, n, s_pair, smem);
  const int col = threadIdx.x & (COLS - 1), half = threadIdx.x >> 7;
  if (half == 0) {
    const float s = s2[static_cast<size_t>(e) * D + seg_a + col];
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      if (r < n) {
        const int p = s_pair[r];
        part[static_cast<size_t>(p) * D + seg_a + col] = acc[r] * s * wts[p];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
expert_sum_kernel(const float* __restrict__ part, int N, int k, int D,
                  __nv_bfloat16* __restrict__ y) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N * D) return;
  const int n = i / D, d = i % D;
  const float* p = part + static_cast<size_t>(n) * k * D + d;
  float s = p[0];
  for (int j = 1; j < k; ++j) s += p[static_cast<size_t>(j) * D];
  y[i] = __float2bfloat16(s);
}

template <int MAXR>
int launch(const void* x, const void* ids, const void* wts, const void* q13, const void* s13,
           const void* q2, const void* s2, void* h, void* part, void* y, void* stats, int N, int k,
           int E, int D, int F, cudaStream_t st) {
  const int P = N * k;
  const size_t tile = KC * COLS + KC * MAXR * sizeof(float);
  const size_t red = MAXR * COLS * sizeof(float);
  const size_t smem = tile > red ? tile : red;
  const int64_t* id = static_cast<const int64_t*>(ids);
  expert_up_kernel<MAXR><<<dim3(F / 64, E), THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), id, P, k, static_cast<const int8_t*>(q13),
      static_cast<const float*>(s13), D, F, static_cast<float*>(h), static_cast<int*>(stats));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  expert_down_kernel<MAXR><<<dim3(D / COLS, E), THREADS, smem, st>>>(
      static_cast<const float*>(h), id, static_cast<const float*>(wts), P,
      static_cast<const int8_t*>(q2), static_cast<const float*>(s2), D, F,
      static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  expert_sum_kernel<<<(N * D + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(part), N, k, D, static_cast<__nv_bfloat16*>(y));
  return cudaGetLastError();
}

}  // namespace

// x (N, D) bf16; ids (N, k) int64 in [0, E); wts (N, k) f32; q13 (E, D, 2F)
// int8 and s13 (E, 2F) f32; q2 (E, F, D) int8 and s2 (E, D) f32; workspaces
// h (N*k, F) and part (N*k, D) f32; y (N, D) bf16; stats int32[2] or null.
// All contiguous.  1 <= N <= 64, 1 <= k <= 8, F % 64 == 0, D % 128 == 0.
extern "C" int expert_swiglu(const void* x, const void* ids, const void* wts, const void* q13,
                             const void* s13, const void* q2, const void* s2, void* h, void* part,
                             void* y, void* stats, int N, int k, int E, int D, int F,
                             void* stream) {
  if (N < 1 || N > 64 || k < 1 || k > 8 || E < 1 || D % COLS || F % 64 || D < KC || F < KC) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch<4>(x, ids, wts, q13, s13, q2, s2, h, part, y, stats, N, k, E, D, F, st);
  if (N <= 8) return launch<8>(x, ids, wts, q13, s13, q2, s2, h, part, y, stats, N, k, E, D, F, st);
  if (N <= 16)
    return launch<16>(x, ids, wts, q13, s13, q2, s2, h, part, y, stats, N, k, E, D, F, st);
  if (N <= 32)
    return launch<32>(x, ids, wts, q13, s13, q2, s2, h, part, y, stats, N, k, E, D, F, st);
  return launch<64>(x, ids, wts, q13, s13, q2, s2, h, part, y, stats, N, k, E, D, F, st);
}
