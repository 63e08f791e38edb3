// Top-k + temperature sampling by Gumbel-argmax for Hopper (sm_90a): one
// launch per call, one block per row.
//
// Replaces no TPU kernel: the JAX package samples with plain jnp ops
// (sesameai_tts_tpu/ops/sampling.py: sample_topk and its 4-phase 32-way
// bracket search topk_threshold), which ops/sampling.py::sample_topk_plain
// ports as written, ~73 PyTorch launches a call.  A frame-step of the
// serving pool samples 32 times (c0 and codebooks 1-31), so those launches
// were ~2,300 of the step's ~10,900 small kernels.
//
// The same arithmetic as sample_topk_plain, bit for bit, for the same
// noise.  Every f32 operation rounds where the PyTorch ops round, with the
// _rn intrinsics (never contracted into an FMA):
//   x = logits / temperature (IEEE division);
//   lo, hi = min, max over the finite x (an all-non-finite row: -1, 1);
//   hi = (hi + 0.001 * (hi - lo)) + 1e-6;
//   4 phases: mids_i = lo + (hi - lo) * (i / 32), i = 1..31;
//     n = #{i : #{x >= mids_i} >= k};  lo, hi = all_mids[n], all_mids[n + 1]
//     with all_mids = (lo, mids_1..mids_31, hi);
//   token = argmax((x < lo ? -inf : x) + gumbel), NaN above all and ties
//   to the lower index as torch.argmax; a row with k <= 1 takes the argmax
//   of the raw logits.  A row with k >= V keeps every token: there the
//   threshold masks only what is -inf already, so the search is skipped.
// The counts are exact integers and min, max and argmax do not depend on
// the order of the reduction, so the result is the plain path's whatever
// the schedule.  n is counted mid by mid, as the plain path does: it
// needs no assumption that the rounded mids ascend.
//
// What bounds it: the bytes are the row's logits and noise, 16 KB at V =
// 2,051 (~5 ns at 3.35 TB/s), so the floor is the launch and the chain of
// block reductions.  The design keeps the row on chip: each thread loads
// up to R of its values and their noise at once, up front, and holds them
// in registers (divided once) across the min/max pass, the 4 phases and
// the draw; rows longer than THREADS * R are read again from L2 each pass.
// A phase counts all 31 mids at once: each thread keeps its counts in
// registers (a byte each, 4 to a word, when the row fits: a warp holds at
// most 160 of its values), a warp sums each word with one
// __reduce_add_sync (lane i keeps mid i's count), and one barrier brings
// the 16 warps' counts together; every warp then derives the same n and
// the next bracket itself.  6 barriers a
// call, nothing written to memory but the token, no workspace: a
// CUDA-graph replay needs no reset.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int R = 5;  // values a thread keeps in registers: V <= 2,560 (CSM: 2,051)
constexpr int WAYS = 32;
constexpr int MIDS = WAYS - 1;
constexpr int PHASES = 4;
constexpr unsigned FULL = 0xffffffffu;
static_assert(32 * R < 256, "a warp's count of one mid must fit in a byte");

// (a, ia) comes before (b, ib) in torch.argmax's order
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a > b || (a == b && ia < ib);
}

// the block's argmax of (v, i) → the index, in every thread
__device__ __forceinline__ int block_argmax(float v, int i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  for (int w = 1; w < WARPS; ++w) {
    if (beats(sv[w], si[w], v, i)) {
      v = sv[w];
      i = si[w];
    }
  }
  return i;
}

// all_mids[j] of the bracket (lo, hi), j = 1..31, as the plain path rounds it
__device__ __forceinline__ float mid_of(float lo, float t, int j) {
  return __fadd_rn(lo, __fmul_rn(t, static_cast<float>(j) / WAYS));
}

// Runs f(x, v) over the row's values in ascending v within each thread:
// from registers when CACHED, else read again and divided by temp (a
// temp of 1 reads the raw logits: x / 1 is x).
template <bool CACHED, typename F>
__device__ __forceinline__ void for_each(const float (&xs)[R], const float* row, float temp,
                                         int V, F f) {
  if (CACHED) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int v = threadIdx.x + r * THREADS;
      if (v < V) f(xs[r], v);
    }
  } else {
    for (int v = threadIdx.x; v < V; v += THREADS) f(__fdiv_rn(row[v], temp), v);
  }
}

template <bool CACHED>
__global__ void __launch_bounds__(THREADS, 1)
    topk_sample_kernel(const float* __restrict__ logits, const float* __restrict__ gumbel,
                       const float* __restrict__ temperature, const int64_t* __restrict__ topk,
                       int64_t* __restrict__ out, int V, int temperature_stride,
                       int topk_stride, float temperature_value, int topk_value) {
  __shared__ float s_lo[WARPS], s_hi[WARPS], s_best[WARPS];
  __shared__ int s_idx[WARPS];
  __shared__ int s_count[2][WARPS][32];

  const int row_id = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = logits + static_cast<int64_t>(row_id) * V;
  const float* noise = gumbel + static_cast<int64_t>(row_id) * V;
  const float temp =
      temperature ? temperature[static_cast<int64_t>(row_id) * temperature_stride]
                  : temperature_value;
  const int64_t k =
      topk ? topk[static_cast<int64_t>(row_id) * topk_stride] : static_cast<int64_t>(topk_value);

  // the row and its noise, loaded together up front when they fit
  float xs[R], gs[R];
  if (CACHED) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int v = threadIdx.x + r * THREADS;
      xs[r] = v < V ? row[v] : 0.0f;
      gs[r] = v < V ? noise[v] : 0.0f;
    }
  }

  if (k <= 1) {  // greedy row: the argmax of the raw logits
    float best = -INFINITY;
    int at = INT32_MAX;
    for_each<CACHED>(xs, row, 1.0f, V, [&](float x, int v) {
      if (beats(x, v, best, at)) {
        best = x;
        at = v;
      }
    });
    const int token = block_argmax(best, at, s_best, s_idx);
    if (threadIdx.x == 0) out[row_id] = token;
    return;
  }

  if (CACHED) {
#pragma unroll
    for (int r = 0; r < R; ++r) xs[r] = __fdiv_rn(xs[r], temp);
  }

  float thr = -INFINITY;  // k >= V: nothing masked
  if (k < V) {
    float lo = INFINITY, hi = -INFINITY;
    for_each<CACHED>(xs, row, temp, V, [&](float x, int) {
      if (isfinite(x)) {
        lo = fminf(lo, x);
        hi = fmaxf(hi, x);
      }
    });
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, off));
    }
    if (lane == 0) {
      s_lo[warp] = lo;
      s_hi[warp] = hi;
    }
    __syncthreads();
    lo = s_lo[0];
    hi = s_hi[0];
    for (int w = 1; w < WARPS; ++w) {
      lo = fminf(lo, s_lo[w]);
      hi = fmaxf(hi, s_hi[w]);
    }
    if (!isfinite(lo)) {  // all-banned row: keep a valid bracket
      lo = -1.0f;
      hi = 1.0f;
    }
    hi = __fadd_rn(__fadd_rn(hi, __fmul_rn(static_cast<float>(0.001), __fsub_rn(hi, lo))),
                   static_cast<float>(1e-6));

#pragma unroll 1
    for (int phase = 0; phase < PHASES; ++phase) {
      const float t = __fsub_rn(hi, lo);
      float mids[MIDS];
#pragma unroll
      for (int i = 0; i < MIDS; ++i) mids[i] = mid_of(lo, t, i + 1);
      // the warp's count for each mid; lane i keeps mid i's
      int mine = 0;
      if (CACHED) {
        // a warp counts at most 32 * R values: 4 mids' counts a word, a
        // byte each, so 8 warp sums serve the 31 mids
        unsigned c[8];
#pragma unroll
        for (int w = 0; w < 8; ++w) c[w] = 0;
        for_each<CACHED>(xs, row, temp, V, [&](float x, int) {
#pragma unroll
          for (int i = 0; i < MIDS; ++i) {
            c[i >> 2] += static_cast<unsigned>(x >= mids[i]) << (8 * (i & 3));
          }
        });
        unsigned word = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const unsigned total = __reduce_add_sync(FULL, c[w]);
          if ((lane >> 2) == w) word = total;
        }
        mine = (word >> (8 * (lane & 3))) & 0xff;
      } else {
        int c[MIDS];
#pragma unroll
        for (int i = 0; i < MIDS; ++i) c[i] = 0;
        for_each<CACHED>(xs, row, temp, V, [&](float x, int) {
#pragma unroll
          for (int i = 0; i < MIDS; ++i) c[i] += x >= mids[i];
        });
#pragma unroll
        for (int i = 0; i < MIDS; ++i) {
          const int total = __reduce_add_sync(FULL, c[i]);
          if (lane == i) mine = total;
        }
      }
      int(*counts)[32] = s_count[phase & 1];  // a phase's reads end before the next barrier
      counts[warp][lane] = mine;
      __syncthreads();
      int count = 0;
      for (int w = 0; w < WARPS; ++w) count += counts[w][lane];
      const int n = __popc(__ballot_sync(FULL, lane < MIDS && count >= k));
      const float new_lo = n == 0 ? lo : mid_of(lo, t, n);
      hi = n == MIDS ? hi : mid_of(lo, t, n + 1);
      lo = new_lo;
    }
    thr = lo;
  }

  float best = -INFINITY;
  int at = INT32_MAX;
  if (CACHED) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int v = threadIdx.x + r * THREADS;
      const float s = __fadd_rn(xs[r] < thr ? -INFINITY : xs[r], gs[r]);
      if (v < V && beats(s, v, best, at)) {
        best = s;
        at = v;
      }
    }
  } else {
    for (int v = threadIdx.x; v < V; v += THREADS) {
      const float x = __fdiv_rn(row[v], temp);
      const float s = __fadd_rn(x < thr ? -INFINITY : x, noise[v]);
      if (beats(s, v, best, at)) {
        best = s;
        at = v;
      }
    }
  }
  const int token = block_argmax(best, at, s_best, s_idx);
  if (threadIdx.x == 0) out[row_id] = token;
}

}  // namespace

// logits and gumbel (rows, V) f32, out (rows,) int64, all contiguous.
// temperature: a f32 pointer read at row * temperature_stride (0: one value
// for every row), or null for temperature_value.  topk: an int64 pointer
// read at row * topk_stride, or null for topk_value.
extern "C" int topk_sample(const void* logits, const void* gumbel, const void* temperature,
                           const void* topk, void* out, int rows, int V,
                           int temperature_stride, int topk_stride, float temperature_value,
                           int topk_value, void* stream) {
  if (rows <= 0 || V <= 0 || static_cast<int64_t>(rows) * V >= (int64_t{1} << 31) ||
      temperature_stride < 0 || topk_stride < 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  const float* gb = static_cast<const float*>(gumbel);
  const float* tp = static_cast<const float*>(temperature);
  const int64_t* kp = static_cast<const int64_t*>(topk);
  int64_t* o = static_cast<int64_t*>(out);
  if (V <= THREADS * R) {
    topk_sample_kernel<true><<<rows, THREADS, 0, st>>>(lg, gb, tp, kp, o, V, temperature_stride,
                                                       topk_stride, temperature_value,
                                                       topk_value);
  } else {
    topk_sample_kernel<false><<<rows, THREADS, 0, st>>>(lg, gb, tp, kp, o, V, temperature_stride,
                                                        topk_stride, temperature_value,
                                                        topk_value);
  }
  return cudaGetLastError();
}
