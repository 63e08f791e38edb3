// The gradient of causal GQA flash attention over a KV cache, for Hopper
// (sm_90a).
//
// No Pallas counterpart: the JAX package trains through XLA's autodiff of
// sesameai_tts_tpu/models/transformer.py::_attention (its cache-free
// training mode), while the port sends every trunk attention to
// csrc/flash_attention.cu.  This is that function's gradient, as
// ops/attention.py::flash_attention_bwd_plain writes it: with q (B, H, S,
// hd), k, v (B, KV, T, hd), head h reading KV head h / G, query row i of
// batch row b at position pos0[b] + i seeing slot t when t <= pos0[b] + i
// and t < valid_end[b], and P = softmax(q k^T * scale) over the visible
// slots,
//   dV = sum_g P^T dO,   dP = dO V^T,   dS = P o (dP - D),  D = rowsum(dO o O),
//   dQ = dS K * scale,   dK = sum_g dS^T Q * scale.
// Every product is of the operands' values (bf16 or f32) in f32 FMA on CUDA
// cores, every sum is f32, the results are rounded to the operands' dtype
// once.  A row that sees no slot gets zero gradients.
//
// What bounds it: operations.  The backward does 10 * hd operations per
// visible (query, slot) pair and head (five products) for the same bytes
// as the forward plus three gradients, so even at S = 512 it sits near the
// ridge in bf16 and far above it in f32; this first design recomputes the
// scores in both kernels (16 * hd operations per pair in all) on CUDA
// cores, so it is far from that bound.  wgmma tiles and one fused pass are
// later work.
//
// Two kernels on the caller's stream, both without atomics: every output
// element is written by exactly one thread after a sum in a fixed order,
// so a call is bit-deterministic (a resumed LoRA run equals an unbroken
// one).
//  * bwd_rows, one block per (query tile, KV head, batch row): the tile's
//    G * BQ <= 16 query vectors (all G heads of the KV head, BQ = 16 / G
//    rows) and their dO sit in shared memory.  A first sweep over the
//    visible K tiles recomputes each vector's max and sum (an online
//    softmax, lanes over keys); the vector's log-sum-exp L and D = dO . O
//    go to a workspace.  A second sweep over the K/V tiles computes, lane
//    per key, p = exp(s - L), dp = dO . v and ds = p (dp - D), and
//    accumulates dq = sum_t ds_t k_t in registers (lanes over dims, ds_t
//    broadcast by shuffle).  K and V rows are padded in shared memory so
//    the lanes, each reading its own key's row, hit distinct banks.
//  * bwd_keys, one block per (16 key slots, KV head, batch row), after
//    bwd_rows: the block's K and V rows sit in shared memory, each warp
//    owns 4 slots and keeps their dk, dv in registers.  It streams, 32 at a
//    time (a lane each), the query vectors of the G heads from the first
//    row that sees its first slot to the last row, with their dO, L and D,
//    recomputes p and ds for each (vector, slot) pair and accumulates
//    dv += p dO and dk += ds q (lanes over dims, p and ds broadcast by
//    shuffle).  Slots at or past valid_end get zero gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int QPW = 4;            // query vectors per warp in bwd_rows
constexpr int QV = WARPS * QPW;   // ... per block: G may not exceed it
constexpr int KPW = 4;            // key slots per warp in bwd_keys
constexpr int BKT = WARPS * KPW;  // ... per block
constexpr int QT = 32;            // query vectors per tile in bwd_keys, one per lane

template <typename T>
struct Layout {
  // K/V tile of bwd_rows, in keys (a lane scores BK / 32 of them)
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;
  // rows a lane reads as its own (K and V in bwd_rows, Q and dO in
  // bwd_keys) are padded to an odd number of 4-byte words
  static constexpr int PAD = sizeof(T) == 2 ? 2 : 1;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int HD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < HD; ++d) s[d % 4] = fmaf(a[d], b[d], s[d % 4]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

template <int HD>
__device__ __forceinline__ float dot(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) {
    const float2 x = __bfloat1622float2(a2[j]);
    const float2 y = __bfloat1622float2(b2[j]);
    s[(2 * j) % 4] = fmaf(x.x, y.x, s[(2 * j) % 4]);
    s[(2 * j + 1) % 4] = fmaf(x.y, y.y, s[(2 * j + 1) % 4]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// grid (ceil(S / BQ), KV, B).  Query vector r of the block is row
// q0 + r / G of head kvh * G + r % G.  q, o, dout and dq are contiguous
// (B, H, S, HD); lse and delta (B, H, S).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ o, const T* __restrict__ dout,
         const long long* __restrict__ pos0, const long long* __restrict__ valid_end,
         T* __restrict__ dq, float* __restrict__ lse, float* __restrict__ delta, int H,
         int KV, int S, int T_len, int BQ, float scale) {
  constexpr int BK = Layout<T>::BK;
  constexpr int KPL = BK / 32;         // keys per lane in a tile
  constexpr int DPL = (HD + 31) / 32;  // dq dims per lane
  constexpr int KS = HD + Layout<T>::PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + BK * KS;
  T* q_s = v_s + BK * KS;
  T* do_s = q_s + QV * HD;

  const int G = H / KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, S - q0);
  const int R = rows * G;
  const long long p0 = pos0[b];
  const long long ve = valid_end[b];
  // slots below kend are visible to some row of the tile
  const long long kend_ll = min(min(ve, p0 + q0 + rows), static_cast<long long>(T_len));
  const int kend = static_cast<int>(max(kend_ll, 0LL));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  auto row_of = [&](int r) -> size_t {  // (b, head, row) of vector r, flattened
    return (static_cast<size_t>(b) * H + kvh * G + r % G) * S + q0 + r / G;
  };
  for (int idx = threadIdx.x; idx < R * HD; idx += THREADS) {
    const int r = idx / HD;
    const size_t off = row_of(r) * HD + (idx - r * HD);
    q_s[idx] = q[off];
    do_s[idx] = dout[off];
  }

  const size_t head = (static_cast<size_t>(b) * KV + kvh) * T_len * HD;
  auto load_tile = [&](T* dst, const T* src, int kt, int n) {
    for (int idx = threadIdx.x; idx < BK * HD; idx += THREADS) {
      const int t = idx / HD;
      const int d = idx - t * HD;
      if (t < n) {
        dst[t * KS + d] = src[head + static_cast<size_t>(kt + t) * HD + d];
      } else {
        store(dst + t * KS + d, 0.f);
      }
    }
  };

  float m[QPW], l[QPW];
  int qpos[QPW];  // a position past the cache sees every slot below kend anyway
  const int p0c = static_cast<int>(min(p0, static_cast<long long>(T_len)));
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
    qpos[j] = p0c + q0 + (warp + WARPS * j) / G;
  }

  // sweep 1: each vector's max and sum over its visible slots
  for (int kt = 0; kt < kend; kt += BK) {
    const int n = min(BK, kend - kt);
    __syncthreads();  // q_s and do_s are staged; the previous tile's reads are done
    load_tile(k_s, k, kt, n);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int r = warp + WARPS * j;
      if (r < R) {  // warp-uniform
        float s[KPL];
        float tmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const int tl = lane + 32 * c;
          const bool visible = tl < n && kt + tl <= qpos[j];
          s[c] = visible ? dot<HD>(q_s + r * HD, k_s + tl * KS) * scale : -INFINITY;
          tmax = fmaxf(tmax, s[c]);
        }
        tmax = warp_max(tmax);
        const float m_new = fmaxf(m[j], tmax);
        if (m_new != -INFINITY) {  // warp-uniform: the vector has seen a slot
          float psum = 0.f;
#pragma unroll
          for (int c = 0; c < KPL; ++c) psum += s[c] == -INFINITY ? 0.f : expf(s[c] - m_new);
          const float alpha = m[j] == -INFINITY ? 0.f : expf(m[j] - m_new);
          l[j] = l[j] * alpha + warp_sum(psum);
          m[j] = m_new;
        }
      }
    }
  }

  // L and D of each vector; a vector that sees no slot gets L = +inf, so
  // every p of it is 0
  float L[QPW], D[QPW], acc[QPW][DPL];
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int r = warp + WARPS * j;
    L[j] = INFINITY;
    D[j] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[j][e] = 0.f;
    if (r < R) {
      const size_t row = row_of(r);
      float dd = 0.f;
      for (int d = lane; d < HD; d += 32) {
        dd = fmaf(to_float(do_s[r * HD + d]), to_float(o[row * HD + d]), dd);
      }
      D[j] = warp_sum(dd);
      if (l[j] > 0.f) L[j] = m[j] + logf(l[j]);
      if (lane == 0) {
        lse[row] = L[j];
        delta[row] = D[j];
      }
    }
  }

  // sweep 2: ds of each visible (vector, slot) pair, dq = sum_t ds_t k_t
  for (int kt = 0; kt < kend; kt += BK) {
    const int n = min(BK, kend - kt);
    __syncthreads();
    load_tile(k_s, k, kt, n);
    load_tile(v_s, v, kt, n);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int r = warp + WARPS * j;
      if (r < R) {
        float ds[KPL];
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const int tl = lane + 32 * c;
          ds[c] = 0.f;
          if (tl < n && kt + tl <= qpos[j]) {
            const float p = expf(dot<HD>(q_s + r * HD, k_s + tl * KS) * scale - L[j]);
            const float dp = dot<HD>(do_s + r * HD, v_s + tl * KS);
            ds[c] = p * (dp - D[j]);
          }
        }
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const int cnt = min(32, n - 32 * c);  // warp-uniform
          for (int t = 0; t < cnt; ++t) {
            const float w = __shfl_sync(FULL, ds[c], t);
            const T* kr = k_s + (32 * c + t) * KS;
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              const int d = lane + 32 * e;
              if (d < HD) acc[j][e] = fmaf(w, to_float(kr[d]), acc[j][e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int r = warp + WARPS * j;
    if (r < R) {
      const size_t row = row_of(r);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < HD) store(dq + row * HD + d, acc[j][e] * scale);
      }
    }
  }
}

// grid (ceil(T / BKT), KV, B), after bwd_rows.  Slot kt0 + warp * KPW + i
// of the block belongs to warp `warp`; query vector u of the stream is row
// i0 + u / G of head kvh * G + u % G.  k, v, dk and dv are contiguous
// (B, KV, T, HD).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
bwd_keys(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ dout, const long long* __restrict__ pos0,
         const long long* __restrict__ valid_end, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
         int KV, int S, int T_len, float scale) {
  constexpr int DPL = (HD + 31) / 32;  // dk, dv dims per lane
  constexpr int QS = HD + Layout<T>::PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + BKT * HD;
  T* q_s = v_s + BKT * HD;
  T* do_s = q_s + QT * QS;
  float* lse_s = reinterpret_cast<float*>(do_s + QT * QS);
  float* d_s = lse_s + QT;

  const int G = H / KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int kt0 = blockIdx.x * BKT;
  const long long p0 = pos0[b];
  // slots at or past kend are visible to no row: zero gradients
  const int kend = static_cast<int>(
      max(min(valid_end[b], static_cast<long long>(T_len)), 0LL));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t head = (static_cast<size_t>(b) * KV + kvh) * T_len * HD;
  // the first row that sees slot kt0 (p0 + i >= kt0), and the vectors from there
  const int i0 = static_cast<int>(min(max(0LL, kt0 - p0), static_cast<long long>(S)));
  const int nvec = kt0 < kend ? (S - i0) * G : 0;

  for (int idx = threadIdx.x; idx < BKT * HD; idx += THREADS) {
    const int t = idx / HD;
    const int j = kt0 + t;
    if (j < kend) {
      const size_t off = head + static_cast<size_t>(j) * HD + (idx - t * HD);
      k_s[idx] = k[off];
      v_s[idx] = v[off];
    } else {
      store(k_s + idx, 0.f);
      store(v_s + idx, 0.f);
    }
  }

  float gk[KPW][DPL], gv[KPW][DPL];
#pragma unroll
  for (int i = 0; i < KPW; ++i) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) gk[i][e] = gv[i][e] = 0.f;
  }

  for (int u0 = 0; u0 < nvec; u0 += QT) {
    const int cnt = min(QT, nvec - u0);
    __syncthreads();  // k_s and v_s are staged; the previous tile's reads are done
    for (int idx = threadIdx.x; idx < cnt * HD; idx += THREADS) {
      const int u = idx / HD;
      const int d = idx - u * HD;
      const int uu = u0 + u;
      const size_t off =
          ((static_cast<size_t>(b) * H + kvh * G + uu % G) * S + i0 + uu / G) * HD + d;
      q_s[u * QS + d] = q[off];
      do_s[u * QS + d] = dout[off];
    }
    if (threadIdx.x < cnt) {
      const int uu = u0 + threadIdx.x;
      const size_t row = (static_cast<size_t>(b) * H + kvh * G + uu % G) * S + i0 + uu / G;
      lse_s[threadIdx.x] = lse[row];
      d_s[threadIdx.x] = delta[row];
    }
    __syncthreads();
    const bool mine = lane < cnt;
    const float L = mine ? lse_s[lane] : INFINITY;
    const float D = mine ? d_s[lane] : 0.f;
    const long long qpos = p0 + i0 + (u0 + lane) / G;  // the position of lane's row
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      const int ks = warp * KPW + i;
      if (kt0 + ks < kend) {  // warp-uniform
        float p = 0.f, ds = 0.f;
        if (mine && kt0 + ks <= qpos) {
          p = expf(dot<HD>(q_s + lane * QS, k_s + ks * HD) * scale - L);
          ds = p * (dot<HD>(do_s + lane * QS, v_s + ks * HD) - D);
        }
        for (int t = 0; t < cnt; ++t) {
          const float pt = __shfl_sync(FULL, p, t);
          const float st = __shfl_sync(FULL, ds, t);
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            const int d = lane + 32 * e;
            if (d < HD) {
              gv[i][e] = fmaf(pt, to_float(do_s[t * QS + d]), gv[i][e]);
              gk[i][e] = fmaf(st, to_float(q_s[t * QS + d]), gk[i][e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    const int j = kt0 + warp * KPW + i;
    if (j < T_len) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < HD) {
          const size_t off = head + static_cast<size_t>(j) * HD + d;
          store(dk + off, gk[i][e] * scale);
          store(dv + off, gv[i][e]);
        }
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* pos0, const void* valid_end, void* dq,
                       void* dk, void* dv, void* lse, void* delta, int B, int H, int KV, int S,
                       int T_len, int BQ, cudaStream_t st) {
  constexpr int BK = Layout<T>::BK;
  const size_t rows_smem = sizeof(T) * (2 * BK * (HD + Layout<T>::PAD) + 2 * QV * HD);
  const size_t keys_smem =
      sizeof(T) * (2 * BKT * HD + 2 * QT * (HD + Layout<T>::PAD)) + 2 * QT * sizeof(float);
  // above 48 KB only after opting in, once per instantiation
  static const cudaError_t opt_in = [&] {
    cudaError_t err = cudaFuncSetAttribute(bwd_rows<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(rows_smem));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(bwd_keys<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(keys_smem));
  }();
  if (opt_in != cudaSuccess) return opt_in;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const long long* p0 = static_cast<const long long*>(pos0);
  const long long* ve = static_cast<const long long*>(valid_end);
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  const dim3 grid_rows((S + BQ - 1) / BQ, KV, B);
  bwd_rows<T, HD><<<grid_rows, THREADS, rows_smem, st>>>(
      qt, kt, vt, static_cast<const T*>(o), dt, p0, ve, static_cast<T*>(dq), lse_f, delta_f,
      H, KV, S, T_len, BQ, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_keys((T_len + BKT - 1) / BKT, KV, B);
  bwd_keys<T, HD><<<grid_keys, THREADS, keys_smem, st>>>(
      qt, kt, vt, dt, p0, ve, lse_f, delta_f, static_cast<T*>(dk), static_cast<T*>(dv), H, KV,
      S, T_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* pos0, const void* valid_end, void* dq,
                     void* dk, void* dv, void* lse, void* delta, int B, int H, int KV, int S,
                     int T_len, int BQ, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, o, dout, pos0, valid_end, dq, dk, dv, lse, delta, B,
                               H, KV, S, T_len, BQ, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dout, pos0, valid_end, dq, dk, dv, lse, delta, B,
                               H, KV, S, T_len, BQ, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, pos0, valid_end, dq, dk, dv, lse, delta, B,
                                H, KV, S, T_len, BQ, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (B, H, S, hd) and k, v, dk, dv (B, KV, T, hd) contiguous,
// bf16 (is_bf16) or f32; pos0, valid_end (B,) int64 on the card; lse and
// delta (B, H, S) f32 scratch; BQ = 16 / G query rows per bwd_rows block.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* pos0, const void* valid_end,
                                   void* dq, void* dk, void* dv, void* lse, void* delta, int B,
                                   int H, int KV, int S, int T, int hd, int BQ, int is_bf16,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || T <= 0 || H % KV != 0 || H / KV > QV ||
      BQ <= 0 || BQ * (H / KV) > QV || B > 65535 || KV > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, dout, pos0, valid_end, dq, dk, dv, lse,
                                   delta, B, H, KV, S, T, BQ, st);
  }
  return dispatch<float>(hd, q, k, v, o, dout, pos0, valid_end, dq, dk, dv, lse, delta, B, H,
                         KV, S, T, BQ, st);
}
