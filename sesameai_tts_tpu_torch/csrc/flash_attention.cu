// Causal GQA flash attention over a KV cache, for Hopper (sm_90a).
//
// Replaces sesameai_tts_tpu/ops/attention.py::flash_attention (body
// _flash_kernel): out (B, H, S, hd) = softmax(q k^T / sqrt(hd)) v over the
// cache k, v (B, KV, T, hd), head h reading KV head h / G (G = H / KV).
// Query row i of batch row b sits at position pos0[b] + i and sees cache
// slot t when t <= pos0[b] + i and t < valid_end[b].  Scores, the running
// max m, the running sum l and the accumulator are f32; p = exp(s - m) is
// rounded to v's dtype before the PV product, as the TPU kernel does
// (attention.py:74), while l sums the unrounded p; the output is
// acc / max(l, 1e-30), so a row that sees no key gives 0 and not NaN.
//
// What bounds it: bytes.  Attention over the cache does 4 * hd operations
// per visible (query, key) pair and head, for 2 * 2 * hd bytes of k and v
// per visible slot shared by the G heads of a group, so even a 512-row
// prefill sits far below the ~295 operations per byte where Hopper's
// tensor cores become the limit; a decode step (S = 1) reads every
// visible slot once for G = 4 queries per KV head.
//
// What the design does about it:
//  * one block per (query tile, KV head, batch row).  It stages the tile's
//    G * BQ <= 16 query vectors in shared memory once and streams the visible
//    cache slots through shared memory one BK-row K/V tile at a time, so
//    each slot is read from device memory once per query tile and serves
//    all G heads of its group;
//  * the block reads pos0 and valid_end itself (no host sync) and visits
//    key tiles only below min(valid_end, pos0 + last row of the tile + 1):
//    the TPU kernel masks the tiles above the causal diagonal to keep its
//    program shape static; skipping them computes the same function;
//  * the K/V tiles move as 16-byte loads, the next one in flight while
//    the current one is computed;
//  * four warps; each owns up to QPW query vectors and keeps their m, l
//    and accumulator in registers.  A lane scores BK / 32 keys against a
//    query (K rows padded in shared memory so that the 32 lanes hit 32
//    banks), warp shuffles give the tile's max and sum, and in the PV
//    product each lane owns hd / 32 output dims and takes p_t of key t from
//    lane t by a shuffle;
//  * every product is f32 FMA on CUDA cores of exact bf16 (or f32) values.
// Tensor cores (mma / wgmma), TMA and split-K decoding are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

// Tile sizes by element type and head dim; the static shared memory (K
// tile, V tile, query vectors) stays under 48 KB.
template <typename T, int HD>
struct Tile {
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;  // keys per K/V tile
  // query vectors per warp; a block holds WARPS * QPW of them.  Few per
  // block give many blocks: a 64-row prefill at G = 4 still fills 128
  static constexpr int QPW = 4;
  // K row pad: an odd number of 4-byte words per row, so the lanes of a
  // warp, each reading its own key's row, hit distinct banks
  static constexpr int KPAD = sizeof(T) == 2 ? 2 : 1;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// p rounded to the element type, as the TPU kernel's p.astype(v.dtype)
__device__ __forceinline__ float round_to(float p, const float*) { return p; }
__device__ __forceinline__ float round_to(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

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
// q0 + r / G of head kvh * G + r % G.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const long long* __restrict__ pos0, const long long* __restrict__ valid_end,
          T* __restrict__ out, int H, int KV, int S, int T_len, int BQ, int q_sb, int q_sh,
          int q_ss, int o_sb, int o_sh, int o_ss, float scale) {
  using C = Tile<T, HD>;
  constexpr int BK = C::BK;
  constexpr int QPW = C::QPW;
  constexpr int KPL = BK / 32;          // keys per lane in a tile
  constexpr int DPL = (HD + 31) / 32;   // output dims per lane
  constexpr int KS = HD + C::KPAD;      // K row stride in shared memory
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int VPR = HD / VEC;         // vectors per K or V row
  constexpr int NV = BK * VPR;          // vectors per K (or V) tile
  constexpr int VPT = (NV + THREADS - 1) / THREADS;  // ... per thread
  // raw bytes: a __shared__ array of a class type (bf16) may not be declared
  __shared__ __align__(16) unsigned char
      smem[sizeof(T) * (BK * KS + BK * HD + WARPS * QPW * HD)];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + BK * KS;
  T* q_s = v_s + BK * HD;

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

  for (int idx = threadIdx.x; idx < R * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int h = kvh * G + r % G;
    q_s[idx] = q[static_cast<size_t>(b) * q_sb + static_cast<size_t>(h) * q_sh +
                 static_cast<size_t>(q0 + r / G) * q_ss + d];
  }

  float m[QPW], l[QPW], acc[QPW][DPL];
  int qpos[QPW];  // a position past the cache sees every slot below kend anyway
  const int p0c = static_cast<int>(min(p0, static_cast<long long>(T_len)));
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[j][e] = 0.f;
    qpos[j] = p0c + q0 + (warp + WARPS * j) / G;
  }

  const size_t head = (static_cast<size_t>(b) * KV + kvh) * T_len * HD;
  const T* kb = k + head;
  const T* vb = v + head;
  // A K/V tile moves as 16-byte vectors, VPT of each per thread, held in
  // registers: the next tile's loads are issued before the current tile is
  // computed, so their latency hides behind it.
  uint4 kr[VPT], vr[VPT];
  auto fetch = [&](int kt) {
    const int n = min(BK, kend - kt);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int t = idx / VPR;
      kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);  // rows past n: 0 * garbage is not NaN
      if (idx < NV && t < n) {
        const size_t off = static_cast<size_t>(kt + t) * HD + (idx - t * VPR) * VEC;
        kr[i] = __ldg(reinterpret_cast<const uint4*>(kb + off));
        vr[i] = __ldg(reinterpret_cast<const uint4*>(vb + off));
      }
    }
  };
  if (kend > 0) fetch(0);
  for (int kt = 0; kt < kend; kt += BK) {
    const int n = min(BK, kend - kt);
    __syncthreads();  // q_s is staged; the previous tile's reads are done
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < NV) {
        const int t = idx / VPR;
        const int c = (idx - t * VPR) * VEC;
        // K rows are padded (4-byte aligned, not 16): store word by word
        unsigned* kd = reinterpret_cast<unsigned*>(k_s + t * KS + c);
        kd[0] = kr[i].x;
        kd[1] = kr[i].y;
        kd[2] = kr[i].z;
        kd[3] = kr[i].w;
        *reinterpret_cast<uint4*>(v_s + t * HD + c) = vr[i];
      }
    }
    __syncthreads();
    if (kt + BK < kend) fetch(kt + BK);
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int r = warp + WARPS * j;
      if (r < R) {  // warp-uniform
        const T* qr = q_s + r * HD;
        float s[KPL];
        float tmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const int tl = lane + 32 * c;
          const bool visible = tl < n && kt + tl <= qpos[j];
          s[c] = visible ? dot<HD>(qr, k_s + tl * KS) * scale : -INFINITY;
          tmax = fmaxf(tmax, s[c]);
        }
        tmax = warp_max(tmax);
        const float m_new = fmaxf(m[j], tmax);
        // a query that has seen no key yet keeps m = -inf
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        const float alpha = isfinite(m[j]) ? expf(m[j] - m_safe) : 0.f;
        float p[KPL];
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const float e = s[c] == -INFINITY ? 0.f : expf(s[c] - m_safe);
          psum += e;
          p[c] = round_to(e, v_s);
        }
        l[j] = l[j] * alpha + warp_sum(psum);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[j][e] *= alpha;
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          const int cnt = min(32, n - 32 * c);  // warp-uniform
#pragma unroll 8
          for (int src = 0; src < cnt; ++src) {
            const float pt = __shfl_sync(FULL, p[c], src);
            const T* vr = v_s + (32 * c + src) * HD;
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              const int d = lane + 32 * e;
              if (d < HD) acc[j][e] = fmaf(pt, to_float(vr[d]), acc[j][e]);
            }
          }
        }
        m[j] = m_new;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int r = warp + WARPS * j;
    if (r < R) {
      const int h = kvh * G + r % G;
      T* o = out + static_cast<size_t>(b) * o_sb + static_cast<size_t>(h) * o_sh +
             static_cast<size_t>(q0 + r / G) * o_ss;
      const float denom = fmaxf(l[j], 1e-30f);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < HD) store(o + d, acc[j][e] / denom);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t run(const void* q, const void* k, const void* v, const void* pos0,
                const void* valid_end, void* out, int B, int H, int KV, int S, int T_len,
                int q_sb, int q_sh, int q_ss, int o_sb, int o_sh, int o_ss,
                cudaStream_t stream) {
  const int G = H / KV;
  const int per_block = WARPS * Tile<T, HD>::QPW;
  if (G > per_block) return cudaErrorInvalidValue;
  const int BQ = std::max(1, std::min(S, per_block / G));
  const dim3 grid((S + BQ - 1) / BQ, KV, B);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  flash_fwd<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const long long*>(pos0), static_cast<const long long*>(valid_end),
      static_cast<T*>(out), H, KV, S, T_len, BQ, q_sb, q_sh, q_ss, o_sb, o_sh, o_ss, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, const void* pos0,
                     const void* valid_end, void* out, int B, int H, int KV, int S, int T_len,
                     int q_sb, int q_sh, int q_ss, int o_sb, int o_sh, int o_ss,
                     cudaStream_t stream) {
  switch (hd) {
    case 16:
      return run<T, 16>(q, k, v, pos0, valid_end, out, B, H, KV, S, T_len, q_sb, q_sh, q_ss,
                        o_sb, o_sh, o_ss, stream);
    case 64:
      return run<T, 64>(q, k, v, pos0, valid_end, out, B, H, KV, S, T_len, q_sb, q_sh, q_ss,
                        o_sb, o_sh, o_ss, stream);
    case 128:
      return run<T, 128>(q, k, v, pos0, valid_end, out, B, H, KV, S, T_len, q_sb, q_sh, q_ss,
                         o_sb, o_sh, o_ss, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, S, hd) with element strides q_sb, q_sh, q_ss (the last dim
// contiguous); k, v (B, KV, T, hd) contiguous; pos0, valid_end (B,) int64
// on the card; out (B, H, S, hd) with strides o_sb, o_sh, o_ss.  bf16 or
// f32 (is_bf16), hd in {16, 64, 128}, H % KV == 0.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, const void* pos0,
                               const void* valid_end, void* out, int B, int H, int KV, int S,
                               int T, int hd, int q_sb, int q_sh, int q_ss, int o_sb,
                               int o_sh, int o_ss, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || T <= 0 || H % KV != 0 || B > 65535 ||
      KV > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(hd, q, k, v, pos0, valid_end, out, B, H, KV, S, T, q_sb,
                                   q_sh, q_ss, o_sb, o_sh, o_ss, st);
  }
  return dispatch<float>(hd, q, k, v, pos0, valid_end, out, B, H, KV, S, T, q_sb, q_sh, q_ss,
                         o_sb, o_sh, o_ss, st);
}
