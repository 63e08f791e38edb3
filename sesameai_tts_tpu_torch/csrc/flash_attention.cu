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
// Three kernels, chosen by the caller (ops/attention.py::_route) from the
// shape and the dtype, never by a failed launch.  A decode call (G * S <=
// RQ = 4 query vectors per KV head: every S = 1 step of both trunks) runs
// flash_fwd_split; a bf16 prefill at hd 64 or 128 (every prefill of the
// CSM trunks) runs flash_fwd_mma on tensor cores; any other prefill (f32,
// or hd 16: the tiny test flavor) runs flash_fwd on CUDA cores, whose f32
// products keep the f32 model's card run equal to the CPU's.
//
// flash_fwd_mma, tensor cores (prefill, bf16, hd 64 / 128).  A prefill of
// S rows over a 2048-slot cache does ~1 GFLOP in ~1 MB of K/V: tensor
// cores do that in about a microsecond, so the kernel is bound by its
// chain of latencies (the positions, one DRAM round trip per K/V tile, the
// products and the softmax of each tile), and the design keeps that chain
// short and the tensor cores fed:
//  * one block per (64 query vectors of one KV head, batch row): BQ = 64 /
//    G rows x the G heads of the group, so each K/V slot is read once per
//    64 query vectors and serves all G heads.  Four warps, each one m16
//    slice of the vectors;
//  * K/V tiles of 64 keys move through a ring of STAGES (3 at hd 64, 2 at
//    hd 128) shared-memory stages by 16-byte cp.async (rows past the
//    visible end zero-filled), so the next tiles are in flight while the
//    current one is computed; one barrier per tile.  Rows are padded by 16
//    bytes, so the 8 rows an ldmatrix reads hit distinct banks;
//  * S = Q K^T by mma.sync.m16n8k16 bf16 -> f32: Q's fragments are loaded
//    once by ldmatrix, K's by ldmatrix from the ring; the scores stay in
//    the accumulator fragments, where the online softmax runs (a row's max
//    by two quad shuffles; l summed per thread and reduced once, after the
//    keys).  p = exp(s - m) is rounded to bf16 in registers at the running
//    max, exactly the TPU kernel's p.astype(v.dtype), and is the A operand
//    of O += P V, with V's fragments by ldmatrix.trans; l sums the
//    unrounded f32 p;
//  * the block reads pos0 and valid_end itself, visits key tiles only below
//    the visible end of its last row and masks only the tiles that straddle
//    the causal diagonal or valid_end (ops/attention.py::_mma_tile_plan).
//  At S = 64 (an utterance prefill) the grid is only S / BQ x KV = 32
//  blocks, each over ~9 tiles; a tile's two products take a few hundred
//  cycles on the tensor cores, so that stays well below SDPA's time
//  without splitting the keys over a cluster, and no combine is needed.
//
// flash_fwd_split, split-K over the cache (flash decoding).  A decode step
// moves a few KB to a few hundred KB, so it is bound by its chain of
// dependent latencies (launch, the position load, one DRAM round trip for
// K and V, the reductions), not by the bytes; the design shortens that
// chain and spreads the keys over many SMs:
//  * grid (splits, KV, B) in clusters of the `splits` blocks along x, four
//    warps each.  The host does not know the visible length (pos0 and
//    valid_end stay on the card), so the wrapper fixes `splits`, a power of
//    two up to 16, from T and the SM count (ops/attention.py::
//    _decode_splits); every block reads kend on the card and each of the
//    splits * 4 warps takes an even, contiguous share of the visible keys
//    [0, kend).  A warp whose share is empty contributes m = -inf, l = 0,
//    acc = 0;
//  * q is loaded beside the positions, before anything waits on them; a
//    warp's K tile (WK consecutive cache rows) moves as coalesced 16-byte
//    loads through its padded rows of shared memory, where LPK = 32 / WK
//    lanes read back KD dims of their key each; V moves straight into
//    registers, DPL output dims of every key of the tile per lane.  The
//    next tile's K is in flight while the current one is computed;
//  * the four queries are padded to RQ and every loop over them is
//    unrolled and unguarded, so their chains (dot, max, exp) interleave;
//    each query's p goes through the warp's row of shared memory and is
//    read back as one broadcast float4 per key: no serial shuffle chain
//    per key; l is summed per lane and reduced once, after the keys;
//  * warp r combines query r over the block's four warps in shared memory;
//    then a reduce-scatter over the cluster: each block leaves its (m, l)
//    in every block and its acc of each output in the output's owner block
//    (distributed shared memory), one cluster barrier, and the owner
//    combines its outputs over the blocks by butterflies over `splits`
//    lanes.  Every order is fixed: no workspace, no atomics,
//    bit-deterministic, graph-safe.
//  Rounding: each warp rounds exp(s - m_j) to v's dtype at its own running
//  max m_j before the PV product, as the TPU kernel does at its own, and l
//  sums the unrounded values.  The combines multiply by exp(m_j - m) in
//  f32, so every weight still moves by at most 2^-9 of itself (plus f32
//  rounding), and the outputs, convex combinations of v's rows, stay
//  within 2^-8 max|v| of the plain version's (chip_smoke.py's tolerance).
//  A row that sees no key has m = -inf in every warp: l = acc = 0 and the
//  output acc / max(l, 1e-30) is exactly 0.
//
// flash_fwd, one block per query tile (f32 or hd-16 prefill):
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

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

// -- tensor-core prefill ---------------------------------------------------

// the kernel a call runs (ops/attention.py::_ROUTES)
constexpr int ROUTE_FMA = 0;    // flash_fwd
constexpr int ROUTE_MMA = 1;    // flash_fwd_mma
constexpr int ROUTE_SPLIT = 2;  // flash_fwd_split

constexpr int MMA_VECS = 64;  // query vectors of a flash_fwd_mma block: 4 warps x m16
constexpr int MMA_BK = 64;    // keys per K/V tile
static_assert(MMA_VECS == 16 * WARPS, "each warp owns one m16 slice of the vectors");

template <int HD>
struct Mma {
  static constexpr int STAGES = HD == 64 ? 3 : 2;  // K/V tiles in the ring
  static constexpr int RS = HD + 8;                // row stride in shared memory, elements
  static constexpr int CH = HD / 8;                // 16-byte chunks of a row
  static constexpr int SMEM = (MMA_VECS + 2 * STAGES * MMA_BK) * RS * 2;  // bytes
};

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
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

// grid (ceil(S / BQ), KV, B), BQ = MMA_VECS / G.  Query vector r of the
// block is row q0 + r / G of head kvh * G + r % G; vectors past the tile's
// last row are zero and dropped.  Warp w owns vectors [16w, 16w + 16): in
// the mma fragments, lane (g = lane / 4, t = lane % 4) holds rows g and
// g + 8 of that slice and, of each 8-key score tile, keys 2t and 2t + 1.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const long long* __restrict__ pos0,
              const long long* __restrict__ valid_end, __nv_bfloat16* __restrict__ out, int H,
              int KV, int S, int T_len, int BQ, int q_sb, int q_sh, int q_ss, int o_sb, int o_sh,
              int o_ss, float scale) {
  using C = Mma<HD>;
  constexpr int RS = C::RS;
  constexpr int CH = C::CH;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [MMA_VECS][RS]
  __nv_bfloat16* k_s = q_s + MMA_VECS * RS;                      // [STAGES][MMA_BK][RS]
  __nv_bfloat16* v_s = k_s + STAGES * MMA_BK * RS;               // [STAGES][MMA_BK][RS]

  const int G = H / KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int R = min(BQ, S - q0) * G;  // the tile's real query vectors
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p0 = pos0[b];
  const long long ve = valid_end[b];
  // slots below lim(r) are visible to vector r (a padding vector takes the
  // last real one's); lim is nondecreasing in r
  auto lim = [&](int r) {
    const long long e = min(min(ve, p0 + q0 + min(r, R - 1) / G + 1), static_cast<long long>(T_len));
    return static_cast<int>(max(e, 0LL));
  };
  const int kend = lim(MMA_VECS - 1);  // tiles at or above it are skipped
  const int full = lim(0);             // tiles below it are seen whole by every vector
  const int nt = (kend + MMA_BK - 1) / MMA_BK;

  const size_t head = (static_cast<size_t>(b) * KV + kvh) * T_len * HD;
  const __nv_bfloat16* kb = k + head;
  const __nv_bfloat16* vb = v + head;
  auto load_tile = [&](int tile) {
    const int kt = tile * MMA_BK;
    const int stage = tile % STAGES;
    for (int i = threadIdx.x; i < MMA_BK * CH; i += THREADS) {
      const int row = i / CH;
      const int c = i % CH;
      const bool ok = kt + row < kend;
      const size_t off = static_cast<size_t>(ok ? kt + row : 0) * HD + c * 8;
      const int dst = (stage * MMA_BK + row) * RS + c * 8;
      cp_async16(smem_u32(k_s + dst), kb + off, ok);
      cp_async16(smem_u32(v_s + dst), vb + off, ok);
    }
  };
  // groups: q, then one per tile (empty past the last), so that before
  // tile i is computed at most STAGES - 2 younger groups may be in flight
  for (int i = threadIdx.x; i < MMA_VECS * CH; i += THREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const bool ok = r < R;
    const __nv_bfloat16* src = q;
    if (ok) {
      src += static_cast<size_t>(b) * q_sb + static_cast<size_t>(kvh * G + r % G) * q_sh +
             static_cast<size_t>(q0 + r / G) * q_ss + c * 8;
    }
    cp_async16(smem_u32(q_s + r * RS + c * 8), src, ok);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load_tile(s);
    cp_async_commit();
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const int lim0 = lim(warp * 16 + g);
  const int lim1 = lim(warp * 16 + g + 8);
  // ldmatrix row and column of this lane: matrix lane / 8 of an x4 load
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;

  cp_async_wait<STAGES - 1>();  // q has arrived (the tiles may still fly)
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    ldsm_x4(qf[kk], smem_u32(q_s + (warp * 16 + lrow) * RS + kk * 16 + lcol));
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 2>();  // tile i has arrived, for this thread's copies
    __syncthreads();              // ... for every thread's; tile i - 1 is consumed
    if (i + STAGES - 1 < nt) load_tile(i + STAGES - 1);
    cp_async_commit();
    const int kt = i * MMA_BK;
    const __nv_bfloat16* ks = k_s + (i % STAGES) * MMA_BK * RS;
    const __nv_bfloat16* vs = v_s + (i % STAGES) * MMA_BK * RS;

    // S = Q K^T: n-tile j holds keys kt + 8j .. kt + 8j + 7
    float s[MMA_BK / 8][4];
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < HD / 32; ++kp) {
        uint32_t kf[4];  // keys 8j.. x dims 32kp + 8 * (0, 1, 2, 3)
        ldsm_x4(kf, smem_u32(ks + (8 * j + (lane & 7)) * RS + kp * 32 + (lane >> 3) * 8));
        mma_bf16(s[j], qf[2 * kp], kf[0], kf[1]);
        mma_bf16(s[j], qf[2 * kp + 1], kf[2], kf[3]);
      }
    }

    // scale, mask (only a tile that straddles a vector's visible end), max
    const bool masked = kt + MMA_BK > full;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt + 8 * j + 2 * t + e;
        s[j][e] *= scale;
        s[j][2 + e] *= scale;
        if (masked) {
          if (key >= lim0) s[j][e] = -INFINITY;
          if (key >= lim1) s[j][2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float n0 = fmaxf(m0, mx0);
    const float n1 = fmaxf(m1, mx1);
    // a row that has seen no key yet keeps m = -inf; its p are exp(-inf) = 0
    const float safe0 = isfinite(n0) ? n0 : 0.f;
    const float safe1 = isfinite(n1) ? n1 : 0.f;
    const float alpha0 = isfinite(m0) ? expf(m0 - safe0) : 0.f;
    const float alpha1 = isfinite(m1) ? expf(m1 - safe1) : 0.f;
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < MMA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - safe0);
        s[j][2 + e] = expf(s[j][2 + e] - safe1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V, P rounded to bf16: 16 keys per step, 16 dims per ldmatrix
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];  // keys 16kk + (0-7, 8-15) x dims 16dp + (0-7, 8-15)
        ldsm_x4_trans(vf, smem_u32(vs + (16 * kk + lrow) * RS + dp * 16 + lcol));
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // l over the quad, then acc / max(l, 1e-30): exactly 0 for a row that saw no key
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + 8 * half;
    if (r < R) {
      __nv_bfloat16* op = out + static_cast<size_t>(b) * o_sb +
                          static_cast<size_t>(kvh * G + r % G) * o_sh +
                          static_cast<size_t>(q0 + r / G) * o_ss;
      const float denom = fmaxf(half ? l1 : l0, 1e-30f);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(op + 8 * n + 2 * t) =
            pack_bf16(o[n][2 * half] / denom, o[n][2 * half + 1] / denom);
      }
    }
  }
}

// -- split-K decode --------------------------------------------------------

constexpr int RQ = 4;           // query vectors (G * S, padded) of a flash_fwd_split block
constexpr int MAX_SPLITS = 16;  // blocks of a cluster (a power of two; non-portable above 8)
static_assert(RQ == WARPS, "warp r combines query r of the block's warps");

template <typename T, int HD>
struct Split {
  static constexpr int ELEM = static_cast<int>(sizeof(T));
  // keys per warp tile: the tile's K and V are 8 KB of registers per warp
  static constexpr int WK = 8192 / (2 * HD * ELEM) < 32 ? 8192 / (2 * HD * ELEM) : 32;
  static constexpr int LPK = 32 / WK;           // lanes per key in the scores
  static constexpr int KD = HD / LPK;           // dims of a key one lane scores
  static constexpr int K16 = KD * ELEM / 16;    // ... as 16-byte vectors
  static constexpr int ROW16 = HD * ELEM / 16;  // 16-byte vectors of a K row
  static constexpr int KROW = HD * ELEM + 16;   // a K row in shared memory, padded
  static constexpr int DPL = (HD + 31) / 32;    // output dims per lane
};

// N elements of a row, moved as one vector
template <typename T, int N>
struct alignas(N * sizeof(T)) Pack {
  T v[N];
};


template <int N>
__device__ __forceinline__ float dot_q(const float* a, const float* qv) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < N; ++d) s[d % 4] = fmaf(a[d], qv[d], s[d % 4]);
  return (s[0] + s[1]) + (s[2] + s[3]);
}

template <int N>
__device__ __forceinline__ float dot_q(const __nv_bfloat16* a, const float* qv) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float2 x = __bfloat1622float2(a2[j]);
    s[(2 * j) % 4] = fmaf(x.x, qv[2 * j], s[(2 * j) % 4]);
    s[(2 * j + 1) % 4] = fmaf(x.y, qv[2 * j + 1], s[(2 * j + 1) % 4]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// The output row of query r: head kvh * G + r % G, row r / G.
__device__ __forceinline__ size_t out_row(int r, int b, int kvh, int G, int o_sb, int o_sh,
                                          int o_ss) {
  return static_cast<size_t>(b) * o_sb + static_cast<size_t>(kvh * G + r % G) * o_sh +
         static_cast<size_t>(r / G) * o_ss;
}

// grid (splits, KV, B), clusters of the `splits` blocks along x.  Query
// vector r < R = G * S of the block is row r / G of head kvh * G + r % G;
// vectors R..RQ-1 are zero padding whose results are dropped.  Every loop
// over queries is unrolled and unguarded, so the four queries' dependent
// chains (dot, max, exp) interleave: a decode step is bound by latency.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const long long* __restrict__ pos0, const long long* __restrict__ valid_end,
                T* __restrict__ out, int H, int KV, int S, int T_len, int q_sb, int q_sh,
                int q_ss, int o_sb, int o_sh, int o_ss, float scale) {
  using C = Split<T, HD>;
  constexpr int WK = C::WK;
  constexpr int LPK = C::LPK;
  constexpr int KD = C::KD;
  constexpr int K16 = C::K16;
  constexpr int DPL = C::DPL;
  constexpr int ROW16 = C::ROW16;
  constexpr int KROW = C::KROW;
  __shared__ __align__(16) float q_s[RQ][HD];
  __shared__ __align__(16) unsigned char k_s[WARPS][WK * KROW];
  __shared__ __align__(16) float p_s[WARPS][WK][RQ];
  __shared__ float w_m[WARPS][RQ], w_l[WARPS][RQ];
  __shared__ __align__(16) float w_acc[WARPS][RQ][HD];
  // what the cluster's blocks leave here: their (m, l) of every query and
  // their acc of the RQ * HD / splits outputs this block finishes
  __shared__ float m_in[MAX_SPLITS][RQ], l_in[MAX_SPLITS][RQ];
  __shared__ __align__(16) float a_in[RQ * HD];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = H / KV;
  const int R = G * S;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // q first: its loads need no position, so they fly beside pos0's
  float qv[RQ];  // dim threadIdx.x of each query
  int row_of[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    row_of[r] = r / G;
    qv[r] = r < R && threadIdx.x < HD
                ? to_float(q[static_cast<size_t>(b) * q_sb +
                             static_cast<size_t>(kvh * G + r - row_of[r] * G) * q_sh +
                             static_cast<size_t>(row_of[r]) * q_ss + threadIdx.x])
                : 0.f;
  }
  const long long p0 = pos0[b];
  const long long ve = valid_end[b];
  // slots below kend are visible to some row; the splits * WARPS warps
  // take even, contiguous shares of them
  const long long kend_ll = min(min(ve, p0 + S), static_cast<long long>(T_len));
  const int kend = static_cast<int>(max(kend_ll, 0LL));
  const int workers = splits * WARPS;
  const int chunk = (kend + workers - 1) / workers;
  const int lo = min(kend, (rank * WARPS + warp) * chunk);
  const int hi = min(kend, lo + chunk);
  const int p0c = static_cast<int>(min(p0, static_cast<long long>(T_len)));

  const size_t head = (static_cast<size_t>(b) * KV + kvh) * T_len * HD;
  const T* kb = k + head;
  const T* vb = v + head;
  const int key = lane / LPK;   // the tile's key this lane scores
  const int part = lane % LPK;  // ... over dims [part * KD, +KD)
  const int d0 = lane * DPL;    // the first output dim this lane owns
  const bool owns = d0 < HD;

  // A warp's K tile is WK consecutive cache rows: it moves as coalesced
  // 16-byte loads (kg), is staged in the warp's padded rows of k_s, and
  // each lane reads back the KD dims of its key it scores (kr).
  uint4 kg[K16], kr[K16];
  Pack<T, DPL> vr[WK];
  auto fetch_k = [&](int kt) {
#pragma unroll
    for (int i = 0; i < K16; ++i) {
      const int idx = i * 32 + lane;
      kg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kt + idx / ROW16 < hi) {
        kg[i] = __ldg(reinterpret_cast<const uint4*>(kb + static_cast<size_t>(kt) * HD) + idx);
      }
    }
  };
  auto stage_k = [&]() {
#pragma unroll
    for (int i = 0; i < K16; ++i) {
      const int idx = i * 32 + lane;
      *reinterpret_cast<uint4*>(&k_s[warp][(idx / ROW16) * KROW + (idx % ROW16) * 16]) = kg[i];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < K16; ++i) {
      kr[i] = *reinterpret_cast<const uint4*>(&k_s[warp][key * KROW + part * KD * C::ELEM + 16 * i]);
    }
  };
  auto fetch_v = [&](int kt) {
#pragma unroll
    for (int j = 0; j < WK; ++j) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) store(&vr[j].v[e], 0.f);  // 0 * garbage is not NaN
      if (owns && kt + j < hi) {
        vr[j] = *reinterpret_cast<const Pack<T, DPL>*>(vb + static_cast<size_t>(kt + j) * HD + d0);
      }
    }
  };
  int last[RQ];  // the last position query r sees
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    last[r] = p0c + row_of[r];
    if (threadIdx.x < HD) q_s[r][threadIdx.x] = qv[r];
  }
  __syncthreads();  // before the K and V loads, which would hold the stores back
  if (lo < hi) {
    fetch_k(lo);
    fetch_v(lo);
  }

  // m is the warp's running max; l sums, per lane, the unrounded p of the
  // keys this lane scores (reduced over the warp once, after the loop)
  float m[RQ], l[RQ], acc[RQ][DPL];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  for (int kt = lo; kt < hi; kt += WK) {
    stage_k();
    if (kt + WK < hi) fetch_k(kt + WK);  // in flight through the softmax and PV
    const T* kvals = reinterpret_cast<const T*>(kr);
    float s[RQ], tmax[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) s[r] = dot_q<KD>(kvals, &q_s[r][part * KD]);
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < RQ; ++r) s[r] += __shfl_xor_sync(FULL, s[r], o);
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const bool visible = kt + key < hi && kt + key <= last[r];
      s[r] = visible ? s[r] * scale : -INFINITY;
      tmax[r] = s[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < RQ; ++r) tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(FULL, tmax[r], o));
    }
    float p[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const float m_new = fmaxf(m[r], tmax[r]);
      // a query that has seen no key yet keeps m = -inf
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[r]) ? expf(m[r] - m_safe) : 0.f;
      const float e = s[r] == -INFINITY ? 0.f : expf(s[r] - m_safe);
      l[r] = l[r] * alpha + (part == 0 ? e : 0.f);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= alpha;
      p[r] = round_to(e, vb);
      m[r] = m_new;
    }
    if (part == 0) *reinterpret_cast<float4*>(&p_s[warp][key][0]) = make_float4(p[0], p[1], p[2], p[3]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < WK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(&p_s[warp][j][0]);
      const float pr[RQ] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const float vf = to_float(vr[j].v[e]);
#pragma unroll
        for (int r = 0; r < RQ; ++r) acc[r][e] = fmaf(pr[r], vf, acc[r][e]);
      }
    }
    __syncwarp();  // p_s and k_s are read before the next tile writes them
    if (kt + WK < hi) fetch_v(kt + WK);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < RQ; ++r) l[r] += __shfl_xor_sync(FULL, l[r], o);
  }

  // the block's warps: warp r combines query r, in warp order; a warp that
  // saw no key (m = -inf) adds 0
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      w_m[warp][r] = m[r];
      w_l[warp][r] = l[r];
    }
  }
  if (owns) {
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      Pack<float, DPL> a;
#pragma unroll
      for (int e = 0; e < DPL; ++e) a.v[e] = acc[r][e];
      *reinterpret_cast<Pack<float, DPL>*>(&w_acc[warp][r][d0]) = a;
    }
  }
  __syncthreads();
  const int r = warp;
  float mb = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, w_m[w][r]);
  float lb = 0.f;
  float ab[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) ab[e] = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float mw = w_m[w][r];
    const float f = mw == -INFINITY ? 0.f : expf(mw - mb);
    lb += w_l[w][r] * f;
    if (owns) {
      const Pack<float, DPL> a = *reinterpret_cast<const Pack<float, DPL>*>(&w_acc[w][r][d0]);
#pragma unroll
      for (int e = 0; e < DPL; ++e) ab[e] += a.v[e] * f;
    }
  }
  if (splits == 1) {
    if (r < R && owns) {
      Pack<T, DPL> o;
#pragma unroll
      for (int e = 0; e < DPL; ++e) store(&o.v[e], ab[e] / fmaxf(lb, 1e-30f));
      *reinterpret_cast<Pack<T, DPL>*>(out + out_row(r, b, kvh, G, o_sb, o_sh, o_ss) + d0) = o;
    }
    return;
  }

  // Reduce-scatter over the cluster: block `owner` finishes the outputs
  // [owner * per, +per) of the RQ x HD grid.  Every block leaves its (m, l)
  // of query r in every block and its acc of each output in the output's
  // owner; then one cluster barrier, and nothing is read remotely after it.
  const int per_shift = __ffs(RQ * HD / splits) - 1;  // splits is a power of two
  const int per = 1 << per_shift;
  if (owns) {
    const int i = r * HD + d0;
    const int owner = i >> per_shift;
    Pack<float, DPL> a;
#pragma unroll
    for (int e = 0; e < DPL; ++e) a.v[e] = ab[e];
    *reinterpret_cast<Pack<float, DPL>*>(
        cluster.map_shared_rank(&a_in[rank * per + (i & (per - 1))], owner)) = a;
  }
  if (lane < splits) {
    *cluster.map_shared_rank(&m_in[rank][r], lane) = mb;
    *cluster.map_shared_rank(&l_in[rank][r], lane) = lb;
  }
  cluster.sync();

  // this block's outputs: per / DPL groups of DPL dims, a thread for each
  // (group, source block); the sources' max, weights and sums are taken by
  // butterflies over the `splits` neighbouring lanes of a group, the same
  // order on every call
  const int src = static_cast<int>(threadIdx.x) & (splits - 1);
  const int t0 = (static_cast<int>(threadIdx.x) / splits) * DPL;
  if (t0 < per) {  // whole groups of `splits` lanes
    const int i = rank * per + t0;
    const int rq = i / HD;
    const float mj = m_in[src][rq];
    float mt = mj;
    for (int o = 1; o < splits; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o, splits));
    const float f = mj == -INFINITY ? 0.f : expf(mj - mt);
    const Pack<float, DPL> a = *reinterpret_cast<const Pack<float, DPL>*>(&a_in[src * per + t0]);
    float lt = l_in[src][rq] * f;
    float at[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) at[e] = a.v[e] * f;
    for (int o = 1; o < splits; o <<= 1) {
      lt += __shfl_xor_sync(FULL, lt, o, splits);
#pragma unroll
      for (int e = 0; e < DPL; ++e) at[e] += __shfl_xor_sync(FULL, at[e], o, splits);
    }
    if (src == 0 && rq < R) {
      Pack<T, DPL> o;
#pragma unroll
      for (int e = 0; e < DPL; ++e) store(&o.v[e], at[e] / fmaxf(lt, 1e-30f));
      *reinterpret_cast<Pack<T, DPL>*>(out + out_row(rq, b, kvh, G, o_sb, o_sh, o_ss) + i % HD) = o;
    }
  }
}

template <typename T, int HD>
cudaError_t run(const void* q, const void* k, const void* v, const void* pos0,
                const void* valid_end, void* out, int B, int H, int KV, int S, int T_len,
                int q_sb, int q_sh, int q_ss, int o_sb, int o_sh, int o_ss, int route, int splits,
                cudaStream_t stream) {
  const int G = H / KV;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  if (route == ROUTE_SPLIT) {
    if (G * S > RQ || splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) != 0 ||
        RQ * HD / splits < Split<T, HD>::DPL) {
      return cudaErrorInvalidValue;
    }
    auto kernel = flash_fwd_split<T, HD>;
    // clusters above 8 blocks must be allowed first; set once per
    // instantiation (on its first call, before any graph capture)
    static bool non_portable = false;
    if (splits > 8 && !non_portable) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      non_portable = true;
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(splits, KV, B);
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
        &config, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const long long*>(pos0),
        static_cast<const long long*>(valid_end), static_cast<T*>(out), H, KV, S, T_len, q_sb,
        q_sh, q_ss, o_sb, o_sh, o_ss, scale);
    const cudaError_t last = cudaGetLastError();  // read and clear
    return err != cudaSuccess ? err : last;
  }
  if (route == ROUTE_MMA) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value && HD >= 64) {
      if (G > MMA_VECS) return cudaErrorInvalidValue;
      auto kernel = flash_fwd_mma<HD>;
      // more than 48 KB of shared memory must be allowed first; set once
      // per instantiation (on its first call, before any graph capture)
      static bool smem_allowed = false;
      if (!smem_allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Mma<HD>::SMEM);
        if (err != cudaSuccess) return err;
        smem_allowed = true;
      }
      const int BQ = MMA_VECS / G;
      const dim3 grid((S + BQ - 1) / BQ, KV, B);
      kernel<<<grid, THREADS, Mma<HD>::SMEM, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<const long long*>(pos0),
          static_cast<const long long*>(valid_end), static_cast<__nv_bfloat16*>(out), H, KV, S,
          T_len, BQ, q_sb, q_sh, q_ss, o_sb, o_sh, o_ss, scale);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;  // bf16 at hd 64 / 128 only
  }
  if (route != ROUTE_FMA) return cudaErrorInvalidValue;
  const int per_block = WARPS * Tile<T, HD>::QPW;
  if (G > per_block) return cudaErrorInvalidValue;
  const int BQ = std::max(1, std::min(S, per_block / G));
  const dim3 grid((S + BQ - 1) / BQ, KV, B);
  flash_fwd<T, HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const long long*>(pos0), static_cast<const long long*>(valid_end),
      static_cast<T*>(out), H, KV, S, T_len, BQ, q_sb, q_sh, q_ss, o_sb, o_sh, o_ss, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, const void* pos0,
                     const void* valid_end, void* out, int B, int H, int KV, int S, int T_len,
                     int q_sb, int q_sh, int q_ss, int o_sb, int o_sh, int o_ss, int route,
                     int splits, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return run<T, 16>(q, k, v, pos0, valid_end, out, B, H, KV, S, T_len, q_sb, q_sh, q_ss,
                        o_sb, o_sh, o_ss, route, splits, stream);
    case 64:
      return run<T, 64>(q, k, v, pos0, valid_end, out, B, H, KV, S, T_len, q_sb, q_sh, q_ss,
                        o_sb, o_sh, o_ss, route, splits, stream);
    case 128:
      return run<T, 128>(q, k, v, pos0, valid_end, out, B, H, KV, S, T_len, q_sb, q_sh, q_ss,
                         o_sb, o_sh, o_ss, route, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, S, hd) with element strides q_sb, q_sh, q_ss (the last dim
// contiguous); k, v (B, KV, T, hd) contiguous; pos0, valid_end (B,) int64
// on the card; out (B, H, S, hd) with strides o_sb, o_sh, o_ss.  bf16 or
// f32 (is_bf16), hd in {16, 64, 128}, H % KV == 0.  route: 0 runs the
// CUDA-core prefill kernel; 1 the tensor-core prefill kernel (bf16, hd 64
// or 128; q 16-byte aligned with strides that are multiples of 8); 2 the
// split-K decode kernel with clusters of `splits` blocks (a power of two
// up to 16, and H / KV * S <= 4).  Launches on `stream` and returns the
// launch's error (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, const void* pos0,
                               const void* valid_end, void* out, int B, int H, int KV, int S,
                               int T, int hd, int q_sb, int q_sh, int q_ss, int o_sb,
                               int o_sh, int o_ss, int route, int splits, int is_bf16,
                               void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || T <= 0 || H % KV != 0 || B > 65535 ||
      KV > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(hd, q, k, v, pos0, valid_end, out, B, H, KV, S, T, q_sb,
                                   q_sh, q_ss, o_sb, o_sh, o_ss, route, splits, st);
  }
  return dispatch<float>(hd, q, k, v, pos0, valid_end, out, B, H, KV, S, T, q_sb, q_sh, q_ss,
                         o_sb, o_sh, o_ss, route, splits, st);
}
