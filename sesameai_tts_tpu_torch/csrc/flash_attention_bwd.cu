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
// Every sum is f32 and each result is rounded to the operands' dtype once.
// A row that sees no slot gets exactly zero gradients.
//
// The structure is FlashAttention-2's deterministic backward: two kernels
// on the caller's stream, both recomputing P from a log-sum-exp, neither
// writing another block's output (no atomics), so a call is bit-equal to
// the next and a resumed LoRA run equals an unbroken one.
//  * bwd_dq_*, one block per (query tile, KV head, batch row): the tile is
//    VECS = 64 query vectors, BQ = 64 / G rows x all G heads, as the
//    forward's prefill (ops/attention.py::_mma_tile_plan).  A first sweep
//    over the visible key tiles gives each vector's LSE (an online max and
//    sum of S = Q K^T); the prologue gives D = rowsum(dO o O).  A second
//    sweep computes P = exp(S * scale - LSE), dP = dO V^T, dS = P o (dP - D)
//    and dQ += dS K.  It writes dQ once, and LSE and D into the workspace.
//  * bwd_dkdv_*, after it, one cluster of `splits` blocks per (64-key
//    tile, KV head, batch row): dK and dV stay in f32 registers while the
//    cluster walks the query tiles from the one holding the first row that
//    sees its first key (the causal skip) to the last, block r taking
//    tiles r, r + splits, ..., recomputing S^T and P^T from the saved LSE,
//    then dV += P^T dO, dP^T = V dO^T, dS^T and dK += dS^T Q.  The blocks
//    sum their partials in rank order through distributed shared memory
//    (cluster_combine); then dK is scaled once, each result rounded once
//    and written once.  Slots at or past valid_end get zeros.  A small grid
//    (main[train]'s 256-row step, one tp 2 rank's heads, the decoder) is
//    as slow as its longest walk, so the wrapper (ops/attention.py::
//    _bwd_splits) doubles `splits` while the grid stays within one block
//    an SM.
//  Both visit exactly the (query tile, key tile) pairs with a visible
//  (row, key) pair, and only the pairs that cross the causal diagonal,
//  valid_end or the cache's end apply the mask (ops/attention.py::
//  _bwd_tile_plan).  Query tiles are handed out heaviest first.
//
// What bounds it: operations.  The backward does 10 * hd operations per
// visible (query, key) pair and head (five products) for the bytes of the
// forward plus three gradients, so at the training shapes it sits at or
// above the ridge in bf16 and far above it in f32.  The design recomputes
// S three times and dP twice (16 * hd operations per pair in products), and
// in bf16 pays two more products for precision (below), so the products
// run at 22 * hd (bf16) or 16 * hd (f32) operations per pair: within 2.2x
// (bf16) and 1.6x (f32) of the bound's count.  What separates the kernels
// from the bound is the rate each route gets from its units:
//
// bf16 (route "mma", every hd): tensor cores.  Q, K, V and dO tiles move
// through rings of shared-memory stages (3 at hd <= 64, 2 at hd 128) by
// 16-byte cp.async, rows padded by 16 bytes so the 8 rows an ldmatrix reads
// hit distinct banks; fragments come from ldmatrix (.trans for the B
// operands of dQ, dK and dV).  Every product is mma.sync.m16n8k16 bf16 ->
// f32.  Each warp owns an m16 slice: 16 query vectors (dq) or 16 keys
// (dkdv).  P and dS pass from the accumulator layout to A fragments in
// registers.  A single bf16 rounding of P and dS there moves the gradients
// past the gate of chip_smoke.py (1e-2 relative + 1e-3 of the peak: each
// term's 2^-9 error adds up over the keys), so P and dS are carried as a
// hi + lo pair of bf16 fragments, x = hi + lo to 2^-16 of x, at two mma a
// product (ops/attention.py::flash_attention_bwd_mma_plain is this
// arithmetic in torch ops).  The rate of mma.sync, the exp2 of every score
// (three a pair, on the SFU) and the latency of each block's chain of tiles
// bound it; wgmma with a TMA producer warp is the next step.
//
// f32 (route "simt", every hd): CUDA cores in exact f32 (no TF32: the f32
// gate is 1e-4 relative).  256 threads; each computes a 4 x 4 micro-tile
// (4 query vectors x 4 keys) of the 64 x 64 scores from float4 loads
// along the head dim (8 FMAs a load), and a 4 x 4 micro-tile of each
// gradient product (4 vectors or keys x 4 dims, float4 loads along the
// keys or vectors of the dS / P tile and along the dims: 8 FMAs a load),
// against one FMA a load before.  Q, K, V and dO tiles are staged by
// cp.async in two stages.  A quarter-warp reads one Q or dO row at one
// chunk (a broadcast) or along 8 chunks, and 8 K or V rows at one chunk,
// so K and V rows are padded by 16 bytes and Q and dO rows are not; the dS
// / P tile has rows of 80 floats so the 4 x 4 stores of two rows land on
// distinct banks.  A tile's key rows past the cache's visible end are left
// out of the products.  The FMA rate of the SMs (one ~120 KB block each
// at hd 64) bounds it.
//
// hd 16 (the tiny flavors) runs through the same templates: an mma depth of
// 16 in bf16, micro-tiles in f32 (there with a quarter of the threads in
// the gradient products).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr unsigned FULL = 0xffffffffu;
constexpr int VECS = 64;           // query vectors of a query tile: BQ = VECS / G rows x G heads
constexpr int BK = 64;             // keys of a key tile
constexpr int MMA_THREADS = 128;   // 4 warps, each an m16 slice of the vectors (dq) or keys (dkdv)
constexpr int SIMT_THREADS = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each of a 64 x 64 tile
constexpr int MAX_SPLITS = 8;      // blocks of a dkdv cluster (a power of two, portable)
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const long long* pos0;
  const long long* valid_end;
  T* dq;
  T* dk;
  T* dv;
  // (B, H, S): log2 of each query vector's sum of 2^(s * sl2) over its
  // visible slots (+inf when it sees none), and D = rowsum(dO o O)
  float* lse;
  float* delta;
  int H, KV, S, T_len, BQ;
  int splits;  // blocks of a dkdv cluster, sharing one key tile's walk
  int q_sb, q_sh, q_ss, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss;
  float scale;
  float sl2;  // scale * log2(e): exp(s * scale) = 2^(s * sl2)
};

// slots below vis_end(row) are visible to query row `row` of a batch row
__device__ __forceinline__ int vis_end(long long p0, long long ve, long long row, int T_len) {
  const long long e = min(min(ve, p0 + row + 1), static_cast<long long>(T_len));
  return static_cast<int>(max(e, 0LL));
}

// The element offset of query vector r of a tile at row q0 (row q0 + r / G
// of head kvh * G + r % G) in a (B, H, S, hd) tensor of strides sb, sh, ss.
__device__ __forceinline__ size_t vec_off(int b, int kvh, int G, int q0, int r, int sb, int sh,
                                          int ss) {
  return static_cast<size_t>(b) * sb + static_cast<size_t>(kvh * G + r % G) * sh +
         static_cast<size_t>(q0 + r / G) * ss;
}

// ... and its index in the (B, H, S) workspace
__device__ __forceinline__ size_t stat_idx(int b, int H, int S, int kvh, int G, int q0, int r) {
  return (static_cast<size_t>(b) * H + kvh * G + r % G) * S + q0 + r / G;
}

// The query tiles of key tile kt's walk: those holding a row that sees key
// kt, when kt is visible, from the first such tile to the last.  Rank r of
// the key tile's cluster of `splits` blocks takes tiles r, r + splits, ...
// of it: -> (the walk's first tile, its length).
__device__ __forceinline__ int2 dkdv_tiles(long long p0, int klim, int kt, int S, int BQ) {
  const int nq = (S + BQ - 1) / BQ;
  const long long i0 = max(0LL, static_cast<long long>(kt) - p0);  // the first row that sees kt
  if (kt >= klim || i0 >= S) return make_int2(nq, 0);
  const int first = static_cast<int>(i0 / BQ);
  return make_int2(first, nq - first);
}

__device__ __forceinline__ int rank_share(int n, int rank, int splits) {  // of n tiles
  return n > rank ? (n - rank + splits - 1) / splits : 0;
}

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(bf16* dst, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

// The dkdv cluster's combine.  Each block has left its unscaled dK and its
// dV partials (the sums over its share of the walk) in red, f32 [2][BK][HD]
// of its shared memory; block r sums keys [r BK / splits, (r + 1) BK /
// splits) over the blocks in rank order (distributed shared memory),
// scales dK, rounds once and writes.  No order depends on timing.
template <typename T, int HD, int THREADS>
__device__ void cluster_combine(const float* red, const Args<T>& a, size_t head, int kt) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partials are in place
  const int splits = a.splits;
  const int per = BK / splits;
  const int k0 = static_cast<int>(cluster.block_rank()) * per;
  for (int i = threadIdx.x; i < 2 * per * (HD / 4); i += THREADS) {
    const int which = i / (per * (HD / 4));  // 0: dK, 1: dV
    const int key = k0 + (i / (HD / 4)) % per;
    const int off = (which * BK + key) * HD + 4 * (i % (HD / 4));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(const_cast<float*>(red) + off, r));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (kt + key < a.T_len) {
      const float sc = which ? 1.f : a.scale;
      store4((which ? a.dv : a.dk) + head + static_cast<size_t>(kt + key) * HD +
                 4 * (i % (HD / 4)),
             make_float4(sum.x * sc, sum.y * sc, sum.z * sc, sum.w * sc));
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// one step of an online softmax in base 2: the running max m and sum l of a
// row take a tile whose max is mx; -> the offset its exps are taken at
__device__ __forceinline__ float online_step(float& m, float& l, float mx) {
  const float n = fmaxf(m, mx);
  // a row that has seen no key yet keeps m = -inf; its exps are 2^-inf = 0
  const float safe = isfinite(n) ? n : 0.f;
  l *= isfinite(m) ? exp2f(m - safe) : 0.f;
  m = n;
  return safe;
}

__device__ __forceinline__ float lse_of(float m, float l) {
  return l > 0.f ? m + log2f(l) : INFINITY;
}

// -- bf16: tensor cores ------------------------------------------------------

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

// (x0, x1) as a hi + lo pair of bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);  // x - hi is exact in f32
}

template <int HD>
struct Mma {
  static constexpr int STAGES = HD == 128 ? 2 : 3;  // tiles in a ring
  static constexpr int RS = HD + 8;                 // row stride in shared memory, elements
  static constexpr int CH = HD / 8;                 // 16-byte chunks of a row
  static constexpr int TILE = 64 * RS;              // elements of a 64-row tile
  static constexpr int NVS = HD == 128 ? 32 : 64;   // vectors of a dkdv product step (registers)
  // two staged tiles, two rings of STAGES tiles, STAGES x 2 x 64 floats
  static constexpr int SMEM = (2 + 2 * STAGES) * TILE * 2 + STAGES * 2 * 64 * 4;
};

// acc (16 x 8NJ) += A (16 rows at a_s, HD dims) B^T (8NJ rows at b_s, HD
// dims), both row-major in shared memory at row stride RS
template <int HD, int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4], const bf16* a_s, const bf16* b_s,
                                         int lane) {
  constexpr int RS = Mma<HD>::RS;
  // A: matrix lane / 8 of an x4 load is (rows +0/+8, dims +0/+8) in a's order
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
  // B: (rows +0, dims +0), (rows +0, dims +8), (rows +8, dims +0), (rows +8, dims +8)
  const int brow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(a_s + arow * RS + kk * 16 + acol));
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_u32(b_s + (16 * jp + brow) * RS + kk * 16 + bcol));
      mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x HD) += X (16 x 8NJ, an f32 accumulator) B (8NJ rows at b_s, HD
// dims, row-major), X as a hi + lo pair of bf16 A fragments
template <int HD, int NJ>
__device__ __forceinline__ void mma_split(float (&acc)[HD / 8][4], const float (&x)[NJ][4],
                                          const bf16* b_s, int lane) {
  constexpr int RS = Mma<HD>::RS;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t bf[4];  // rows 16kk + (0-7, 8-15) x dims 16dp + (0-7, 8-15)
      ldsm_x4_trans(bf, smem_u32(b_s + (16 * kk + lrow) * RS + dp * 16 + lcol));
      mma_bf16(acc[2 * dp], hi, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], hi, bf[2], bf[3]);
      mma_bf16(acc[2 * dp], lo, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], lo, bf[2], bf[3]);
    }
  }
}

// grid (ceil(S / BQ), KV, B), query tiles heaviest (last) first.  Warp w
// owns vectors [16w, 16w + 16): lane (g = lane / 4, t = lane % 4) holds
// rows g and g + 8 of the slice and, of each 8-key score tile, keys 2t and
// 2t + 1.  Vectors past the tile's last row are zero and dropped.
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS) bwd_dq_mma(const Args<bf16> a) {
  using C = Mma<HD>;
  constexpr int RS = C::RS, CH = C::CH, ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [64][RS]
  bf16* do_s = q_s + C::TILE;                 // [64][RS]
  bf16* k_s = do_s + C::TILE;                 // [ST][64][RS]
  bf16* v_s = k_s + ST * C::TILE;             // [ST][64][RS]
  float* d_s = reinterpret_cast<float*>(v_s + ST * C::TILE);  // [64]

  const int G = a.H / a.KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * a.BQ;
  const int R = min(a.BQ, a.S - q0) * G;  // the tile's real vectors
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p0 = a.pos0[b];
  const long long ve = a.valid_end[b];
  // slots below lim(r) are visible to vector r (a padding vector takes the
  // last real one's); lim is nondecreasing in r
  auto lim = [&](int r) { return vis_end(p0, ve, q0 + min(r, R - 1) / G, a.T_len); };
  const int kend = lim(VECS - 1);  // key tiles at or above it are skipped
  const int full = lim(0);         // key tiles below it are seen whole by every vector
  const int nt = (kend + BK - 1) / BK;
  const size_t head = (static_cast<size_t>(b) * a.KV + kvh) * a.T_len * HD;
  const bf16* kb = a.k + head;
  const bf16* vb = a.v + head;

  for (int i = threadIdx.x; i < VECS * CH; i += MMA_THREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const bool ok = r < R;
    cp_async16(smem_u32(q_s + r * RS + c * 8),
               ok ? a.q + vec_off(b, kvh, G, q0, r, a.q_sb, a.q_sh, a.q_ss) + c * 8 : a.q, ok);
    cp_async16(smem_u32(do_s + r * RS + c * 8),
               ok ? a.dout + vec_off(b, kvh, G, q0, r, a.do_sb, a.do_sh, a.do_ss) + c * 8 : a.dout,
               ok);
  }
  cp_async_commit();
  auto load_tile = [&](int tile, bool with_v) {
    const int kt = tile * BK;
    const int stage = tile % ST;
    for (int i = threadIdx.x; i < BK * CH; i += MMA_THREADS) {
      const int row = i / CH;
      const int c = i % CH;
      const bool ok = kt + row < kend;
      const size_t off = static_cast<size_t>(ok ? kt + row : 0) * HD + c * 8;
      const int dst = (stage * BK + row) * RS + c * 8;
      cp_async16(smem_u32(k_s + dst), kb + off, ok);
      if (with_v) cp_async16(smem_u32(v_s + dst), vb + off, ok);
    }
  };
  // groups: Q and dO, then one per tile (empty past the last), so that
  // before tile i is used at most ST - 2 younger groups may be in flight
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nt) load_tile(s, false);
    cp_async_commit();
  }

  // D = rowsum(dO o O): two threads a vector, dO from shared memory, O from
  // device memory, summed in a fixed order
  cp_async_wait<ST - 1>();
  __syncthreads();
  {
    const int r = threadIdx.x / 2;
    const int half = threadIdx.x % 2;
    float acc = 0.f;
    if (r < R) {
      const bf16* orow = a.o + vec_off(b, kvh, G, q0, r, a.o_sb, a.o_sh, a.o_ss);
#pragma unroll
      for (int d = half * HD / 2; d < (half + 1) * HD / 2; d += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + d);
        const uint4 dv = *reinterpret_cast<const uint4*>(do_s + r * RS + d);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(o2[j]);
          const float2 y = __bfloat1622float2(d2[j]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    if (half == 0) {
      d_s[r] = acc;
      if (r < R) a.delta[stat_idx(b, a.H, a.S, kvh, G, q0, r)] = acc;
    }
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const int lim0 = lim(warp * 16 + g);
  const int lim1 = lim(warp * 16 + g + 8);
  const bf16* qw = q_s + warp * 16 * RS;
  const bf16* dow = do_s + warp * 16 * RS;

  // sweep 1: each vector's LSE over its visible keys
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (i + ST - 1 < nt) load_tile(i + ST - 1, false);
    cp_async_commit();
    const int kt = i * BK;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_rows<HD, 8>(s, qw, k_s + (i % ST) * C::TILE, lane);
    const bool masked = kt + BK > full;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt + 8 * j + 2 * t + e;
        s[j][e] = masked && key >= lim0 ? -INFINITY : s[j][e] * a.sl2;
        s[j][2 + e] = masked && key >= lim1 ? -INFINITY : s[j][2 + e] * a.sl2;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    const float off0 = online_step(m0, l0, quad_max(mx0));
    const float off1 = online_step(m1, l1, quad_max(mx1));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l0 += exp2f(s[j][e] - off0);
        l1 += exp2f(s[j][2 + e] - off1);
      }
    }
  }
  const float lse0 = lse_of(m0, quad_sum(l0));
  const float lse1 = lse_of(m1, quad_sum(l1));
  if (t == 0) {
    const int r = warp * 16 + g;
    if (r < R) a.lse[stat_idx(b, a.H, a.S, kvh, G, q0, r)] = lse0;
    if (r + 8 < R) a.lse[stat_idx(b, a.H, a.S, kvh, G, q0, r + 8)] = lse1;
  }

  // sweep 2: dS of each visible (vector, key) pair, dQ = sum_t dS_t k_t
  cp_async_wait<0>();
  __syncthreads();  // every read of the ring is done; d_s is written
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nt) load_tile(s, true);
    cp_async_commit();
  }
  const float D0 = d_s[warp * 16 + g];
  const float D1 = d_s[warp * 16 + g + 8];
  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (i + ST - 1 < nt) load_tile(i + ST - 1, true);
    cp_async_commit();
    const int kt = i * BK;
    const bf16* ks = k_s + (i % ST) * C::TILE;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_rows<HD, 8>(s, qw, ks, lane);
    mma_rows<HD, 8>(dp, dow, v_s + (i % ST) * C::TILE, lane);
    const bool masked = kt + BK > full;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt + 8 * j + 2 * t + e;
        const float p0v = exp2f(masked && key >= lim0 ? -INFINITY : s[j][e] * a.sl2 - lse0);
        const float p1v = exp2f(masked && key >= lim1 ? -INFINITY : s[j][2 + e] * a.sl2 - lse1);
        s[j][e] = p0v * (dp[j][e] - D0);  // dS, in place of S
        s[j][2 + e] = p1v * (dp[j][2 + e] - D1);
      }
    }
    mma_split<HD, 8>(dq, s, ks, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + 8 * half;
    if (r < R) {
      bf16* out = a.dq + vec_off(b, kvh, G, q0, r, a.dq_sb, a.dq_sh, a.dq_ss);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * t) =
            pack_bf16(dq[n][2 * half] * a.scale, dq[n][2 * half + 1] * a.scale);
      }
    }
  }
}

// grid (ceil(T / BK), KV, B), after bwd_dq_mma.  Warp w owns keys kt + 16w
// .. kt + 16w + 15: lane (g, t) holds keys g and g + 8 of the slice and, of
// each 8-vector score tile, vectors 2t and 2t + 1.  k, v, dk and dv are
// contiguous (B, KV, T, HD).
template <int HD>
__global__ void __launch_bounds__(MMA_THREADS) bwd_dkdv_mma(const Args<bf16> a) {
  using C = Mma<HD>;
  constexpr int RS = C::RS, CH = C::CH, ST = C::STAGES, NVS = C::NVS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [64][RS]
  bf16* v_s = k_s + C::TILE;                  // [64][RS]
  bf16* q_s = v_s + C::TILE;                  // [ST][64][RS]
  bf16* do_s = q_s + ST * C::TILE;            // [ST][64][RS]
  float* lse_s = reinterpret_cast<float*>(do_s + ST * C::TILE);  // [ST][64]
  float* d_s = lse_s + ST * VECS;                                // [ST][64]

  const int G = a.H / a.KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int kt = blockIdx.x / a.splits * BK;
  const int rank = blockIdx.x % a.splits;  // in the key tile's cluster
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long p0 = a.pos0[b];
  const long long ve = a.valid_end[b];
  // slots at or past klim are visible to no row: zero gradients
  const int klim = static_cast<int>(max(min(ve, static_cast<long long>(a.T_len)), 0LL));
  const int2 tiles = dkdv_tiles(p0, klim, kt, a.S, a.BQ);
  const int mine = rank_share(tiles.y, rank, a.splits);  // tiles rank, rank + splits, ...
  const size_t head = (static_cast<size_t>(b) * a.KV + kvh) * a.T_len * HD;

  for (int i = threadIdx.x; i < BK * CH; i += MMA_THREADS) {
    const int row = i / CH;
    const int c = i % CH;
    const bool ok = kt + row < klim;
    const size_t off = head + static_cast<size_t>(ok ? kt + row : 0) * HD + c * 8;
    cp_async16(smem_u32(k_s + row * RS + c * 8), a.k + off, ok);
    cp_async16(smem_u32(v_s + row * RS + c * 8), a.v + off, ok);
  }
  cp_async_commit();
  // the block's query tile j into stage j % ST: its Q and dO rows, LSE and
  // D (all zero for padding vectors, which then add exactly 0)
  auto load_tile = [&](int j) {
    const int q0 = (tiles.x + rank + j * a.splits) * a.BQ;
    const int R = min(a.BQ, a.S - q0) * G;
    const int stage = j % ST;
    bf16* qd = q_s + stage * C::TILE;
    bf16* dd = do_s + stage * C::TILE;
    for (int i = threadIdx.x; i < VECS * CH; i += MMA_THREADS) {
      const int r = i / CH;
      const int c = i % CH;
      const bool ok = r < R;
      cp_async16(smem_u32(qd + r * RS + c * 8),
                 ok ? a.q + vec_off(b, kvh, G, q0, r, a.q_sb, a.q_sh, a.q_ss) + c * 8 : a.q, ok);
      cp_async16(smem_u32(dd + r * RS + c * 8),
                 ok ? a.dout + vec_off(b, kvh, G, q0, r, a.do_sb, a.do_sh, a.do_ss) + c * 8
                    : a.dout,
                 ok);
    }
    if (threadIdx.x < VECS) {
      const int r = threadIdx.x;
      const bool ok = r < R;
      const size_t idx = ok ? stat_idx(b, a.H, a.S, kvh, G, q0, r) : 0;
      cp_async4(smem_u32(lse_s + stage * VECS + r), a.lse + idx, ok);
      cp_async4(smem_u32(d_s + stage * VECS + r), a.delta + idx, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < mine) load_tile(s);
    cp_async_commit();
  }

  const int g = lane / 4;
  const int t = lane % 4;
  const int key0 = kt + warp * 16 + g;
  const int key1 = key0 + 8;
  const bf16* kw = k_s + warp * 16 * RS;
  const bf16* vw = v_s + warp * 16 * RS;
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int j = 0; j < mine; ++j) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (j + ST - 1 < mine) load_tile(j + ST - 1);
    cp_async_commit();
    const int q0 = (tiles.x + rank + j * a.splits) * a.BQ;
    const bool masked = kt + BK > vis_end(p0, ve, q0, a.T_len);
    const int stage = j % ST;
    const bf16* qs = q_s + stage * C::TILE;
    const bf16* dos = do_s + stage * C::TILE;
    const float* ls = lse_s + stage * VECS;
    const float* ds_ = d_s + stage * VECS;
#pragma unroll
    for (int h = 0; h < VECS / NVS; ++h) {
      float st[NVS / 8][4], dpt[NVS / 8][4];
#pragma unroll
      for (int jj = 0; jj < NVS / 8; ++jj) {
        st[jj][0] = st[jj][1] = st[jj][2] = st[jj][3] = 0.f;
        dpt[jj][0] = dpt[jj][1] = dpt[jj][2] = dpt[jj][3] = 0.f;
      }
      mma_rows<HD, NVS / 8>(st, kw, qs + h * NVS * RS, lane);
      mma_rows<HD, NVS / 8>(dpt, vw, dos + h * NVS * RS, lane);
#pragma unroll
      for (int jj = 0; jj < NVS / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int vec = h * NVS + 8 * jj + 2 * t + e;
          const float L = ls[vec];
          const float D = ds_[vec];
          bool see0 = true, see1 = true;
          if (masked) {
            const long long pos = p0 + q0 + vec / G;
            see0 = key0 <= pos && key0 < klim;
            see1 = key1 <= pos && key1 < klim;
          }
          const float pa = exp2f(see0 ? st[jj][e] * a.sl2 - L : -INFINITY);
          const float pb = exp2f(see1 ? st[jj][2 + e] * a.sl2 - L : -INFINITY);
          st[jj][e] = pa;  // P^T, in place of S^T
          st[jj][2 + e] = pb;
          dpt[jj][e] = pa * (dpt[jj][e] - D);  // dS^T, in place of dP^T
          dpt[jj][2 + e] = pb * (dpt[jj][2 + e] - D);
        }
      }
      mma_split<HD, NVS / 8>(dv, st, dos + h * NVS * RS, lane);
      mma_split<HD, NVS / 8>(dk, dpt, qs + h * NVS * RS, lane);
    }
  }

  if (a.splits > 1) {
    cp_async_wait<0>();
    __syncthreads();  // every read of the tiles is done: red may overwrite them
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lk = warp * 16 + g + 8 * half;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<float2*>(red + lk * HD + 8 * n + 2 * t) =
            make_float2(dk[n][2 * half], dk[n][2 * half + 1]);
        *reinterpret_cast<float2*>(red + (BK + lk) * HD + 8 * n + 2 * t) =
            make_float2(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
    cluster_combine<bf16, HD, MMA_THREADS>(red, a, head, kt);
    return;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key1 : key0;
    if (key < a.T_len) {
      const size_t off = head + static_cast<size_t>(key) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(a.dk + off + 8 * n + 2 * t) =
            pack_bf16(dk[n][2 * half] * a.scale, dk[n][2 * half + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(a.dv + off + 8 * n + 2 * t) =
            pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
}

// -- f32: CUDA cores, register-tiled --------------------------------------------

template <int HD>
struct Simt {
  static constexpr int STAGES = 2;
  static constexpr int C4 = HD / 4;             // 16-byte chunks of a row
  static constexpr int QS = HD;                 // row stride of a Q / dO tile (floats)
  static constexpr int KS = HD + 4;             // ... of a K / V tile, padded by 16 bytes
  static constexpr int QTILE = 64 * QS;
  static constexpr int KTILE = 64 * KS;
  static constexpr int WS = 80;                 // row stride of the 64 x 64 dS / P tile
  static constexpr int TD = C4 < 16 ? C4 : 16;  // dim chunks across threads in a gradient
  static constexpr int U = C4 / TD;             // ... and per thread
  // dq: Q and dO, a ring of K / V tiles, the dS tile, D; dkdv: K and V, a
  // ring of Q / dO tiles, the P / dS tile, the ring's LSE and D
  static constexpr int DQ_SMEM = (2 * QTILE + 2 * STAGES * KTILE + 64 * WS + 64) * 4;
  static constexpr int KV_SMEM = (2 * KTILE + 2 * STAGES * QTILE + 64 * WS + STAGES * 2 * 64) * 4;
  static constexpr int SMEM = DQ_SMEM > KV_SMEM ? DQ_SMEM : KV_SMEM;
};

template <int RS>
__device__ __forceinline__ float4 ld4(const float* tile, int row, int chunk) {
  return *reinterpret_cast<const float4*>(tile + row * RS + 4 * chunk);
}

// rows r < n of a 64-row tile at row stride RS, row r from src + off(r),
// rows >= n zero-filled
template <int HD, int RS, int THREADS, typename Off>
__device__ __forceinline__ void stage_rows(float* tile, const float* src, int n, Off off) {
  constexpr int C4 = Simt<HD>::C4;
  for (int i = threadIdx.x; i < 64 * C4; i += THREADS) {
    const int r = i / C4;
    const int c = i % C4;
    const bool ok = r < n;
    cp_async16(smem_u32(tile + r * RS + 4 * c), ok ? src + off(r) + 4 * c : src, ok);
  }
}

__device__ __forceinline__ float dot4(const float4 x, const float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float w, const float4 x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ float half_max(float x) {  // over the 16 lanes of a half-warp
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// s[j][i] += a row (ra + 16j) . b row (rb + 16i) over HD, for j < 4 and i <
// ni (block-uniform: b's rows past 16 ni are zero padding, left out); a is
// a Q / dO tile (its rows are read as broadcasts), b a K / V tile (8 rows
// at one chunk a quarter-warp: padded rows put them on distinct banks)
template <int HD>
__device__ __forceinline__ void scores_part(float (&s)[4][4], const float* a_t, int ra,
                                            const float* b_t, int rb, int ni) {
  using C = Simt<HD>;
#pragma unroll 4
  for (int c = 0; c < C::C4; ++c) {
    float4 x[4], y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = ld4<C::QS>(a_t, ra + 16 * j, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < ni) y[i] = ld4<C::KS>(b_t, rb + 16 * i, c);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < ni) s[j][i] = dot4(x[j], y[i], s[j][i]);
      }
    }
  }
}

// ... over b's rows below nb: a full tile takes the unpredicated copy
template <int HD>
__device__ __forceinline__ void simt_scores(float (&s)[4][4], const float* a_t, int ra,
                                            const float* b_t, int rb, int nb) {
  if (nb >= BK) {
    scores_part<HD>(s, a_t, ra, b_t, rb, 4);
  } else {
    scores_part<HD>(s, a_t, ra, b_t, rb, (nb + 15) / 16);
  }
}

// acc[i][u] (4 result rows x U float4 chunks) += sum over the rows x < nx of
// b of w(i, x) b[x][chunk td + TD u], w a 64 x 64 tile at row stride WS:
// w(i, x) = w[w0 + i][x] when W_BY_ROW (dQ: w is dS [vector][key]), else
// w[x][w0 + i] (dK, dV: w is P or dS [vector][key])
template <int HD, bool W_BY_ROW, int BS>
__device__ __forceinline__ void grad_part(float4 (&acc)[4][Simt<HD>::U], const float* w_s,
                                          int w0, const float* b_t, int td, int nx) {
  using C = Simt<HD>;
#pragma unroll 2
  for (int x = 0; x < nx; x += 4) {
    float w[4][4];  // w[i][e] = w(i, x + e)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(
          W_BY_ROW ? w_s + (w0 + i) * C::WS + x : w_s + (x + i) * C::WS + w0);
      if (W_BY_ROW) {
        w[i][0] = t.x;
        w[i][1] = t.y;
        w[i][2] = t.z;
        w[i][3] = t.w;
      } else {  // t holds w(0..3, x + i)
        w[0][i] = t.x;
        w[1][i] = t.y;
        w[2][i] = t.z;
        w[3][i] = t.w;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int u = 0; u < C::U; ++u) {
        const float4 y = ld4<BS>(b_t, x + e, td + C::TD * u);
#pragma unroll
        for (int i = 0; i < 4; ++i) axpy4(acc[i][u], w[i][e], y);
      }
    }
  }
}

// ... over b's rows below nb (b at row stride BS; its rows are read along
// consecutive chunks a quarter-warp): a full tile takes the copy of 64
template <int HD, bool W_BY_ROW, int BS>
__device__ __forceinline__ void simt_grad(float4 (&acc)[4][Simt<HD>::U], const float* w_s,
                                          int w0, const float* b_t, int td, int nb) {
  if (nb >= BK) {
    grad_part<HD, W_BY_ROW, BS>(acc, w_s, w0, b_t, td, BK);
  } else {
    grad_part<HD, W_BY_ROW, BS>(acc, w_s, w0, b_t, td, (nb + 3) & ~3);
  }
}

// grid (ceil(S / BQ), KV, B), query tiles heaviest first.  In the scores
// thread (tv, tk) = (lane / 16 + 2 warp, lane % 16) owns vectors tv + 16j
// and keys tk + 16i; in dQ thread (gv, td) = (tid / TD, tid % TD), gv < 16,
// owns vectors 4gv .. 4gv + 3 and dim chunks td + TD u.  The dS tile is
// stored [vector][key]: a dQ thread reads 4 keys of a vector as a float4.
template <int HD>
__global__ void __launch_bounds__(SIMT_THREADS) bwd_dq_simt(const Args<float> a) {
  using C = Simt<HD>;
  constexpr int ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [64][QS]
  float* do_s = q_s + C::QTILE;
  float* k_s = do_s + C::QTILE;      // [ST][64][KS]
  float* v_s = k_s + ST * C::KTILE;  // [ST][64][KS]
  float* w_s = v_s + ST * C::KTILE;  // [64 vectors][WS]: dS of the tile
  float* d_s = w_s + 64 * C::WS;    // [64]

  const int G = a.H / a.KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * a.BQ;
  const int R = min(a.BQ, a.S - q0) * G;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tk = lane % 16;
  const int tv = lane / 16 + 2 * (tid / 32);
  const long long p0 = a.pos0[b];
  const long long ve = a.valid_end[b];
  auto lim = [&](int r) { return vis_end(p0, ve, q0 + min(r, R - 1) / G, a.T_len); };
  const int kend = lim(VECS - 1);
  const int full = lim(0);
  const int nt = (kend + BK - 1) / BK;
  const size_t head = (static_cast<size_t>(b) * a.KV + kvh) * a.T_len * HD;

  stage_rows<HD, C::QS, SIMT_THREADS>(q_s, a.q, R, [&](int r) {
    return vec_off(b, kvh, G, q0, r, a.q_sb, a.q_sh, a.q_ss);
  });
  stage_rows<HD, C::QS, SIMT_THREADS>(do_s, a.dout, R, [&](int r) {
    return vec_off(b, kvh, G, q0, r, a.do_sb, a.do_sh, a.do_ss);
  });
  cp_async_commit();
  auto load_tile = [&](int tile, bool with_v) {
    const int kt = tile * BK;
    const int n = min(BK, kend - kt);
    auto off = [&](int r) { return head + static_cast<size_t>(kt + r) * HD; };
    stage_rows<HD, C::KS, SIMT_THREADS>(k_s + (tile % ST) * C::KTILE, a.k, n, off);
    if (with_v) stage_rows<HD, C::KS, SIMT_THREADS>(v_s + (tile % ST) * C::KTILE, a.v, n, off);
  };
  if (nt > 0) load_tile(0, false);
  cp_async_commit();

  // D: four threads a vector, each a quarter of the dims, summed in a fixed order
  cp_async_wait<1>();
  __syncthreads();
  {
    const int r = tid / 4;
    const int quarter = tid % 4;
    float acc = 0.f;
    if (r < R) {
      const float* orow = a.o + vec_off(b, kvh, G, q0, r, a.o_sb, a.o_sh, a.o_ss);
#pragma unroll
      for (int c = quarter * C::C4 / 4; c < (quarter + 1) * C::C4 / 4; ++c) {
        acc = dot4(*reinterpret_cast<const float4*>(orow + 4 * c), ld4<C::QS>(do_s, r, c), acc);
      }
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    acc += __shfl_xor_sync(FULL, acc, 2);
    if (quarter == 0) {
      d_s[r] = acc;
      if (r < R) a.delta[stat_idx(b, a.H, a.S, kvh, G, q0, r)] = acc;
    }
  }

  int lims[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) lims[j] = lim(tv + 16 * j);

  // sweep 1: each vector's LSE (a partial sum per thread, reduced after)
  float m[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has arrived; tile i - 1 is consumed
    if (i + 1 < nt) load_tile(i + 1, false);
    cp_async_commit();
    const int kt = i * BK;
    const bool masked = kt + BK > full;
    float s[4][4] = {};
    simt_scores<HD>(s, q_s, tv, k_s + (i % ST) * C::KTILE, tk, kend - kt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float mx = -INFINITY;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        s[j][ii] = masked && kt + tk + 16 * ii >= lims[j] ? -INFINITY : s[j][ii] * a.sl2;
        mx = fmaxf(mx, s[j][ii]);
      }
      const float off = online_step(m[j], l[j], half_max(mx));
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) l[j] += exp2f(s[j][ii] - off);
    }
  }
  float lse[4], D[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lse[j] = lse_of(m[j], half_sum(l[j]));
    const int r = tv + 16 * j;
    if (tk == 0 && r < R) a.lse[stat_idx(b, a.H, a.S, kvh, G, q0, r)] = lse[j];
  }

  // sweep 2
  cp_async_wait<0>();
  __syncthreads();  // every read of the ring is done; d_s is written
#pragma unroll
  for (int j = 0; j < 4; ++j) D[j] = d_s[tv + 16 * j];
  if (nt > 0) load_tile(0, true);
  cp_async_commit();
  const int td = tid % C::TD;
  const int gv = tid / C::TD;
  float4 acc[4][C::U];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int u = 0; u < C::U; ++u) acc[j][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // tile i has arrived; tile i - 1 and its dS are consumed
    if (i + 1 < nt) load_tile(i + 1, true);
    cp_async_commit();
    const int kt = i * BK;
    const bool masked = kt + BK > full;  // so is every tile with keys past kend
    const int nk = min(BK, kend - kt);   // keys of the tile below kend
    const float* ks = k_s + (i % ST) * C::KTILE;
    float s[4][4] = {}, dp[4][4] = {};
    simt_scores<HD>(s, q_s, tv, ks, tk, nk);
    simt_scores<HD>(dp, do_s, tv, v_s + (i % ST) * C::KTILE, tk, nk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int key = tk + 16 * ii;
        const float p =
            exp2f(masked && kt + key >= lims[j] ? -INFINITY : s[j][ii] * a.sl2 - lse[j]);
        w_s[(tv + 16 * j) * C::WS + key] = p * (dp[j][ii] - D[j]);
      }
    }
    __syncthreads();
    if (gv < 16) simt_grad<HD, true, C::KS>(acc, w_s, 4 * gv, ks, td, nk);
  }

  if (gv < 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * gv + j;
      if (r < R) {
        float* out = a.dq + vec_off(b, kvh, G, q0, r, a.dq_sb, a.dq_sh, a.dq_ss);
#pragma unroll
        for (int u = 0; u < C::U; ++u) {
          const float4 x = acc[j][u];
          *reinterpret_cast<float4*>(out + 4 * (td + C::TD * u)) =
              make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
        }
      }
    }
  }
}

// grid (ceil(T / BK), KV, B), after bwd_dq_simt.  In the scores thread
// (tv, tk) owns vectors tv + 16j and keys tk + 16i; in dK and dV thread
// (gk, td) = (tid / TD, tid % TD), gk < 16, owns keys 4gk .. 4gk + 3 and dim
// chunks td + TD u.  P and then dS pass through one [vector][key] tile.
template <int HD>
__global__ void __launch_bounds__(SIMT_THREADS) bwd_dkdv_simt(const Args<float> a) {
  using C = Simt<HD>;
  constexpr int ST = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [64][KS]
  float* v_s = k_s + C::KTILE;
  float* q_s = v_s + C::KTILE;        // [ST][64][QS]
  float* do_s = q_s + ST * C::QTILE;  // [ST][64][QS]
  float* w_s = do_s + ST * C::QTILE;  // [64 vectors][WS]
  float* lse_s = w_s + 64 * C::WS;   // [ST][64]
  float* d_s = lse_s + ST * VECS;    // [ST][64]

  const int G = a.H / a.KV;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int kt = blockIdx.x / a.splits * BK;
  const int rank = blockIdx.x % a.splits;  // in the key tile's cluster
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tk = lane % 16;
  const int tv = lane / 16 + 2 * (tid / 32);
  const long long p0 = a.pos0[b];
  const long long ve = a.valid_end[b];
  const int klim = static_cast<int>(max(min(ve, static_cast<long long>(a.T_len)), 0LL));
  const int nk = max(0, min(BK, klim - kt));  // the tile's keys below klim; the rest get 0
  const int2 tiles = dkdv_tiles(p0, klim, kt, a.S, a.BQ);
  const int mine = rank_share(tiles.y, rank, a.splits);  // tiles rank, rank + splits, ...
  const size_t head = (static_cast<size_t>(b) * a.KV + kvh) * a.T_len * HD;

  auto key_off = [&](int r) { return head + static_cast<size_t>(kt + r) * HD; };
  stage_rows<HD, C::KS, SIMT_THREADS>(k_s, a.k, nk, key_off);
  stage_rows<HD, C::KS, SIMT_THREADS>(v_s, a.v, nk, key_off);
  cp_async_commit();
  auto load_tile = [&](int j) {
    const int q0 = (tiles.x + rank + j * a.splits) * a.BQ;
    const int R = min(a.BQ, a.S - q0) * G;
    const int stage = j % ST;
    stage_rows<HD, C::QS, SIMT_THREADS>(q_s + stage * C::QTILE, a.q, R, [&](int r) {
      return vec_off(b, kvh, G, q0, r, a.q_sb, a.q_sh, a.q_ss);
    });
    stage_rows<HD, C::QS, SIMT_THREADS>(do_s + stage * C::QTILE, a.dout, R, [&](int r) {
      return vec_off(b, kvh, G, q0, r, a.do_sb, a.do_sh, a.do_ss);
    });
    if (tid < VECS) {
      const bool ok = tid < R;
      const size_t idx = ok ? stat_idx(b, a.H, a.S, kvh, G, q0, tid) : 0;
      cp_async4(smem_u32(lse_s + stage * VECS + tid), a.lse + idx, ok);
      cp_async4(smem_u32(d_s + stage * VECS + tid), a.delta + idx, ok);
    }
  };
  if (mine > 0) load_tile(0);
  cp_async_commit();

  const int td = tid % C::TD;
  const int gk = tid / C::TD;
  const bool grad_thread = gk < 16 && 4 * gk < nk;
  float4 dk[4][C::U], dv[4][C::U];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      dk[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  for (int j = 0; j < mine; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j has arrived; tile j - 1 and its dS are consumed
    if (j + 1 < mine) load_tile(j + 1);
    cp_async_commit();
    const int q0 = (tiles.x + rank + j * a.splits) * a.BQ;
    const bool masked = kt + BK > vis_end(p0, ve, q0, a.T_len);
    const int stage = j % ST;
    const float* qs = q_s + stage * C::QTILE;
    const float* dos = do_s + stage * C::QTILE;
    float s[4][4] = {}, dp[4][4] = {};
    simt_scores<HD>(s, qs, tv, k_s, tk, nk);
    simt_scores<HD>(dp, dos, tv, v_s, tk, nk);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int vec = tv + 16 * jj;
      const float L = lse_s[stage * VECS + vec];
      const float D = d_s[stage * VECS + vec];
      const long long pos = p0 + q0 + vec / G;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int key = kt + tk + 16 * ii;
        const bool see = !masked || (key <= pos && key < klim);
        const float p = exp2f(see ? s[jj][ii] * a.sl2 - L : -INFINITY);
        w_s[vec * C::WS + tk + 16 * ii] = p;
        dp[jj][ii] = p * (dp[jj][ii] - D);  // dS
      }
    }
    __syncthreads();
    if (grad_thread) simt_grad<HD, false, C::QS>(dv, w_s, 4 * gk, dos, td, VECS);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) w_s[(tv + 16 * jj) * C::WS + tk + 16 * ii] = dp[jj][ii];
    }
    __syncthreads();
    if (grad_thread) simt_grad<HD, false, C::QS>(dk, w_s, 4 * gk, qs, td, VECS);
  }

  if (a.splits > 1) {
    cp_async_wait<0>();
    __syncthreads();  // every read of the tiles is done: red may overwrite them
    float* red = reinterpret_cast<float*>(smem);
    if (gk < 16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int u = 0; u < C::U; ++u) {
          const int d = 4 * (td + C::TD * u);
          store4(red + (4 * gk + i) * HD + d, dk[i][u]);
          store4(red + (BK + 4 * gk + i) * HD + d, dv[i][u]);
        }
      }
    }
    cluster_combine<float, HD, SIMT_THREADS>(red, a, head, kt);
    return;
  }
  if (gk < 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kt + 4 * gk + i;
      if (key < a.T_len) {
        const size_t off = head + static_cast<size_t>(key) * HD;
#pragma unroll
        for (int u = 0; u < C::U; ++u) {
          const int d = 4 * (td + C::TD * u);
          const float4 x = dk[i][u];
          *reinterpret_cast<float4*>(a.dk + off + d) =
              make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
          *reinterpret_cast<float4*>(a.dv + off + d) = dv[i][u];
        }
      }
    }
  }
}

// -- launch ------------------------------------------------------------------

template <typename Kdq, typename Kkv>
cudaError_t opt_in(Kdq kdq, Kkv kkv, int smem) {  // above 48 KB only after opting in
  const cudaError_t err =
      cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// the dq kernel, then the dkdv kernel in clusters of a.splits blocks along x
template <typename T, typename Kdq, typename Kkv>
cudaError_t launch_pair(Kdq kdq, Kkv kkv, int smem, int threads, const Args<T>& a, int B,
                        cudaStream_t st) {
  kdq<<<dim3((a.S + a.BQ - 1) / a.BQ, a.KV, B), threads, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((a.T_len + BK - 1) / BK * a.splits, a.KV, B);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kkv, a);
  const cudaError_t last = cudaGetLastError();  // read and clear
  return err != cudaSuccess ? err : last;
}

template <int HD>
cudaError_t launch_hd(const Args<bf16>& a, int B, cudaStream_t st) {
  static const cudaError_t opted = opt_in(bwd_dq_mma<HD>, bwd_dkdv_mma<HD>, Mma<HD>::SMEM);
  if (opted != cudaSuccess) return opted;
  return launch_pair(bwd_dq_mma<HD>, bwd_dkdv_mma<HD>, Mma<HD>::SMEM, MMA_THREADS, a, B, st);
}

template <int HD>
cudaError_t launch_hd(const Args<float>& a, int B, cudaStream_t st) {
  static const cudaError_t opted = opt_in(bwd_dq_simt<HD>, bwd_dkdv_simt<HD>, Simt<HD>::SMEM);
  if (opted != cudaSuccess) return opted;
  return launch_pair(bwd_dq_simt<HD>, bwd_dkdv_simt<HD>, Simt<HD>::SMEM, SIMT_THREADS, a, B,
                     st);
}

template <typename T>
cudaError_t dispatch(int hd, const Args<T>& a, int B, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_hd<16>(a, B, st);
    case 64:
      return launch_hd<64>(a, B, st);
    case 128:
      return launch_hd<128>(a, B, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* pos0, const void* valid_end, void* dq, void* dk, void* dv,
                  void* lse, void* delta, int H, int KV, int S, int T_len, int hd, int BQ,
                  int splits, const int* strides) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<const T*>(o);
  a.dout = static_cast<const T*>(dout);
  a.pos0 = static_cast<const long long*>(pos0);
  a.valid_end = static_cast<const long long*>(valid_end);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.T_len = T_len;
  a.BQ = BQ;
  a.splits = splits;
  a.q_sb = strides[0];
  a.q_sh = strides[1];
  a.q_ss = strides[2];
  a.o_sb = strides[3];
  a.o_sh = strides[4];
  a.o_ss = strides[5];
  a.do_sb = strides[6];
  a.do_sh = strides[7];
  a.do_ss = strides[8];
  a.dq_sb = strides[9];
  a.dq_sh = strides[10];
  a.dq_ss = strides[11];
  a.scale = 1.0f / sqrtf(static_cast<float>(hd));
  a.sl2 = a.scale * LOG2E;
  return a;
}

}  // namespace

// q, o, dout, dq (B, H, S, hd) with a contiguous last dim, 16-byte aligned
// rows and the given (batch, head, row) strides; k, v, dk, dv (B, KV, T,
// hd) contiguous and 16-byte aligned; bf16 (route 1, "mma") or f32 (route
// 0, "simt"); pos0, valid_end (B,) int64 on the card; lse and delta (B, H,
// S) f32 scratch; BQ = 64 / G query rows a query tile; splits (1, 2, 4 or 8)
// blocks share each key tile's walk in the dkdv kernel.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* pos0, const void* valid_end,
                                   void* dq, void* dk, void* dv, void* lse, void* delta, int B,
                                   int H, int KV, int S, int T, int hd, int BQ, int splits,
                                   int route,
                                   int q_sb, int q_sh, int q_ss, int o_sb, int o_sh, int o_ss,
                                   int do_sb, int do_sh, int do_ss, int dq_sb, int dq_sh,
                                   int dq_ss, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || T <= 0 || H % KV != 0 || BQ <= 0 ||
      BQ * (H / KV) > VECS || B > 65535 || KV > 65535 || splits < 1 || splits > MAX_SPLITS ||
      (splits & (splits - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const int strides[12] = {q_sb, q_sh, q_ss, o_sb, o_sh, o_ss,
                           do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    return dispatch(hd, make_args<bf16>(q, k, v, o, dout, pos0, valid_end, dq, dk, dv, lse, delta,
                                        H, KV, S, T, hd, BQ, splits, strides),
                    B, st);
  }
  if (route == 0) {
    return dispatch(hd, make_args<float>(q, k, v, o, dout, pos0, valid_end, dq, dk, dv, lse,
                                         delta, H, KV, S, T, hd, BQ, splits, strides),
                    B, st);
  }
  return cudaErrorInvalidValue;
}
