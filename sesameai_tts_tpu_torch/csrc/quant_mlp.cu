// Fused int8 SwiGLU MLP for Hopper (sm_90a): one launch per call.
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
// bf16 x bf16 product in f32, so only the order of the f32 sums differs
// from the unfused kernels (ops/quant.py::quant_mlp_cluster_plain states
// the order of the tile sums).
//
// What bounds it: at decode sizes (S <= 64) the int8 weight bytes,
// 2*D*F + F*Dout per call (50.3 MB for the backbone's MLP, 25.2 MB for the
// decoder's); x, the scales and y are a few KB.  Below the bytes, the
// chain of latencies after the last weight byte: the w2 product, the
// cluster's and the grid's sums.
//
// What the design does about it:
//  * one launch per call: one block per intermediate tile of BI columns,
//    grid F / BI in one wave (the launch checks
//    cudaOccupancyMaxActiveClusters and refuses a grid whose clusters
//    would not all be resident at once; ops/quant.py::_qmlp_geometry picks
//    the tile, the cluster, the threads and the shared memory, which also
//    keeps more blocks than the grid needs off an SM).  The block streams
//    its w1 and w3 column tiles and its w2 row tile once; h never leaves
//    the block;
//  * the w2 tile (BI rows x Dout, contiguous in q2) does not depend on h,
//    so thread 0 issues it into shared memory first, as bulk asynchronous
//    copies completed on an mbarrier: it is in flight while w13 streams,
//    and phase 2 reads it from shared memory with no DRAM round trip after
//    h is ready.  Where S leaves too little shared memory, only the first
//    `prefetch_rows` rows are copied and phase 2 reads the rest from
//    global memory.  The scales are read at the start too;
//  * phase 1 (w1, w3): tpr = 2*BI/16 threads cover a tile row, each 16
//    neighbouring columns of w1 or w3 by one 16-byte ld.global.nc per row,
//    the block's row groups walk D interleaved; every thread keeps U rows
//    in flight and issues the next U before it uses the current ones, from
//    its first instructions (x is read beside the weights and rounded in
//    registers: no staging pass).  int8 -> f32 without an I2F: the byte,
//    its sign bit flipped, is permuted (PRMT) into the mantissa of 2^23
//    and one FADD removes 2^23 + 128, which is exact.  The row groups are
//    summed by warp shuffles, then the warps in shared memory, both in a
//    fixed order.  S above the S tile loops over S tiles in the block (the
//    w1/w3 tile is read again, from L2 where it stayed);
//  * phase 2 (w2): each thread owns 8 output columns of a slice of the
//    tile's rows, reads them from shared memory 8 bytes a row, and the
//    slices are added in shared memory in a fixed order;
//  * the w2 partials: the blocks of a thread-block cluster (up to 16,
//    non-portable above 8) reduce-scatter theirs through distributed
//    shared memory (each block leaves its partial of every 4-column vector
//    in the vector's owner block, one cluster barrier, the owner adds them
//    in rank order) and each owner writes its columns of the cluster's
//    partial to a small persistent buffer.  A grid barrier (one word whose
//    top bit flips when every block has arrived, as in cooperative groups'
//    grid sync: no reset, safe to replay) follows, and then every block
//    adds the cluster partials of its share of the output in a fixed
//    order, applies s2 and writes bf16 y.  No atomics on values: the result
//    is bit-equal from call to call and in a CUDA-graph replay, and the
//    launch allocates nothing (the wrapper owns the buffer and the barrier
//    word, one pair per device and stream);
//  * a wait on the mbarrier or the grid barrier that lasts 2 s traps, so a
//    fault ends the launch with an error instead of hanging the card.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int VEC = 16;             // phase-1 columns per thread (one 16-byte load a row)
constexpr int VEC2 = 8;             // phase-2 columns per thread (one 8-byte load a row)
constexpr int MAX_CLUSTER = 16;     // blocks of a cluster (non-portable above 8)
constexpr int MAX_S = 64;
constexpr int SMEM_LIMIT = 232448;  // shared memory one block may use (227 KB)
constexpr int HEADER = 16;          // the mbarrier (8 bytes), padded
constexpr int COPY_CHUNK = 16384;   // bytes per bulk copy of the w2 tile
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets of the dynamic shared memory; ops/quant.py::_qmlp_smem_bytes
// mirrors `total`.
struct Layout {
  int w2s, hs, scratch, recv, total;
};

__host__ __device__ inline Layout layout(int S, int BI, int Dout, int threads, int cluster,
                                         int prefetch_rows, int s_tile) {
  const int tiles_s = (S + s_tile - 1) / s_tile;
  const int cg2 = Dout / VEC2;
  const int rg2 = min(max(1, threads / cg2), BI);
  const int slice = (Dout / 4 + cluster - 1) / cluster * 4;  // columns per owner
  const int p1 = threads / 32 * s_tile * 2 * BI * 4;          // phase-1 warp sums
  const int p2 = rg2 * s_tile * Dout * 4;                     // phase-2 slice sums
  Layout l;
  l.w2s = HEADER;
  l.hs = l.w2s + align16(prefetch_rows * Dout);
  l.scratch = l.hs + tiles_s * s_tile * BI * 4;
  l.recv = l.scratch + (p1 > p2 ? p1 : p2);
  l.total = l.recv + cluster * s_tile * slice * 4;
  return l;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte I of `flipped` (an int8 with its sign bit flipped, i.e. b + 128)
// as the float b: 0x4B0000uu is 2^23 + uu exactly.
template <int I>
__device__ __forceinline__ float int8_value(uint32_t flipped) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | I)) - 8388736.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(ns));
  return ns;
}

// A wait that has not ended after WATCHDOG_NS is a fault (a lost copy, a
// block that never arrives): the kernel traps, and the launch's error
// reaches the caller, instead of hanging the card
constexpr uint64_t WATCHDOG_NS = 2000000000ull;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const uint64_t start = global_ns();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && global_ns() - start > WATCHDOG_NS) __trap();
  }
}

// global -> shared, `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// Every block of the grid waits here until all have arrived (they are all
// resident: the launch is one wave).  One word, as cooperative groups'
// grid barrier keeps it: each block adds 1, block 0 adds 2^31 - (blocks -
// 1), so the word's top bit flips once all have arrived and the word
// needs no reset.  Thread 0's fences make the block's global stores
// before the barrier visible to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned* word) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned before = atomicAdd(word, add);
    const uint64_t start = global_ns();
    while (((before ^ ld_volatile(word)) & 0x80000000u) == 0) {
      if (global_ns() - start > WATCHDOG_NS) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// U rows of the thread's 16 columns (rows r0, r0 + step, ...; zero past D)
// and the S tile's x at those rows, rounded to bf16 values
template <int S_TILE, int U>
__device__ __forceinline__ void fetch13(uint4 (&w)[U], float (&xv)[U][S_TILE],
                                        const __nv_bfloat16* __restrict__ x,
                                        const int8_t* __restrict__ q13, int r0, int step, int D,
                                        size_t ld13, int col, int s0, int S) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = r0 + u * step;
    const bool ok = r < D;
    w[u] = ok ? __ldg(reinterpret_cast<const uint4*>(q13 + static_cast<size_t>(r) * ld13 + col))
              : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
      xv[u][s] = ok && s0 + s < S ? __bfloat162float(x[static_cast<size_t>(s0 + s) * D + r])
                                  : 0.f;
    }
  }
}

// acc[s][0..7] += h[s][r] * w2[r][0..7] over rows [r_begin, r_end) of a
// w2 tile whose rows are `ld` bytes apart, from shared (SHARED) or global
// memory
template <int S_TILE, bool SHARED>
__device__ __forceinline__ void rows2(float (&acc)[S_TILE][VEC2], const int8_t* w, int ld,
                                      const float* hs, int BI, int r_begin, int r_end) {
  constexpr int U2 = 8;
  int r = r_begin;
  for (; r + U2 <= r_end; r += U2) {
    uint2 wv[U2];
#pragma unroll
    for (int u = 0; u < U2; ++u) {
      const uint2* p = reinterpret_cast<const uint2*>(w + static_cast<size_t>(r + u) * ld);
      wv[u] = SHARED ? *p : __ldg(p);
    }
#pragma unroll
    for (int u = 0; u < U2; ++u) {
      const uint32_t lo = wv[u].x ^ 0x80808080u, hi = wv[u].y ^ 0x80808080u;
      const float wf[VEC2] = {int8_value<0>(lo), int8_value<1>(lo), int8_value<2>(lo),
                              int8_value<3>(lo), int8_value<0>(hi), int8_value<1>(hi),
                              int8_value<2>(hi), int8_value<3>(hi)};
#pragma unroll
      for (int s = 0; s < S_TILE; ++s) {
        const float hv = hs[s * BI + r + u];
#pragma unroll
        for (int e = 0; e < VEC2; ++e) acc[s][e] = fmaf(hv, wf[e], acc[s][e]);
      }
    }
  }
  for (; r < r_end; ++r) {
    const uint2* p = reinterpret_cast<const uint2*>(w + static_cast<size_t>(r) * ld);
    const uint2 wv = SHARED ? *p : __ldg(p);
    const uint32_t lo = wv.x ^ 0x80808080u, hi = wv.y ^ 0x80808080u;
    const float wf[VEC2] = {int8_value<0>(lo), int8_value<1>(lo), int8_value<2>(lo),
                            int8_value<3>(lo), int8_value<0>(hi), int8_value<1>(hi),
                            int8_value<2>(hi), int8_value<3>(hi)};
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
      const float hv = hs[s * BI + r];
#pragma unroll
      for (int e = 0; e < VEC2; ++e) acc[s][e] = fmaf(hv, wf[e], acc[s][e]);
    }
  }
}

// Block `tile` of a grid of F / BI blocks in clusters along x, all
// resident at once.  `part` holds two halves of (F / BI / cluster,
// S_TILE, Dout) f32 cluster partials (S tiles alternate between them);
// `barrier` is the grid barrier's word.
template <int S_TILE>
__global__ void __launch_bounds__(MAX_THREADS)
qmlp_cluster(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q13,
             const float* __restrict__ s13, const int8_t* __restrict__ q2,
             const float* __restrict__ s2, __nv_bfloat16* __restrict__ y,
             float* __restrict__ part, unsigned* __restrict__ barrier, int S, int D, int F, int Dout,
             int BI, int prefetch_rows) {
  constexpr int U = S_TILE == 1 ? 8 : S_TILE == 2 ? 4 : 2;  // rows in flight per thread (x2)
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int warps = threads / 32;
  const int tile = blockIdx.x;
  const Layout L = layout(S, BI, Dout, threads, csize, prefetch_rows, S_TILE);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int8_t* w2s = reinterpret_cast<int8_t*>(smem + L.w2s);
  float* hs = reinterpret_cast<float*>(smem + L.hs);          // [S tiles * S_TILE][BI]
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  float* recv = reinterpret_cast<float*>(smem + L.recv);      // [cluster][S_TILE][slice]
  const int8_t* q2t = q2 + static_cast<size_t>(tile) * BI * Dout;

  // the w2 tile's first prefetch_rows rows, in flight from here on
  if (t == 0) {
    mbar_init(bar, 1);
    const int bytes = prefetch_rows * Dout;
    mbar_expect_tx(bar, static_cast<uint32_t>(bytes));
    for (int off = 0; off < bytes; off += COPY_CHUNK) {
      bulk_copy(w2s + off, q2t + off, static_cast<uint32_t>(min(COPY_CHUNK, bytes - off)), bar);
    }
  }
  if (csize > 1) cluster_arrive_relaxed();  // waited for before the first remote store
  // the scales this thread applies, read now so that no DRAM round trip
  // follows the weights: s13 of its h column (threads % BI == 0, so every
  // (s, j) item of the thread has j = t % BI) and s2 of its first output
  // vector (the first S tile's first pass of the grid's sum)
  const float sc1 = __ldg(s13 + tile * BI + t % BI);
  const float sc3 = __ldg(s13 + F + tile * BI + t % BI);
  const int n4 = Dout / 4;
  const int clusters = gridDim.x / csize;
  int tpv = 1;  // lanes per output vector in the grid's sum
  while (tpv < clusters && tpv < 32) tpv *= 2;
  float4 sc2_first = make_float4(0.f, 0.f, 0.f, 0.f);
  {
    const int total4 = min(S_TILE, S) * n4;
    const int per = (total4 + gridDim.x - 1) / gridDim.x;
    const int v = tile * per + t / tpv;
    if (t / tpv < per && v < total4) {
      sc2_first = __ldg(reinterpret_cast<const float4*>(s2) + v % n4);
    }
  }

  // ---- phase 1: the w1 and w3 column tiles, one S tile at a time ----------
  const int tpr = 2 * BI / VEC;  // threads per tile row (divides 32)
  const int step = threads / tpr;
  const int c = t % tpr;
  const int half = tpr / 2;
  const int col = c < half ? tile * BI + c * VEC : F + tile * BI + (c - half) * VEC;
  const size_t ld13 = static_cast<size_t>(2) * F;
  for (int s0 = 0; s0 < S; s0 += S_TILE) {
    float acc[S_TILE][VEC];
#pragma unroll
    for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[s][e] = 0.f;
    }
    uint4 wa[U];
    float xa[U][S_TILE];
    int r0 = t / tpr;
    fetch13<S_TILE, U>(wa, xa, x, q13, r0, step, D, ld13, col, s0, S);
    for (; r0 < D; r0 += U * step) {
      uint4 wb[U];
      float xb[U][S_TILE];
      fetch13<S_TILE, U>(wb, xb, x, q13, r0 + U * step, step, D, ld13, col, s0, S);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t* words = reinterpret_cast<const uint32_t*>(&wa[u]);
#pragma unroll
        for (int k = 0; k < VEC / 4; ++k) {
          const uint32_t fl = words[k] ^ 0x80808080u;
          const float wf[4] = {int8_value<0>(fl), int8_value<1>(fl), int8_value<2>(fl),
                               int8_value<3>(fl)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int s = 0; s < S_TILE; ++s) {
              acc[s][4 * k + i] = fmaf(xa[u][s], wf[i], acc[s][4 * k + i]);
            }
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
    if (lane < tpr) {  // w1 columns [0, BI), w3 columns [BI, 2 BI) of the tile
#pragma unroll
      for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          *reinterpret_cast<float4*>(&scratch[(warp * S_TILE + s) * 2 * BI + lane * VEC + e]) =
              make_float4(acc[s][e], acc[s][e + 1], acc[s][e + 2], acc[s][e + 3]);
        }
      }
    }
    __syncthreads();
    for (int i = t; i < S_TILE * BI; i += threads) {
      const int s = i / BI;
      const int j = i - s * BI;
      float a1 = 0.f, a3 = 0.f;
      for (int w = 0; w < warps; ++w) {
        a1 += scratch[(w * S_TILE + s) * 2 * BI + j];
        a3 += scratch[(w * S_TILE + s) * 2 * BI + BI + j];
      }
      a1 *= sc1;
      a3 *= sc3;
      const float g = bf16_round(a1);
      const float act = bf16_round(g / (1.f + expf(-g)));
      hs[(s0 + s) * BI + j] = s0 + s < S ? bf16_round(act * bf16_round(a3)) : 0.f;
    }
    __syncthreads();  // h of the S tile is complete; scratch is free again
  }

  // ---- phase 2: the w2 tile, then the cluster's and the grid's sums ------
  mbar_wait(bar, 0);
  const int cg2 = Dout / VEC2;
  const int rg2 = min(max(1, threads / cg2), BI);
  const int per2 = (BI + rg2 - 1) / rg2;  // rows per slice
  const int items = rg2 * cg2;
  const int slice = (Dout / 4 + csize - 1) / csize * 4;  // columns per owner
  const int own_begin = rank * slice;
  const int own = max(0, min(slice, Dout - own_begin));
  const int cluster_id = tile / csize;
  const size_t plane = static_cast<size_t>(S_TILE) * Dout;  // one cluster's partial
  for (int s0 = 0; s0 < S; s0 += S_TILE) {
    const float* h = hs + s0 * BI;
    for (int item = t; item < items; item += threads) {
      const int c2 = item % cg2;
      const int g = item / cg2;
      const int rb = g * per2;
      const int re = min(BI, rb + per2);
      float acc2[S_TILE][VEC2];
#pragma unroll
      for (int s = 0; s < S_TILE; ++s) {
#pragma unroll
        for (int e = 0; e < VEC2; ++e) acc2[s][e] = 0.f;
      }
      const int split = max(rb, min(re, prefetch_rows));  // rows below it are in shared memory
      rows2<S_TILE, true>(acc2, w2s + c2 * VEC2, Dout, h, BI, rb, split);
      rows2<S_TILE, false>(acc2, q2t + c2 * VEC2, Dout, h, BI, split, re);
#pragma unroll
      for (int s = 0; s < S_TILE; ++s) {
        float* out = &scratch[(g * S_TILE + s) * Dout + c2 * VEC2];
        *reinterpret_cast<float4*>(out) =
            make_float4(acc2[s][0], acc2[s][1], acc2[s][2], acc2[s][3]);
        *reinterpret_cast<float4*>(out + 4) =
            make_float4(acc2[s][4], acc2[s][5], acc2[s][6], acc2[s][7]);
      }
    }
    __syncthreads();
    // every block of the cluster has started (a later S tile: every owner
    // has read its slots before the grid barrier), so recv may be written
    if (csize > 1 && s0 == 0) cluster_wait();
    // the block's partial of each 4-column vector: its slices in order, into
    // the owner's recv at slot `rank`
    for (int v = t; v < S_TILE * n4; v += threads) {
      const int s = v / n4;
      const int col4 = (v - s * n4) * 4;
      float4 sum = *reinterpret_cast<const float4*>(&scratch[s * Dout + col4]);
      for (int g = 1; g < rg2; ++g) {
        add4(sum, *reinterpret_cast<const float4*>(&scratch[(g * S_TILE + s) * Dout + col4]));
      }
      const int owner = col4 / slice;
      float4* slot = reinterpret_cast<float4*>(
          &recv[(rank * S_TILE + s) * slice + col4 - owner * slice]);
      *(csize == 1 ? slot : cluster.map_shared_rank(slot, owner)) = sum;
    }
    if (csize > 1) {
      cluster_sync();
    } else {
      __syncthreads();
    }
    // the owner's columns of the cluster's partial, ranks in order, to the
    // S tile's half of `part` (two halves: a block may still read the
    // previous S tile's while another writes this one)
    float* half_part = part + static_cast<size_t>((s0 / S_TILE) % 2) * clusters * plane;
    for (int v = t; v < S_TILE * (own / 4); v += threads) {
      const int s = v / (own / 4);
      const int j = (v - s * (own / 4)) * 4;
      float4 sum = *reinterpret_cast<const float4*>(&recv[s * slice + j]);
      for (int k = 1; k < csize; ++k) {
        add4(sum, *reinterpret_cast<const float4*>(&recv[(k * S_TILE + s) * slice + j]));
      }
      __stcg(reinterpret_cast<float4*>(
                 &half_part[static_cast<size_t>(cluster_id) * plane + s * Dout + own_begin + j]),
             sum);
    }
    grid_barrier(barrier);
    // the S tile's output: each block adds the cluster partials of its
    // share of the 4-column vectors.  tpv consecutive lanes (a power of two
    // up to 32) share a vector: lane l adds partials l, l + tpv, ... in
    // order, then a shuffle tree (offsets tpv/2, ..., 1) gives lane 0 the sum
    const int total4 = min(S_TILE, S - s0) * n4;
    const int per = (total4 + gridDim.x - 1) / gridDim.x;
    const int v0 = tile * per;
    for (int base = 0; base < per; base += threads / tpv) {  // uniform over the block
      const int vb = base + t / tpv;
      const int v = v0 + vb;
      const bool ok = vb < per && v < total4;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {  // eight loads in flight, then their sums in order
        for (int k0 = t % tpv; k0 < clusters; k0 += 8 * tpv) {
          float4 p[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = k0 + j * tpv;
            p[j] = k < clusters ? __ldcg(reinterpret_cast<const float4*>(half_part + k * plane) + v)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) add4(sum, p[j]);
        }
      }
      for (int o = tpv / 2; o >= 1; o >>= 1) {
        sum.x += __shfl_down_sync(FULL, sum.x, o, tpv);
        sum.y += __shfl_down_sync(FULL, sum.y, o, tpv);
        sum.z += __shfl_down_sync(FULL, sum.z, o, tpv);
        sum.w += __shfl_down_sync(FULL, sum.w, o, tpv);
      }
      if (ok && t % tpv == 0) {
        const float4 sc = s0 == 0 && base == 0
                              ? sc2_first
                              : __ldg(reinterpret_cast<const float4*>(s2) + v % n4);
        __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x * sc.x, sum.y * sc.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z * sc.z, sum.w * sc.w);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(y + static_cast<size_t>(s0) * Dout + 4 * v) = packed;
      }
    }
  }
}

// The most clusters of `cluster` blocks of `threads` threads and `smem`
// bytes the card holds at once, asked once per instantiation and footprint
template <int S_TILE>
cudaError_t max_clusters(int cluster, int threads, int smem, int* out) {
  struct Entry {
    int cluster, threads, smem, clusters;
  };
  static Entry cache[64];
  static int cached = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < cached; ++i) {
    if (cache[i].cluster == cluster && cache[i].threads == threads && cache[i].smem == smem) {
      *out = cache[i].clusters;
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(out, qmlp_cluster<S_TILE>, &config);
  if (err != cudaSuccess) return err;
  if (cached < 64) cache[cached++] = {cluster, threads, smem, *out};
  return cudaSuccess;
}

template <int S_TILE>
cudaError_t launch(const void* x, const void* q13, const void* s13, const void* q2,
                   const void* s2, void* y, void* part, void* barrier, int S, int D, int F,
                   int Dout, int BI, int cluster, int threads, int prefetch_rows, int smem,
                   cudaStream_t stream) {
  auto kernel = qmlp_cluster<S_TILE>;
  // smem may exceed the layout's total, so that no more blocks share an SM
  // than the grid needs (clusters are then spread over the SMs)
  const Layout L = layout(S, BI, Dout, threads, cluster, prefetch_rows, S_TILE);
  if (L.total > smem || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  // the shared-memory and cluster-size opt-ins, once per instantiation (on
  // its first call, before any graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // one wave: every cluster of the grid resident at once
  const int tiles = F / BI;
  int fit = 0;
  const cudaError_t occ = max_clusters<S_TILE>(cluster, threads, smem, &fit);
  if (occ != cudaSuccess) return occ;
  if (tiles / cluster > fit) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q13),
      static_cast<const float*>(s13), static_cast<const int8_t*>(q2),
      static_cast<const float*>(s2), static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      static_cast<unsigned*>(barrier), S, D, F, Dout, BI, prefetch_rows);
  const cudaError_t last = cudaGetLastError();  // read and clear
  return err != cudaSuccess ? err : last;
}

}  // namespace

// x (S, D) bf16, q13 (D, 2F) int8, s13 (2F,) f32, q2 (F, Dout) int8, s2
// (Dout,) f32, y (S, Dout) bf16, all contiguous, q13, q2 and s2 16-byte
// aligned; part (F / block_i / cluster, s_tile, Dout) f32, twice that when
// S has more than one S tile, and barrier (one 32-bit word) persist
// between calls and are not shared with a call that may run at the same
// time.  1 <= S <= 64, D % 16 == 0, Dout % 8 == 0; block_i in {16, 32, 64,
// 128, 256} divides F; cluster in 1..16 divides F / block_i; threads a
// multiple of 32 and of block_i, up to 512; prefetch_rows even and <=
// block_i; smem (bytes of dynamic shared memory) at least the layout's and
// at most 227 KB; s_tile in {1, 2, 4}.  Launches on `stream` and returns
// the launch's CUDA error (0 on success; cudaErrorCooperativeLaunchTooLarge
// when the grid's clusters would not all be resident at once).
extern "C" int quant_mlp(const void* x, const void* q13, const void* s13, const void* q2,
                         const void* s2, void* y, void* part, void* barrier, int S, int D,
                         int F, int Dout, int block_i, int cluster, int threads,
                         int prefetch_rows, int smem, int s_tile, void* stream) {
  const bool bi_ok = block_i == 16 || block_i == 32 || block_i == 64 || block_i == 128 ||
                     block_i == 256;
  if (S <= 0 || S > MAX_S || D <= 0 || D % 16 != 0 || F <= 0 || Dout <= 0 || Dout % 8 != 0 ||
      !bi_ok || F % block_i != 0 || cluster < 1 || cluster > MAX_CLUSTER ||
      (F / block_i) % cluster != 0 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || threads % block_i != 0 || prefetch_rows < 0 || prefetch_rows > block_i ||
      prefetch_rows % 2 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s_tile) {
    case 1: return launch<1>(x, q13, s13, q2, s2, y, part, barrier, S, D, F, Dout, block_i,
                             cluster, threads, prefetch_rows, smem, st);
    case 2: return launch<2>(x, q13, s13, q2, s2, y, part, barrier, S, D, F, Dout, block_i,
                             cluster, threads, prefetch_rows, smem, st);
    case 4: return launch<4>(x, q13, s13, q2, s2, y, part, barrier, S, D, F, Dout, block_i,
                             cluster, threads, prefetch_rows, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
