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
// from the unfused kernels (ops/quant.py::quant_mlp_cluster_plain and
// quant_mlp_mma_plain state each route's order of sums).
//
// Two routes, chosen by ops/quant.py from S alone (quant_route):
//  * S = 1 (single-stream decode): `qmlp_cluster`, on the CUDA cores;
//  * 2 <= S <= 64 (a serving pool's slots, a mesh prompt's prefill rows):
//    `qmlp_mma`, on the tensor cores.
//
// What bounds it: the int8 weight bytes, 2*D*F + F*Dout per call (50.3 MB
// for the backbone's MLP, 25.2 MB for the decoder's); x, the scales and y
// are a few KB.  Below the bytes, the chain of latencies after the last
// weight byte: the w2 product and the sums across blocks.  On the CUDA
// cores a product does 2*S FLOP per weight byte, so from S = 2 on the
// instruction stream sets the pace; on the tensor cores S = 64 (128 FLOP a
// byte) is bound by the rate mma.sync reaches (~100 TFLOP/s here).
//
// The S = 1 route (qmlp_cluster):
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
//    h is ready.  Where shared memory is short, only the first
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
//    fixed order;
//  * phase 2 (w2): each thread owns 8 output columns of a slice of the
//    tile's rows, reads them from shared memory 8 bytes a row, and the
//    slices are added in shared memory in a fixed order;
//  * the w2 partials: the blocks of a thread-block cluster (up to 16,
//    non-portable above 8) reduce-scatter theirs through distributed
//    shared memory (each block leaves its partial of every 4-column vector
//    in the vector's owner block, one cluster barrier, the owner adds them
//    in rank order) and each owner writes its columns of the cluster's
//    partial to a small persistent buffer.  A grid barrier follows, and
//    then every block adds the cluster partials of its share of the output
//    in a fixed order, applies s2 and writes bf16 y.
//
// The 2 <= S <= 64 route (qmlp_mma) computes in one pass over the weights
// for all S rows: w13 and w2 are each read from device memory once a call,
// in one launch, with no loop over S tiles.  Carrying S tiles over would
// read the w1/w3 tiles again per tile and run phase 2 and a grid barrier
// per tile; and a phase-2 partial of every output per intermediate tile
// (S x Dout f32: 512 KB at S = 64 and Dout 2048) is more than a block's
// shared memory and, over the grid, more bytes than the weights.  So the
// two products are tiled apart, around two grid barriers:
//  * grid F / BI blocks of 8 warps, one an SM (ops/quant.py::_qmlp_mma_plan
//    asks for enough shared memory that no second block fits), all
//    resident at once (the launch checks the occupancy and refuses a
//    larger grid);
//  * phase 1, block b: x @ w1 and x @ w3 over all of D for intermediate
//    columns [b * BI, +BI), on mma.sync.m16n8k16 bf16 -> f32 with the
//    weight as A (16 columns an m-tile) and x as B (8 rows of S an n-tile);
//    a lane takes the same 4 columns of w1 and of w3, so it holds a1 and a3
//    of the same columns, for NT n-tiles of x (up to 8: 64 rows); then the
//    scales and h = bf16(bf16(silu(bf16(a1))) * bf16(a3)) to a persistent
//    (S, F) buffer (2*S*F bytes, in L2);
//  * grid barrier; phase 2, block b: h @ w2 over a tile of `cols` columns
//    of Dout and `rows` rows of F (the blocks' splits of F), the same way
//    with the w2 tile as A and h as B; the block's partial of its tile goes
//    to a persistent (splits, S, Dout) f32 buffer;
//  * grid barrier; every block adds the splits' partials of its share of
//    y in split order, applies s2 and writes bf16.
// The streaming: per-thread loads, cp.async or a bulk copy a row moved
// the weights at ~10 GB/s an SM or less (a third of the card's rate;
// csrc/probes/qmlp_mma_stamps.py), so every weight stage is one tensor copy
// (TMA): a tensor map over q13 as (F columns, 2
// halves, D rows), a box the tile's columns of w1 and of w3 over kc rows,
// and one over q2 as (Dout, F), a box `cols` columns over kc rows, each
// completed on the stage's mbarrier.  A ring of NSTAGE stages in shared
// memory keeps five in flight; x (phase 1) or h (phase 2) rides in the same
// stage by cp.async.  The boxes are swizzled over their inner bytes, so
// that a lane's A loads (4 bytes of rows 2t, 2t + 1, 2t + 8, 2t + 9 of a
// k-step, the fragment's k pairs) meet no bank conflict at 128 bytes (two
// ways at 64); int8 -> bf16 by PRMT + FADD (the f32 value of an integer of
// at most 8 bits is exact, and its top half is its bf16).  Warps: along the
// columns (32 each), the rest along the reduction, each over all the
// n-tiles of x (so a weight is converted once), their sums added in warp
// order in shared memory.  The traffic beside the weights: h written once
// and read by Dout / cols column tiles, the partials written once and read
// once, all in L2.  Where q2's rows are not 16-byte aligned (Dout % 16 !=
// 0) the map cannot describe them, and phase 2 stages w2 by 8-byte cp.async.
//
// Both routes: a grid barrier is one word whose top bit flips when every
// block has arrived, as in cooperative groups' grid sync: no reset, safe
// to replay and to use twice in a launch.  No atomics on values: the
// result is bit-equal from call to call and in a CUDA-graph replay, and
// the launch allocates nothing (the wrapper owns the buffers and the
// barrier word, one set per device and stream).  A wait on an mbarrier or
// a grid barrier that lasts 2 s traps, so a fault ends the launch with an
// error instead of hanging the card.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (encoded by libcuda's function, found through the runtime)
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
constexpr int SMEM_LIMIT = 232448;  // shared memory one block may use (227 KB)
constexpr int HEADER = 16;          // the mbarrier (8 bytes), padded
constexpr int COPY_CHUNK = 16384;   // bytes per bulk copy of the w2 tile
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets of the dynamic shared memory of qmlp_cluster;
// ops/quant.py::_qmlp_smem_bytes mirrors `total`.
struct Layout {
  int w2s, hs, scratch, recv, total;
};

__host__ __device__ inline Layout layout(int BI, int Dout, int threads, int cluster,
                                         int prefetch_rows) {
  const int cg2 = Dout / VEC2;
  const int rg2 = min(max(1, threads / cg2), BI);
  const int slice = (Dout / 4 + cluster - 1) / cluster * 4;  // columns per owner
  const int p1 = threads / 32 * 2 * BI * 4;                   // phase-1 warp sums
  const int p2 = rg2 * Dout * 4;                              // phase-2 slice sums
  Layout l;
  l.w2s = HEADER;
  l.hs = l.w2s + align16(prefetch_rows * Dout);
  l.scratch = l.hs + BI * 4;
  l.recv = l.scratch + (p1 > p2 ? p1 : p2);
  l.total = l.recv + cluster * slice * 4;
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
// and x at those rows, rounded to bf16 values
template <int U>
__device__ __forceinline__ void fetch13(uint4 (&w)[U], float (&xv)[U],
                                        const __nv_bfloat16* __restrict__ x,
                                        const int8_t* __restrict__ q13, int r0, int step, int D,
                                        size_t ld13, int col) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = r0 + u * step;
    const bool ok = r < D;
    w[u] = ok ? __ldg(reinterpret_cast<const uint4*>(q13 + static_cast<size_t>(r) * ld13 + col))
              : make_uint4(0, 0, 0, 0);
    xv[u] = ok ? __bfloat162float(x[r]) : 0.f;
  }
}

// acc[0..7] += h[r] * w2[r][0..7] over rows [r_begin, r_end) of a w2 tile
// whose rows are `ld` bytes apart, from shared (SHARED) or global memory
template <bool SHARED>
__device__ __forceinline__ void rows2(float (&acc)[VEC2], const int8_t* w, int ld,
                                      const float* hs, int r_begin, int r_end) {
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
      const float hv = hs[r + u];
#pragma unroll
      for (int e = 0; e < VEC2; ++e) acc[e] = fmaf(hv, wf[e], acc[e]);
    }
  }
  for (; r < r_end; ++r) {
    const uint2* p = reinterpret_cast<const uint2*>(w + static_cast<size_t>(r) * ld);
    const uint2 wv = SHARED ? *p : __ldg(p);
    const uint32_t lo = wv.x ^ 0x80808080u, hi = wv.y ^ 0x80808080u;
    const float wf[VEC2] = {int8_value<0>(lo), int8_value<1>(lo), int8_value<2>(lo),
                            int8_value<3>(lo), int8_value<0>(hi), int8_value<1>(hi),
                            int8_value<2>(hi), int8_value<3>(hi)};
    const float hv = hs[r];
#pragma unroll
    for (int e = 0; e < VEC2; ++e) acc[e] = fmaf(hv, wf[e], acc[e]);
  }
}

// Block `tile` of a grid of F / BI blocks in clusters along x, all
// resident at once, for one row of x.  `part` holds (F / BI / cluster,
// Dout) f32 cluster partials; `barrier` is the grid barrier's word.
__global__ void __launch_bounds__(MAX_THREADS)
qmlp_cluster(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q13,
             const float* __restrict__ s13, const int8_t* __restrict__ q2,
             const float* __restrict__ s2, __nv_bfloat16* __restrict__ y,
             float* __restrict__ part, unsigned* __restrict__ barrier, int D, int F, int Dout,
             int BI, int prefetch_rows) {
  constexpr int U = 8;  // rows in flight per thread (x2)
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
  const Layout L = layout(BI, Dout, threads, csize, prefetch_rows);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int8_t* w2s = reinterpret_cast<int8_t*>(smem + L.w2s);
  float* hs = reinterpret_cast<float*>(smem + L.hs);          // [BI]
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  float* recv = reinterpret_cast<float*>(smem + L.recv);      // [cluster][slice]
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
  // follows the weights: s13 of its h column (threads % BI == 0, so the
  // thread's column is t % BI) and s2 of its first output vector (the first
  // pass of the grid's sum)
  const float sc1 = __ldg(s13 + tile * BI + t % BI);
  const float sc3 = __ldg(s13 + F + tile * BI + t % BI);
  const int n4 = Dout / 4;
  const int clusters = gridDim.x / csize;
  int tpv = 1;  // lanes per output vector in the grid's sum
  while (tpv < clusters && tpv < 32) tpv *= 2;
  float4 sc2_first = make_float4(0.f, 0.f, 0.f, 0.f);
  {
    const int per = (n4 + gridDim.x - 1) / gridDim.x;
    const int v = tile * per + t / tpv;
    if (t / tpv < per && v < n4) sc2_first = __ldg(reinterpret_cast<const float4*>(s2) + v);
  }

  // ---- phase 1: the w1 and w3 column tiles --------------------------------
  const int tpr = 2 * BI / VEC;  // threads per tile row (divides 32)
  const int step = threads / tpr;
  const int c = t % tpr;
  const int half = tpr / 2;
  const int col = c < half ? tile * BI + c * VEC : F + tile * BI + (c - half) * VEC;
  const size_t ld13 = static_cast<size_t>(2) * F;
  {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    uint4 wa[U];
    float xa[U];
    int r0 = t / tpr;
    fetch13<U>(wa, xa, x, q13, r0, step, D, ld13, col);
    for (; r0 < D; r0 += U * step) {
      uint4 wb[U];
      float xb[U];
      fetch13<U>(wb, xb, x, q13, r0 + U * step, step, D, ld13, col);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t* words = reinterpret_cast<const uint32_t*>(&wa[u]);
#pragma unroll
        for (int k = 0; k < VEC / 4; ++k) {
          const uint32_t fl = words[k] ^ 0x80808080u;
          const float wf[4] = {int8_value<0>(fl), int8_value<1>(fl), int8_value<2>(fl),
                               int8_value<3>(fl)};
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[4 * k + i] = fmaf(xa[u], wf[i], acc[4 * k + i]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        wa[u] = wb[u];
        xa[u] = xb[u];
      }
    }
    // the warp's row groups (lanes tpr apart) by a butterfly, then the
    // block's warps in shared memory, in warp order
    for (int o = 16; o >= tpr; o >>= 1) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(FULL, acc[e], o);
    }
    if (lane < tpr) {  // w1 columns [0, BI), w3 columns [BI, 2 BI) of the tile
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(&scratch[warp * 2 * BI + lane * VEC + e]) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      }
    }
    __syncthreads();
    for (int j = t; j < BI; j += threads) {
      float a1 = 0.f, a3 = 0.f;
      for (int w = 0; w < warps; ++w) {
        a1 += scratch[w * 2 * BI + j];
        a3 += scratch[w * 2 * BI + BI + j];
      }
      a1 *= sc1;
      a3 *= sc3;
      const float g = bf16_round(a1);
      const float act = bf16_round(g / (1.f + expf(-g)));
      hs[j] = bf16_round(act * bf16_round(a3));
    }
    __syncthreads();  // h is complete; scratch is free again
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
  for (int item = t; item < items; item += threads) {
    const int c2 = item % cg2;
    const int g = item / cg2;
    const int rb = g * per2;
    const int re = min(BI, rb + per2);
    float acc2[VEC2];
#pragma unroll
    for (int e = 0; e < VEC2; ++e) acc2[e] = 0.f;
    const int split = max(rb, min(re, prefetch_rows));  // rows below it are in shared memory
    rows2<true>(acc2, w2s + c2 * VEC2, Dout, hs, rb, split);
    rows2<false>(acc2, q2t + c2 * VEC2, Dout, hs, split, re);
    float* out = &scratch[g * Dout + c2 * VEC2];
    *reinterpret_cast<float4*>(out) = make_float4(acc2[0], acc2[1], acc2[2], acc2[3]);
    *reinterpret_cast<float4*>(out + 4) = make_float4(acc2[4], acc2[5], acc2[6], acc2[7]);
  }
  __syncthreads();
  // every block of the cluster has started, so recv may be written
  if (csize > 1) cluster_wait();
  // the block's partial of each 4-column vector: its slices in order, into
  // the owner's recv at slot `rank`
  for (int v = t; v < n4; v += threads) {
    const int col4 = v * 4;
    float4 sum = *reinterpret_cast<const float4*>(&scratch[col4]);
    for (int g = 1; g < rg2; ++g) {
      add4(sum, *reinterpret_cast<const float4*>(&scratch[g * Dout + col4]));
    }
    const int owner = col4 / slice;
    float4* slot = reinterpret_cast<float4*>(&recv[rank * slice + col4 - owner * slice]);
    *(csize == 1 ? slot : cluster.map_shared_rank(slot, owner)) = sum;
  }
  if (csize > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  // the owner's columns of the cluster's partial, ranks in order
  for (int v = t; v < own / 4; v += threads) {
    const int j = v * 4;
    float4 sum = *reinterpret_cast<const float4*>(&recv[j]);
    for (int k = 1; k < csize; ++k) {
      add4(sum, *reinterpret_cast<const float4*>(&recv[k * slice + j]));
    }
    __stcg(reinterpret_cast<float4*>(&part[static_cast<size_t>(cluster_id) * Dout + own_begin + j]),
           sum);
  }
  grid_barrier(barrier);
  // the output: each block adds the cluster partials of its share of the
  // 4-column vectors.  tpv consecutive lanes (a power of two up to 32)
  // share a vector: lane l adds partials l, l + tpv, ... in order, then a
  // shuffle tree (offsets tpv/2, ..., 1) gives lane 0 the sum
  const int per = (n4 + gridDim.x - 1) / gridDim.x;
  const int v0 = tile * per;
  for (int base = 0; base < per; base += threads / tpv) {  // uniform over the block
    const int vb = base + t / tpv;
    const int v = v0 + vb;
    const bool ok = vb < per && v < n4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {  // eight loads in flight, then their sums in order
      for (int k0 = t % tpv; k0 < clusters; k0 += 8 * tpv) {
        float4 p[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + j * tpv;
          p[j] = k < clusters ? __ldcg(reinterpret_cast<const float4*>(part + k * Dout) + v)
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
      const float4 sc = base == 0 ? sc2_first : __ldg(reinterpret_cast<const float4*>(s2) + v);
      __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x * sc.x, sum.y * sc.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z * sc.z, sum.w * sc.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(y + 4 * v) = packed;
    }
  }
}

// The most clusters of `cluster` blocks of `threads` threads and `smem`
// bytes the card holds at once, asked once per footprint
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
  const cudaError_t err = cudaOccupancyMaxActiveClusters(out, qmlp_cluster, &config);
  if (err != cudaSuccess) return err;
  if (cached < 64) cache[cached++] = {cluster, threads, smem, *out};
  return cudaSuccess;
}

cudaError_t launch(const void* x, const void* q13, const void* s13, const void* q2,
                   const void* s2, void* y, void* part, void* barrier, int D, int F, int Dout,
                   int BI, int cluster, int threads, int prefetch_rows, int smem,
                   cudaStream_t stream) {
  auto kernel = qmlp_cluster;
  // smem may exceed the layout's total, so that no more blocks share an SM
  // than the grid needs (clusters are then spread over the SMs)
  const Layout L = layout(BI, Dout, threads, cluster, prefetch_rows);
  if (L.total > smem || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  // the shared-memory and cluster-size opt-ins, once (on the first call,
  // before any graph capture)
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
  const cudaError_t occ = max_clusters(cluster, threads, smem, &fit);
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
      static_cast<unsigned*>(barrier), D, F, Dout, BI, prefetch_rows);
  const cudaError_t last = cudaGetLastError();  // read and clear
  return err != cudaSuccess ? err : last;
}

// ---------------------------------------------------------------------------
// The tensor-core route, 2 <= S <= 64
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int NSTAGE = 6;        // stages of the shared-memory ring
constexpr int MMA_HEADER = 64;   // the stages' mbarriers
constexpr int SWIZZLE = 1024;    // the swizzles' period, and a stage's alignment

// a stage's rows of the activations (x or h) are x_stride(kc) bf16 apart:
// 2 * stride = 16 (mod 128) bytes, so the 4-byte B loads of a warp (8 rows
// x 4 lanes) lie in distinct banks
__host__ __device__ constexpr int x_stride(int kc) { return (kc + 63) / 64 * 64 + 8; }
__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
// one stage: kc weight rows of rb bytes (dense, as the tensor copy writes
// them, swizzled), then sp activation rows of kc values
__host__ __device__ constexpr int stage_bytes(int kc, int rb, int sp) {
  return kc * rb + round_up(sp * x_stride(kc) * 2, SWIZZLE);
}

// Dynamic shared memory of qmlp_mma (ops/quant.py::_qmlp_mma_smem mirrors
// it): the stages' mbarriers, room to align the region to SWIZZLE, then one
// region that each phase uses first as its ring of NSTAGE stages and then
// for its warps' f32 sums.
__host__ __device__ inline int mma_smem(int nt, int pass_cols, int cols, int kc1, int kc2) {
  const int sp = 8 * nt;
  const int wk1 = MMA_WARPS / (pass_cols / 32);
  const int wk2 = MMA_WARPS / (cols / 64);
  const int ring1 = NSTAGE * stage_bytes(kc1, 2 * pass_cols, sp);
  const int sums1 = wk1 * sp * 2 * pass_cols * 4;
  const int ring2 = NSTAGE * stage_bytes(kc2, cols, sp);
  const int sums2 = wk2 * sp * cols * 4;
  const int p1 = ring1 > sums1 ? ring1 : sums1;
  const int p2 = ring2 > sums2 ? ring2 : sums2;
  return MMA_HEADER + SWIZZLE + (p1 > p2 ? p1 : p2);
}

// The byte of a stage's weight rows where the tensor copy puts logical byte
// `l` (the box row-major): a swizzle of span 32 * 2^k bytes (the box's inner
// bytes) moves each 16-byte chunk within its span by the chunk's 128-byte
// line, mask = span / 16 - 1.  At 128 bytes (phase 2's 128-column tiles)
// the rows 2t, 2t + 1 (+8) of a k-step that lanes t = 0..3 read at one
// column lie in distinct banks; at 64 (phase 1's rows of w1 and w3, 64
// columns each) two of them share a bank.
__device__ __forceinline__ int swizzled(int l, int mask) { return l ^ (((l >> 7) & mask) << 4); }

// one box of a tensor map into shared memory, completed on `bar`
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int rank, uint64_t* bar) {
  if (rank == 3) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
        : "memory");
  }
}

// global -> shared, 16 bytes, zero-filled when !valid (src is then not
// read), bypassing L1
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// byte `byte` of `flipped` (b + 128) as the f32 b (see int8_value)
__device__ __forceinline__ float int8_f32(uint32_t flipped, int byte) {
  return __int_as_float(__byte_perm(flipped, 0x4B000000u, 0x7540u | byte)) - 8388736.f;
}
// two f32 integers of at most 8 bits as a bf16 pair (lo in the low half):
// their top halves, which are their bf16 values exactly
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The weight side of a reduction: rows [0, k_rows) of two halves of hw
// bytes each, the second h_off bytes after the first in a source row, rows
// ld bytes apart, `valid` bytes of a row (the halves end to end) real, the
// rest zeros.  With a tensor map (`map`, rank 2 or 3) a stage is one box at
// coordinates (x0, row) or (x0, 0, row): rows of 2 * hw bytes; else (q2 rows
// that are not 16-byte aligned) 8-byte cp.async into the same layout.
struct WeightSide {
  const CUtensorMap* map;
  int rank, x0, row0, swz;  // swz: the swizzle's mask
  const int8_t* src;
  size_t ld;
  int h_off, hw, valid, k_rows;
};

// rows [r0, r0 + n) of the weight side into dst (dense rows of 2 * hw
// bytes, swizzled with mask w.swz): one tensor copy by thread 0, completed
// on `bar`, or one 8-byte cp.async a thread per 8 bytes, zero past k_rows
// and past `valid`
__device__ __forceinline__ void stage_weights(int8_t* dst, const WeightSide& w, int r0, int n,
                                              uint64_t* bar) {
  const int rb = 2 * w.hw;
  if (w.map != nullptr) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, static_cast<uint32_t>(n * rb));
      tensor_copy(dst, w.map, w.x0, w.rank == 3 ? 0 : w.row0 + r0, w.row0 + r0, w.rank, bar);
    }
    return;
  }
  const int per_row = rb / 8;
  for (int i = threadIdx.x; i < n * per_row; i += MMA_THREADS) {
    const int r = i / per_row;
    const int pos = (i - r * per_row) * 8;  // byte of the row
    const int h = pos >= w.hw;
    const bool ok = r0 + r < w.k_rows && pos < w.valid;
    const int8_t* from =
        ok ? w.src + static_cast<size_t>(r0 + r) * w.ld + h * w.h_off + pos - h * w.hw : w.src;
    const int8_t* to = dst + swizzled(r * rb + pos, w.swz);
    cp_async8(static_cast<uint32_t>(__cvta_generic_to_shared(to)), from, ok);
  }
}

// rows [0, sp) x columns [c0, c0 + 8 * chunks) of src (bf16, rows ld
// apart) into xs (row stride rs) by the block's threads: zero at rows >= S
// and at columns >= c0 + valid.  16-byte aligned rows go by cp.async,
// anything else one value at a time.  src may have been written by other
// blocks of this launch before a grid barrier: cp.async.cg reads it from
// L2, and the scalar path with ld.global.cg.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* xs, int rs,
                                           const __nv_bfloat16* __restrict__ src, int S, int ld,
                                           int sp, int c0, int valid, int chunks) {
  const bool vec = ld % 8 == 0 && c0 % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int i = threadIdx.x; i < sp * chunks; i += MMA_THREADS) {
    const int n = i / chunks;
    const int c = 8 * (i - n * chunks);
    __nv_bfloat16* dst = xs + n * rs + c;
    const __nv_bfloat16* from = src + static_cast<size_t>(n) * ld + c0 + c;
    if (vec && c + 8 <= valid) {
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), n < S ? from : src, n < S);
    } else {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = n < S && c + e < valid
                   ? __bfloat162float(__ushort_as_bfloat16(
                         __ldcg(reinterpret_cast<const unsigned short*>(from + e))))
                   : 0.f;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                  pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    }
  }
}

// One warp's products over the rows of a reduction, the weight as A (mma's
// M: 16 columns an m-tile) and the activations as B (mma's N: 8 rows an
// n-tile, NT n-tiles): for each of the two halves h of the weight side (w1
// and w3 in phase 1, the two halves of the column tile in phase 2) and each
// of the lane's two m-tiles j, acc[h][j][n] += A_h,j (16 x 16) B_n.  The
// block stages both operands through a ring of NSTAGE stages of kc rows in
// shared memory (`ring`), NSTAGE - 1 stages in flight; every warp of the
// block calls this together.  The warp takes every wk_n-th 16-row k-step
// from the wk-th.  Lane (gid, t) reads rows 2t, 2t + 1, 2t + 8, 2t + 9 of a
// k-step (the fragment's k pairs) and 4 neighbouring columns at byte `col`
// of each half (4-byte shared loads): column 2j is row gid of m-tile j and
// column 2j + 1 row gid + 8; the B fragment takes the same rows of the
// staged activations (two 4-byte shared loads).  int8 -> bf16 by PRMT +
// FADD.
template <int NT>
__device__ __forceinline__ void mma_walk(float (&acc)[2][2][NT][4], const WeightSide& w, int col,
                                         const __nv_bfloat16* __restrict__ b, int b_ld, int b_k0,
                                         int S, int wk, int wk_n, int kc, unsigned char* ring,
                                         uint64_t* bars, int& stages) {
  constexpr int sp = 8 * NT;  // rows of the activations staged
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int t = lane & 3;
  const int rb = 2 * w.hw;
  const int xst = x_stride(kc);
  const int a_bytes = kc * rb;
  const int sbytes = stage_bytes(kc, rb, sp);
  const int steps = (w.k_rows + 15) / 16;
  const int chunks = (w.k_rows + kc - 1) / kc;
  const int ku = kc / (16 * wk_n);  // the warp's k-steps a stage
  // the ring's slot and mbarrier phase follow the block's count of stages,
  // which runs on across calls
  const int g0 = stages;
  stages += chunks;

  // the region was last written by this block's threads (generic proxy):
  // order that before the tensor copies (async proxy) write it again
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  auto stage = [&](int c) {
    if (c < chunks) {
      const int slot = (g0 + c) % NSTAGE;
      unsigned char* st = ring + slot * sbytes;
      stage_weights(reinterpret_cast<int8_t*>(st), w, c * kc, kc, bars + slot);
      stage_rows(reinterpret_cast<__nv_bfloat16*>(st + a_bytes), xst, b, S, b_ld, sp,
                 b_k0 + c * kc, min(kc, w.k_rows - c * kc), kc / 8);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) stage(c);
  for (int c = 0; c < chunks; ++c) {
    const int slot = (g0 + c) % NSTAGE;
    cp_async_wait<NSTAGE - 2>();
    if (w.map != nullptr) mbar_wait(bars + slot, static_cast<uint32_t>((g0 + c) / NSTAGE) & 1u);
    __syncthreads();  // stage c is in, and every warp is done with stage c - 1
    stage(c + NSTAGE - 1);
    const unsigned char* st = ring + slot * sbytes;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + a_bytes);
    for (int u = 0; u < ku; ++u) {
      const int k = u * wk_n + wk;  // the k-step within the stage
      if (c * (kc / 16) + k >= steps) break;  // uniform in the warp
      // rows 2t, 2t + 1, 2t + 8, 2t + 9 of the k-step: the fragment's k
      // pairs {2t, 2t+1} and {2t+8, 2t+9}
      uint32_t wv[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = (16 * k + 2 * t + (i & 1) + 8 * (i >> 1)) * rb + col;
        wv[i][0] = *reinterpret_cast<const uint32_t*>(st + swizzled(l, w.swz));
        wv[i][1] = *reinterpret_cast<const uint32_t*>(st + swizzled(l + w.hw, w.swz));
      }
      uint32_t bf[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* xr = xs + (8 * n + gid) * xst + 16 * k + 2 * t;
        bf[n][0] = *reinterpret_cast<const uint32_t*>(xr);
        bf[n][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t fl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) fl[i] = wv[i][h] ^ 0x80808080u;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int byte = 2 * j;
          const uint32_t af[4] = {
              bf16_pair(int8_f32(fl[0], byte), int8_f32(fl[1], byte)),
              bf16_pair(int8_f32(fl[0], byte + 1), int8_f32(fl[1], byte + 1)),
              bf16_pair(int8_f32(fl[2], byte), int8_f32(fl[3], byte)),
              bf16_pair(int8_f32(fl[2], byte + 1), int8_f32(fl[3], byte + 1))};
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_bf16(acc[h][j][n], af, bf[n][0], bf[n][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
}

// The warp's accumulators into sums[wk][8 * NT][width] f32: half h's
// columns start at h * half_width, the lane's at col (its 4 columns), its
// rows at 8n + 2t (+1)
template <int NT>
__device__ __forceinline__ void store_sums(float* sums, const float (&acc)[2][2][NT][4], int wk,
                                           int width, int half_width, int col) {
  constexpr int sp = 8 * NT;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* row = sums + (static_cast<size_t>(wk) * sp + 8 * n + 2 * t + e) * width +
                     h * half_width + col;
        *reinterpret_cast<float4*>(row) = make_float4(acc[h][0][n][e], acc[h][0][n][2 + e],
                                                      acc[h][1][n][e], acc[h][1][n][2 + e]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][2][NT][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n) acc[h][j][n][0] = acc[h][j][n][1] = acc[h][j][n][2] =
                                       acc[h][j][n][3] = 0.f;
}

// One block per intermediate tile of block_i columns, F / block_i blocks
// all resident at once (the launch checks).  Phase 1: x @ w1 and x @ w3
// over all of D for the tile (in passes of pass_cols columns), h to
// `hbuf` (S, F) bf16.  Grid barrier.  Phase 2: block b < col_tiles * splits
// takes column tile b / splits (`cols` columns of Dout) and rows [(b %
// splits) * rows, +rows) of F: h @ w2 over them, its f32 partial to `part`
// (splits, S, Dout).  Grid barrier.  Then every block adds the splits'
// partials of its share of y in split order, applies s2 and writes bf16.
// Warps: pass_cols / 32 (phase 1) or cols / 64 (phase 2) along the
// columns, the rest along the reduction, each over all NT n-tiles of x;
// kc1 / kc2 rows of the reduction a ring stage.
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS, 1)
qmlp_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q13,
         const float* __restrict__ s13, const int8_t* __restrict__ q2,
         const float* __restrict__ s2, __nv_bfloat16* __restrict__ y, float* __restrict__ part,
         __nv_bfloat16* __restrict__ hbuf, unsigned* __restrict__ barrier, int S, int D, int F,
         int Dout, int block_i, int pass_cols, int cols, int rows, int splits, int kc1, int kc2,
         const __grid_constant__ CUtensorMap map13,
         const __grid_constant__ CUtensorMap map2, int use_map2) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one a ring slot
  // the region starts on the swizzles' period (the tensor copies' swizzle
  // is a function of the shared-memory address)
  unsigned char* region =
      smem + MMA_HEADER + (SWIZZLE - (smem_addr(smem) + MMA_HEADER) % SWIZZLE) % SWIZZLE;
  float* sums = reinterpret_cast<float*>(region);
  int stages = 0;  // ring stages this block has filled
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  constexpr int sp = 8 * NT;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NSTAGE; ++i) mbar_init(bars + i, 1);
  }


  // ---- phase 1: h of the block's intermediate columns, pass by pass -------
  {
    const int wc_n = pass_cols / 32;
    const int wk_n = MMA_WARPS / wc_n;
    const int wk = warp % wk_n;
    const int col = warp / wk_n * 32 + gid * 4;
    for (int pc0 = 0; pc0 < block_i; pc0 += pass_cols) {
      const int f0 = b * block_i + pc0;  // the pass's first intermediate column
      float acc[2][2][NT][4];
      zero(acc);
      const WeightSide w{&map13, 3, f0, 0, pass_cols / 16 - 1, q13 + f0, static_cast<size_t>(2) * F,
                         F, pass_cols, 2 * pass_cols, D};
      mma_walk<NT>(acc, w, col, x, D, 0, S, wk, wk_n, kc1, region, bars, stages);
      store_sums<NT>(sums, acc, wk, 2 * pass_cols, pass_cols, col);
      __syncthreads();
      // the warps' sums in warp order, the scales, then h; a thread's
      // column is fixed (pass_cols divides the block's threads)
      const int j = threadIdx.x % pass_cols;
      const float sc1 = __ldg(s13 + f0 + j);
      const float sc3 = __ldg(s13 + F + f0 + j);
      for (int s = threadIdx.x / pass_cols; s < S; s += MMA_THREADS / pass_cols) {
        float a1 = 0.f, a3 = 0.f;
        for (int k = 0; k < wk_n; ++k) {
          a1 += sums[(k * sp + s) * 2 * pass_cols + j];
          a3 += sums[(k * sp + s) * 2 * pass_cols + pass_cols + j];
        }
        const float g = bf16_round(a1 * sc1);
        const float act = bf16_round(g / (1.f + expf(-g)));
        hbuf[static_cast<size_t>(s) * F + f0 + j] =
            __float2bfloat16_rn(act * bf16_round(a3 * sc3));
      }
      __syncthreads();  // the region is the next pass's ring
    }
  }
  grid_barrier(barrier);

  // ---- phase 2: h @ the block's w2 tile -----------------------------------
  const int col_tiles = (Dout + cols - 1) / cols;
  const int ks = b % splits;
  if (b < col_tiles * splits) {
    const int c0 = (b / splits) * cols;
    const int width = min(cols, Dout - c0);  // the tile's valid columns
    const int wk_n = MMA_WARPS / (cols / 64);
    const int wk = warp % wk_n;
    const int col = warp / wk_n * 32 + gid * 4;  // of the tile's first half; + cols / 2 the second
    float acc[2][2][NT][4];
    zero(acc);
    const WeightSide w{use_map2 ? &map2 : nullptr, 2, c0, ks * rows, cols / 16 - 1,
                       q2 + static_cast<size_t>(ks) * rows * Dout + c0, static_cast<size_t>(Dout),
                       cols / 2, cols / 2, width, max(0, min(rows, F - ks * rows))};
    mma_walk<NT>(acc, w, col, hbuf, F, ks * rows, S, wk, wk_n, kc2, region, bars, stages);
    store_sums<NT>(sums, acc, wk, cols, cols / 2, col);
    __syncthreads();
    // the warps' sums in warp order: the block's partial of its tile
    const int w4 = width / 4;
    for (int v = threadIdx.x; v < S * w4; v += MMA_THREADS) {
      const int s = v / w4;
      const int c = (v - s * w4) * 4;
      float4 sum = *reinterpret_cast<const float4*>(&sums[s * cols + c]);
      for (int k = 1; k < wk_n; ++k) {
        add4(sum, *reinterpret_cast<const float4*>(&sums[(k * sp + s) * cols + c]));
      }
      __stcg(reinterpret_cast<float4*>(part + (static_cast<size_t>(ks) * S + s) * Dout + c0 + c),
             sum);
    }
  }
  grid_barrier(barrier);

  // ---- y: the splits' partials in split order, the scale, the cast --------
  const int n4 = Dout / 4;
  const int total4 = S * n4;
  const int per = (total4 + gridDim.x - 1) / gridDim.x;
  const int v_end = min(total4, (b + 1) * per);
  const size_t plane = static_cast<size_t>(S) * Dout;
  for (int v = b * per + threadIdx.x; v < v_end; v += MMA_THREADS) {
    const int s = v / n4;
    const int c = (v - s * n4) * 4;
    const float* p = part + static_cast<size_t>(s) * Dout + c;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < splits; k0 += 8) {  // eight loads in flight, then their sums in order
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        pv[i] = k0 + i < splits ? __ldcg(reinterpret_cast<const float4*>(p + (k0 + i) * plane))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) add4(sum, pv[i]);
    }
    const float4 sc = __ldg(reinterpret_cast<const float4*>(s2 + c));
    __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x * sc.x, sum.y * sc.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z * sc.z, sum.w * sc.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(y + static_cast<size_t>(s) * Dout + c) = packed;
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (no link to libcuda), looked up once
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// An int8 tensor map of `rank` dimensions (dim[0] contiguous, stride[i] the
// bytes between steps of dimension i + 1), boxes of `box` written to shared
// memory densely, swizzled over a span of box[0] bytes (32, 64 or 128);
// zeros past the tensor's edge
cudaError_t encode_map(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dim,
                       const cuuint64_t* stride, const cuuint32_t* box) {
  const CUtensorMapSwizzle swizzle = box[0] == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  static EncodeTiled encode = nullptr;
  static std::mutex lock;
  {
    std::lock_guard<std::mutex> guard(lock);
    if (encode == nullptr) {
      void* fn = nullptr;
      cudaDriverEntryPointQueryResult found;
      const cudaError_t err =
          cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
      if (err != cudaSuccess) return err;
      if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
      encode = reinterpret_cast<EncodeTiled>(fn);
    }
  }
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, static_cast<cuuint32_t>(rank),
                              const_cast<void*>(base), dim, stride, box, ones,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The blocks of `smem` bytes the card holds at once, asked once per
// instantiation, device and footprint
template <int NT>
cudaError_t resident_blocks(int smem, int* out) {
  struct Entry {
    int device, smem, blocks;
  };
  static Entry cache[64];
  static int cached = 0;
  static std::mutex lock;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < cached; ++i) {
    if (cache[i].device == device && cache[i].smem == smem) {
      *out = cache[i].blocks;
      return cudaSuccess;
    }
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qmlp_mma<NT>, MMA_THREADS, smem);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  if (cached < 64) cache[cached++] = {device, smem, *out};
  return cudaSuccess;
}

template <int NT>
cudaError_t launch_mma(const void* x, const void* q13, const void* s13, const void* q2,
                       const void* s2, void* y, void* part, void* hbuf, void* barrier, int S,
                       int D, int F, int Dout, int block_i, int pass_cols, int cols, int rows,
                       int splits, int kc1, int kc2, int smem, cudaStream_t stream) {
  auto kernel = qmlp_mma<NT>;
  if (mma_smem(NT, pass_cols, cols, kc1, kc2) > smem || smem > SMEM_LIMIT) {
    return cudaErrorInvalidValue;
  }
  // the shared-memory opt-in, once per instantiation (on its first call,
  // before any graph capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // one wave: the grid barriers need every block resident at once
  const int blocks = F / block_i;
  int fit = 0;
  const cudaError_t occ = resident_blocks<NT>(smem, &fit);
  if (occ != cudaSuccess) return occ;
  if (blocks > fit) return cudaErrorCooperativeLaunchTooLarge;
  // q13 as (F columns, 2 halves, D rows): a box is pass_cols columns of w1
  // and of w3 over kc1 rows; q2 as (Dout, F): cols columns over kc2 rows
  // (rows that are not 16-byte aligned cannot be described: cp.async then)
  CUtensorMap map13, map2;
  const cuuint64_t dim13[3] = {static_cast<cuuint64_t>(F), 2, static_cast<cuuint64_t>(D)};
  const cuuint64_t stride13[2] = {static_cast<cuuint64_t>(F), 2 * static_cast<cuuint64_t>(F)};
  const cuuint32_t box13[3] = {static_cast<cuuint32_t>(pass_cols), 2,
                               static_cast<cuuint32_t>(kc1)};
  cudaError_t err = encode_map(&map13, 3, q13, dim13, stride13, box13);
  if (err != cudaSuccess) return err;
  const int use_map2 = Dout % 16 == 0;
  if (use_map2) {
    const cuuint64_t dim2[2] = {static_cast<cuuint64_t>(Dout), static_cast<cuuint64_t>(F)};
    const cuuint64_t stride2[1] = {static_cast<cuuint64_t>(Dout)};
    const cuuint32_t box2[2] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(kc2)};
    err = encode_map(&map2, 2, q2, dim2, stride2, box2);
    if (err != cudaSuccess) return err;
  } else {
    map2 = map13;  // not read
  }
  kernel<<<blocks, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q13),
      static_cast<const float*>(s13), static_cast<const int8_t*>(q2),
      static_cast<const float*>(s2), static_cast<__nv_bfloat16*>(y), static_cast<float*>(part),
      static_cast<__nv_bfloat16*>(hbuf), static_cast<unsigned*>(barrier), S, D, F, Dout, block_i,
      pass_cols, cols, rows, splits, kc1, kc2, map13, map2, use_map2);
  return cudaGetLastError();
}

}  // namespace

// The S = 1 route.  x (1, D) bf16, q13 (D, 2F) int8, s13 (2F,) f32, q2 (F,
// Dout) int8, s2 (Dout,) f32, y (1, Dout) bf16, all contiguous, q13, q2
// and s2 16-byte aligned; part (F / block_i / cluster, Dout) f32 and
// barrier (one 32-bit word) persist between calls and are not shared with
// a call that may run at the same time.  D % 16 == 0, Dout % 8 == 0;
// block_i in {16, 32, 64, 128, 256} divides F; cluster in 1..16 divides
// F / block_i; threads a multiple of 32 and of block_i, up to 512;
// prefetch_rows even and <= block_i; smem (bytes of dynamic shared memory)
// at least the layout's and at most 227 KB.  Launches on `stream` and
// returns the launch's CUDA error (0 on success;
// cudaErrorCooperativeLaunchTooLarge when the grid's clusters would not
// all be resident at once).
extern "C" int quant_mlp(const void* x, const void* q13, const void* s13, const void* q2,
                         const void* s2, void* y, void* part, void* barrier, int D, int F,
                         int Dout, int block_i, int cluster, int threads, int prefetch_rows,
                         int smem, void* stream) {
  const bool bi_ok = block_i == 16 || block_i == 32 || block_i == 64 || block_i == 128 ||
                     block_i == 256;
  if (D <= 0 || D % 16 != 0 || F <= 0 || Dout <= 0 || Dout % 8 != 0 || !bi_ok ||
      F % block_i != 0 || cluster < 1 || cluster > MAX_CLUSTER || (F / block_i) % cluster != 0 ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || threads % block_i != 0 ||
      prefetch_rows < 0 || prefetch_rows > block_i || prefetch_rows % 2 != 0) {
    return cudaErrorInvalidValue;
  }
  return launch(x, q13, s13, q2, s2, y, part, barrier, D, F, Dout, block_i, cluster, threads,
                prefetch_rows, smem, static_cast<cudaStream_t>(stream));
}

// The tensor-core route.  x, q13, s13, q2, s2 and y as quant_mlp's, q13,
// q2 and s2 16-byte aligned; part (splits, S, Dout) f32, hbuf (S, F) bf16
// (16-byte aligned) and barrier (one 32-bit word) persist between calls and
// are not shared with a call that may run at the same time.  2 <= S <= 8 *
// nt with nt in {1, 2, 4, 8}; D % 16 == 0, Dout % 8 == 0; block_i a
// multiple of pass_cols that divides F, pass_cols in {32, 64, 128}; cols in
// {64, 128}; rows a multiple of 16, splits * rows >= F and ceil(Dout /
// cols) * splits <= F / block_i; kc1 and kc2 (rows a ring stage holds,
// phase 1 and 2) multiples of 16 * the phase's warps along the reduction,
// at most 256; smem (bytes of dynamic shared memory) at least the layout's
// and at most 227 KB.  Launches on `stream` and returns the launch's CUDA
// error (0 on success; cudaErrorCooperativeLaunchTooLarge when the F /
// block_i blocks would not all be resident at once).
extern "C" int quant_mlp_mma(const void* x, const void* q13, const void* s13, const void* q2,
                             const void* s2, void* y, void* part, void* hbuf, void* barrier,
                             int S, int D, int F, int Dout, int block_i, int pass_cols, int nt,
                             int cols, int rows, int splits, int kc1, int kc2, int smem,
                             void* stream) {
  const bool pc_ok = pass_cols == 32 || pass_cols == 64 || pass_cols == 128;
  const bool cols_ok = cols == 64 || cols == 128;
  const bool nt_ok = nt == 1 || nt == 2 || nt == 4 || nt == 8;
  const int wk1 = pc_ok ? MMA_WARPS / (pass_cols / 32) : 0;
  const int wk2 = cols_ok ? MMA_WARPS / (cols / 64) : 0;
  if (S < 2 || !nt_ok || S > 8 * nt || D <= 0 || D % 16 != 0 || F <= 0 || Dout <= 0 ||
      Dout % 8 != 0 || !pc_ok || !cols_ok || block_i <= 0 || block_i % pass_cols != 0 ||
      F % block_i != 0 || wk1 < 1 || wk2 < 1 || rows <= 0 || rows % 16 != 0 || splits < 1 ||
      static_cast<long>(splits) * rows < F ||
      (Dout + cols - 1) / cols * splits > F / block_i || kc1 <= 0 || kc1 > 256 ||
      kc1 % (16 * wk1) != 0 || kc2 <= 0 || kc2 > 256 || kc2 % (16 * wk2) != 0 ||
      reinterpret_cast<uintptr_t>(q13) % 16 != 0 || reinterpret_cast<uintptr_t>(q2) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(s2) % 16 != 0 || reinterpret_cast<uintptr_t>(hbuf) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
#define QMLP_MMA_CASE(NT)                                                                     \
  case NT:                                                                                    \
    return launch_mma<NT>(x, q13, s13, q2, s2, y, part, hbuf, barrier, S, D, F, Dout, block_i, \
                          pass_cols, cols, rows, splits, kc1, kc2, smem, st);
    QMLP_MMA_CASE(1)
    QMLP_MMA_CASE(2)
    QMLP_MMA_CASE(4)
    QMLP_MMA_CASE(8)
#undef QMLP_MMA_CASE
    default: return cudaErrorInvalidValue;
  }
}
