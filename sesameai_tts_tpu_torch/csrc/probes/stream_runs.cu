// Device-memory read rate of a column-tiled int8 matrix, by the length of
// the contiguous run each block reads from a row.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/stream_runs sesameai_tts_tpu_torch/csrc/probes/stream_runs.cu
//   build/stream_runs
//
// A (D, 2F) int8 matrix, the shape of quant_mlp.cu's q13, is read once by
// 256 blocks of 256 threads (two per SM), each thread 16 bytes per row
// with 16 rows in flight, as quant_mlp.cu's phase 1 does.  Block b reads
// two runs of `run` contiguous bytes from each of its rows, F apart (a w1
// and a w3 column tile): F / run tiles, each tile's rows cut into
// 256 * run / F equal ranges; run = 32 is a 32-column tile of whole rows.
// Prints GB/s per run length (mean of 20 launches, each over a copy that
// is not in L2), for the decoder's and the backbone's q13.
// Not part of the package's build (ops/kernels.py builds csrc/*.cu only).
#include <cuda_runtime.h>
#include <cstdio>
#include <stdint.h>

__global__ void __launch_bounds__(256) k_read(const int8_t* __restrict__ q, int D, int W, int run,
                                              int splits, unsigned* sink) {
  const int tile = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const int tpr = 2 * run / 16;
  const int step = blockDim.x / tpr;
  const int rows = D / splits;
  const int r_begin = split * rows;
  const int c = threadIdx.x % tpr;
  const int col = (c < tpr / 2 ? 0 : W / 2 - run) + tile * run + c * 16;
  uint32_t acc = 0;
  for (int r0 = r_begin + threadIdx.x / tpr; r0 < r_begin + rows; r0 += 16 * step) {
    uint4 w[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int r = r0 + u * step;
      w[u] = r < r_begin + rows
                 ? __ldg(reinterpret_cast<const uint4*>(q + static_cast<size_t>(r) * W + col))
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) acc ^= w[u].x ^ w[u].y ^ w[u].z ^ w[u].w;
  }
  if (acc == 0x12345678u) sink[0] = acc;
}

int main() {
  unsigned* sink;
  cudaMalloc(&sink, 4);
  const int shapes[2][2] = {{1024, 16384}, {2048, 16384}};  // D, 2F
  for (const auto& shape : shapes) {
    const int D = shape[0], W = shape[1];
    const size_t bytes = static_cast<size_t>(D) * W;
    const int copies = static_cast<int>(200e6 / bytes) + 1;
    int8_t* q;
    cudaMalloc(&q, bytes * copies);
    cudaMemset(q, 1, bytes * copies);
    for (int run = 32; run <= 512; run *= 2) {
      const int tiles = W / 2 / run;
      const int splits = 256 / tiles;
      if (splits < 1 || D % splits) continue;
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      for (int i = 0; i < copies; ++i) k_read<<<256, 256>>>(q + (i % copies) * bytes, D, W, run, splits, sink);
      cudaEventRecord(a);
      const int n = 20;
      for (int i = 0; i < n; ++i) k_read<<<256, 256>>>(q + (i % copies) * bytes, D, W, run, splits, sink);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms = 0;
      cudaEventElapsedTime(&ms, a, b);
      printf("D %d x %d: run %3d B (%d tiles x %d splits): %.2f us per read, %.0f GB/s\n", D, W,
             run, tiles, splits, ms * 1e3 / n, bytes * n / (ms * 1e-3) / 1e9);
    }
    cudaFree(q);
  }
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
