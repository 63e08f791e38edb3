// Launch and cluster-barrier floor of a small kernel on the card.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/launch_floor sesameai_tts_tpu_torch/csrc/probes/launch_floor.cu
//   build/launch_floor
//
// Prints the mean time per launch, in microseconds, of 200 launches
// captured in one CUDA graph and replayed five times: an empty kernel with
// and without a thread-block-cluster launch attribute, one that passes
// two cluster barriers, and one that reads 1 MB or 16 MB (both stay in
// the 50 MB L2 between launches).  The decode-width kernels of this
// package (quant_matmul.cu, flash_attention.cu) sit a few of these floors
// above their byte bounds; this separates the fixed costs from the work.
// Not part of the package's build (ops/kernels.py builds csrc/*.cu only).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdio>
#include <stdint.h>
namespace cg = cooperative_groups;
__global__ void k_empty(int* p) { if (p && threadIdx.x == 9999) p[0] = 1; }
__global__ void k_csync(int* p) { cg::this_cluster().sync(); cg::this_cluster().sync(); if (p && threadIdx.x == 9999) p[0] = 1; }
__global__ void k_read(const uint4* q, int n, int* p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x; uint32_t acc = 0;
  for (; i < n; i += gridDim.x * blockDim.x) { uint4 v = __ldg(q + i); acc ^= v.x ^ v.y ^ v.z ^ v.w; }
  if (acc == 0x12345678u) p[0] = acc;
}
template <typename K, typename... A>
float timeit(K kernel, int blocks, int cluster, A... args) {
  cudaStream_t s; cudaStreamCreate(&s);
  cudaLaunchConfig_t c = {}; c.gridDim = dim3(blocks); c.blockDim = dim3(128); c.stream = s;
  cudaLaunchAttribute at[1]; at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster > 0 ? cluster : 1; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
  c.attrs = at; c.numAttrs = cluster > 0 ? 1 : 0;
  if (cluster > 8) cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  const int N = 200;
  cudaGraph_t g; cudaGraphExec_t ge;
  cudaStreamBeginCapture(s, cudaStreamCaptureModeGlobal);
  for (int i = 0; i < N; ++i) cudaLaunchKernelEx(&c, kernel, args...);
  cudaStreamEndCapture(s, &g);
  cudaGraphInstantiate(&ge, g, 0);
  cudaGraphLaunch(ge, s); cudaStreamSynchronize(s);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0, s);
  for (int r = 0; r < 5; ++r) cudaGraphLaunch(ge, s);
  cudaEventRecord(e1, s); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  cudaError_t err = cudaGetLastError();
  if (err) printf("err %s\n", cudaGetErrorString(err));
  return ms * 1000.f / (5 * N);
}
int main() {
  int* p = nullptr; cudaMalloc(&p, 4);
  const int n = (1 << 20) / 16; uint4* q; cudaMalloc(&q, 64 << 20);
  for (int cl : {0, 1, 2, 4, 8, 16}) printf("empty 256 blocks cluster %d: %.3f us\n", cl, timeit(k_empty, 256, cl, p));
  for (int cl : {1, 2, 4, 8, 16}) printf("2x cluster.sync 256 blocks cluster %d: %.3f us\n", cl, timeit(k_csync, 256, cl, p));
  printf("empty 2 blocks, no cluster: %.3f us\n", timeit(k_empty, 2, 0, p));
  printf("empty 128 blocks cluster 16: %.3f us\n", timeit(k_empty, 128, 16, p));
  for (int cl : {0, 8, 16}) printf("read 1 MB 256 blocks cluster %d: %.3f us\n", cl, timeit(k_read, 256, cl, (const uint4*)q, n, p));
  for (int cl : {0, 8, 16}) printf("read 16 MB 512 blocks cluster %d: %.3f us\n", cl, timeit(k_read, 512, cl, (const uint4*)q, 16 * n, p));
  return 0;
}
