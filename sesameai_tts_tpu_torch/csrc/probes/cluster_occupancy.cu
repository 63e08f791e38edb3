// How many thread-block clusters the card holds at once, by cluster size,
// block size and shared memory per block.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/cluster_occupancy sesameai_tts_tpu_torch/csrc/probes/cluster_occupancy.cu
//   build/cluster_occupancy
//
// Prints cudaOccupancyMaxActiveClusters for clusters of 1-16 blocks of 256
// and 512 threads at shared-memory footprints that allow 1, 2 and 3 blocks
// per SM.  A cluster lives inside one GPC, and the GPCs of a card hold
// unequal numbers of SMs, so the count is below SMs x blocks-per-SM /
// cluster-size for large clusters: this is the table that quant_mlp.cu's
// one-wave rule (ops/quant.py::_qmlp_geometry) must respect.  Not part of
// the package's build (ops/kernels.py builds csrc/*.cu only).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdio>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(512) k_cluster(int* p) {
  extern __shared__ int smem[];
  smem[threadIdx.x] = threadIdx.x;
  cg::this_cluster().sync();
  if (p && threadIdx.x == 9999) p[0] = smem[0];
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, sms);
  cudaFuncSetAttribute(k_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  cudaFuncSetAttribute(k_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  const int threads[] = {256, 512};
  const int smem_kb[] = {200, 110, 72};  // 1, 2, 3 blocks per SM by shared memory
  printf("threads smem_kb blocks/SM | max active clusters for cluster size 1 2 3 4 5 6 7 8 "
         "9 10 11 12 13 14 15 16\n");
  for (int t : threads) {
    for (int kb : smem_kb) {
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_cluster, t, kb * 1024);
      printf("%4d %4d %2d |", t, kb, per_sm);
      for (int c = 1; c <= 16; ++c) {
        cudaLaunchConfig_t config = {};
        config.gridDim = dim3(c * 64);
        config.blockDim = dim3(t);
        config.dynamicSmemBytes = kb * 1024;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = c;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        config.attrs = attr;
        config.numAttrs = 1;
        int n = -1;
        const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, k_cluster, &config);
        if (err != cudaSuccess) n = -static_cast<int>(err);
        printf(" %d", n);
      }
      printf("\n");
    }
  }
  return 0;
}
