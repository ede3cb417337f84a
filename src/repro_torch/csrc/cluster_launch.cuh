// The launch of a lane on a thread-block cluster, shared by K11 and K13
// (qr_cluster.cuh) and by K12 and K14 (tiled_chol.cuh): batch lanes of c
// CTAs each, one cudaLaunchKernelEx with the cluster dimension, and
// cudaOccupancyMaxActiveClusters, the clusters the card holds at once,
// which the plans (pipelines/qr_solve.py, pipelines/cholesky_solve.py)
// weigh their forms by.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// The launch configuration of batch lanes of c CTAs of threads threads
// each (the cluster dimension in attr), smem bytes of dynamic shared
// memory a CTA.
inline cudaLaunchConfig_t cluster_config(int batch, int c, int threads,
                                         int smem,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch of kernel(args...) on batch lanes of c CTAs each; returns the
// launch's error, if any (a refused cluster is never run).
template <class... Params, class... Args>
inline int cluster_launch(void (*kernel)(Params...), int batch, int c,
                          int threads, int smem, void* stream,
                          Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(batch, c, threads, smem, attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of kernel at clusters of c CTAs of
// threads threads and smem bytes each: how many the card holds at once;
// -1 where the query fails.
template <class... Params>
inline int cluster_occupancy(void (*kernel)(Params...), int c, int threads,
                             int smem) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(8 * 16, c, threads, smem,
                                                attr);
  int clusters = -1;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return clusters;
}

}  // namespace repro_torch
