// Host-side launch helpers shared by the kernels' sources.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <utility>

namespace hh {

// Raises `kernel`'s dynamic shared memory limit to `bytes` (it may exceed
// the 48 KB default) on the current device, once per device: bit d of
// `configured`, a static the caller keeps for this kernel, marks device d
// as done (devices from 32 on are set at every call).
template <typename Kernel>
cudaError_t set_max_smem_once(Kernel* kernel, size_t bytes, unsigned& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (configured >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) configured |= 1u << dev;
  return err;
}

// Launches `kernel` on `blocks` blocks of `threads` threads with `smem`
// bytes of dynamic shared memory, in clusters of `cluster` blocks (1: no
// cluster), and returns the launch's error. The cluster size is given at
// launch, not by __cluster_dims__, so that one kernel template serves
// several sizes (K2 and K5 on rows above n = 32768).
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), unsigned blocks, unsigned threads,
                             size_t smem, unsigned cluster, cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace hh
