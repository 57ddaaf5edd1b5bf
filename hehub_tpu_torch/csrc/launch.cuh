// Host-side launch helpers shared by the kernels' sources.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

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

}  // namespace hh
