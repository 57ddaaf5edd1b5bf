// K1 and K2: the forward and inverse negacyclic NTT of [rows, n] uint32
// residue rows, one thread block per row.
//
// Replaces the TPU kernels hehub_tpu/ops/pallas/ntt_pallas.py::_fwd_kernel
// (+ fwd_stage_chain) and ::_inv_kernel, built by make_ntt.
//
// What bounds it on the H100: each row is read once and written once
// (2 x 4n bytes), and log2(n) stages of n/2 Shoup butterflies (two
// __umulhi-class multiplies each) run on it in between: 14 stages at
// n=16384. The design keeps the row in dynamic shared memory for all
// stages (64 KB at n=16384, 128 KB at n=32768, opted in above 48 KB), so
// device memory sees exactly one read and one write per element. Twiddles
// come from the compact [L, n] Context tables (tw_fwd/tw_inv and their
// Shoup companions), 8 x 64 KB at the main path's shape, which stay in L2;
// the TPU kernel's full-width per-stage tables, its roll-and-mask
// butterflies and its row padding were Mosaic artefacts and are not used.
//
// The row's limb is row % L: data is a contiguous [..., L, n] tensor.
// Output is bitwise equal to the plain chains ntt_fwd / ntt_inv of
// hehub_tpu_torch/ops/ntt.py (same butterflies, same operation order).
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt.cuh"

namespace {

__global__ void __launch_bounds__(1024)
    ntt_fwd_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
                   const uint32_t* __restrict__ q, const uint32_t* __restrict__ two_q, int L,
                   int logn) {
  extern __shared__ uint4 smem_fwd[];
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_fwd);
  const int n = 1 << logn;
  const long long row = blockIdx.x;
  const int limb = static_cast<int>(row % L);
  hh::load_row(x, in + row * n, n);
  __syncthreads();
  hh::fwd_stages(x, tw + static_cast<long long>(limb) * n,
                 tw_sh + static_cast<long long>(limb) * n, q[limb], two_q[limb], logn);
  hh::store_row(out + row * n, x, n);
}

__global__ void __launch_bounds__(1024)
    ntt_inv_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
                   const uint32_t* __restrict__ q, const uint32_t* __restrict__ two_q,
                   const uint32_t* __restrict__ w_last, const uint32_t* __restrict__ w_last_sh,
                   const uint32_t* __restrict__ n_inv, const uint32_t* __restrict__ n_inv_sh,
                   int L, int logn) {
  extern __shared__ uint4 smem_inv[];
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_inv);
  const int n = 1 << logn;
  const long long row = blockIdx.x;
  const int limb = static_cast<int>(row % L);
  hh::load_row(x, in + row * n, n);
  __syncthreads();
  hh::inv_stages(x, tw + static_cast<long long>(limb) * n,
                 tw_sh + static_cast<long long>(limb) * n, q[limb], two_q[limb], w_last[limb],
                 w_last_sh[limb], n_inv[limb], n_inv_sh[limb], logn);
  hh::store_row(out + row * n, x, n);
}

int threads_for(int n) { return n / 2 < 1024 ? n / 2 : 1024; }

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 on success).
int hh_ntt_fwd(const uint32_t* in, uint32_t* out, const uint32_t* tw, const uint32_t* tw_sh,
               const uint32_t* q, const uint32_t* two_q, long long rows, int L, int logn,
               void* stream) {
  const int n = 1 << logn;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_fwd_kernel<<<static_cast<unsigned>(rows), threads_for(n), smem,
                   static_cast<cudaStream_t>(stream)>>>(in, out, tw, tw_sh, q, two_q, L, logn);
  return static_cast<int>(cudaGetLastError());
}

int hh_ntt_inv(const uint32_t* in, uint32_t* out, const uint32_t* tw, const uint32_t* tw_sh,
               const uint32_t* q, const uint32_t* two_q, const uint32_t* w_last,
               const uint32_t* w_last_sh, const uint32_t* n_inv, const uint32_t* n_inv_sh,
               long long rows, int L, int logn, void* stream) {
  const int n = 1 << logn;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inv_kernel<<<static_cast<unsigned>(rows), threads_for(n), smem,
                   static_cast<cudaStream_t>(stream)>>>(in, out, tw, tw_sh, q, two_q, w_last,
                                                        w_last_sh, n_inv, n_inv_sh, L, logn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
