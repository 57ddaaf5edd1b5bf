// Negacyclic NTT stage chains on one row held in shared memory, shared by
// the standalone NTT kernels (ntt.cu) and the fused external product
// (extprod.cu).
//
// The whole block works on one row x[0..n) in shared memory. Each stage
// runs its n/2 butterflies spread over the block's threads and ends with
// __syncthreads(). The butterfly order and operations are those of the
// plain stage chains ntt_fwd / ntt_inv in hehub_tpu_torch/ops/ntt.py, so
// the results are bitwise equal to them.
#pragma once

#include <cstdint>

#include "modarith.cuh"

namespace hh {

// Row copies between global and shared memory, 16 bytes per thread and
// access; n is a multiple of 4 and both rows are 16-byte aligned.
__device__ __forceinline__ void load_row(uint32_t* x, const uint32_t* g, int n) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x)
    *reinterpret_cast<uint4*>(x + e) = *reinterpret_cast<const uint4*>(g + e);
}

__device__ __forceinline__ void store_row(uint32_t* g, const uint32_t* x, int n) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x)
    *reinterpret_cast<uint4*>(g + e) = *reinterpret_cast<const uint4*>(x + e);
}

// Forward negacyclic NTT, Cooley-Tukey DIT: natural-order coefficients in,
// bit-reversed values out, lazy [0, 2q) in and out. Stage s pairs
// x[i*2t + j] with x[i*2t + t + j] (t = n >> (s+1)) under twiddle
// tw[2^s + i]. tw/tw_sh: the limb's [n] rows of Context.tw_fwd(_sh).
// Expects the row loaded and a __syncthreads() before the call.
__device__ __forceinline__ void fwd_stages(uint32_t* x, const uint32_t* __restrict__ tw,
                                           const uint32_t* __restrict__ tw_sh, uint32_t q,
                                           uint32_t two_q, int logn) {
  const int half = 1 << (logn - 1);
  for (int s = 0; s < logn; ++s) {
    const int log_t = logn - 1 - s;
    const int t = 1 << log_t;
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> log_t;
      const int lo = (i << (log_t + 1)) + (k & (t - 1));
      const int hi = lo + t;
      const uint32_t w = __ldg(tw + (1 << s) + i);
      const uint32_t w_sh = __ldg(tw_sh + (1 << s) + i);
      const uint32_t a = x[lo];
      const uint32_t wh = shoup_mul_lazy(x[hi], w, w_sh, q);
      x[lo] = add_lazy(a, wh, two_q);
      x[hi] = sub_lazy(a, wh, two_q);
    }
    __syncthreads();
  }
}

// Inverse negacyclic NTT, Gentleman-Sande DIF: bit-reversed values in,
// natural coefficients out. Stage s pairs x[i*2t + j] with x[i*2t + t + j]
// (t = 2^s, h = n >> (s+1) blocks) and emits lo' = lo + hi,
// hi' = (lo + 2q - hi) * w with w = tw[h + i]; the last stage (h == 1)
// takes the n^-1-folded twiddle w_last and scales lo' by n^-1.
__device__ __forceinline__ void inv_stages(uint32_t* x, const uint32_t* __restrict__ tw,
                                           const uint32_t* __restrict__ tw_sh, uint32_t q,
                                           uint32_t two_q, uint32_t w_last,
                                           uint32_t w_last_sh, uint32_t n_inv,
                                           uint32_t n_inv_sh, int logn) {
  const int half = 1 << (logn - 1);
  for (int s = 0; s < logn; ++s) {
    const int t = 1 << s;
    const int h = half >> s;
    const bool last = (h == 1);
    for (int k = threadIdx.x; k < half; k += blockDim.x) {
      const int i = k >> s;
      const int lo = (i << (s + 1)) + (k & (t - 1));
      const int hi = lo + t;
      const uint32_t a = x[lo];
      const uint32_t b = x[hi];
      uint32_t w, w_sh, new_lo;
      if (last) {
        w = w_last;
        w_sh = w_last_sh;
        new_lo = shoup_mul_lazy(a + b, n_inv, n_inv_sh, q);
      } else {
        w = __ldg(tw + h + i);
        w_sh = __ldg(tw_sh + h + i);
        new_lo = add_lazy(a, b, two_q);
      }
      x[lo] = new_lo;
      x[hi] = shoup_mul_lazy(a + two_q - b, w, w_sh, q);
    }
    __syncthreads();
  }
}

}  // namespace hh
