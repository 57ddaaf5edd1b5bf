// Lazy modular arithmetic on uint32_t residues — the device twin of
// hehub_tpu_torch/ops/modarith.py (and of hehub_tpu/ops/modarith.py).
//
// Residues are lazy in [0, 2q) for 30-bit primes q < 2^30. Every function
// computes exactly what its Python twin computes, uint32 wraparound
// included, so kernels built from them are bitwise equal to the plain
// PyTorch stage chains. Products use the hardware 32x32->64 multiply
// (__umulhi for the high word) instead of the 16-bit splits that the
// Python versions need.
#pragma once

#include <cstdint>

namespace hh {

// The lazy sums fold t in [0, 4q) into [0, 2q) as min(t, t - 2q), one
// unsigned minimum (below 2q, t - 2q wraps above t): the same value as
// t >= 2q ? t - 2q : t, whose compare and select made K1-K4 4-11 % slower
// on an H100 (PERF.md).
__device__ __forceinline__ uint32_t add_lazy(uint32_t a, uint32_t b, uint32_t two_q) {
  const uint32_t t = a + b;
  return min(t, t - two_q);
}

__device__ __forceinline__ uint32_t sub_lazy(uint32_t a, uint32_t b, uint32_t two_q) {
  const uint32_t t = a + two_q - b;
  return min(t, t - two_q);
}

__device__ __forceinline__ uint32_t neg_lazy(uint32_t a, uint32_t two_q) {
  const uint32_t t = two_q - a;
  return t >= two_q ? t - two_q : t;
}

__device__ __forceinline__ uint32_t reduce_strict(uint32_t a, uint32_t q) {
  return a >= q ? a - q : a;
}

// x * w mod q for a constant w < q, w_sh = floor(w * 2^32 / q); any uint32
// x, output in [0, 2q).
__device__ __forceinline__ uint32_t shoup_mul_lazy(uint32_t x, uint32_t w, uint32_t w_sh,
                                                   uint32_t q) {
  const uint32_t hi = __umulhi(x, w_sh);
  return x * w - hi * q;
}

// Montgomery product a * b * 2^-32 mod q, neg_qinv = (-q)^-1 mod 2^32;
// inputs and output in [0, 2q).
__device__ __forceinline__ uint32_t mont_mul_lazy(uint32_t a, uint32_t b, uint32_t q,
                                                  uint32_t neg_qinv) {
  const uint32_t lo = a * b;
  const uint32_t hi = __umulhi(a, b);
  const uint32_t m = lo * neg_qinv;
  return hi + __umulhi(m, q) + (lo != 0u ? 1u : 0u);
}

}  // namespace hh
