// Short rows: the negacyclic NTT stage chains for n in [8, 512], several
// rows a block, each row's stages in shared memory. Used by the small-n
// instantiations of K1 and K2 (ntt.cu) and of K3 and K4 (extprod.cu).
//
// The register chains of ntt.cuh need rows of at least 2^(2 EB) = 256
// values a block (16 a thread, a row split over two blocks), and one block a
// row of n <= 512 would hold 16 to 256 threads: too few warps to hide the
// latency of a butterfly chain. Here a block holds kSmallValues = 2048
// values, 2048 / n whole rows (256 rows at n = 8, 4 at n = 512), and
// 256 threads. Every stage, thread tid takes kSmallPairs = 4 butterflies:
// butterfly j = tid mod n/2 of the block rows rb = tid / (n/2) + k 512 / n,
// k < 4, so a thread's twiddle index is the same for its 4 butterflies and
// only the row (and its limb) changes. A barrier ends every stage. What
// bounds these chains on the H100: the latency of log2(n) dependent stages,
// each a shared-memory round trip and a barrier; the short rows have no
// more work to spread. The butterflies and their operands are those of the
// plain stage chains ntt_fwd / ntt_inv of hehub_tpu_torch/ops/ntt.py, so
// the results are bitwise equal to them.
#pragma once

#include <cstdint>

#include "modarith.cuh"

namespace hh {

constexpr int kSmallLog = 11;
constexpr int kSmallValues = 1 << kSmallLog;  // values a block
constexpr int kSmallThreads = 256;
constexpr int kSmallPairs = kSmallValues / 2 / kSmallThreads;  // butterflies a thread a stage
constexpr int kSmallElems = kSmallValues / kSmallThreads;      // values a thread loads

// The limb constants of the rows a thread's butterflies act on, k < kSmallPairs:
// its row rb(k) = tid / (n/2) + k kSmallThreads / (n/2) of the block.
struct SmallLimbs {
  const uint32_t* tw[kSmallPairs];
  const uint32_t* tw_sh[kSmallPairs];
  uint32_t q[kSmallPairs];
  uint32_t two_q[kSmallPairs];
};

// The block row of butterfly k of thread tid, for rows of 2^LOGN.
template <int LOGN>
__device__ __forceinline__ int small_row(int tid, int k) {
  return (tid >> (LOGN - 1)) + k * (kSmallThreads >> (LOGN - 1));
}

// Forward (Cooley-Tukey) stages on the block's rows in x (kSmallValues
// words of shared memory, row rb at rb 2^LOGN): stage s pairs x[i 2t + j]
// with x[i 2t + t + j], t = n >> (s+1), under tw[2^s + i] of the row's
// limb. The caller synchronises before; every stage ends in a barrier.
template <int LOGN>
__device__ __forceinline__ void fwd_stages_small(uint32_t* x, int tid, const SmallLimbs& c) {
  constexpr int n = 1 << LOGN;
  const int j = tid & (n / 2 - 1);
#pragma unroll
  for (int s = 0; s < LOGN; ++s) {
    const int t = n >> (s + 1);
    const int i = j >> (LOGN - 1 - s);
    const int off = 2 * t * i + (j & (t - 1));
    const int w_at = (1 << s) + i;
#pragma unroll
    for (int k = 0; k < kSmallPairs; ++k) {
      uint32_t* p = x + (small_row<LOGN>(tid, k) << LOGN) + off;
      const uint32_t a = p[0];
      const uint32_t wh = shoup_mul_lazy(p[t], __ldg(c.tw[k] + w_at), __ldg(c.tw_sh[k] + w_at),
                                         c.q[k]);
      p[0] = add_lazy(a, wh, c.two_q[k]);
      p[t] = sub_lazy(a, wh, c.two_q[k]);
    }
    __syncthreads();
  }
}

// The last inverse stage's constants of the rows of a thread's butterflies.
struct SmallLast {
  uint32_t w[kSmallPairs], w_sh[kSmallPairs], n_inv[kSmallPairs], n_inv_sh[kSmallPairs];
};

// Inverse (Gentleman-Sande) stages: stage s pairs x[i 2t + j] with
// x[i 2t + t + j], t = 2^s: lo' = lo + hi, hi' = (lo + 2q - hi) tw[h + i],
// h = n >> (s+1); the last stage (h = 1) folds n^-1: lo' = (lo + hi) n^-1,
// hi' = (lo + 2q - hi) w_last, or, with FOLD false, is an ordinary stage
// under tw[1] (last unused). Synchronisation as fwd_stages_small.
template <int LOGN, bool FOLD = true>
__device__ __forceinline__ void inv_stages_small(uint32_t* x, int tid, const SmallLimbs& c,
                                                 const SmallLast& last) {
  constexpr int n = 1 << LOGN;
  const int j = tid & (n / 2 - 1);
#pragma unroll
  for (int s = 0; s < LOGN; ++s) {
    const int t = 1 << s;
    const int i = j >> s;
    const int off = 2 * t * i + (j & (t - 1));
    const int w_at = (n >> (s + 1)) + i;
#pragma unroll
    for (int k = 0; k < kSmallPairs; ++k) {
      uint32_t* p = x + (small_row<LOGN>(tid, k) << LOGN) + off;
      const uint32_t a = p[0];
      const uint32_t b = p[t];
      if (s + 1 < LOGN || !FOLD) {
        p[0] = add_lazy(a, b, c.two_q[k]);
        p[t] = shoup_mul_lazy(a + c.two_q[k] - b, __ldg(c.tw[k] + w_at),
                              __ldg(c.tw_sh[k] + w_at), c.q[k]);
      } else {
        p[0] = shoup_mul_lazy(a + b, last.n_inv[k], last.n_inv_sh[k], c.q[k]);
        p[t] = shoup_mul_lazy(a + c.two_q[k] - b, last.w[k], last.w_sh[k], c.q[k]);
      }
    }
    __syncthreads();
  }
}

}  // namespace hh
