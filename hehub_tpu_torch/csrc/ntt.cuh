// Negacyclic NTT stage chains on one row: fwd_stages / inv_stages, the
// whole row in shared memory, used by the standalone NTT kernels (ntt.cu,
// K1 and K2); and fwd_stages_reg, register-resident, used by the fused
// external product (extprod.cu, K3 and K4).
//
// In the first two the whole block works on one row x[0..n) in shared
// memory; each stage runs its n/2 butterflies spread over the block's
// threads and ends with __syncthreads(). The butterfly order and
// operations of all three are those of the plain stage chains ntt_fwd /
// ntt_inv in hehub_tpu_torch/ops/ntt.py, so the results are bitwise equal
// to them.
#pragma once

#include <cstdint>

#include "modarith.cuh"
#include "reglayout.cuh"

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

// Register-resident forward stage chain (used by extprod.cu; K1 keeps
// fwd_stages above). The same butterflies as fwd_stages, regrouped: a block
// of T = n / 2^EB threads works on one row, each thread holding E = 2^EB
// values in registers, and runs the stages in groups of up to EB, the
// stages of a group being the index bits [b, b + EB). Thread tid holds, for
// e < E, the value at reg_index<EB>(tid, e, b) of reglayout.cuh. Between
// groups the values go once through shared memory (padded<EB>: no bank
// conflicts in any group's layout), so a row of n = 16384 takes 4 groups of
// 4 stages or 3 of 5 where
// fwd_stages takes 14 shared-memory passes, each ending in a barrier; a
// group's twiddle pair is loaded once per (stage, twiddle), not per
// butterfly.
//
// The groups are b = log n - EB (stages 0..EB-1: the thread's values lie at
// stride T, e * T + tid, so they load straight from device memory,
// coalesced), then b = max(b - EB, 0), down to b = 0, where the thread
// holds the E contiguous values tid * E + e of the bit-reversed output.
// What bounds it on the H100: the integer instructions of the butterflies
// (shoup_mul_lazy + add_lazy + sub_lazy) and the latency of their chains;
// the chain keeps everything else (addresses, twiddle loads, exchanges) few
// and off the integer pipes, and the caller picks E for enough warps (16
// values a thread at n = 16384 gives 1024 threads; 32 gave 512 and ran
// slower in the external product).

// The same value, opaque to the compiler: what is computed from it inside a
// loop is computed again in each iteration, not hoisted out and kept in
// registers across it (a digit loop around fwd_stages_reg would otherwise
// keep every twiddle of the row live).
__device__ __forceinline__ const uint32_t* opaque(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  asm volatile("mov.b64 %0, %0;" : "+l"(p));
#endif
  return p;
}

// Forward stages on the index bits [LO, HI) (highest first) of the E
// values v[e] at reg_index<EB>(tid, e, B), B <= LO < HI <= B + EB.
template <int LOGN, int EB, int B, int LO, int HI>
__device__ __forceinline__ void fwd_group(uint32_t (&v)[1 << EB], int tid,
                                          const uint32_t* __restrict__ tw,
                                          const uint32_t* __restrict__ tw_sh, uint32_t q,
                                          uint32_t two_q) {
  constexpr int E = 1 << EB;
#pragma unroll
  for (int beta = HI - 1; beta >= LO; --beta) {
    const int lb = beta - B;         // the bit of e this stage pairs on
    const int s = LOGN - 1 - beta;   // global stage, span t = 2^beta
    // i = lo >> (log t + 1) of fwd_stages = reg_index(tid, e0, B) >> (beta + 1):
    // tid's bits above B + EB, shifted, plus e0's bits above lb, a constant
    const int i_tid = (tid >> B) << (B + EB - 1 - beta);
    const uint32_t* tws = tw + (1 << s) + i_tid;
    const uint32_t* tws_sh = tw_sh + (1 << s) + i_tid;
#pragma unroll
    for (int hh = 0; hh < (E >> (lb + 1)); ++hh) {
      const uint32_t w = __ldg(tws + hh);
      const uint32_t w_sh = __ldg(tws_sh + hh);
#pragma unroll
      for (int ll = 0; ll < (1 << lb); ++ll) {
        const int lo = (hh << (lb + 1)) + ll;
        const int hi = lo + (1 << lb);
        const uint32_t a = v[lo];
        const uint32_t wh = shoup_mul_lazy(v[hi], w, w_sh, q);
        v[lo] = add_lazy(a, wh, two_q);
        v[hi] = sub_lazy(a, wh, two_q);
      }
    }
  }
}

// Moves the thread's values from layout FROM to layout TO through x (at
// least padded<EB>(n) words of shared memory). Starts with a barrier, so x
// may still be read by a previous exchange.
template <int EB, int FROM, int TO>
__device__ __forceinline__ void exchange(uint32_t (&v)[1 << EB], uint32_t* x, int tid) {
  uint32_t* from = x + padded<EB>(reg_index<EB>(tid, 0, FROM));
  uint32_t* to = x + padded<EB>(reg_index<EB>(tid, 0, TO));
  __syncthreads();
#pragma unroll
  for (int e = 0; e < (1 << EB); ++e) from[slot<EB>(e, FROM)] = v[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < (1 << EB); ++e) v[e] = to[slot<EB>(e, TO)];
}

// Runs the groups from bit position B (the group covering bits [B, HI))
// down to 0.
template <int LOGN, int EB, int B, int HI>
__device__ __forceinline__ void fwd_groups_from(uint32_t (&v)[1 << EB], uint32_t* x, int tid,
                                                const uint32_t* __restrict__ tw,
                                                const uint32_t* __restrict__ tw_sh, uint32_t q,
                                                uint32_t two_q) {
  fwd_group<LOGN, EB, B, B, HI>(v, tid, tw, tw_sh, q, two_q);
  if constexpr (B > 0) {
    constexpr int NEXT = B > EB ? B - EB : 0;
    exchange<EB, B, NEXT>(v, x, tid);
    fwd_groups_from<LOGN, EB, NEXT, B>(v, x, tid, tw, tw_sh, q, two_q);
  }
}

// Forward negacyclic NTT of one row of n = 2^LOGN (LOGN >= 2 EB) by
// T = n / 2^EB threads: on entry v[e] is coefficient e * T + tid (lazy,
// natural order), on return v[e] is value tid * 2^EB + e of the
// bit-reversed output (lazy), bitwise what fwd_stages leaves in x.
// x: padded<EB>(n) words of shared memory. tw and tw_sh pass through
// opaque(), so a caller's loop around this call keeps none of the row's
// twiddles or their addresses live between calls.
template <int LOGN, int EB>
__device__ __forceinline__ void fwd_stages_reg(uint32_t (&v)[1 << EB], uint32_t* x, int tid,
                                               const uint32_t* tw, const uint32_t* tw_sh,
                                               uint32_t q, uint32_t two_q) {
  fwd_groups_from<LOGN, EB, LOGN - EB, LOGN>(v, x, tid, opaque(tw), opaque(tw_sh), q, two_q);
}

}  // namespace hh
