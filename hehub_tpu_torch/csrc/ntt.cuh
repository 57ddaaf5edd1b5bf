// Register-resident negacyclic NTT stage chains, used by the standalone NTT
// kernels (ntt.cu: K1 fwd_stages_reg and K2 inv_stages_reg, each on half a
// row) and by the fused external product (extprod.cu, K3 and K4:
// fwd_stages_reg on a whole row).
//
// A block of T = n / 2^EB threads works on n values (a row, or half of
// one), each thread holding E = 2^EB values in registers, and runs the
// stages in groups of up to EB, the stages of a group being the index bits
// [b, b + EB). Thread tid holds, for e < E, the value at
// reg_index<EB>(tid, e, b) of reglayout.cuh. Between groups the values go
// once through shared memory (padded<EB>), so a row of n = 16384 takes 4
// groups of 4 stages and 3 exchanges, not 14 shared-memory passes each
// ending in a barrier; a group's twiddle pair is loaded once per (stage,
// twiddle), not per butterfly, and its index comes from the thread's part
// of reg_index, a shift, plus a constant. The butterflies and their
// operands are those of the plain stage chains ntt_fwd / ntt_inv in
// hehub_tpu_torch/ops/ntt.py, so the results are bitwise equal to them.
//
// What bounds the chains on the H100: the integer instructions of the
// butterflies (a Shoup product and two lazy sums each) and the latency of
// their dependent chains; the design keeps everything else (addresses,
// twiddle loads, exchanges) few, and the caller picks E for enough warps.
#pragma once

#include <cstdint>

#include "modarith.cuh"
#include "reglayout.cuh"

namespace hh {

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

// Forward (Cooley-Tukey) stages on the index bits [LO, HI), highest first,
// of the E values v[e] at reg_index<EB>(tid, e, B), B <= LO < HI <= B + EB:
// lo' = lo + hi w, hi' = lo - hi w, the stage's twiddles starting at
// tw_mul 2^s (fwd_stages_reg).
template <int LOGN, int EB, int B, int LO, int HI>
__device__ __forceinline__ void fwd_group(uint32_t (&v)[1 << EB], int tid,
                                          const uint32_t* __restrict__ tw,
                                          const uint32_t* __restrict__ tw_sh, uint32_t q,
                                          uint32_t two_q, int tw_mul) {
  constexpr int E = 1 << EB;
#pragma unroll
  for (int beta = HI - 1; beta >= LO; --beta) {
    const int lb = beta - B;         // the bit of e this stage pairs on
    const int s = LOGN - 1 - beta;   // global stage, span t = 2^beta
    // i = lo >> (beta + 1) for lo = reg_index(tid, e0, B): tid's bits above
    // B + EB, shifted, plus e0's bits above lb, a constant
    const int i_tid = (tid >> B) << (B + EB - 1 - beta);
    const uint32_t* tws = tw + (tw_mul << s) + i_tid;
    const uint32_t* tws_sh = tw_sh + (tw_mul << s) + i_tid;
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

// Inverse (Gentleman-Sande) stages on the index bits [BETA, HI), lowest
// first, of the values at reg_index<EB>(tid, e, B): lo' = lo + hi,
// hi' = (lo + 2q - hi) w, the stage's twiddles starting at
// tw_mul 2^(LOGN - 1 - beta) (inv_stages_reg). One stage an instantiation,
// so that every loop bound is a constant: with the loop over the stages,
// nvcc left a loop of K2's partial group rolled and put v in local memory.
template <int LOGN, int EB, int B, int BETA, int HI>
__device__ __forceinline__ void inv_group(uint32_t (&v)[1 << EB], int tid,
                                          const uint32_t* __restrict__ tw,
                                          const uint32_t* __restrict__ tw_sh, uint32_t q,
                                          uint32_t two_q, int tw_mul) {
  constexpr int E = 1 << EB;
  constexpr int lb = BETA - B;
  // i as in fwd_group
  const int i_tid = (tid >> B) << (B + EB - 1 - BETA);
  const uint32_t* tws = tw + (tw_mul << (LOGN - 1 - BETA)) + i_tid;
  const uint32_t* tws_sh = tw_sh + (tw_mul << (LOGN - 1 - BETA)) + i_tid;
#pragma unroll
  for (int hh = 0; hh < (E >> (lb + 1)); ++hh) {
    const uint32_t w = __ldg(tws + hh);
    const uint32_t w_sh = __ldg(tws_sh + hh);
#pragma unroll
    for (int ll = 0; ll < (1 << lb); ++ll) {
      const int lo = (hh << (lb + 1)) + ll;
      const int hi = lo + (1 << lb);
      const uint32_t a = v[lo];
      const uint32_t b = v[hi];
      v[lo] = add_lazy(a, b, two_q);
      v[hi] = shoup_mul_lazy(a + two_q - b, w, w_sh, q);
    }
  }
  if constexpr (BETA + 1 < HI)
    inv_group<LOGN, EB, B, BETA + 1, HI>(v, tid, tw, tw_sh, q, two_q, tw_mul);
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

// Runs the forward groups from bit position B (the group covering bits
// [B, HI)) down to 0: B = log n - EB, then max(B - EB, 0), so where EB does
// not divide log n the group at 0 is partial and runs only the bits below
// the previous group.
template <int LOGN, int EB, int B, int HI>
__device__ __forceinline__ void fwd_groups_from(uint32_t (&v)[1 << EB], uint32_t* x, int tid,
                                                const uint32_t* __restrict__ tw,
                                                const uint32_t* __restrict__ tw_sh, uint32_t q,
                                                uint32_t two_q, int tw_mul) {
  fwd_group<LOGN, EB, B, B, HI>(v, tid, tw, tw_sh, q, two_q, tw_mul);
  if constexpr (B > 0) {
    constexpr int NEXT = B > EB ? B - EB : 0;
    exchange<EB, B, NEXT>(v, x, tid);
    fwd_groups_from<LOGN, EB, NEXT, B>(v, x, tid, tw, tw_sh, q, two_q, tw_mul);
  }
}

// Forward negacyclic NTT (Cooley-Tukey DIT, natural order in, bit-reversed
// out, lazy [0, 2q) in and out; stage s pairs x[i 2t + j] with
// x[i 2t + t + j], t = n >> (s+1), under tw[2^s + i]) of one row of
// n = 2^LOGN (LOGN >= 2 EB) by T = n / 2^EB threads: on entry v[e] is
// coefficient e T + tid, on return v[e] is value tid 2^EB + e of the
// bit-reversed output. x: padded<EB>(n) words of shared memory. tw/tw_sh:
// the limb's [n] rows of Context.tw_fwd(_sh), passed through opaque(), so
// a caller's loop around this call keeps none of the row's twiddles or
// their addresses live between calls.
//
// With tw_mul = 2 + h and the limb's rows for 2n, the same runs stages 1 ..
// log2(2n) - 1 of a row of 2n on its half h (values [h n, (h + 1) n), after
// stage 0): there stage s + 1 takes tw[2^(s+1) + h 2^s + i] = tw[(2 + h) 2^s + i].
template <int LOGN, int EB>
__device__ __forceinline__ void fwd_stages_reg(uint32_t (&v)[1 << EB], uint32_t* x, int tid,
                                               const uint32_t* tw, const uint32_t* tw_sh,
                                               uint32_t q, uint32_t two_q, int tw_mul = 1) {
  fwd_groups_from<LOGN, EB, LOGN - EB, LOGN>(v, x, tid, opaque(tw), opaque(tw_sh), q, two_q,
                                             tw_mul);
}

// Runs the inverse groups from the group at B (covering bits [LO, B + EB))
// up to the one at log n - EB: B = 0, EB, 2 EB, ..., and where EB does not
// divide log n a last, partial group at log n - EB runs only the bits above
// the previous group, so the thread ends holding values at stride T.
template <int LOGN, int EB, int B, int LO>
__device__ __forceinline__ void inv_groups_from(uint32_t (&v)[1 << EB], uint32_t* x, int tid,
                                                const uint32_t* __restrict__ tw,
                                                const uint32_t* __restrict__ tw_sh, uint32_t q,
                                                uint32_t two_q, int tw_mul) {
  inv_group<LOGN, EB, B, LO, B + EB>(v, tid, tw, tw_sh, q, two_q, tw_mul);
  if constexpr (B + EB < LOGN) {
    constexpr int NEXT = B + 2 * EB <= LOGN ? B + EB : LOGN - EB;
    exchange<EB, B, NEXT>(v, x, tid);
    inv_groups_from<LOGN, EB, NEXT, B + EB>(v, x, tid, tw, tw_sh, q, two_q, tw_mul);
  }
}

// The inverse negacyclic NTT (Gentleman-Sande DIF, bit-reversed values in,
// natural coefficients out, lazy [0, 2q) in and out; stage s pairs
// x[i 2t + j] with x[i 2t + t + j], t = 2^s, under tw[h + i], h = 2n >> (s+1))
// of a row of 2n = 2^(LOGN+1), but for its last stage, which pairs the two
// halves (and folds n^-1, so the caller runs it), on half h by
// T = n / 2^EB threads (LOGN >= 2 EB): the half's stages act on the index
// bits [0, LOGN), stage s taking tw[(2 + h) 2^(LOGN-1-s) + i]. On entry v[e]
// is value tid 2^EB + e of the half, on return v[e] is its value e T + tid.
// x: padded<EB>(n) words of shared memory; tw/tw_sh: the limb's [2n] rows
// of Context.tw_inv(_sh); tw_mul = 2 + h.
template <int LOGN, int EB>
__device__ __forceinline__ void inv_stages_reg(uint32_t (&v)[1 << EB], uint32_t* x, int tid,
                                               const uint32_t* __restrict__ tw,
                                               const uint32_t* __restrict__ tw_sh, uint32_t q,
                                               uint32_t two_q, int tw_mul) {
  inv_groups_from<LOGN, EB, 0, 0>(v, x, tid, tw, tw_sh, q, two_q, tw_mul);
}

// Rows cut into 2^S equal parts (K1: half sub-rows of 32768 values, K3/K4:
// sub-rows of 16384, as the rows above those lengths are split): the first S
// forward stages pair whole parts, stage s part u with u + 2^(S-1-s) under
// tw[2^s + (u >> (S - s))]. fwd_cross runs them on one column of the parts,
// y[u] the value at the same offset in part u, and keeps only the branch
// that ends in part g, the caller's: at stage s the values still held share
// the top s bits of g, and bit S-1-s of g picks the sum or the difference.
// w/w_sh[s] = tw/tw_sh[2^s + (g >> (S - s))]. Returns part g's value; the
// butterflies and their operands are those of the plain chain ntt_fwd.
template <int S>
__device__ __forceinline__ uint32_t fwd_cross(uint32_t (&y)[1 << S], int g, const uint32_t* w,
                                              const uint32_t* w_sh, uint32_t q, uint32_t two_q) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    constexpr int kTop = S - 1;
    const int half = 1 << (kTop - s);
    const bool upper = (g >> (kTop - s)) & 1;
#pragma unroll
    for (int u = 0; u < half; ++u) {
      const uint32_t wh = shoup_mul_lazy(y[u + half], w[s], w_sh[s], q);
      y[u] = upper ? sub_lazy(y[u], wh, two_q) : add_lazy(y[u], wh, two_q);
    }
  }
  return y[0];
}

// Entry idx < 2P of a limb's compact twiddle table, read from its P rows of
// a regrouped table (context.sub_row_tables; `rows` points at the first):
// entry 0 of row idx below P, entry 1 of row idx - P from P on. P = 1 reads
// entry idx of the compact table itself.
template <int LOGP>
__device__ __forceinline__ uint32_t cross_twiddle(const uint32_t* rows, int n, int idx) {
  constexpr int P = 1 << LOGP;
  return __ldg(idx < P ? rows + static_cast<long long>(idx) * n
                       : rows + static_cast<long long>(idx - P) * n + 1);
}

// The last S inverse stages of a row of 2^S parts, which pair whole parts,
// on one column y[u] of them: stage s pairs part u with u + 2^s, in block
// i = u >> (s + 1) of 2^S >> (s + 1) blocks, under tw[(2^S >> (s + 1)) + i]
// (w/w_sh indexed by that table index, entries 2 .. 2^S - 1), and the last
// stage folds n^-1 (w_last, n_inv), as ntt_inv's. With FOLD false the last
// stage is an ordinary one under w[1] (entries 1 .. 2^S - 1), as where the
// row is a part of a longer one whose last stages run after it. Every
// value is kept.
template <int S, bool FOLD = true>
__device__ __forceinline__ void inv_cross(uint32_t (&y)[1 << S], const uint32_t* w,
                                          const uint32_t* w_sh, uint32_t q, uint32_t two_q,
                                          uint32_t w_last, uint32_t w_last_sh, uint32_t n_inv,
                                          uint32_t n_inv_sh) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int t = 1 << s;
    const int blocks = (1 << S) >> (s + 1);
#pragma unroll
    for (int i = 0; i < blocks; ++i) {
#pragma unroll
      for (int jj = 0; jj < t; ++jj) {
        const int lo = 2 * t * i + jj, hi = lo + t;
        const uint32_t a = y[lo], b = y[hi];
        if (FOLD && s == S - 1) {
          y[lo] = shoup_mul_lazy(a + b, n_inv, n_inv_sh, q);
          y[hi] = shoup_mul_lazy(a + two_q - b, w_last, w_last_sh, q);
        } else {
          y[lo] = add_lazy(a, b, two_q);
          y[hi] = shoup_mul_lazy(a + two_q - b, w[blocks + i], w_sh[blocks + i], q);
        }
      }
    }
  }
}

}  // namespace hh
