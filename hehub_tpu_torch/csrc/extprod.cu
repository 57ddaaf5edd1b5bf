// K3 and K4: the fused external product (RNS key switching), one thread
// block per (row r, extended output limb j), and per sub-row of 16384 above
// n = 16384.
//
// K3 (hh_ext_prod, alpha = 1) replaces the TPU kernel
// hehub_tpu/ops/pallas/extprod_pallas.py::_kernel, built by make_ext_prod;
// K4 (hh_ext_prod_conv, alpha > 1, hybrid key switching) replaces
// extprod_pallas.py::_kernel_conv, built by make_ext_prod_converted. Both
// are called from hehub_tpu/rlwe/rgsw.py::ext_prod. They differ only in
// where digit i of row r for output limb j lies:
//   K3: digits [R, l, n], the strict coefficient-form residues of each ct
//       limb, the same row for every j (strides l*n, n, 0);
//   K4: digits [R, D, L_ext, n], the signed base conversion of each limb
//       group into every extended limb, lazy in [0, 2 q_j) (any strides).
// So both run the same block program below on different digit strides.
//
// For each digit i < D the block runs the forward NTT under q_j on the
// digit row (hh::fwd_stages_reg of ntt.cuh: lazy [0, 2q) inputs) and
// multiplies it with the key rows key[i, 0, j] and key[i, 1, j] (Montgomery
// domain) by mont_mul_lazy. The two products accumulate in digit order,
// acc = p_0, then acc = add_lazy(acc, p_i), exactly as ks_contract does, so
// the output is bitwise equal to the plain ks_contract(ntt(digits)) of
// hehub_tpu_torch/rlwe/rgsw.py (and to hehub_tpu.rlwe.rgsw.ext_prod). The
// digit NTTs never reach device memory.
//
// Assumption kept from the reference (hehub_tpu/rlwe/rgsw.py:269-272): a
// strict K3 digit below q_i is a valid lazy input under every q_j. It holds
// for the 30-bit primes of create_ckks_params, all in [2^29, 2^30), since
// then q_i < 2^30 <= 2 q_j.
//
// The key is read in place from the RGSW tensor [rows, 2, L_ext, n] through
// its strides, and K4's digits from the port's [R, D, L_ext, n] tensor
// through theirs, so no transposed copy is made (the TPU kernels took
// [L_ext, R, D, n] and [L_ext, D, 2, n] copies); c0 and c1 are written
// directly as out[2, R, L_ext, n], the layout of the two output RnsPolys.
//
// What bounds it on the H100: the integer operations of D * L_ext digit
// NTTs per row (56 for K3 at the main path, l=7 and L_ext=8; 84 for K4 at
// the hybrid path, D=6 and L_ext=14), log2(n) stages of n/2 butterflies
// each, and of the contraction; bytes are a tenth of that. The first design
// ran each digit NTT as 14 shared-memory stages, each ending in a barrier,
// recomputed indices and loaded two twiddles per butterfly, and capped its
// 1024 threads at 64 registers, 32 of them accumulators (2.7x its bound on
// an H100). This design gives each thread 16 values of the row (1024
// threads at n=16384, 32 warps an SM): the digit row loads straight into
// registers (coalesced, stride n/16), the NTT runs in groups of four
// stages in registers with three exchanges through padded shared memory
// (hh::fwd_stages_reg, ntt.cuh), and the thread ends holding 16 contiguous
// values, so the key rows load as uint4 and the Montgomery products happen
// in registers. The accumulators (2n words, 128 KB at n=16384) live in
// shared memory beside the exchange buffer, at e T + tid (no bank
// conflicts), which leaves each thread under 64 registers with no spills:
// 32 values a thread with register accumulators (512 threads, 16 warps,
// spills) ran slower than the first design. Rows of n <= 512 are too short
// for that block program (16 to 32 threads a row): there a block of 256
// threads takes 2048 / n (row, limb) pairs, runs each digit's stages in
// shared memory and keeps the accumulators in registers
// (ext_prod_small_kernel).
//
// Rows of n = 2^k 16384 (32768, 65536 and 131072) run the n = 16384 block
// program on sub-rows: a block per (row r, extended limb j, sub-row
// g < 2^k). The first k stages of a digit NTT pair whole sub-rows, so the
// block loads its column of every sub-row of the digit row (2^k loads a
// value; the blocks of the row's other sub-rows run beside it and read the
// same lines, from L2), computes those stages under q_j along the branch
// that ends in sub-row g (hh::fwd_cross), and runs the sub-row's 14 stages
// under its own table row (row j 2^k + g of the tables regrouped for
// sub-rows of 16384, whose rows also hold the cross stages' twiddles;
// ntt.cu's header gives the algebra). The kernel's arguments stay those of
// unsplit rows: two more pointers in ExtProdArgs cost K3/K4 3.5-5 % at
// n = 16384 (52 registers a thread instead of 64, PERF.md). Key and
// output are read and written at sub-row g of limb j, and the
// accumulation stays in digit order, so the output stays bitwise. At
// n = 32768 this replaced a program of 128 values a thread with the
// accumulators in the output rows, and at 65536 a split into sub-rows of
// 32768 on that program, which ran at 6.1x its bound (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "ntt.cuh"
#include "smallrow.cuh"

namespace {

struct ExtProdArgs {
  const uint32_t* digits;
  long long dig_row_stride, dig_digit_stride, dig_limb_stride;
  const uint32_t* key;
  long long key_row_stride, key_half_stride, key_limb_stride;
  const uint32_t* tw;  // [L_ext 2^k, n]: the regrouped tables of rows of n 2^k
  const uint32_t* tw_sh;
  const uint32_t* q;
  const uint32_t* two_q;
  const uint32_t* neg_qinv;
  uint32_t* out;
  int R, D, L_ext, logn;
};

// One block of T = n / 2^EB threads per (row r, extended limb j, sub-row g
// < 2^K) of rows of n 2^K values, n = 2^LOGN, block r 2^K + g of grid
// column j, so that the blocks of a row's sub-rows, which read the same
// digit lines, run side by side; thread tid ends each digit's NTT holding
// the E = 2^EB contiguous values tid E + e of sub-row g. The accumulators
// live in 2n words of shared memory after the exchange buffer, element e of
// thread tid at e T + tid.
template <int LOGN, int EB, int K = 0>
__global__ void __launch_bounds__(1 << (LOGN - EB)) ext_prod_kernel(const ExtProdArgs a) {
  extern __shared__ uint4 smem_ep[];
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_ep);
  constexpr int n = 1 << LOGN;
  constexpr long long NF = static_cast<long long>(n) << K;  // the row
  constexpr int E = 1 << EB;
  constexpr int T = n / E;
  uint32_t* acc0_sh = x + ((hh::padded<EB>(n) + 3) & ~3);
  uint32_t* acc1_sh = acc0_sh + n;
  const int tid = threadIdx.x;
  const int r = static_cast<int>(blockIdx.x >> K);
  const int g = static_cast<int>(blockIdx.x & ((1u << K) - 1));
  const int j = blockIdx.y;
  const uint32_t q = a.q[j];
  const uint32_t two_q = a.two_q[j];
  const uint32_t neg_qinv = a.neg_qinv[j];
  const uint32_t* rows = a.tw + (static_cast<long long>(j) << K) * n;  // limb j's tables
  const uint32_t* rows_sh = a.tw_sh + (static_cast<long long>(j) << K) * n;
  const uint32_t* twj = rows + g * n;  // sub-row g's
  const uint32_t* tw_shj = rows_sh + g * n;
  uint32_t w[K + 1], w_sh[K + 1];  // the cross stages' twiddles on g's branch
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int at = (1 << s) + (g >> (K - s));
    w[s] = hh::cross_twiddle<K>(rows, n, at);
    w_sh[s] = hh::cross_twiddle<K>(rows_sh, n, at);
  }
  const uint32_t* dig = a.digits + r * a.dig_row_stride + j * a.dig_limb_stride;
  uint4* o0 =
      reinterpret_cast<uint4*>(a.out + (static_cast<long long>(r) * a.L_ext + j) * NF + g * n) +
      tid * (E / 4);
  uint4* o1 = o0 + static_cast<long long>(a.R) * a.L_ext * NF / 4;

  for (int i = 0; i < a.D; ++i) {
    const uint32_t* d = dig + i * a.dig_digit_stride;
    uint32_t v[E];
    if constexpr (K == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = __ldg(d + e * T + tid);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        uint32_t y[1 << K];
#pragma unroll
        for (int u = 0; u < (1 << K); ++u) y[u] = __ldg(d + u * n + e * T + tid);
        v[e] = hh::fwd_cross<K>(y, g, w, w_sh, q, two_q);
      }
    }
    hh::fwd_stages_reg<LOGN, EB>(v, x, tid, twj, tw_shj, q, two_q);
    const uint4* k0 = reinterpret_cast<const uint4*>(a.key + i * a.key_row_stride +
                                                     j * a.key_limb_stride + g * n) +
                      tid * (E / 4);
    const uint4* k1 = k0 + a.key_half_stride / 4;
#pragma unroll
    for (int p = 0; p < E / 4; ++p) {
      const uint4 w0 = __ldg(k0 + p);
      const uint4 w1 = __ldg(k1 + p);
      const uint32_t kw0[4] = {w0.x, w0.y, w0.z, w0.w};
      const uint32_t kw1[4] = {w1.x, w1.y, w1.z, w1.w};
      uint32_t p0[4], p1[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p0[c] = hh::mont_mul_lazy(v[4 * p + c], kw0[c], q, neg_qinv);
        p1[c] = hh::mont_mul_lazy(v[4 * p + c], kw1[c], q, neg_qinv);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int at = (4 * p + c) * T + tid;
        acc0_sh[at] = i == 0 ? p0[c] : hh::add_lazy(acc0_sh[at], p0[c], two_q);
        acc1_sh[at] = i == 0 ? p1[c] : hh::add_lazy(acc1_sh[at], p1[c], two_q);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < E / 4; ++p) {
    uint32_t s0[4], s1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s0[c] = acc0_sh[(4 * p + c) * T + tid];
      s1[c] = acc1_sh[(4 * p + c) * T + tid];
    }
    o0[p] = make_uint4(s0[0], s0[1], s0[2], s0[3]);
    o1[p] = make_uint4(s1[0], s1[1], s1[2], s1[3]);
  }
}

// K3 and K4 on rows of n = 2^LOGN <= 512 (smallrow.cuh): the pairs
// (r, j) in order p = r L_ext + j, the order of the output rows, block b
// taking the pairs [b P, (b + 1) P), P = 2048 / n, so its output rows are
// contiguous. For each digit i the block loads the digit row of each of
// its pairs into shared memory, runs the forward stages under each pair's
// limb j, and each thread multiplies its kSmallElems values with the key
// rows key[i, 0, j] and key[i, 1, j], accumulating in registers in digit
// order as the large-row kernel does. The last block masks the pairs past
// R L_ext.
template <int LOGN>
__global__ void __launch_bounds__(hh::kSmallThreads) ext_prod_small_kernel(const ExtProdArgs a) {
  __shared__ uint32_t x[hh::kSmallValues];
  constexpr int n = 1 << LOGN;
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * hh::kSmallValues;
  const long long left = static_cast<long long>(a.R) * a.L_ext * n - first;
  const unsigned p0 = static_cast<unsigned>(first >> LOGN);
  // value k of the thread: element e of pair p (row r, limb j)
  const uint32_t* dig[hh::kSmallElems];
  const uint32_t* key[hh::kSmallElems];
  uint32_t q[hh::kSmallElems], two_q[hh::kSmallElems], neg_qinv[hh::kSmallElems];
#pragma unroll
  for (int k = 0; k < hh::kSmallElems; ++k) {
    const int at = k * hh::kSmallThreads + tid;
    const unsigned p = p0 + (at >> LOGN);
    const int e = at & (n - 1);
    const unsigned r = p / a.L_ext;
    const int j = static_cast<int>(p - r * a.L_ext);
    dig[k] = a.digits + r * a.dig_row_stride + j * a.dig_limb_stride + e;
    key[k] = a.key + j * a.key_limb_stride + e;
    q[k] = a.q[j];
    two_q[k] = a.two_q[j];
    neg_qinv[k] = a.neg_qinv[j];
  }
  hh::SmallLimbs c;
#pragma unroll
  for (int k = 0; k < hh::kSmallPairs; ++k) {
    const unsigned p = p0 + hh::small_row<LOGN>(tid, k);
    const int j = static_cast<int>(p % a.L_ext);
    c.tw[k] = a.tw + static_cast<long long>(j) * n;
    c.tw_sh[k] = a.tw_sh + static_cast<long long>(j) * n;
    c.q[k] = a.q[j];
    c.two_q[k] = a.two_q[j];
  }
  uint32_t acc0[hh::kSmallElems], acc1[hh::kSmallElems];
  for (int i = 0; i < a.D; ++i) {
    // each thread writes the words it read after the previous digit's
    // stages: the barrier that ended them keeps every other word's reads
    // before these writes
#pragma unroll
    for (int k = 0; k < hh::kSmallElems; ++k) {
      const int at = k * hh::kSmallThreads + tid;
      if (at < left) x[at] = __ldg(dig[k] + i * a.dig_digit_stride);
    }
    __syncthreads();
    hh::fwd_stages_small<LOGN>(x, tid, c);
#pragma unroll
    for (int k = 0; k < hh::kSmallElems; ++k) {
      const uint32_t v = x[k * hh::kSmallThreads + tid];
      const uint32_t* kr = key[k] + i * a.key_row_stride;
      const uint32_t p0v = hh::mont_mul_lazy(v, __ldg(kr), q[k], neg_qinv[k]);
      const uint32_t p1v = hh::mont_mul_lazy(v, __ldg(kr + a.key_half_stride), q[k], neg_qinv[k]);
      acc0[k] = i == 0 ? p0v : hh::add_lazy(acc0[k], p0v, two_q[k]);
      acc1[k] = i == 0 ? p1v : hh::add_lazy(acc1[k], p1v, two_q[k]);
    }
  }
  uint32_t* o0 = a.out + first;
  uint32_t* o1 = o0 + static_cast<long long>(a.R) * a.L_ext * n;
#pragma unroll
  for (int k = 0; k < hh::kSmallElems; ++k) {
    const int at = k * hh::kSmallThreads + tid;
    if (at < left) {
      o0[at] = acc0[k];
      o1[at] = acc1[k];
    }
  }
}

template <int LOGN>
int launch_small(const ExtProdArgs& a, cudaStream_t stream) {
  constexpr long long per_block = hh::kSmallValues >> LOGN;
  const long long blocks = (static_cast<long long>(a.R) * a.L_ext + per_block - 1) / per_block;
  ext_prod_small_kernel<LOGN><<<static_cast<unsigned>(blocks), hh::kSmallThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Sets the kernel's dynamic shared memory limit once per device (it may
// exceed the 48 KB default) and launches it: rows of n 2^K values.
template <int LOGN, int EB, int K = 0>
int launch(const ExtProdArgs& a, cudaStream_t stream) {
  constexpr int n = 1 << LOGN;
  constexpr size_t smem = (((n + (n >> EB) + 3) & ~3) + 2 * n) * sizeof(uint32_t);
  static unsigned configured = 0;
  const cudaError_t err = hh::set_max_smem_once(ext_prod_kernel<LOGN, EB, K>, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.R) << K, static_cast<unsigned>(a.L_ext));
  ext_prod_kernel<LOGN, EB, K><<<grid, n >> EB, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Several rows a block below n = 1024 (smallrow.cuh); 16 values a thread
// and the accumulators in shared memory up to n = 16384 (1024 threads
// there); above it the n = 16384 program on sub-rows of 16384 (a block
// cannot hold a longer row's accumulators beside its exchange buffer).
int dispatch(const ExtProdArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.logn) {
    case 3:
      return launch_small<3>(a, s);
    case 4:
      return launch_small<4>(a, s);
    case 5:
      return launch_small<5>(a, s);
    case 6:
      return launch_small<6>(a, s);
    case 7:
      return launch_small<7>(a, s);
    case 8:
      return launch_small<8>(a, s);
    case 9:
      return launch_small<9>(a, s);
    case 10:
      return launch<10, 4>(a, s);
    case 11:
      return launch<11, 4>(a, s);
    case 12:
      return launch<12, 4>(a, s);
    case 13:
      return launch<13, 4>(a, s);
    case 14:
      return launch<14, 4>(a, s);
    case 15:  // two sub-rows of 16384
      return launch<14, 4, 1>(a, s);
    case 16:  // four
      return launch<14, 4, 2>(a, s);
    case 17:  // eight
      return launch<14, 4, 3>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3. digits: [R, l, n] strict; key: element (i, half, j, e) at
// i*krs + half*khs + j*kls + e; tw/tw_sh: [L_ext, n], above n = 16384 the
// regrouped [L_ext n / 16384, 16384] (context.sub_row_tables);
// q/two_q/neg_qinv: [L_ext]; out: [2, R, L_ext, n]. n in [8, 131072].
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for an n out of range.
int hh_ext_prod(const uint32_t* digits, const uint32_t* key, long long krs, long long khs,
                long long kls, const uint32_t* tw, const uint32_t* tw_sh, const uint32_t* q,
                const uint32_t* two_q, const uint32_t* neg_qinv, uint32_t* out, int R, int l,
                int L_ext, int logn, void* stream) {
  const long long n = 1LL << logn;
  return dispatch({digits, l * n, n, 0, key, krs, khs, kls, tw, tw_sh, q, two_q, neg_qinv, out,
                   R, l, L_ext, logn},
                  stream);
}

// K4. digits: element (r, g, j, e) at r*drs + g*dgs + j*djs + e, lazy in
// [0, 2 q_j), every row start 16-byte aligned; the rest as hh_ext_prod, with
// D digit rows of the key.
int hh_ext_prod_conv(const uint32_t* digits, long long drs, long long dgs, long long djs,
                     const uint32_t* key, long long krs, long long khs, long long kls,
                     const uint32_t* tw, const uint32_t* tw_sh, const uint32_t* q,
                     const uint32_t* two_q, const uint32_t* neg_qinv, uint32_t* out, int R,
                     int D, int L_ext, int logn, void* stream) {
  return dispatch({digits, drs, dgs, djs, key, krs, khs, kls, tw, tw_sh, q, two_q, neg_qinv, out,
                   R, D, L_ext, logn},
                  stream);
}

}  // extern "C"
