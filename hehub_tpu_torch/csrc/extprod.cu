// K3 and K4: the fused external product (RNS key switching), one thread
// block per (row r, extended output limb j).
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
// For each digit i < D the block loads the digit row into shared memory,
// runs the forward NTT under q_j on it (the same device stage chain as K1,
// which takes lazy [0, 2q) inputs), and multiplies it with the key rows
// key[i, 0, j] and key[i, 1, j] (Montgomery domain) by mont_mul_lazy. The
// two products accumulate in registers in digit order, acc = p_0, then
// acc = add_lazy(acc, p_i), exactly as ks_contract does, so the output is
// bitwise equal to the plain ks_contract(ntt(digits)) of
// hehub_tpu_torch/rlwe/rgsw.py (and to hehub_tpu.rlwe.rgsw.ext_prod).
// The digit NTTs never reach device memory.
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
// What bounds it on the H100: D * L_ext digit NTTs per row (56 for K3 at
// the main path, l=7 and L_ext=8; 84 for K4 at the hybrid path, D=6 and
// L_ext=14) of log2(n) butterfly stages each dominate the arithmetic. K3
// reads each digit row L_ext times (from L2 after the first), K4 each of
// its digit rows once; both read each key column R times (from L2 after
// the first). The accumulators take 2 n / blockDim registers per thread
// (32 at n=16384).
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt.cuh"

namespace {

struct ExtProdArgs {
  const uint32_t* digits;
  long long dig_row_stride, dig_digit_stride, dig_limb_stride;
  const uint32_t* key;
  long long key_row_stride, key_half_stride, key_limb_stride;
  const uint32_t* tw;
  const uint32_t* tw_sh;
  const uint32_t* q;
  const uint32_t* two_q;
  const uint32_t* neg_qinv;
  uint32_t* out;
  int R, D, L_ext, logn;
};

template <int PER>
__global__ void __launch_bounds__(1024) ext_prod_kernel(const ExtProdArgs a) {
  extern __shared__ uint4 smem_ep[];
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_ep);
  const int n = 1 << a.logn;
  const int r = blockIdx.x;
  const int j = blockIdx.y;
  const uint32_t q = a.q[j];
  const uint32_t two_q = a.two_q[j];
  const uint32_t neg_qinv = a.neg_qinv[j];
  const uint32_t* twj = a.tw + static_cast<long long>(j) * n;
  const uint32_t* tw_shj = a.tw_sh + static_cast<long long>(j) * n;
  const uint32_t* dig = a.digits + r * a.dig_row_stride + j * a.dig_limb_stride;

  uint32_t acc0[PER];
  uint32_t acc1[PER];
  for (int i = 0; i < a.D; ++i) {
    hh::load_row(x, dig + i * a.dig_digit_stride, n);
    __syncthreads();
    hh::fwd_stages(x, twj, tw_shj, q, two_q, a.logn);
    const uint32_t* k0 = a.key + i * a.key_row_stride + j * a.key_limb_stride;
    const uint32_t* k1 = k0 + a.key_half_stride;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = threadIdx.x + p * blockDim.x;
      const uint32_t v = x[e];
      const uint32_t p0 = hh::mont_mul_lazy(v, __ldg(k0 + e), q, neg_qinv);
      const uint32_t p1 = hh::mont_mul_lazy(v, __ldg(k1 + e), q, neg_qinv);
      acc0[p] = i == 0 ? p0 : hh::add_lazy(acc0[p], p0, two_q);
      acc1[p] = i == 0 ? p1 : hh::add_lazy(acc1[p], p1, two_q);
    }
    __syncthreads();  // the next digit overwrites x
  }
  uint32_t* o0 = a.out + (static_cast<long long>(r) * a.L_ext + j) * n;
  uint32_t* o1 = o0 + static_cast<long long>(a.R) * a.L_ext * n;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int e = threadIdx.x + p * blockDim.x;
    o0[e] = acc0[p];
    o1[e] = acc1[p];
  }
}

template <int PER>
int launch(const ExtProdArgs& a, cudaStream_t stream) {
  const int n = 1 << a.logn;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ext_prod_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.R), static_cast<unsigned>(a.L_ext));
  ext_prod_kernel<PER><<<grid, n / PER, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// blockDim = n / PER: 512 threads at n=1024, 1024 threads above
int dispatch(const ExtProdArgs& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.logn) {
    case 10:
      return launch<2>(a, s);
    case 11:
      return launch<2>(a, s);
    case 12:
      return launch<4>(a, s);
    case 13:
      return launch<8>(a, s);
    case 14:
      return launch<16>(a, s);
    case 15:
      return launch<32>(a, s);
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
// i*krs + half*khs + j*kls + e; tw/tw_sh: [L_ext, n]; q/two_q/neg_qinv:
// [L_ext]; out: [2, R, L_ext, n]. n in [1024, 32768]. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an n
// out of range.
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
