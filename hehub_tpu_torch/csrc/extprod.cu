// K3: the fused alpha=1 external product (RNS key switching), one thread
// block per (row r, extended output limb j).
//
// Replaces the TPU kernel hehub_tpu/ops/pallas/extprod_pallas.py::_kernel,
// built by make_ext_prod and called from hehub_tpu/rlwe/rgsw.py::ext_prod.
//
// For each digit i < l the block loads the strict coefficient-form digit
// row digits[r, i] into shared memory, runs the forward NTT under q_j on it
// (the same device stage chain as K1), and multiplies it with the key rows
// key[i, 0, j] and key[i, 1, j] (Montgomery domain) by mont_mul_lazy. The
// two products accumulate in registers in digit order, acc = p_0, then
// acc = add_lazy(acc, p_i), exactly as ks_contract does, so the output is
// bitwise equal to the plain ks_contract(ks_digits(...)) of
// hehub_tpu_torch/rlwe/rgsw.py (and to hehub_tpu.rlwe.rgsw.ext_prod).
// The digit NTTs never reach device memory.
//
// Assumption kept from the reference (hehub_tpu/rlwe/rgsw.py:269-272): a
// strict digit below q_i is a valid lazy input under every q_j. It holds
// for the 30-bit primes of create_ckks_params, all in [2^29, 2^30), since
// then q_i < 2^30 <= 2 q_j.
//
// The key is read in place from the RGSW tensor [rows, 2, L_ext, n] through
// its strides, so no transposed key copy is made; c0 and c1 are written
// directly as out[2, R, L_ext, n], the layout of the two output RnsPolys.
//
// What bounds it on the H100: l * L_ext digit NTTs per row (56 at the main
// path, l=7 and L_ext=8) of log2(n) butterfly stages each dominate the
// arithmetic; each digit row is read L_ext times (from L2 after the first)
// and each key column R times. The accumulators take 2 n / blockDim
// registers per thread (32 at n=16384).
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt.cuh"

namespace {

template <int PER>
__global__ void __launch_bounds__(1024)
    ext_prod_kernel(const uint32_t* __restrict__ digits, const uint32_t* __restrict__ key,
                    long long key_row_stride, long long key_half_stride,
                    long long key_limb_stride, const uint32_t* __restrict__ tw,
                    const uint32_t* __restrict__ tw_sh, const uint32_t* __restrict__ q_arr,
                    const uint32_t* __restrict__ two_q_arr,
                    const uint32_t* __restrict__ neg_qinv_arr, uint32_t* __restrict__ out,
                    int R, int l, int L_ext, int logn) {
  extern __shared__ uint4 smem_ep[];
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_ep);
  const int n = 1 << logn;
  const int r = blockIdx.x;
  const int j = blockIdx.y;
  const uint32_t q = q_arr[j];
  const uint32_t two_q = two_q_arr[j];
  const uint32_t neg_qinv = neg_qinv_arr[j];
  const uint32_t* twj = tw + static_cast<long long>(j) * n;
  const uint32_t* tw_shj = tw_sh + static_cast<long long>(j) * n;

  uint32_t acc0[PER];
  uint32_t acc1[PER];
  for (int i = 0; i < l; ++i) {
    hh::load_row(x, digits + (static_cast<long long>(r) * l + i) * n, n);
    __syncthreads();
    hh::fwd_stages(x, twj, tw_shj, q, two_q, logn);
    const uint32_t* k0 = key + i * key_row_stride + j * key_limb_stride;
    const uint32_t* k1 = k0 + key_half_stride;
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
  uint32_t* o0 = out + (static_cast<long long>(r) * L_ext + j) * n;
  uint32_t* o1 = o0 + static_cast<long long>(R) * L_ext * n;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int e = threadIdx.x + p * blockDim.x;
    o0[e] = acc0[p];
    o1[e] = acc1[p];
  }
}

template <int PER>
int launch(const uint32_t* digits, const uint32_t* key, long long krs, long long khs,
           long long kls, const uint32_t* tw, const uint32_t* tw_sh, const uint32_t* q,
           const uint32_t* two_q, const uint32_t* neg_qinv, uint32_t* out, int R, int l,
           int L_ext, int logn, cudaStream_t stream) {
  const int n = 1 << logn;
  const size_t smem = static_cast<size_t>(n) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ext_prod_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>(L_ext));
  ext_prod_kernel<PER><<<grid, n / PER, smem, stream>>>(digits, key, krs, khs, kls, tw, tw_sh,
                                                        q, two_q, neg_qinv, out, R, l, L_ext,
                                                        logn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// digits: [R, l, n] strict; key: element (i, half, j, e) at
// i*krs + half*khs + j*kls + e; tw/tw_sh: [L_ext, n]; q/two_q/neg_qinv:
// [L_ext]; out: [2, R, L_ext, n]. n in [1024, 32768]. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an n
// out of range.
int hh_ext_prod(const uint32_t* digits, const uint32_t* key, long long krs, long long khs,
                long long kls, const uint32_t* tw, const uint32_t* tw_sh, const uint32_t* q,
                const uint32_t* two_q, const uint32_t* neg_qinv, uint32_t* out, int R, int l,
                int L_ext, int logn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // blockDim = n / PER: 512 threads at n=1024, 1024 threads above
  switch (logn) {
    case 10:
      return launch<2>(digits, key, krs, khs, kls, tw, tw_sh, q, two_q, neg_qinv, out, R, l,
                       L_ext, logn, s);
    case 11:
      return launch<2>(digits, key, krs, khs, kls, tw, tw_sh, q, two_q, neg_qinv, out, R, l,
                       L_ext, logn, s);
    case 12:
      return launch<4>(digits, key, krs, khs, kls, tw, tw_sh, q, two_q, neg_qinv, out, R, l,
                       L_ext, logn, s);
    case 13:
      return launch<8>(digits, key, krs, khs, kls, tw, tw_sh, q, two_q, neg_qinv, out, R, l,
                       L_ext, logn, s);
    case 14:
      return launch<16>(digits, key, krs, khs, kls, tw, tw_sh, q, two_q, neg_qinv, out, R, l,
                        L_ext, logn, s);
    case 15:
      return launch<32>(digits, key, krs, khs, kls, tw, tw_sh, q, two_q, neg_qinv, out, R, l,
                        L_ext, logn, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
