// The ciphertext tensor product: (a0, a1) x (b0, b1) -> (p0, p1, p2), the
// three halves of a product before relinearization, in one launch.
//
// It replaces no Pallas kernel: hehub_tpu's tensor product
// (hehub_tpu/models/ckks.py:638 mult_low_level, and BGV's copy) is a jnp
// chain. It replaces the port's plain chain (ops/modarith.py's
// tensor_product_plain): two shoup_mul_lazy, four mont_mul_lazy and one
// add_lazy, each about ten to thirty-five int64 PyTorch kernels over 16-bit
// halves on the whole [batch, L, n] tensor, about 167 launches a product.
//
// Per coefficient of limb l (q, 2q, neg_qinv = (-q)^-1 mod 2^32, R = 2^32
// mod q and its Shoup word, all per limb):
//   b0' = shoup_mul_lazy(b0, R), b1' = shoup_mul_lazy(b1, R): b into the
//   Montgomery domain;
//   p0 = mont(a0, b0'), p1 = add_lazy(mont(a0, b1'), mont(a1, b0')),
//   p2 = mont(a1, b1').
// These are the plain chain's uint32 operations in its order
// (csrc/modarith.cuh), so the kernel is bitwise the chain.
//
// What bounds it on the H100: bytes. A coefficient reads four int64 words
// and writes three, 56 bytes, against about forty uint32 operations (a
// Shoup product three, a Montgomery product five), most of them IMADs on
// the FMA pipe: at std128's top level [64, 12, 16384] 704.6 MB move, 0.210
// ms at 3.35 TB/s, where 40 operations a coefficient at 16.7 T/s take 0.030
// ms. So the design moves each byte once and keeps the memory system busy:
// a thread takes 4 coefficients of one (batch, limb) row, loads each
// operand as two 16-byte longlong2 vectors (8 loads in flight a thread) and
// stores each output as two; a warp covers 128 contiguous coefficients of
// one row from n = 128 on, so every access is a whole 512-byte line and the
// row's five constants, loaded once a thread into registers, are
// warp-uniform. Each operand is read through its own batch and limb
// strides: the operands of a level-aligned product are views of a higher
// level (batch stride L' n), and copying them first would add four passes.
// The grid is (coefficient blocks of a row) x (blocks of rows): a block
// holds 256 threads, 1024 coefficients of one row, or for n < 1024 the
// whole of 1024 / n rows.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace {

constexpr int kLogThreads = 8;
constexpr int kThreads = 1 << kLogThreads;
constexpr long long kMaxGridY = 65535;

struct Operand {
  const long long* p;  // [R, L, n] words, lazy residues (the low 32 bits are read)
  long long batch_stride, limb_stride;  // in words
};

struct TensorArgs {
  Operand a0, a1, b0, b1;
  long long* out;  // [3, R, L, n]: p0, p1, p2
  const long long* q;  // [L] each (the low 32 bits are read)
  const long long* two_q;
  const long long* neg_qinv;
  const long long* r;
  const long long* r_sh;
  long long R, row_blocks;
  int L;
  int log_n4;   // log2(n / 4)
  int log_tpr;  // log2 of the threads a row takes in a block: min(8, log_n4)
};

// The 4 coefficients at `c` (a multiple of 4) of row (r, l).
__device__ __forceinline__ void load4(const Operand& o, long long r, int l, long long c,
                                      uint32_t (&x)[4]) {
  const long long* p = o.p + r * o.batch_stride + l * o.limb_stride + c;
  const longlong2 x01 = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 x23 = __ldg(reinterpret_cast<const longlong2*>(p + 2));
  x[0] = static_cast<uint32_t>(x01.x);
  x[1] = static_cast<uint32_t>(x01.y);
  x[2] = static_cast<uint32_t>(x23.x);
  x[3] = static_cast<uint32_t>(x23.y);
}

__device__ __forceinline__ void store4(long long* p, const uint32_t (&v)[4]) {
  reinterpret_cast<longlong2*>(p)[0] = make_longlong2(v[0], v[1]);
  reinterpret_cast<longlong2*>(p)[1] = make_longlong2(v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads) tensor_product_kernel(const TensorArgs a) {
  const int sub = threadIdx.x & ((1 << a.log_tpr) - 1);
  const long long c = ((static_cast<long long>(blockIdx.x) << a.log_tpr) + sub) * 4;
  const long long n = 4LL << a.log_n4;
  const long long rows = a.R * a.L;
  const int log_rpb = kLogThreads - a.log_tpr;  // rows a block
  for (long long rb = blockIdx.y; rb < a.row_blocks; rb += gridDim.y) {
    const long long row = (rb << log_rpb) + (threadIdx.x >> a.log_tpr);
    if (row >= rows) return;
    const long long r = row / a.L;
    const int l = static_cast<int>(row - r * a.L);
    const uint32_t q = static_cast<uint32_t>(__ldg(a.q + l));
    const uint32_t two_q = static_cast<uint32_t>(__ldg(a.two_q + l));
    const uint32_t neg_qinv = static_cast<uint32_t>(__ldg(a.neg_qinv + l));
    const uint32_t rm = static_cast<uint32_t>(__ldg(a.r + l));
    const uint32_t rm_sh = static_cast<uint32_t>(__ldg(a.r_sh + l));
    uint32_t a0[4], a1[4], b0[4], b1[4], p0[4], p1[4], p2[4];
    load4(a.a0, r, l, c, a0);
    load4(a.a1, r, l, c, a1);
    load4(a.b0, r, l, c, b0);
    load4(a.b1, r, l, c, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t m0 = hh::shoup_mul_lazy(b0[e], rm, rm_sh, q);
      const uint32_t m1 = hh::shoup_mul_lazy(b1[e], rm, rm_sh, q);
      p0[e] = hh::mont_mul_lazy(a0[e], m0, q, neg_qinv);
      p1[e] = hh::add_lazy(hh::mont_mul_lazy(a0[e], m1, q, neg_qinv),
                           hh::mont_mul_lazy(a1[e], m0, q, neg_qinv), two_q);
      p2[e] = hh::mont_mul_lazy(a1[e], m1, q, neg_qinv);
    }
    long long* o = a.out + row * n + c;
    store4(o, p0);
    store4(o + rows * n, p1);
    store4(o + 2 * rows * n, p2);
  }
}

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tensor product. a0, a1, b0, b1: [R, L, n] int64 lazy residues, each at
// its own batch and limb strides (in words, even), 16-byte aligned; out: [3,
// R, L, n] int64, contiguous; q, two_q, neg_qinv, r, r_sh: [L] int64; n =
// 2^(log_n4 + 2) >= 8. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments out of range.
int hh_tensor_product(const long long* a0, long long sa0_b, long long sa0_l, const long long* a1,
                      long long sa1_b, long long sa1_l, const long long* b0, long long sb0_b,
                      long long sb0_l, const long long* b1, long long sb1_b, long long sb1_l,
                      long long* out, const long long* q, const long long* two_q,
                      const long long* neg_qinv, const long long* r, const long long* r_sh,
                      long long R, int L, int log_n4, void* stream) {
  if (R < 0 || L < 0 || log_n4 < 1 || log_n4 > 29) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R == 0 || L == 0) return 0;
  const int log_tpr = log_n4 < kLogThreads ? log_n4 : kLogThreads;
  const long long rows = R * L;
  const long long row_blocks = (rows + (1LL << (kLogThreads - log_tpr)) - 1) >>
                               (kLogThreads - log_tpr);
  const TensorArgs args{{a0, sa0_b, sa0_l}, {a1, sa1_b, sa1_l}, {b0, sb0_b, sb0_l},
                        {b1, sb1_b, sb1_l}, out, q, two_q, neg_qinv, r, r_sh, R, row_blocks,
                        L, log_n4, log_tpr};
  const dim3 grid(static_cast<unsigned>(1LL << (log_n4 - log_tpr)),
                  static_cast<unsigned>(row_blocks < kMaxGridY ? row_blocks : kMaxGridY));
  tensor_product_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
