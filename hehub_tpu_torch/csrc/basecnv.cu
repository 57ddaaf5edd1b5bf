// ModUp: the base conversion of the hybrid (alpha > 1) key switch, every
// digit group of every row in one launch.
//
// It replaces no Pallas kernel: hehub_tpu's base conversion
// (hehub_tpu/core/basecnv.py::base_convert, called per digit group by
// hehub_tpu/rlwe/rgsw.py) is jnp. It replaces the port's plain chain, one
// base_convert(ctx, take_limbs(d, group), ids_ext, signed=True) per digit
// group (hehub_tpu_torch/core/basecnv.py, called by rlwe/rgsw.py's
// _coeff_digits), which ran about ten int64 PyTorch kernels over 16-bit
// halves per Shoup multiply on an int64 [R, L_ext, alpha, n] tensor of
// terms, group after group.
//
// Input: the strict coefficient-form source limbs [R, l, n] as int64 (the
// low 32 bits are read). Output: the key switch's coefficient-form digits
// [R, D, L_ext, n], D = ceil(l / alpha), the uint32 bits K4
// (hh_ext_prod_conv) takes, lazy in [0, 2 p_j) under destination limb j.
// For a coefficient x of group g (source limbs q_i, product Q, the last
// group ragged: 1 .. alpha limbs), under destination limb p_j:
//   y_i = x_i (Q/q_i)^-1 mod q_i, strict (a Shoup multiply, then a fold);
//   z_i = y_i c_hi + mul_hi(y_i, c_lo) mod 2^32, c = floor(2^64 / q_i),
//   the 0.32 fixed point of y_i / q_i; v = the carries out of the uint32
//   sum of the z_i in limb order, plus the rounding bit (the sum's top
//   bit): the signed lift's count of Q;
//   out_j = Σ_i y_i (Q/q_i mod p_j) - v (Q mod p_j): a Shoup multiply a
//   term, summed by reduce_add_lazy's tree (pairing i with i + k/2, an odd
//   last carried), and the correction subtracted lazily.
// These are base_convert's operations in its order, so the output is
// bitwise equal to the plain chain's, for the in-group destination limbs
// too (they go through the same formula).
//
// The constants come from one packed table per (source limbs, destination
// limbs, alpha, device), built once (core/basecnv.py::modup_tables):
// per source limb (qhat_inv, its Shoup word, q_i, c_hi, c_lo, 0, 0, 0);
// per (group, destination limb) a record of (p_j, 2 p_j, Q mod p_j, its
// Shoup word), then (Q/q_i mod p_j, its Shoup word) per member of the
// group, padded to whole uint4.
//
// What bounds it on the H100: its bytes at 3.35 TB/s (each source word
// read once, 8 bytes as int64; each digit word written once). Its uint32
// operations, counted as the other kernels' are (7 K + 5 an output of a
// group of K limbs, 12 a source coefficient), read longer than that at
// 16.7 T/s at alpha = 4, yet the kernel runs faster than that term: for
// sm_90a ptxas makes 27 instructions an output at K = 4 (a Shoup product
// is three IMADs, an add and its min one VIADDMNMX), 16 of them IMADs,
// which run on the FMA pipe beside the integer ALU's, so their least
// time lies under the bytes term. Nothing is reused, so the design only
// keeps every intermediate in registers: a thread takes 4 coefficients of
// one (row, group), loads its K source limbs as 16-byte vectors, makes
// y, z and v once, then walks the L_ext destination limbs and writes each
// 4 outputs as one uint4 as soon as they are made. A warp covers 128
// contiguous coefficients of one (row, group) from n = 128 on, so the
// per-(group, destination) record is a warp-uniform load (L1), and each
// store is a coalesced 512-byte line. The group size K is a template
// parameter (1 .. alpha, dispatched per thread from alpha and l), so the
// terms and the tree stay in registers; the kernel is instantiated for
// groups up to 2, 4, 8 and 16 limbs, the smallest that holds alpha.
#include <cuda_runtime.h>

#include <cstdint>

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAlpha = 16;
constexpr int kSrcWords = 8;  // a source limb's record: two uint4

struct ModUpArgs {
  const long long* src;  // [R, l, n]
  uint32_t* out;         // [R, D, L_ext, n]
  const uint4* src_tab;  // [l, kSrcWords] words
  const uint4* dst_tab;  // [D, L_ext, 4 rec4] words
  int l, alpha, D, L_ext;
  int log_n4;  // log2(n / 4)
  int rec4;    // a (group, destination) record's uint4s
};

// reduce_add_lazy's tree over t[0 .. K): t[i] += t[i + K/2] for i < K/2,
// an odd last term carried to t[K/2], until one is left in t[0].
template <int K, int N>
__device__ __forceinline__ void tree_add(uint32_t (&t)[N], uint32_t two_p) {
  if constexpr (K > 1) {
    constexpr int half = K / 2;
#pragma unroll
    for (int i = 0; i < half; ++i) t[i] = hh::add_lazy(t[i], t[i + half], two_p);
    if constexpr (K % 2 == 1) t[half] = t[2 * half];
    tree_add<half + K % 2>(t, two_p);
  }
}

// Coefficients 4 c4 .. 4 c4 + 3 of row r, group g of K source limbs.
template <int K>
__device__ __forceinline__ void modup_group(const ModUpArgs& a, long long r, int g,
                                            long long c4) {
  const long long n = 4LL << a.log_n4;
  const int s0 = g * a.alpha;
  const long long* x = a.src + (r * a.l + s0) * n + 4 * c4;
  uint32_t y[K][4];
  uint32_t lo[4] = {0u, 0u, 0u, 0u}, v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const uint4* rec = a.src_tab + (s0 + m) * (kSrcWords / 4);
    const uint4 s = __ldg(rec);  // qhat_inv, its Shoup word, q, c_hi
    const uint32_t c_lo = __ldg(rec + 1).x;
    const longlong2 x01 = __ldg(reinterpret_cast<const longlong2*>(x + m * n));
    const longlong2 x23 = __ldg(reinterpret_cast<const longlong2*>(x + m * n + 2));
    const uint32_t xs[4] = {static_cast<uint32_t>(x01.x), static_cast<uint32_t>(x01.y),
                            static_cast<uint32_t>(x23.x), static_cast<uint32_t>(x23.y)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t yi = hh::reduce_strict(hh::shoup_mul_lazy(xs[e], s.x, s.y, s.z), s.z);
      y[m][e] = yi;
      const uint32_t z = yi * s.w + __umulhi(yi, c_lo);
      const uint32_t sum = lo[e] + z;
      v[e] += sum < z ? 1u : 0u;
      lo[e] = sum;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] += lo[e] >> 31;  // signed: round
  uint32_t* o = a.out + (r * a.D + g) * a.L_ext * n + 4 * c4;
  const uint4* rec = a.dst_tab + static_cast<long long>(g) * a.L_ext * a.rec4;
  for (int j = 0; j < a.L_ext; ++j, rec += a.rec4, o += n) {
    const uint4 h = __ldg(rec);  // p, 2p, Q mod p, its Shoup word
    uint32_t w[K], w_sh[K];
    const uint2* pairs = reinterpret_cast<const uint2*>(rec + 1);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const uint2 pw = __ldg(pairs + m);
      w[m] = pw.x;
      w_sh[m] = pw.y;
    }
    uint32_t res[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t t[K];
#pragma unroll
      for (int m = 0; m < K; ++m) t[m] = hh::shoup_mul_lazy(y[m][e], w[m], w_sh[m], h.x);
      tree_add<K>(t, h.y);
      res[e] = hh::sub_lazy(t[0], hh::shoup_mul_lazy(v[e], h.z, h.w, h.x), h.y);
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(res[0], res[1], res[2], res[3]);
  }
}

template <int K, int KMAX>
__device__ __forceinline__ void dispatch_group(const ModUpArgs& a, int k, long long r, int g,
                                               long long c4) {
  if constexpr (K <= KMAX) {
    if (k == K) {
      modup_group<K>(a, r, g, c4);
    } else {
      dispatch_group<K + 1, KMAX>(a, k, r, g, c4);
    }
  }
}

// A grid-stride loop over the items (row r, group g, 4 coefficients c4),
// c4 fastest. KMAX >= alpha bounds the group sizes the kernel holds code
// for, and its registers are those of its largest group: 40 a thread at
// KMAX = 2, 64 at 4, 197 at 16 (one block an SM; with every size up to 16
// in one kernel, alpha = 2 and 4 ran 1.3-1.7x slower on an H100).
template <int KMAX>
__global__ void __launch_bounds__(kThreads) modup_kernel(const ModUpArgs a,
                                                         unsigned long long items) {
  const unsigned long long n4_mask = (1ull << a.log_n4) - 1;
  for (unsigned long long it = static_cast<unsigned long long>(blockIdx.x) * kThreads +
                               threadIdx.x;
       it < items; it += static_cast<unsigned long long>(gridDim.x) * kThreads) {
    const unsigned long long rg = it >> a.log_n4;
    const long long r = static_cast<long long>(rg / static_cast<unsigned>(a.D));
    const int g = static_cast<int>(rg - static_cast<unsigned long long>(r) * a.D);
    const int k = min(a.alpha, a.l - g * a.alpha);
    dispatch_group<1, KMAX>(a, k, r, g, static_cast<long long>(it & n4_mask));
  }
}

template <int KMAX>
int launch(const ModUpArgs& a, unsigned long long items, cudaStream_t stream) {
  const unsigned long long want = (items + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1ull << 20) ? want : (1ull << 20));
  modup_kernel<KMAX><<<blocks, kThreads, 0, stream>>>(a, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ModUp. src: [R, l, n] int64 strict residues, 16-byte aligned; out: [R, D,
// L_ext, n], D = ceil(l / alpha); src_tab: [l, 8] words; dst_tab: [D, L_ext,
// 4 rec4] words (core/basecnv.py::modup_tables), both 16-byte aligned; n =
// 2^(log_n4 + 2) >= 8; 1 <= alpha <= 16. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an alpha out of range.
int hh_modup(const long long* src, uint32_t* out, const uint32_t* src_tab,
             const uint32_t* dst_tab, long long R, int l, int alpha, int L_ext, int log_n4,
             int rec4, void* stream) {
  if (alpha < 1 || alpha > kMaxAlpha || 4 * rec4 < 4 + 2 * alpha) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int D = (l + alpha - 1) / alpha;
  const ModUpArgs a{src, out, reinterpret_cast<const uint4*>(src_tab),
                    reinterpret_cast<const uint4*>(dst_tab), l, alpha, D, L_ext, log_n4, rec4};
  const unsigned long long items = static_cast<unsigned long long>(R) * D << log_n4;
  if (items == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alpha <= 2) return launch<2>(a, items, s);
  if (alpha <= 4) return launch<4>(a, items, s);
  if (alpha <= 8) return launch<8>(a, items, s);
  return launch<kMaxAlpha>(a, items, s);
}

}  // extern "C"
