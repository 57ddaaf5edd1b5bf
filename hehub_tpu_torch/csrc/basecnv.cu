// The key switch's base changes: ModUp (below) and ModDown (further down,
// after ModUp's launch function).
//
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

// The blocks of a grid-stride loop over `items`: one item a thread, at most
// 2^20 blocks.
unsigned grid_for(unsigned long long items) {
  const unsigned long long want = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < (1ull << 20) ? want : (1ull << 20));
}

template <int KMAX>
int launch(const ModUpArgs& a, unsigned long long items, cudaStream_t stream) {
  modup_kernel<KMAX><<<grid_for(items), kThreads, 0, stream>>>(a, items);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// ModDown: the division of both halves of a ciphertext by its last C limbs
// (the special primes after a key switch, the dropped primes of a rescale),
// one limb after the other from the top, each with rounding.
//
// It replaces no Pallas kernel: hehub_tpu divides by one limb at a time in
// jnp (hehub_tpu/core/basecnv.py::div_last_rounded, called once a limb). It
// replaces the port's plain loop, C calls of div_last_rounded_pair
// (hehub_tpu_torch/core/basecnv.py), each K2 on the last limb, then about
// 25 int64 PyTorch kernels over 16-bit halves on every remaining limb
// around one K1 launch.
//
// One step of that loop, dropping limb e (prime q_e) from x in NTT form:
//   v = the strict coefficients of x_e (K2, then a fold);
//   r_j = (v mod q_j) + (q_j - q_e mod q_j) [v >= q_e / 2] under every
//   remaining limb j, the centred remainder, lazy in [0, 2 q_j); v mod q_j
//   is one conditional subtract where q_e < 2 min q_j (the uniform-width
//   branch), else a Shoup multiply by 1 and a fold (the mixed-width one);
//   x_j <- (x_j - NTT(r_j)) q_e^-1: sub_lazy, then shoup_mul_lazy.
// The chain runs the C steps in four launches, whatever C is:
//   1. K2 on the C dropped limbs of both halves;
//   2. moddown_lift_kernel: per coefficient, the strict values u of the
//      dropped limbs, then the walk from the top: step k takes v_k = u of
//      the limb it drops and moves every lower dropped limb d to (u_d -
//      r_d) q_e^-1 mod q_d, strict, in coefficient form; then r_kj of
//      every step k under every remaining limb j, as int32 [2R, C, L, n];
//   3. K1 on those C L rows of each row of the pair;
//   4. moddown_apply_kernel: per coefficient of a remaining limb, the C
//      steps' sub_lazy and shoup_mul_lazy in registers, in step order, and
//      one store of the result as int64.
// Why this is bitwise the loop: step k of the loop takes v_k as the strict
// coefficients of x_e, which steps 0 .. k-1 have moved in NTT form as the
// walk moves u_e in coefficient form. NTT and INTT are linear mod q_e, so
// the two agree mod q_e, and a strict value mod q_e is one number, however
// it is reached. From the same v_k the lift makes the same r_kj by the
// same operations (the branch included), K1 transforms a row independently
// of the others, and the apply gives each remaining limb the loop's uint32
// operations in the loop's order. Only the lower dropped limbs' updates,
// which the loop made in NTT form, are made otherwise, and each ends in a
// strict value.
//
// The constants come from one packed table per (limbs, C, device), built
// once (core/basecnv.py::moddown_tables), [L + C, 1 + C] uint4: per limb i
// (q_i, 2 q_i, floor(2^32 / q_i), 0), then per step k, while limb i lies
// below the limb e the step drops, (q_i - q_e mod q_i, q_e^-1 mod q_i, its
// Shoup word, 1 where the step takes the uniform-width branch).
//
// What bounds it on the H100: bytes. At deep65536's top level (R = 8, L =
// 54, C = 4, n = 65536) the lift writes 906 MB of corrections, K1 reads and
// writes them, the apply reads them and x (8 bytes a word) and writes the
// result: 4.53 GB, 1.35 ms at 3.35 TB/s, at a few uint32 operations a
// word, far under the integer peak. Nothing is reused, so the two kernels
// only keep every intermediate in registers: a thread takes 4 coefficients
// (16-byte loads and stores), a warp 128 contiguous ones of one row and
// limb from n = 128 on, so each table record is a warp-uniform load (L1)
// and each store a coalesced 512-byte line. The lift holds the C dropped
// values in registers, C a template parameter (1 .. kMaxCount), and writes
// the corrections of `group` remaining limbs an item: the caller makes the
// groups small enough that a batch-1 ciphertext still fills the card, each
// item re-reading its 16 C bytes of K2's output. Folding the lift into
// K1's load and the apply into K1's store would keep the corrections out
// of device memory.

constexpr int kMaxCount = 8;

struct LiftArgs {
  const uint4* low;  // [rows, C, n]: K2's output on the dropped limbs
  uint4* out;        // [rows, C, L, n]
  const uint4* tab;  // [L + C, 1 + C]
  int L, group, groups;
  int log_n4;  // log2(n / 4)
};

struct ApplyArgs {
  const long long* a;  // [R, L + C, n]: the first half
  const long long* b;  // [R, L + C, n]: the second half
  const uint4* rhat;   // [2R, C, L, n]: K1's output on the corrections
  long long* out;      // [2R, L, n]
  const uint4* tab;    // [L + C, 1 + C]
  long long R;
  int L, C;
  int log_n4;
};

// div_last_rounded's centred remainder of v under a limb (lim: q, 2q, the
// Shoup word of 1) at a step (st: its correction, inverse and branch) that
// drops a limb of q_e, half = floor(q_e / 2).
__device__ __forceinline__ uint32_t centred(uint32_t v, uint4 lim, uint4 st, uint32_t half) {
  const uint32_t m = st.w ? hh::reduce_strict(v, lim.x)
                          : hh::reduce_strict(hh::shoup_mul_lazy(v, 1u, lim.z, lim.x), lim.x);
  return m + (v >= half ? st.x : 0u);
}

// Coefficients 4 c4 .. 4 c4 + 3 of row `row`, the remaining limbs of group
// `grp`. u[p] is the dropped limb p from the top (limb L + C - 1 - p); step
// k drops u[k].
template <int C>
__device__ __forceinline__ void lift_item(const LiftArgs& a, long long row, int grp,
                                          long long c4) {
  constexpr int W = 1 + C;  // a limb's records
  const long long n4 = 1LL << a.log_n4;
  uint32_t u[C][4];
  uint32_t half[C];
#pragma unroll
  for (int p = 0; p < C; ++p) {
    const uint32_t q = __ldg(a.tab + (a.L + C - 1 - p) * W).x;
    half[p] = q >> 1;
    const uint4 x = __ldg(a.low + (row * C + C - 1 - p) * n4 + c4);
    u[p][0] = hh::reduce_strict(x.x, q);
    u[p][1] = hh::reduce_strict(x.y, q);
    u[p][2] = hh::reduce_strict(x.z, q);
    u[p][3] = hh::reduce_strict(x.w, q);
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
#pragma unroll
    for (int p = k + 1; p < C; ++p) {
      const uint4* rec = a.tab + (a.L + C - 1 - p) * W;
      const uint4 lim = __ldg(rec), st = __ldg(rec + 1 + k);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t r = centred(u[k][e], lim, st, half[k]);
        u[p][e] = hh::reduce_strict(
            hh::shoup_mul_lazy(hh::sub_lazy(u[p][e], r, lim.y), st.y, st.z, lim.x), lim.x);
      }
    }
  }
  const int j1 = min(a.L, (grp + 1) * a.group);
  for (int j = grp * a.group; j < j1; ++j) {
    const uint4* rec = a.tab + j * W;
    const uint4 lim = __ldg(rec);
    uint4* o = a.out + (row * C * a.L + j) * n4 + c4;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const uint4 st = __ldg(rec + 1 + k);
      o[k * a.L * n4] = make_uint4(centred(u[k][0], lim, st, half[k]),
                                   centred(u[k][1], lim, st, half[k]),
                                   centred(u[k][2], lim, st, half[k]),
                                   centred(u[k][3], lim, st, half[k]));
    }
  }
}

// A grid-stride loop over the items (row, group of remaining limbs, 4
// coefficients c4), c4 fastest.
template <int C>
__global__ void __launch_bounds__(kThreads) moddown_lift_kernel(const LiftArgs a,
                                                                unsigned long long items) {
  const unsigned long long n4_mask = (1ull << a.log_n4) - 1;
  for (unsigned long long it = static_cast<unsigned long long>(blockIdx.x) * kThreads +
                               threadIdx.x;
       it < items; it += static_cast<unsigned long long>(gridDim.x) * kThreads) {
    const unsigned long long rg = it >> a.log_n4;
    const long long row = static_cast<long long>(rg / static_cast<unsigned>(a.groups));
    const int grp = static_cast<int>(rg - static_cast<unsigned long long>(row) * a.groups);
    lift_item<C>(a, row, grp, static_cast<long long>(it & n4_mask));
  }
}

// A grid-stride loop over the items (row of the pair, remaining limb j, 4
// coefficients c4), c4 fastest; rows 0 .. R-1 are the first half's, R ..
// 2R-1 the second's.
__global__ void __launch_bounds__(kThreads) moddown_apply_kernel(const ApplyArgs a,
                                                                 unsigned long long items) {
  const unsigned long long n4_mask = (1ull << a.log_n4) - 1;
  const long long n4 = 1LL << a.log_n4;
  for (unsigned long long it = static_cast<unsigned long long>(blockIdx.x) * kThreads +
                               threadIdx.x;
       it < items; it += static_cast<unsigned long long>(gridDim.x) * kThreads) {
    const unsigned long long rj = it >> a.log_n4;
    const long long hr = static_cast<long long>(rj / static_cast<unsigned>(a.L));
    const int j = static_cast<int>(rj - static_cast<unsigned long long>(hr) * a.L);
    const long long c4 = static_cast<long long>(it & n4_mask);
    const long long r = hr < a.R ? hr : hr - a.R;
    const long long* x = (hr < a.R ? a.a : a.b) + ((r * (a.L + a.C) + j) * n4 + c4) * 4;
    const longlong2 x01 = __ldg(reinterpret_cast<const longlong2*>(x));
    const longlong2 x23 = __ldg(reinterpret_cast<const longlong2*>(x + 2));
    uint32_t v[4] = {static_cast<uint32_t>(x01.x), static_cast<uint32_t>(x01.y),
                     static_cast<uint32_t>(x23.x), static_cast<uint32_t>(x23.y)};
    const uint4* rec = a.tab + static_cast<long long>(j) * (1 + a.C);
    const uint4 lim = __ldg(rec);
    const uint4* rh = a.rhat + (hr * a.C * a.L + j) * n4 + c4;
    for (int k = 0; k < a.C; ++k) {
      const uint4 st = __ldg(rec + 1 + k);
      const uint4 y = __ldg(rh + k * a.L * n4);
      v[0] = hh::shoup_mul_lazy(hh::sub_lazy(v[0], y.x, lim.y), st.y, st.z, lim.x);
      v[1] = hh::shoup_mul_lazy(hh::sub_lazy(v[1], y.y, lim.y), st.y, st.z, lim.x);
      v[2] = hh::shoup_mul_lazy(hh::sub_lazy(v[2], y.z, lim.y), st.y, st.z, lim.x);
      v[3] = hh::shoup_mul_lazy(hh::sub_lazy(v[3], y.w, lim.y), st.y, st.z, lim.x);
    }
    longlong2* o = reinterpret_cast<longlong2*>(a.out + ((hr * a.L + j) * n4 + c4) * 4);
    o[0] = make_longlong2(v[0], v[1]);
    o[1] = make_longlong2(v[2], v[3]);
  }
}

// Launches the lift's instance for count (1 .. kMaxCount, checked by the
// caller).
template <int C>
int launch_lift(int count, const LiftArgs& a, unsigned long long items, cudaStream_t stream) {
  if constexpr (C < kMaxCount) {
    if (count != C) return launch_lift<C + 1>(count, a, items, stream);
  }
  moddown_lift_kernel<C><<<grid_for(items), kThreads, 0, stream>>>(a, items);
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

// ModDown's lift. low: [rows, count, n] int32 bits (K2's output on the
// dropped limbs), out: [rows, count, L, n], tab: [L + count, 1 + count, 4]
// words (core/basecnv.py::moddown_tables), all 16-byte aligned; each item
// writes `group` remaining limbs; n = 2^(log_n4 + 2) >= 8; 1 <= count <=
// 8. Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments out of range.
int hh_moddown_lift(const uint32_t* low, uint32_t* out, const uint32_t* tab, long long rows,
                    int L, int count, int group, int log_n4, void* stream) {
  if (count < 1 || count > kMaxCount || L < 1 || group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (L + group - 1) / group;
  const LiftArgs a{reinterpret_cast<const uint4*>(low), reinterpret_cast<uint4*>(out),
                   reinterpret_cast<const uint4*>(tab), L, group, groups, log_n4};
  const unsigned long long items = static_cast<unsigned long long>(rows) * groups << log_n4;
  if (items == 0) return 0;
  return launch_lift<1>(count, a, items, static_cast<cudaStream_t>(stream));
}

// ModDown's apply. a, b: [R, L + count, n] int64 (lazy residues, the low 32
// bits read), rhat: [2R, count, L, n] int32 bits (K1's output on the
// lift's), out: [2R, L, n] int64, tab as the lift's, all 16-byte aligned;
// n = 2^(log_n4 + 2) >= 8; count >= 1. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments out of range.
int hh_moddown_apply(const long long* a, const long long* b, const uint32_t* rhat,
                     long long* out, const uint32_t* tab, long long R, int L, int count,
                     int log_n4, void* stream) {
  if (count < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ApplyArgs args{a, b, reinterpret_cast<const uint4*>(rhat), out,
                       reinterpret_cast<const uint4*>(tab), R, L, count, log_n4};
  const unsigned long long items = static_cast<unsigned long long>(2 * R) * L << log_n4;
  if (items == 0) return 0;
  moddown_apply_kernel<<<grid_for(items), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, items);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
