// K1 and K2: the forward and inverse negacyclic NTT of [rows, n] uint32
// residue rows, two thread blocks per row up to n = 32768 (2 n / 32768
// above it).
//
// K1 (hh_ntt_fwd) replaces the TPU kernel
// hehub_tpu/ops/pallas/ntt_pallas.py::_fwd_kernel (+ fwd_stage_chain), K2
// (hh_ntt_inv) replaces ntt_pallas.py::_inv_kernel, both built by make_ntt.
//
// What bounds them on the H100: the integer operations of log2(n) stages of
// n/2 Shoup butterflies per row (14 stages at n = 16384, about twice the
// time of the row's one read and one write at the memory rate), and, in
// launches of about one wave of blocks (the key switches launch 128 rows),
// the latency of a block's load, dependent butterfly chains and store.
//
// The design: the stages run in registers (ntt.cuh), 16 values a thread, in
// groups of four between padded exchanges through shared memory, a twiddle
// pair loaded once per (stage, twiddle). A row is split over two blocks of
// n/32 threads (512 at n = 16384), one per half: only the first forward
// stage and the last inverse stage pair the halves. K1's two blocks each
// read the whole row and compute that stage for their own half (the second
// read comes from L2); K2's two blocks form a cluster and share the last
// stage through distributed shared memory. Two independent blocks an SM
// (64 registers a thread) overlap one block's loads and stores with the
// other's butterflies, and the waves come in half rows. One block of n/16
// threads a row (1024 at n = 16384, one block an SM) ran 1.3-1.5x slower
// at the main path's 448 rows: every SM loaded, computed and stored in
// step (PERF.md). Device memory sees each element read once (K1: once more
// from L2) and written once; K1 stores after one more exchange, coalesced
// (its 16 contiguous words a thread, stored as uint4, cost 6 %), K2 loads
// 16 contiguous words a thread as uint4. Twiddles come from the compact
// [L, n] Context tables (tw_fwd/tw_inv and their Shoup companions), which
// stay in L2.
//
// Rows of n <= 512 are shorter than the chains' 16 values a thread on two
// blocks allow (a half row of n = 512 is 16 threads): there a block holds
// 2048 / n whole rows and runs their stages in shared memory, 256 threads,
// no cluster (ntt_small_kernel, smallrow.cuh).
//
// Rows of n = 2^k 32768 (65536 and 131072) are longer than two blocks of
// at most 1024 threads hold at 16 values a thread. They are split into 2^k
// sub-rows of 32768: the first k forward stages pair whole sub-rows, and
// after them sub-row j is an ordinary 32768-point row under its own table
// row sub_j[2^s + i] = tw[2^(s+k) + j 2^s + i] (Context's tables regrouped
// for sub-rows of 32768, [L 2^k, 32768], context.sub_row_tables; the
// inverse chain's first 15 stages act within sub-rows under the same
// regrouping). K1 runs 2^(k+1)
// blocks a row, one per half sub-row g: each reads the 2^(k+1) values of
// its column in every half sub-row (from L2 after the first block of the
// row) and computes the k + 1 stages that pair them only along the branch
// that ends in its own half (hh::fwd_cross), as the two blocks of a
// 32768-point row already did for its one such stage; then the sub-row's
// stages 1 .. 14 run as at n = 32768, under the regrouped table. K2 runs a
// cluster of 2^(k+1) blocks a row (4 or 8): each runs its half sub-row's
// first 14 stages under the regrouped table, and the last k + 1 stages,
// which pair the half sub-rows (the last one folding n^-1), run across the
// cluster through distributed shared memory on columns of 2^(k+1) values
// (hh::inv_cross), as the two-block cluster does at n = 32768. So every
// butterfly keeps its operands and the output stays bitwise equal to the
// plain chains; ops/ntt.py's ntt_fwd_split / ntt_inv_split emulate the
// split in PyTorch.
//
// The row's limb is row % L: data is a contiguous [..., L, n] tensor.
// Output is bitwise equal to the plain chains ntt_fwd / ntt_inv of
// hehub_tpu_torch/ops/ntt.py (same butterflies, same operands).
//
// The stage kernel (hh_ntt_stage) is the port's own and replaces no TPU
// kernel: one forward (Cooley-Tukey) or inverse (Gentleman-Sande) radix-2
// stage on (lo, hi) operand pairs that lie in two places: the two halves of
// each block of a row held in place (rows of n = 2^k 131072, whose first k
// forward and last k inverse stages pair whole parts of 131072, so that
// after them each part is an ordinary row of 131072 for K1 and K2 under
// its regrouped table row, ops/ntt.py), or the halves of a row held by two
// ranks (parallel/ntt_sharded.py's cross stages, the counterpart of the
// jnp stage after each ppermute of hehub_tpu/parallel/ntt_sharded.py). In
// both, every pair of a block takes the same twiddle, so the kernel reads
// one (w, w_sh) per (limb, block), not one per element. What bounds it on
// the H100: the bytes, each operand read once and each result written once
// (4 words a butterfly, 2 when only one half is kept), against 9-11
// integer operations; the design is one coalesced pass, 4 words a thread as
// uint4, with no shared memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "ntt.cuh"
#include "smallrow.cuh"

namespace {

namespace cg = cooperative_groups;

// log2 of the values a thread holds: 16, so a half row of n = 16384 takes
// 512 threads (1024 at n = 32768, the most a block may have).
constexpr int kElemsLog = 4;

struct NttArgs {
  const uint32_t* in;
  uint32_t* out;
  const uint32_t* tw;  // [L 2^k, n]: the regrouped tables of rows of n 2^k
  const uint32_t* tw_sh;
  const uint32_t* q;
  const uint32_t* two_q;
  const uint32_t* w_last;  // K2's last-stage constants, [L] each
  const uint32_t* w_last_sh;
  const uint32_t* n_inv;
  const uint32_t* n_inv_sh;
  int L;
};

// The blocks an SM should hold of a kernel of `threads` threads: at most 64
// registers a thread.
__host__ __device__ constexpr int min_blocks(int threads) {
  return threads >= 1024 ? 1 : 1024 / threads;
}

// K1: block (r, g), g < U = 2^(K+1), works on the half sub-row g of row r
// (a row of n 2^K values, n = 2^LOGN; sub-row j = g / 2, half h = g mod 2),
// values [g H, (g + 1) H), H = n / 2, by T = H / 2^EB threads. The first
// K + 1 stages pair whole half sub-rows (at K = 0 only stage 0, the halves
// x[j], x[j + n/2] under tw[1]): the block loads its column of all U parts
// (coalesced, at stride T; the other blocks of the row read the same lines,
// from L2), runs those stages along the branch that ends in part g
// (hh::fwd_cross), then runs the sub-row's stages 1 .. log n - 1 on its half
// in registers under the sub-row's table (row limb 2^K + j of the
// regrouped tw, whose rows also hold the cross stages' twiddles,
// hh::cross_twiddle) and stores the half, coalesced.
template <int LOGN, int EB, int K>
__global__ void __launch_bounds__(1 << (LOGN - 1 - EB), min_blocks(1 << (LOGN - 1 - EB)))
    ntt_fwd_kernel(const NttArgs a) {
  constexpr int n = 1 << LOGN, H = n / 2, E = 1 << EB, T = H / E, U = 2 << K;
  constexpr long long NF = static_cast<long long>(n) << K;  // the row
  extern __shared__ uint4 smem_fwd[];
  const int tid = threadIdx.x;
  const int g = static_cast<int>(blockIdx.x & (U - 1));
  const int h = g & 1;
  const unsigned r = blockIdx.x >> (K + 1);
  const int limb = static_cast<int>(r % a.L);  // 32-bit: no division call
  const long long row = r;
  const uint32_t* rows = a.tw + (static_cast<long long>(limb) << K) * n;  // the limb's tables
  const uint32_t* rows_sh = a.tw_sh + (static_cast<long long>(limb) << K) * n;
  const uint32_t* tw = rows + (g >> 1) * n;  // sub-row g / 2's
  const uint32_t* tw_sh = rows_sh + (g >> 1) * n;
  const uint32_t q = a.q[limb], two_q = a.two_q[limb];
  uint32_t w[K + 1], w_sh[K + 1];  // the cross stages' twiddles on g's branch
#pragma unroll
  for (int s = 0; s <= K; ++s) {
    const int at = (1 << s) + (g >> (K + 1 - s));
    w[s] = hh::cross_twiddle<K>(rows, n, at);
    w_sh[s] = hh::cross_twiddle<K>(rows_sh, n, at);
  }
  const uint32_t* src = a.in + row * NF + tid;
  uint32_t v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    uint32_t y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) y[u] = __ldg(src + u * H + e * T);
    v[e] = hh::fwd_cross<K + 1>(y, g, w, w_sh, q, two_q);
  }
  hh::fwd_stages_reg<LOGN - 1, EB>(v, reinterpret_cast<uint32_t*>(smem_fwd), tid, tw, tw_sh, q,
                                   two_q, 2 + h);
  // through shared memory once more, to stride T, so that the stores coalesce
  hh::exchange<EB, 0, LOGN - 1 - EB>(v, reinterpret_cast<uint32_t*>(smem_fwd), tid);
  uint32_t* dst = a.out + row * NF + g * H + tid;
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e * T] = v[e];
}

// K2: a cluster of U = 2^(K+1) blocks a row (launched so), block rank g
// working on half sub-row g as K1's block g, by T = H / 2^EB threads. The
// sub-row's stages 0 .. log n - 2 act within the half; each block runs its
// half's in registers under the sub-row's table row and leaves the result
// in its shared memory. After a cluster barrier the last K + 1 stages, which
// pair the half sub-rows (the last folding n^-1), run on columns c of the U
// parts: block g takes c in [g H/U, (g + 1) H/U), reads the U values of each
// through distributed shared memory (hh::inv_cross) and writes all U
// results. With FOLD false (no n^-1 given) the last stage is an ordinary one
// under table entry 1: the row is a part of a longer one, whose stages
// pairing the parts follow in the stage kernel below.
template <int LOGN, int EB, int K, bool FOLD>
__global__ void __launch_bounds__(1 << (LOGN - 1 - EB), min_blocks(1 << (LOGN - 1 - EB)))
    ntt_inv_kernel(const NttArgs a) {
  constexpr int n = 1 << LOGN, H = n / 2, E = 1 << EB, T = H / E, U = 2 << K;
  constexpr long long NF = static_cast<long long>(n) << K;
  extern __shared__ uint4 smem_inv[];
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_inv);
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.block_rank());
  const int h = g & 1;
  const int tid = threadIdx.x;
  const unsigned r = blockIdx.x >> (K + 1);
  const int limb = static_cast<int>(r % a.L);  // 32-bit: no division call
  const long long row = r;
  const uint4* src = reinterpret_cast<const uint4*>(a.in + row * NF + g * H) + tid * (E / 4);
  uint32_t v[E];
#pragma unroll
  for (int p = 0; p < E / 4; ++p) {
    const uint4 u = __ldg(src + p);
    v[4 * p] = u.x;
    v[4 * p + 1] = u.y;
    v[4 * p + 2] = u.z;
    v[4 * p + 3] = u.w;
  }
  const uint32_t q = a.q[limb], two_q = a.two_q[limb];
  const uint32_t* rows = a.tw + (static_cast<long long>(limb) << K) * n;  // the limb's tables
  const uint32_t* rows_sh = a.tw_sh + (static_cast<long long>(limb) << K) * n;
  hh::inv_stages_reg<LOGN - 1, EB>(v, x, tid, rows + (g >> 1) * n, rows_sh + (g >> 1) * n, q,
                                   two_q, 2 + h);
  __syncthreads();  // the last exchange's reads are done
#pragma unroll
  for (int e = 0; e < E; ++e) x[e * T + tid] = v[e];
  cluster.sync();  // every part done and visible to the other blocks
  const uint32_t* xs[U];
#pragma unroll
  for (int u = 0; u < U; ++u) xs[u] = cluster.map_shared_rank(x, u) + g * (H / U) + tid;
  uint32_t w[U], w_sh[U];  // table entries 2 .. U - 1 (1 .. U - 1): the unfolded cross stages
#pragma unroll
  for (int u = FOLD ? 2 : 1; u < U; ++u) {
    w[u] = hh::cross_twiddle<K>(rows, n, u);
    w_sh[u] = hh::cross_twiddle<K>(rows_sh, n, u);
  }
  uint32_t w_last = 0, w_last_sh = 0, n_inv = 0, n_inv_sh = 0;
  if constexpr (FOLD) {
    w_last = a.w_last[limb];
    w_last_sh = a.w_last_sh[limb];
    n_inv = a.n_inv[limb];
    n_inv_sh = a.n_inv_sh[limb];
  }
  uint32_t* dst = a.out + row * NF + g * (H / U) + tid;
#pragma unroll
  for (int k = 0; k < E / U; ++k) {
    uint32_t y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) y[u] = xs[u][k * T];
    hh::inv_cross<K + 1, FOLD>(y, w, w_sh, q, two_q, w_last, w_last_sh, n_inv, n_inv_sh);
#pragma unroll
    for (int u = 0; u < U; ++u) dst[u * H + k * T] = y[u];
  }
  // the other blocks may still read this block's part; nothing is live
  // across the barrier (values held across it went to the stack)
  cluster.sync();
}

// K1 and K2 on rows of n = 2^LOGN <= 512 (smallrow.cuh): block b holds the
// rows [b R, (b + 1) R), R = 2048 / n, contiguous in memory, so its loads
// and stores are coalesced words; the last block masks the rows past `rows`.
// Row r takes limb r % L; each thread's butterflies take the constants of
// their rows' limbs. FOLD as ntt_inv_kernel's.
template <bool INV, int LOGN, bool FOLD>
__global__ void __launch_bounds__(hh::kSmallThreads)
    ntt_small_kernel(const NttArgs a, long long rows) {
  __shared__ uint32_t x[hh::kSmallValues];
  constexpr int n = 1 << LOGN;
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * hh::kSmallValues;
  const long long left = rows * n - first;  // values of this block that exist
#pragma unroll
  for (int k = 0; k < hh::kSmallElems; ++k) {
    const int at = k * hh::kSmallThreads + tid;
    if (at < left) x[at] = __ldg(a.in + first + at);
  }
  hh::SmallLimbs c;
  hh::SmallLast last;
#pragma unroll
  for (int k = 0; k < hh::kSmallPairs; ++k) {
    const unsigned r = static_cast<unsigned>(first >> LOGN) + hh::small_row<LOGN>(tid, k);
    const int limb = static_cast<int>(r % a.L);  // 32-bit: no division call
    c.tw[k] = a.tw + static_cast<long long>(limb) * n;
    c.tw_sh[k] = a.tw_sh + static_cast<long long>(limb) * n;
    c.q[k] = a.q[limb];
    c.two_q[k] = a.two_q[limb];
    if constexpr (INV && FOLD) {
      last.w[k] = a.w_last[limb];
      last.w_sh[k] = a.w_last_sh[limb];
      last.n_inv[k] = a.n_inv[limb];
      last.n_inv_sh[k] = a.n_inv_sh[limb];
    }
  }
  __syncthreads();
  if constexpr (INV) {
    hh::inv_stages_small<LOGN, FOLD>(x, tid, c, last);
  } else {
    hh::fwd_stages_small<LOGN>(x, tid, c);
  }
#pragma unroll
  for (int k = 0; k < hh::kSmallElems; ++k) {
    const int at = k * hh::kSmallThreads + tid;
    if (at < left) a.out[first + at] = x[at];
  }
}

template <bool INV, bool FOLD, int LOGN>
int launch_small(const NttArgs& a, long long rows, cudaStream_t stream) {
  constexpr long long per_block = hh::kSmallValues >> LOGN;
  const long long blocks = (rows + per_block - 1) / per_block;
  ntt_small_kernel<INV, LOGN, FOLD><<<static_cast<unsigned>(blocks), hh::kSmallThreads, 0, stream>>>(
      a, rows);
  return static_cast<int>(cudaGetLastError());
}

// Sets the kernel's dynamic shared memory limit once per device (it may
// exceed the 48 KB default) and launches it on 2^(K+1) `rows` blocks, K2 in
// clusters of 2^(K+1): rows of n 2^K values.
template <bool INV, bool FOLD, int LOGN, int K = 0>
int launch(const NttArgs& a, long long rows, cudaStream_t stream) {
  constexpr int EB = kElemsLog;
  constexpr size_t smem = hh::padded<EB>(1 << (LOGN - 1)) * sizeof(uint32_t);
  void (*kernel)(NttArgs) =
      INV ? ntt_inv_kernel<LOGN, EB, K, FOLD> : ntt_fwd_kernel<LOGN, EB, K>;
  static unsigned configured = 0;
  const cudaError_t err = hh::set_max_smem_once(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(hh::launch_clustered(kernel, static_cast<unsigned>(rows << (K + 1)),
                                               1u << (LOGN - 1 - EB), smem, INV ? 2u << K : 1u,
                                               stream, a));
}

// FOLD: K2 folds n^-1 into its last stage (always true for K1).
template <bool INV, bool FOLD>
int dispatch(const NttArgs& a, long long rows, int logn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (logn) {
    case 3:
      return launch_small<INV, FOLD, 3>(a, rows, s);
    case 4:
      return launch_small<INV, FOLD, 4>(a, rows, s);
    case 5:
      return launch_small<INV, FOLD, 5>(a, rows, s);
    case 6:
      return launch_small<INV, FOLD, 6>(a, rows, s);
    case 7:
      return launch_small<INV, FOLD, 7>(a, rows, s);
    case 8:
      return launch_small<INV, FOLD, 8>(a, rows, s);
    case 9:
      return launch_small<INV, FOLD, 9>(a, rows, s);
    case 10:
      return launch<INV, FOLD, 10>(a, rows, s);
    case 11:
      return launch<INV, FOLD, 11>(a, rows, s);
    case 12:
      return launch<INV, FOLD, 12>(a, rows, s);
    case 13:
      return launch<INV, FOLD, 13>(a, rows, s);
    case 14:
      return launch<INV, FOLD, 14>(a, rows, s);
    case 15:
      return launch<INV, FOLD, 15>(a, rows, s);
    case 16:  // two sub-rows of 32768
      return launch<INV, FOLD, 15, 1>(a, rows, s);
    case 17:  // four sub-rows of 32768
      return launch<INV, FOLD, 15, 2>(a, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The stage kernel: items k < rows L B m / 4, each 4 consecutive pairs of
// row ρ = (r L + l) B + b (limb l, block b) at offset i, lo at
// lo + ρ in_stride + i and hi likewise, under w[l w_stride + b]:
//   forward:  lo' = lo + hi w, hi' = lo - hi w (lazy, as ntt_fwd's stages);
//   inverse:  lo' = lo + hi, hi' = (lo + 2q - hi) w, or with FOLD (the last
//             stage of a chain) lo' = (lo + hi) n^-1 (as ntt_inv's).
// A null out_lo or out_hi is not written (a rank keeps one half).
struct StageArgs {
  const uint32_t* lo;
  const uint32_t* hi;
  long long in_stride;
  uint32_t* out_lo;
  uint32_t* out_hi;
  long long out_stride;
  const uint32_t* w;  // [L, w_stride], entry b of row l for block b
  const uint32_t* w_sh;
  long long w_stride;
  const uint32_t* q;  // [L] each
  const uint32_t* two_q;
  const uint32_t* n_inv;
  const uint32_t* n_inv_sh;
  int L;
  int log_b;   // log2 of the blocks B a row
  int log_m4;  // log2 of m / 4, m the pairs a block
};

constexpr int kStageThreads = 256;

template <bool INV, bool FOLD>
__device__ __forceinline__ void stage_butterfly(uint32_t& lo, uint32_t& hi, uint32_t w,
                                                uint32_t w_sh, uint32_t q, uint32_t two_q,
                                                uint32_t n_inv, uint32_t n_inv_sh) {
  const uint32_t a = lo, b = hi;
  if constexpr (!INV) {
    const uint32_t wh = hh::shoup_mul_lazy(b, w, w_sh, q);
    lo = hh::add_lazy(a, wh, two_q);
    hi = hh::sub_lazy(a, wh, two_q);
  } else {
    lo = FOLD ? hh::shoup_mul_lazy(a + b, n_inv, n_inv_sh, q) : hh::add_lazy(a, b, two_q);
    hi = hh::shoup_mul_lazy(a + two_q - b, w, w_sh, q);
  }
}

template <bool INV, bool FOLD>
__global__ void __launch_bounds__(kStageThreads)
    ntt_stage_kernel(const StageArgs a, unsigned long long items) {
  const unsigned long long m4_mask = (1ull << a.log_m4) - 1;
  for (unsigned long long k = static_cast<unsigned long long>(blockIdx.x) * kStageThreads +
                              threadIdx.x;
       k < items; k += static_cast<unsigned long long>(gridDim.x) * kStageThreads) {
    const unsigned long long row = k >> a.log_m4;
    const long long i = static_cast<long long>(k & m4_mask) * 4;
    const int b = static_cast<int>(row & ((1ull << a.log_b) - 1));
    const int limb = static_cast<int>(static_cast<unsigned>(row >> a.log_b) % a.L);
    const uint32_t q = __ldg(a.q + limb), two_q = __ldg(a.two_q + limb);
    const long long wi = limb * a.w_stride + b;
    const uint32_t w = __ldg(a.w + wi), w_sh = __ldg(a.w_sh + wi);
    uint32_t n_inv = 0, n_inv_sh = 0;
    if constexpr (FOLD) {
      n_inv = __ldg(a.n_inv + limb);
      n_inv_sh = __ldg(a.n_inv_sh + limb);
    }
    const long long at = static_cast<long long>(row) * a.in_stride + i;
    uint4 x = __ldg(reinterpret_cast<const uint4*>(a.lo + at));
    uint4 y = __ldg(reinterpret_cast<const uint4*>(a.hi + at));
    stage_butterfly<INV, FOLD>(x.x, y.x, w, w_sh, q, two_q, n_inv, n_inv_sh);
    stage_butterfly<INV, FOLD>(x.y, y.y, w, w_sh, q, two_q, n_inv, n_inv_sh);
    stage_butterfly<INV, FOLD>(x.z, y.z, w, w_sh, q, two_q, n_inv, n_inv_sh);
    stage_butterfly<INV, FOLD>(x.w, y.w, w, w_sh, q, two_q, n_inv, n_inv_sh);
    const long long to = static_cast<long long>(row) * a.out_stride + i;
    if (a.out_lo != nullptr) *reinterpret_cast<uint4*>(a.out_lo + to) = x;
    if (a.out_hi != nullptr) *reinterpret_cast<uint4*>(a.out_hi + to) = y;
  }
}

template <bool INV, bool FOLD>
int launch_stage(const StageArgs& a, long long rows, cudaStream_t stream) {
  const unsigned long long items = static_cast<unsigned long long>(rows) * a.L
                                   << (a.log_b + a.log_m4);
  if (items == 0) return 0;
  // a grid-stride loop: at most 2^20 blocks, 16 a streaming multiprocessor and more
  const unsigned long long want = (items + kStageThreads - 1) / kStageThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1ull << 20) ? want : (1ull << 20));
  ntt_stage_kernel<INV, FOLD><<<blocks, kStageThreads, 0, stream>>>(a, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1. in/out: [rows, n] (row r under limb r % L), 16-byte aligned;
// tw/tw_sh: [L, n], above n = 32768 the regrouped [L n / 32768, 32768]
// (context.sub_row_tables); q/two_q: [L]; n = 2^logn in [8, 131072].
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// an n out of range.
int hh_ntt_fwd(const uint32_t* in, uint32_t* out, const uint32_t* tw, const uint32_t* tw_sh,
               const uint32_t* q, const uint32_t* two_q, long long rows, int L, int logn,
               void* stream) {
  return dispatch<false, true>(
      {in, out, tw, tw_sh, q, two_q, nullptr, nullptr, nullptr, nullptr, L}, rows, logn, stream);
}

// K2. As K1, with the last stage's constants w_last/w_last_sh/n_inv/n_inv_sh
// [L]; all four null: the last stage does not fold n^-1 (the rows are parts
// of longer ones, whose last stages the stage kernel runs).
int hh_ntt_inv(const uint32_t* in, uint32_t* out, const uint32_t* tw, const uint32_t* tw_sh,
               const uint32_t* q, const uint32_t* two_q, const uint32_t* w_last,
               const uint32_t* w_last_sh, const uint32_t* n_inv, const uint32_t* n_inv_sh,
               long long rows, int L, int logn, void* stream) {
  const NttArgs a{in, out, tw, tw_sh, q, two_q, w_last, w_last_sh, n_inv, n_inv_sh, L};
  return n_inv == nullptr ? dispatch<true, false>(a, rows, logn, stream)
                          : dispatch<true, true>(a, rows, logn, stream);
}

// The stage kernel. lo/hi: the operand rows, row ρ < rows L 2^log_b at
// lo + ρ in_stride (limb (ρ >> log_b) % L, block ρ mod 2^log_b), each of
// m = 2^(log_m4 + 2) pairs; out_lo/out_hi likewise at out_stride (either
// may be null: not written); w/w_sh: the twiddle of limb l, block b at
// l w_stride + b; q/two_q: [L]; inverse: 0 forward, 1 inverse; n_inv and
// n_inv_sh [L] (inverse only, else null): fold n^-1 into lo'. Pointers and
// strides 16-byte aligned. Returns cudaGetLastError() after the launch.
int hh_ntt_stage(const uint32_t* lo, const uint32_t* hi, long long in_stride, uint32_t* out_lo,
                 uint32_t* out_hi, long long out_stride, const uint32_t* w, const uint32_t* w_sh,
                 long long w_stride, const uint32_t* q, const uint32_t* two_q,
                 const uint32_t* n_inv, const uint32_t* n_inv_sh, long long rows, int L,
                 int log_b, int log_m4, int inverse, void* stream) {
  const StageArgs a{lo, hi, in_stride, out_lo, out_hi, out_stride, w, w_sh, w_stride,
                    q, two_q, n_inv, n_inv_sh, L, log_b, log_m4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!inverse) return launch_stage<false, false>(a, rows, s);
  return n_inv == nullptr ? launch_stage<true, false>(a, rows, s)
                          : launch_stage<true, true>(a, rows, s);
}

}  // extern "C"
