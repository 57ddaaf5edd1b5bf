// K1 and K2: the forward and inverse negacyclic NTT of [rows, n] uint32
// residue rows, two thread blocks per row.
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
// The row's limb is row % L: data is a contiguous [..., L, n] tensor.
// Output is bitwise equal to the plain chains ntt_fwd / ntt_inv of
// hehub_tpu_torch/ops/ntt.py (same butterflies, same operands).
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
  const uint32_t* tw;
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

// K1: block 2 r + h works on half h of row r, values [h n/2, (h + 1) n/2),
// by T = n / 2^(EB+1) threads. Stage 0 pairs the halves, x[j] with
// x[j + n/2] under tw[1]: the block loads both (coalesced, at stride T; the
// other block of the row reads the same lines, from L2) and keeps its
// half's results, then runs stages 1 .. log n - 1 on its half in registers
// and stores the half, coalesced.
template <int LOGN, int EB>
__global__ void __launch_bounds__(1 << (LOGN - 1 - EB), min_blocks(1 << (LOGN - 1 - EB)))
    ntt_fwd_kernel(const NttArgs a) {
  constexpr int n = 1 << LOGN, H = n / 2, E = 1 << EB, T = H / E;
  extern __shared__ uint4 smem_fwd[];
  const int tid = threadIdx.x;
  const int h = static_cast<int>(blockIdx.x & 1);
  const unsigned r = blockIdx.x >> 1;
  const int limb = static_cast<int>(r % a.L);  // 32-bit: no division call
  const long long row = r;
  const uint32_t* tw = a.tw + static_cast<long long>(limb) * n;
  const uint32_t* tw_sh = a.tw_sh + static_cast<long long>(limb) * n;
  const uint32_t q = a.q[limb], two_q = a.two_q[limb];
  const uint32_t w = __ldg(tw + 1), w_sh = __ldg(tw_sh + 1);
  const uint32_t* src = a.in + row * n + tid;
  uint32_t v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const uint32_t lo = __ldg(src + e * T);
    const uint32_t wh = hh::shoup_mul_lazy(__ldg(src + H + e * T), w, w_sh, q);
    v[e] = h ? hh::sub_lazy(lo, wh, two_q) : hh::add_lazy(lo, wh, two_q);
  }
  hh::fwd_stages_reg<LOGN - 1, EB>(v, reinterpret_cast<uint32_t*>(smem_fwd), tid, tw, tw_sh, q,
                                   two_q, 2 + h);
  // through shared memory once more, to stride T, so that the stores coalesce
  hh::exchange<EB, 0, LOGN - 1 - EB>(v, reinterpret_cast<uint32_t*>(smem_fwd), tid);
  uint32_t* dst = a.out + row * n + h * H + tid;
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e * T] = v[e];
}

// K2: a cluster of two blocks a row, block rank h working on half h by
// T = n / 2^(EB+1) threads. Stages 0 .. log n - 2 act within the halves;
// each block runs its half's in registers, leaves the result in its shared
// memory, and after a cluster barrier takes the last stage (the halves
// paired, n^-1 folded) for the pairs j, j + n/2 with j in
// [h n/4, (h + 1) n/4), reading both halves through distributed shared
// memory and writing both results.
template <int LOGN, int EB>
__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(1 << (LOGN - 1 - EB), min_blocks(1 << (LOGN - 1 - EB)))
    ntt_inv_kernel(const NttArgs a) {
  constexpr int n = 1 << LOGN, H = n / 2, E = 1 << EB, T = H / E;
  extern __shared__ uint4 smem_inv[];
  uint32_t* x = reinterpret_cast<uint32_t*>(smem_inv);
  cg::cluster_group cluster = cg::this_cluster();
  const int h = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const unsigned r = blockIdx.x >> 1;
  const int limb = static_cast<int>(r % a.L);  // 32-bit: no division call
  const long long row = r;
  const uint4* src = reinterpret_cast<const uint4*>(a.in + row * n + h * H) + tid * (E / 4);
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
  hh::inv_stages_reg<LOGN - 1, EB>(v, x, tid, a.tw + static_cast<long long>(limb) * n,
                                   a.tw_sh + static_cast<long long>(limb) * n, q, two_q, 2 + h);
  __syncthreads();  // the last exchange's reads are done
#pragma unroll
  for (int e = 0; e < E; ++e) x[e * T + tid] = v[e];
  cluster.sync();  // both halves done and visible to the other block
  const uint32_t* x0 = cluster.map_shared_rank(x, 0) + h * (H / 2) + tid;
  const uint32_t* x1 = cluster.map_shared_rank(x, 1) + h * (H / 2) + tid;
  const uint32_t w = a.w_last[limb], w_sh = a.w_last_sh[limb];
  const uint32_t n_inv = a.n_inv[limb], n_inv_sh = a.n_inv_sh[limb];
  uint32_t* dst = a.out + row * n + h * (H / 2) + tid;
#pragma unroll
  for (int k = 0; k < E / 2; ++k) {
    const uint32_t lo = x0[k * T];
    const uint32_t hi = x1[k * T];
    dst[k * T] = hh::shoup_mul_lazy(lo + hi, n_inv, n_inv_sh, q);
    dst[H + k * T] = hh::shoup_mul_lazy(lo + two_q - hi, w, w_sh, q);
  }
  // the other block may still read this block's half; nothing is live
  // across the barrier (values held across it went to the stack)
  cluster.sync();
}

// K1 and K2 on rows of n = 2^LOGN <= 512 (smallrow.cuh): block b holds the
// rows [b R, (b + 1) R), R = 2048 / n, contiguous in memory, so its loads
// and stores are coalesced words; the last block masks the rows past `rows`.
// Row r takes limb r % L; each thread's butterflies take the constants of
// their rows' limbs.
template <bool INV, int LOGN>
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
    if constexpr (INV) {
      last.w[k] = a.w_last[limb];
      last.w_sh[k] = a.w_last_sh[limb];
      last.n_inv[k] = a.n_inv[limb];
      last.n_inv_sh[k] = a.n_inv_sh[limb];
    }
  }
  __syncthreads();
  if constexpr (INV) {
    hh::inv_stages_small<LOGN>(x, tid, c, last);
  } else {
    hh::fwd_stages_small<LOGN>(x, tid, c);
  }
#pragma unroll
  for (int k = 0; k < hh::kSmallElems; ++k) {
    const int at = k * hh::kSmallThreads + tid;
    if (at < left) a.out[first + at] = x[at];
  }
}

template <bool INV, int LOGN>
int launch_small(const NttArgs& a, long long rows, cudaStream_t stream) {
  constexpr long long per_block = hh::kSmallValues >> LOGN;
  const long long blocks = (rows + per_block - 1) / per_block;
  ntt_small_kernel<INV, LOGN><<<static_cast<unsigned>(blocks), hh::kSmallThreads, 0, stream>>>(
      a, rows);
  return static_cast<int>(cudaGetLastError());
}

// Sets the kernel's dynamic shared memory limit once per device (it may
// exceed the 48 KB default) and launches it on 2 `rows` blocks.
template <bool INV, int LOGN>
int launch(const NttArgs& a, long long rows, cudaStream_t stream) {
  constexpr int EB = kElemsLog;
  constexpr size_t smem = hh::padded<EB>(1 << (LOGN - 1)) * sizeof(uint32_t);
  void (*kernel)(NttArgs) = INV ? ntt_inv_kernel<LOGN, EB> : ntt_fwd_kernel<LOGN, EB>;
  static unsigned configured = 0;
  const cudaError_t err = hh::set_max_smem_once(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(2 * rows), 1 << (LOGN - 1 - EB), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool INV>
int dispatch(const NttArgs& a, long long rows, int logn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (logn) {
    case 3:
      return launch_small<INV, 3>(a, rows, s);
    case 4:
      return launch_small<INV, 4>(a, rows, s);
    case 5:
      return launch_small<INV, 5>(a, rows, s);
    case 6:
      return launch_small<INV, 6>(a, rows, s);
    case 7:
      return launch_small<INV, 7>(a, rows, s);
    case 8:
      return launch_small<INV, 8>(a, rows, s);
    case 9:
      return launch_small<INV, 9>(a, rows, s);
    case 10:
      return launch<INV, 10>(a, rows, s);
    case 11:
      return launch<INV, 11>(a, rows, s);
    case 12:
      return launch<INV, 12>(a, rows, s);
    case 13:
      return launch<INV, 13>(a, rows, s);
    case 14:
      return launch<INV, 14>(a, rows, s);
    case 15:
      return launch<INV, 15>(a, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1. in/out: [rows, n] (row r under limb r % L), 16-byte aligned;
// tw/tw_sh: [L, n]; q/two_q: [L]; n = 2^logn in [8, 32768]. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an n
// out of range.
int hh_ntt_fwd(const uint32_t* in, uint32_t* out, const uint32_t* tw, const uint32_t* tw_sh,
               const uint32_t* q, const uint32_t* two_q, long long rows, int L, int logn,
               void* stream) {
  return dispatch<false>({in, out, tw, tw_sh, q, two_q, nullptr, nullptr, nullptr, nullptr, L},
                         rows, logn, stream);
}

// K2. As K1, with the last stage's constants w_last/w_last_sh/n_inv/n_inv_sh
// [L].
int hh_ntt_inv(const uint32_t* in, uint32_t* out, const uint32_t* tw, const uint32_t* tw_sh,
               const uint32_t* q, const uint32_t* two_q, const uint32_t* w_last,
               const uint32_t* w_last_sh, const uint32_t* n_inv, const uint32_t* n_inv_sh,
               long long rows, int L, int logn, void* stream) {
  return dispatch<true>(
      {in, out, tw, tw_sh, q, two_q, w_last, w_last_sh, n_inv, n_inv_sh, L}, rows, logn, stream);
}

}  // extern "C"
