// K5: the complex forward DFT of the CKKS device codec, in native FP64, on
// [rows, m] rows given as separate real and imaginary float64 planes.
//
// Replaces the TPU kernel hehub_tpu/ops/pallas/fft_pallas.py::_fft_kernel
// (built by _build, called through fft_pallas.fft from
// hehub_tpu/ops/df64.py::fft). It computes the same function: the natural-
// order forward DFT of a row given in bit-reversed order, by in-order
// radix-2 DIT stages; stage s (span t = 2^s) pairs x[lo] with x[lo + t]
// under the twiddle e^{-i pi j / t}, j = lo mod t. The reference carries
// each value as four float32 planes (double-float32) because the TPU has no
// float64; the H100 has native FP64, so a value here is one double. The
// twiddles are the compact per-stage table of hehub_tpu_torch/ops/fft.py
// (m - 1 complex entries, stage s at offset 2^s - 1), read through L1/L2.
//
// Each butterfly is written with __dmul_rn / __dadd_rn / __dsub_rn, so that
// nvcc contracts nothing into an FMA: every output is the same chain of
// correctly rounded operations as in the plain stage chain fft_plain of
// hehub_tpu_torch/ops/fft.py, and the two are bitwise equal. Regrouping the
// butterflies over blocks, threads and registers below changes no
// butterfly's operands.
//
// What bounds it on the H100: a row is read once and written once (32 B per
// complex element in and out); in between, log m stages of m/2 butterflies
// of 10 FP64 operations each. At [64, 8192] that is 16.8 MB (5.0 us at
// 3.35 TB/s) against 34 MFLOP (1.0 us at 34 TFLOP/s FP64): memory-bound.
// The first design (one block per row, the row in shared memory, one
// shared-memory pass and barrier per stage) filled only 64 of 132 SMs at 64
// rows and took 5.5x its bound on an H100; two passes of small transforms
// through L2 filled the card but moved the row through L2 twice more, and
// lost to cuFFT.
//
// The design: one pass, a cluster of two blocks per row, each block holding
// one contiguous half of the row in its shared memory. On a bit-reversed
// input the first log m - 1 stages act within each half, with the same
// twiddles in both (j = lo mod t < m/2), and only the last stage pairs the
// halves: x[j] with x[j + m/2]. So each block runs log m - 1 stages on its
// half, the cluster synchronises, and the last stage reads both halves
// through distributed shared memory, block k taking the butterflies
// j in [k m/4, (k + 1) m/4) and writing both of their outputs to device
// memory. A block's m/16 threads each hold E = 8 values in registers and
// run three stages at a time on them (radix 8): a group takes three index
// bits [b, b + 3), with one exchange through shared memory between groups
// (padded by one double in 8: no bank conflicts in any group's layout; 16
// values a thread, with half the warps, ran slower at m = 8192). The
// half row is loaded coalesced, all loads in flight before the first store
// to shared memory. At [64, 8192] that is 128 blocks of 512 threads, 72 KB
// of shared memory each; every m in [512, 16384] takes the same code
// (144 KB a block at 16384). Above that a block's part would not fit, so
// the cluster grows instead: 4 blocks a row at m = 32768 and 8 at 65536
// (the codec's m = n/2 at n = 65536 and 131072), each still holding 8192
// values, the last 2 or 3 stages pairing the parts through distributed
// shared memory as the last one does at two blocks (the cluster size is
// set at launch, not by __cluster_dims__). The shared-memory limit is set
// once per device and size, not per call. Rows of m <= 256 run on
// fft_small_kernel instead, several rows a block in shared memory, no
// cluster. The kernel is CUDA C++ rather than Triton: it needs clusters,
// distributed shared memory and register-resident butterflies.
//
// F (hh_fft_stage, fft_stage_kernel): one DIT stage of span t on whole rows
// in place, the port's own kernel (the TPU had none: the reference runs the
// stages of df64.fft_xla, hehub_tpu/ops/df64.py:260, as XLA element-wise
// chains). Rows of m above 65536 (the codec's m = n/2 up to n = 2^23) would
// need a cluster of 16 or more blocks of 8192 values, past the portable
// cluster size of 8; on a bit-reversed input the first 16 stages act within
// aligned parts of 65536, so ops/fft.py runs K5 on the parts (under the
// table of 65536, a prefix of the table of m) and then F once for each
// later stage, t = 65536 .. m/2. Each thread takes two adjacent butterflies
// (j, j + 1) of one block of 2t: x[lo] with x[lo + t] under e^{-i pi j / t},
// its data as 16-byte loads in a grid-stride loop, coalesced, and the
// butterfly is K5's own function below, so F's outputs are bitwise those of
// the plain stage (ops/fft.py fft_stage_plain). What bounds it: each
// stage reads and writes the rows once, 32 B a complex value, against 10
// FP64 operations a butterfly, so the memory rate (at [8, 131072], one
// stage: 33.6 MB in and out, 10 us at 3.35 TB/s).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "reglayout.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kElemsLog = 3;  // 8 values per thread
constexpr int kElems = 1 << kElemsLog;
// log2 of the blocks a row: 2 up to m = 16384, then as many as keep a
// block's part at 8192 values (147 KB of shared memory): 4 at m = 32768,
// 8 (the largest portable cluster) at m = 65536
constexpr int kMaxPartLog = 13;
__host__ __device__ constexpr int cluster_log(int logm) {
  return logm > kMaxPartLog + 1 ? logm - kMaxPartLog : 1;
}

// (a + w b, a - w b) with w b = (br wr - bi wi, br wi + bi wr), every
// operation rounded to nearest on its own; in place on (ar, ai), (br, bi).
__device__ __forceinline__ void butterfly(double& ar, double& ai, double& br, double& bi,
                                          double wr, double wi) {
  const double bwr = __dsub_rn(__dmul_rn(br, wr), __dmul_rn(bi, wi));
  const double bwi = __dadd_rn(__dmul_rn(br, wi), __dmul_rn(bi, wr));
  const double a_r = ar, a_i = ai;
  ar = __dadd_rn(a_r, bwr);
  ai = __dadd_rn(a_i, bwi);
  br = __dsub_rn(a_r, bwr);
  bi = __dsub_rn(a_i, bwi);
}

// The register-group layouts of reglayout.cuh at E = 8 values a thread:
// value e of thread tid in the group on bits [b, b + 3) of the block's part
// of the row lies at part_index(tid, e, b), in shared memory at
// pad(part_index(tid, 0, b)) + slot(e, b).
__device__ __forceinline__ int part_index(int tid, int e, int b) {
  return hh::reg_index<kElemsLog>(tid, e, b);
}
__host__ __device__ constexpr int pad(int u) { return hh::padded<kElemsLog>(u); }
__host__ __device__ constexpr int slot(int e, int b) { return hh::slot<kElemsLog>(e, b); }

// DIT stages B + LO .. B + kElemsLog - 1 on the thread's values at
// part_index(tid, e, B): stage B + sb pairs e with e + 2^sb, twiddle
// j = lo mod 2^(B + sb) = (tid mod 2^B) + (e mod 2^sb) 2^B.
template <int B, int LO>
__device__ __forceinline__ void stage_group(double (&vr)[kElems], double (&vi)[kElems], int tid,
                                            const double* __restrict__ tw_re,
                                            const double* __restrict__ tw_im) {
  const int low = tid & ((1 << B) - 1);
#pragma unroll
  for (int sb = LO; sb < kElemsLog; ++sb) {
    const int h = 1 << sb;
#pragma unroll
    for (int jl = 0; jl < h; ++jl) {
      const int t = (1 << (B + sb)) - 1 + low + (jl << B);
      const double wr = __ldg(tw_re + t), wi = __ldg(tw_im + t);
#pragma unroll
      for (int i = jl; i < kElems; i += 2 * h) butterfly(vr[i], vi[i], vr[i + h], vi[i + h], wr, wi);
    }
  }
}

// The groups from the one at bit B (running its bits LO..kElemsLog-1) up to
// the P stages of a block's part: groups at B = 0, E', 2E', ... (E' =
// kElemsLog), and where E' does not divide P a last one at B = P - E'
// running only the bits not done yet.
// The values arrive in group B's layout, and leave stored in shared memory
// in the last group's layout.
template <int P, int B, int LO>
__device__ __forceinline__ void groups_from(double (&vr)[kElems], double (&vi)[kElems],
                                            double* sre, double* sim, int tid,
                                            const double* __restrict__ tw_re,
                                            const double* __restrict__ tw_im) {
  stage_group<B, LO>(vr, vi, tid, tw_re, tw_im);
  // each thread writes back the slots it read: no other thread reads them
  const int here = pad(part_index(tid, 0, B));
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    sre[here + slot(e, B)] = vr[e];
    sim[here + slot(e, B)] = vi[e];
  }
  constexpr int DONE = B + kElemsLog;
  if constexpr (DONE < P) {
    constexpr int NEXT = DONE + kElemsLog <= P ? DONE : P - kElemsLog;
    __syncthreads();
    const int next = pad(part_index(tid, 0, NEXT));
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      vr[e] = sre[next + slot(e, NEXT)];
      vi[e] = sim[next + slot(e, NEXT)];
    }
    groups_from<P, NEXT, DONE - NEXT>(vr, vi, sre, sim, tid, tw_re, tw_im);
  }
}

// A cluster of CS = 2^CL blocks per row (CL = cluster_log(LOGM), the
// cluster given at launch), block rank k holding the contiguous part
// [k Q, (k + 1) Q) of the row, Q = m / CS. The first log m - CL stages act
// within each part; the last CL pair the parts: a unit of them is the CS
// values j + c Q (c < CS) of one j < Q, whose stage log Q + sb pairs c with
// c + 2^sb under twiddle j + (c mod 2^sb) Q. Block k takes the units j in
// [k Q / CS, (k + 1) Q / CS).
template <int LOGM>
__global__ void __launch_bounds__(1 << (LOGM - cluster_log(LOGM) - kElemsLog))
    fft_row_kernel(const double* __restrict__ in_re, const double* __restrict__ in_im,
                   double* __restrict__ out_re, double* __restrict__ out_im,
                   const double* __restrict__ tw_re, const double* __restrict__ tw_im) {
  constexpr int CL = cluster_log(LOGM);
  constexpr int CS = 1 << CL;
  constexpr int LOGQ = LOGM - CL;
  constexpr int Q = 1 << LOGQ;   // values a block
  constexpr int T = Q / kElems;  // threads a block
  extern __shared__ double2 smem_fft[];
  double* sre = reinterpret_cast<double*>(smem_fft);
  double* sim = sre + pad(Q);
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const long long row = blockIdx.x >> CL;
  const double* pre = in_re + (row << LOGM) + k * Q;
  const double* pim = in_im + (row << LOGM) + k * Q;

  // coalesced load of the block's part, every load issued before the stores
  double vr[kElems], vi[kElems];
#pragma unroll
  for (int q = 0; q < kElems; ++q) {
    vr[q] = pre[tid + q * T];
    vi[q] = pim[tid + q * T];
  }
#pragma unroll
  for (int q = 0; q < kElems; ++q) {
    sre[pad(tid + q * T)] = vr[q];
    sim[pad(tid + q * T)] = vi[q];
  }
  __syncthreads();
  const int first = pad(part_index(tid, 0, 0));
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    vr[e] = sre[first + slot(e, 0)];
    vi[e] = sim[first + slot(e, 0)];
  }
  groups_from<LOGQ, 0, 0>(vr, vi, sre, sim, tid, tw_re, tw_im);
  cluster.sync();  // every part done and visible to the other blocks

  // the last CL stages, on units read through distributed shared memory
  const double* rre[CS];
  const double* rim[CS];
#pragma unroll
  for (int c = 0; c < CS; ++c) {
    rre[c] = cluster.map_shared_rank(sre, c);
    rim[c] = cluster.map_shared_rank(sim, c);
  }
  double* ore = out_re + (row << LOGM);
  double* oim = out_im + (row << LOGM);
#pragma unroll
  for (int q = 0; q < kElems / CS; ++q) {
    const int j = k * (Q / CS) + tid + q * T;
    double ur[CS], ui[CS];
#pragma unroll
    for (int c = 0; c < CS; ++c) {
      ur[c] = rre[c][pad(j)];
      ui[c] = rim[c][pad(j)];
    }
#pragma unroll
    for (int sb = 0; sb < CL; ++sb) {
      const int h = 1 << sb;
#pragma unroll
      for (int jl = 0; jl < h; ++jl) {
        const int t = (Q << sb) - 1 + j + jl * Q;
        const double wr = __ldg(tw_re + t), wi = __ldg(tw_im + t);
#pragma unroll
        for (int c = jl; c < CS; c += 2 * h) butterfly(ur[c], ui[c], ur[c + h], ui[c + h], wr, wi);
      }
    }
#pragma unroll
    for (int c = 0; c < CS; ++c) {
      ore[j + c * Q] = ur[c];
      oim[j + c * Q] = ui[c];
    }
  }
  cluster.sync();  // the other blocks may still read this block's part
}

// F: items k < rows m / 4, each the butterflies (j, j + 1), j even, of one
// block of 2t in the rows taken end to end (the blocks tile each row of m,
// so the row does not matter): block 2k / t, j = 2k mod t, lo = 2t block +
// j, in place on re/im; twiddles w_re/w_im[j] = tw[t - 1 + j].
constexpr int kFftStageThreads = 256;

__global__ void __launch_bounds__(kFftStageThreads)
    fft_stage_kernel(double* __restrict__ re, double* __restrict__ im,
                     const double* __restrict__ w_re, const double* __restrict__ w_im,
                     unsigned long long items, int log_t) {
  const unsigned long long j_mask = (1ull << log_t) - 1;
  for (unsigned long long k = static_cast<unsigned long long>(blockIdx.x) * kFftStageThreads +
                              threadIdx.x;
       k < items; k += static_cast<unsigned long long>(gridDim.x) * kFftStageThreads) {
    const unsigned long long pair = k * 2;
    const unsigned long long j = pair & j_mask;
    const unsigned long long lo = ((pair >> log_t) << (log_t + 1)) + j;
    const unsigned long long hi = lo + (1ull << log_t);
    double2 ar = *reinterpret_cast<const double2*>(re + lo);
    double2 ai = *reinterpret_cast<const double2*>(im + lo);
    double2 br = *reinterpret_cast<const double2*>(re + hi);
    double2 bi = *reinterpret_cast<const double2*>(im + hi);
    butterfly(ar.x, ai.x, br.x, bi.x, __ldg(w_re + j), __ldg(w_im + j));
    butterfly(ar.y, ai.y, br.y, bi.y, __ldg(w_re + j + 1), __ldg(w_im + j + 1));
    *reinterpret_cast<double2*>(re + lo) = ar;
    *reinterpret_cast<double2*>(im + lo) = ai;
    *reinterpret_cast<double2*>(re + hi) = br;
    *reinterpret_cast<double2*>(im + hi) = bi;
  }
}

// Rows of m = 2^LOGM <= 256 (a half row of m = 256 would be 16 threads):
// block b holds the rows [b R, (b + 1) R), R = 1024 / m, in shared memory
// (16 KB for both planes), and its 256 threads run every stage there, a
// barrier after each: thread tid takes butterfly j = tid mod m/2 of the
// block rows tid / (m/2) + k 512 / m, k < 2, with the same twiddle. The
// last block masks the rows past `rows`. The butterflies and their
// operands are fft_plain's, as above.
constexpr int kSmallFftLog = 10;
constexpr int kSmallFftValues = 1 << kSmallFftLog;
constexpr int kSmallFftThreads = 256;
constexpr int kSmallFftPairs = kSmallFftValues / 2 / kSmallFftThreads;

template <int LOGM>
__global__ void __launch_bounds__(kSmallFftThreads)
    fft_small_kernel(const double* __restrict__ in_re, const double* __restrict__ in_im,
                     double* __restrict__ out_re, double* __restrict__ out_im,
                     const double* __restrict__ tw_re, const double* __restrict__ tw_im,
                     long long rows) {
  __shared__ double sre[kSmallFftValues], sim[kSmallFftValues];
  constexpr int m = 1 << LOGM;
  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kSmallFftValues;
  const long long left = rows * m - first;  // values of this block that exist
#pragma unroll
  for (int k = 0; k < kSmallFftValues / kSmallFftThreads; ++k) {
    const int at = k * kSmallFftThreads + tid;
    if (at < left) {
      sre[at] = in_re[first + at];
      sim[at] = in_im[first + at];
    }
  }
  __syncthreads();
  const int j = tid & (m / 2 - 1);
#pragma unroll
  for (int s = 0; s < LOGM; ++s) {
    const int t = 1 << s;
    const int jl = j & (t - 1);
    const int off = 2 * t * (j >> s) + jl;
    const double wr = __ldg(tw_re + t - 1 + jl), wi = __ldg(tw_im + t - 1 + jl);
#pragma unroll
    for (int k = 0; k < kSmallFftPairs; ++k) {
      const int lo = (((tid >> (LOGM - 1)) + k * (kSmallFftThreads >> (LOGM - 1))) << LOGM) + off;
      butterfly(sre[lo], sim[lo], sre[lo + t], sim[lo + t], wr, wi);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kSmallFftValues / kSmallFftThreads; ++k) {
    const int at = k * kSmallFftThreads + tid;
    if (at < left) {
      out_re[first + at] = sre[at];
      out_im[first + at] = sim[at];
    }
  }
}

template <int LOGM>
cudaError_t launch_small(const double* in_re, const double* in_im, double* out_re,
                         double* out_im, const double* tw_re, const double* tw_im, long long rows,
                         cudaStream_t s) {
  constexpr long long per_block = kSmallFftValues >> LOGM;
  const long long blocks = (rows + per_block - 1) / per_block;
  fft_small_kernel<LOGM><<<static_cast<unsigned>(blocks), kSmallFftThreads, 0, s>>>(
      in_re, in_im, out_re, out_im, tw_re, tw_im, rows);
  return cudaGetLastError();
}

template <int LOGM>
cudaError_t launch(const double* in_re, const double* in_im, double* out_re, double* out_im,
                   const double* tw_re, const double* tw_im, long long rows, cudaStream_t s) {
  constexpr int CL = cluster_log(LOGM);
  constexpr int Q = 1 << (LOGM - CL);
  constexpr size_t smem = 2 * static_cast<size_t>(pad(Q)) * sizeof(double);
  static unsigned configured = 0;
  const cudaError_t err = hh::set_max_smem_once(fft_row_kernel<LOGM>, smem, configured);
  if (err != cudaSuccess) return err;
  return hh::launch_clustered(fft_row_kernel<LOGM>, static_cast<unsigned>(rows << CL),
                              Q / kElems, smem, 1u << CL, s, in_re, in_im, out_re, out_im,
                              tw_re, tw_im);
}

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in_re/in_im: [rows, 2^logm] bit-reversed input; out_re/out_im: [rows,
// 2^logm] natural-order DFT (not aliasing the input); tw_re/tw_im:
// [2^logm - 1] compact per-stage twiddles. logm in [2, 16]. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a logm
// out of range.
int hh_fft(const double* in_re, const double* in_im, double* out_re, double* out_im,
           const double* tw_re, const double* tw_im, long long rows, int logm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (logm) {
    case 2:
      return launch_small<2>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 3:
      return launch_small<3>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 4:
      return launch_small<4>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 5:
      return launch_small<5>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 6:
      return launch_small<6>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 7:
      return launch_small<7>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 8:
      return launch_small<8>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 9:
      return launch<9>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 10:
      return launch<10>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 11:
      return launch<11>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 12:
      return launch<12>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 13:
      return launch<13>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 14:
      return launch<14>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 15:
      return launch<15>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    case 16:
      return launch<16>(in_re, in_im, out_re, out_im, tw_re, tw_im, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// F. re/im: [rows, 2^logm] rows (16-byte aligned), in place; w_re/w_im:
// [2^logt] the stage's twiddles, tw[2^logt - 1 ..] of the compact table;
// logt in [1, logm - 1]. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a logt out of range.
int hh_fft_stage(double* re, double* im, const double* w_re, const double* w_im, long long rows,
                 int logm, int logt, void* stream) {
  if (logt < 1 || logt >= logm) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long items = static_cast<unsigned long long>(rows) << (logm - 2);
  if (items == 0) return 0;
  // a grid-stride loop: at most 2^20 blocks
  const unsigned long long want = (items + kFftStageThreads - 1) / kFftStageThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1ull << 20) ? want : (1ull << 20));
  fft_stage_kernel<<<blocks, kFftStageThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      re, im, w_re, w_im, items, logt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
