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
// reference's roll-and-mask butterflies, its full-width [4, log m, m]
// tables and its 8-row padding served Mosaic only and are gone: the
// twiddles are the compact per-stage table of hehub_tpu_torch/ops/fft.py
// (m - 1 complex entries, stage s at offset 2^s - 1), read through L2.
//
// Each butterfly is written with __dmul_rn / __dadd_rn / __dsub_rn, so that
// nvcc contracts nothing into an FMA: the result is bitwise equal to the
// plain stage chain fft_plain of hehub_tpu_torch/ops/fft.py, whose complex
// multiply is the same four products and two sums in the same order.
//
// What bounds it on the H100: a row is read once and written once (32 B per
// complex element in and out); in between, log m stages of m/2 butterflies
// of 10 FP64 operations each. At [64, 8192] that is 16.8 MB (5.0 us at
// 3.35 TB/s) against 34 MFLOP (1.0 us at 34 TFLOP/s FP64): memory-bound.
// The design keeps the row in dynamic shared memory for all stages, one
// thread block per row, so device memory sees one read and one write of
// each element: 16 B per complex value, 128 KB at m = 8192 (opted in above
// 48 KB with cudaFuncSetAttribute). m = 16384 (256 KB) does not fit a
// block's 227 KB: on a bit-reversed input the first log m - 1 DIT stages
// are two independent m/2 transforms of the two halves (with the same
// twiddles, since the table of m/2 is a prefix of the table of m), so the
// row kernel runs on [2 rows, m/2] and a second, elementwise kernel does
// the last stage in place. The kernel is CUDA C++ rather than Triton: the
// transform is a multi-stage in-place exchange through shared memory, not
// an elementwise pass.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRowLogM = 13;  // 8192 complex doubles = 128 KB of shared memory

struct Complex2 {
  double lo_re, lo_im, hi_re, hi_im;
};

// (a + w b, a - w b) with w b = (br wr - bi wi, br wi + bi wr), every
// operation rounded to nearest on its own.
__device__ __forceinline__ Complex2 butterfly(double ar, double ai, double br, double bi,
                                              double wr, double wi) {
  const double bwr = __dsub_rn(__dmul_rn(br, wr), __dmul_rn(bi, wi));
  const double bwi = __dadd_rn(__dmul_rn(br, wi), __dmul_rn(bi, wr));
  return {__dadd_rn(ar, bwr), __dadd_rn(ai, bwi), __dsub_rn(ar, bwr), __dsub_rn(ai, bwi)};
}

// One block per row of 2^logm complex values, all logm stages in shared
// memory.
__global__ void __launch_bounds__(1024)
    fft_rows_kernel(const double* __restrict__ in_re, const double* __restrict__ in_im,
                    double* __restrict__ out_re, double* __restrict__ out_im,
                    const double* __restrict__ tw_re, const double* __restrict__ tw_im,
                    int logm) {
  extern __shared__ double2 smem_fft[];
  double2* x = smem_fft;
  const int m = 1 << logm;
  const long long base = static_cast<long long>(blockIdx.x) * m;
  for (int e = threadIdx.x; e < m; e += blockDim.x)
    x[e] = make_double2(in_re[base + e], in_im[base + e]);
  __syncthreads();
  for (int s = 0; s < logm; ++s) {
    const int t = 1 << s;
    for (int k = threadIdx.x; k < m / 2; k += blockDim.x) {
      const int j = k & (t - 1);
      const int lo = ((k >> s) << (s + 1)) + j;
      const double2 a = x[lo];
      const double2 b = x[lo + t];
      const Complex2 c =
          butterfly(a.x, a.y, b.x, b.y, __ldg(tw_re + t - 1 + j), __ldg(tw_im + t - 1 + j));
      x[lo] = make_double2(c.lo_re, c.lo_im);
      x[lo + t] = make_double2(c.hi_re, c.hi_im);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    out_re[base + e] = x[e].x;
    out_im[base + e] = x[e].y;
  }
}

// The last DIT stage (t = m/2) of rows of 2^logm values, in place: one
// thread per butterfly.
__global__ void fft_last_stage_kernel(double* __restrict__ re, double* __restrict__ im,
                                      const double* __restrict__ tw_re,
                                      const double* __restrict__ tw_im, int logm,
                                      long long rows) {
  const int half = 1 << (logm - 1);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * half) return;
  const long long row = idx >> (logm - 1);
  const int k = static_cast<int>(idx & (half - 1));
  const long long lo = (row << logm) + k;
  const long long hi = lo + half;
  const Complex2 c = butterfly(re[lo], im[lo], re[hi], im[hi], __ldg(tw_re + half - 1 + k),
                               __ldg(tw_im + half - 1 + k));
  re[lo] = c.lo_re;
  im[lo] = c.lo_im;
  re[hi] = c.hi_re;
  im[hi] = c.hi_im;
}

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in_re/in_im: [rows, 2^logm] bit-reversed input; out_re/out_im: [rows,
// 2^logm] natural-order DFT; tw_re/tw_im: [2^logm - 1] compact per-stage
// twiddles. logm in [9, 14]. Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for a logm out of range.
int hh_fft(const double* in_re, const double* in_im, double* out_re, double* out_im,
           const double* tw_re, const double* tw_im, long long rows, int logm, void* stream) {
  if (logm < 9 || logm > kMaxRowLogM + 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_logm = logm < kMaxRowLogM ? logm : kMaxRowLogM;
  const long long block_rows = rows << (logm - row_logm);
  const int m_row = 1 << row_logm;
  const size_t smem = static_cast<size_t>(m_row) * sizeof(double2);
  cudaError_t err = cudaFuncSetAttribute(
      fft_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = m_row / 2 < 1024 ? m_row / 2 : 1024;
  fft_rows_kernel<<<static_cast<unsigned>(block_rows), threads, smem, s>>>(
      in_re, in_im, out_re, out_im, tw_re, tw_im, row_logm);
  err = cudaGetLastError();
  if (err != cudaSuccess || logm == row_logm) return static_cast<int>(err);
  const long long butterflies = rows << (logm - 1);
  const int last_threads = 256;
  fft_last_stage_kernel<<<static_cast<unsigned>((butterflies + last_threads - 1) / last_threads),
                          last_threads, 0, s>>>(out_re, out_im, tw_re, tw_im, logm, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
