// Register-group layouts shared by the register-resident transforms: the
// NTT stage chain of ntt.cuh (K3, K4) and the FFT of fft.cu (K5).
//
// A thread holds E = 2^EB values of a row and runs the stages on the index
// bits [b, b + EB) in registers. In the layout of the group at bit b,
// value e of thread tid sits at reg_index<EB>(tid, e, b): e on bits
// [b, b + EB), tid's bits around it. Between groups the values go once
// through shared memory, at padded<EB>(index): one word of padding after
// every E, so that no group's layout conflicts on banks.
#pragma once

namespace hh {

template <int EB>
__host__ __device__ constexpr int reg_index(int tid, int e, int b) {
  return ((tid >> b) << (b + EB)) | (e << b) | (tid & ((1 << b) - 1));
}

template <int EB>
__host__ __device__ constexpr int padded(int idx) { return idx + (idx >> EB); }

// padded<EB>(reg_index<EB>(tid, e, b)) = padded<EB>(reg_index<EB>(tid, 0, b))
// + slot<EB>(e, b): tid's bits lie below b or at b + EB and above, so e's
// bits never carry into them.
template <int EB>
__host__ __device__ constexpr int slot(int e, int b) { return (e << b) + ((e << b) >> EB); }

}  // namespace hh
