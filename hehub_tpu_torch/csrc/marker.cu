// Stage markers of the CKKS bootstrap (circuits/bootstrap.py): one empty
// kernel a stage boundary, each under the stage's own name, launched on the
// caller's stream at the boundary. A CUDA graph that captures a stage
// captures its marker, and every replay launches it again, so a device trace
// names where each stage of each refresh begins on the device.
#include <cuda_runtime.h>

namespace {

#define HH_MARKERS(X) \
  X(sse_in) X(mod_raise) X(sse_out) X(c2s) X(evalmod) X(s2c) X(done)

#define HH_DEFINE(name) __global__ void boot_mark_##name() {}
HH_MARKERS(HH_DEFINE)
#undef HH_DEFINE

}  // namespace

extern "C" {

const char* hh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the marker of stage `stage`, in HH_MARKERS' order from 0 (the
// order of circuits/bootstrap.MARKERS). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a stage out of range.
int hh_boot_mark(int stage, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int i = 0;
#define HH_LAUNCH(name)                             \
  if (stage == i++) {                               \
    boot_mark_##name<<<1, 1, 0, s>>>();             \
    return static_cast<int>(cudaGetLastError());    \
  }
  HH_MARKERS(HH_LAUNCH)
#undef HH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
