// Small C entry points shared by the kernels' ctypes wrappers.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest dynamic shared memory one block may opt in to on `device`.
extern "C" int repro_smem_optin(int device, int* out) {
  return static_cast<int>(
      cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

namespace {
__global__ void repro_empty_kernel() {}
}  // namespace

// Launches a kernel that does nothing, one block of `threads`: the floor
// under a one-block kernel's device time, for the measurements.
extern "C" int repro_empty_launch(int threads, void* stream) {
  repro_empty_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
