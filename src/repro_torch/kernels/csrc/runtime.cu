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
