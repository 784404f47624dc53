// Row RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w, statistics in float32.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel, launched by rmsnorm_rows). x is [n, d] in bfloat16 or
// float32, w is [d] float32, y is [n, d] in x's type.
//
// Design: a row belongs to one warp when d <= 256 (eight rows per 256-thread
// block, shuffle reduction only) and to a whole 256-thread block otherwise
// (warp shuffles, then the eight warp sums through shared memory). Each
// thread strides over the row twice: once for the sum of squares, once to
// scale and store; the second read hits L1/L2. Any n and d; no divisibility
// rule.
//
// What bounds it on the H100: bytes. It moves 2·n·d·sizeof(x) + 4·d bytes
// and does about 4 flops per element, far below the card's ratio of
// operations to bytes, so its floor is the HBM rate (3.35 TB/s). At the
// model's shapes ([B·S, 2560] and [B·S·heads, 128]) a launch moves a few MB,
// so launch latency dominates the small ones.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// TPR threads per row: 32 (one warp) or kThreads (the whole block).
template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
    int n, int d, float eps) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  const int t = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / TPR;
  const bool live = row < n;  // no early return: the block-wide barrier below
  const T* xr = x + row * d;

  float ss = 0.f;
  if (live)
    for (int c = t; c < d; c += TPR) {
      const float v = to_f32(xr[c]);
      ss = fmaf(v, v, ss);
    }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (TPR > 32) {
    __shared__ float part[kThreads / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) ss += part[i];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  T* yr = y + row * d;
  for (int c = t; c < d; c += TPR) store(yr + c, to_f32(xr[c]) * inv * w[c]);
}

template <typename T>
int launch(const void* x, const float* w, void* y, int n, int d, float eps,
           cudaStream_t stream) {
  if (d <= 256) {
    const int blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
    rmsnorm_kernel<T, 32><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), n, d, eps);
  } else {
    rmsnorm_kernel<T, kThreads><<<n, kThreads, 0, stream>>>(
        static_cast<const T*>(x), w, static_cast<T*>(y), n, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on a clean launch).
extern "C" int rmsnorm_launch(const void* x, const float* w, void* y, int n, int d,
                              float eps, int dtype, void* stream) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, w, y, n, d, eps, s);
    case 1: return launch<__nv_bfloat16>(x, w, y, n, d, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
