// Row RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w, statistics in float32.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel, launched by rmsnorm_rows). x is [n, d] in bfloat16 or
// float32, w is [d] float32, y is [n, d] in x's type.
//
// What bounds it on the H100: bytes. It moves 2·n·d·sizeof(x) + 4·d bytes
// and does about 4 flops per element, far below the card's ratio of
// operations to bytes, so its floor is the HBM rate (3.35 TB/s). At the
// model's shapes ([B·S, 2560] and [B·S·heads, 128]) a launch moves a few MB,
// so launch latency dominates the small ones, and on the decode path the
// caller's host time per launch dominates the kernel (see kernel.py).
//
// Design: every path reads x from HBM once, holding the row in registers
// between the sum of squares and the scaled store.
// - d <= 256: a row belongs to one warp (eight rows per 256-thread block,
//   shuffle reduction only); each lane holds at most 8 elements.
// - d <= 4096, d a multiple of 16 bytes' worth of elements and every
//   pointer 16-byte aligned: a row belongs to one 128-thread block; each
//   thread moves 16-byte chunks (8 bf16 or 4 float32) of x, w and y and
//   holds at most 32 elements; warp shuffles, then the four warp sums
//   through shared memory.
// - anything else: a 256-thread block per row strides over it twice (the
//   second read hits L1/L2).
// Any n and d; no divisibility rule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;     // warp-per-row and fallback blocks
constexpr int kRowThreads = 128;  // one-pass block per row
constexpr int kMaxD = 4096;       // widest row the one-pass block holds
constexpr int kWarpMaxD = 256;    // widest row one warp holds

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of T <-> floats.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per row, d <= kWarpMaxD; lane holds elements lane + 32·i.
template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_warp_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y, int n, int d,
    float eps) {
  constexpr int kPer = kWarpMaxD / 32;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n) return;  // warp-uniform; no block-wide barrier below
  const T* xr = x + row * d;
  float v[kPer];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d ? to_f32(xr[c]) : 0.f;
    ss = fmaf(v[i], v[i], ss);
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  T* yr = y + row * d;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    if (c < d) store(yr + c, v[i] * inv * w[c]);
  }
}

// One 128-thread block per row, d <= kMaxD, 16-byte chunks.
template <typename T>
__global__ void __launch_bounds__(kRowThreads) rmsnorm_row_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y, int d, float eps) {
  using C = Chunk<T>;
  constexpr int kMaxChunks = kMaxD / (C::kN * kRowThreads);  // per thread
  const int n_chunks = d / C::kN;
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  float v[kMaxChunks][C::kN];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < n_chunks) {
      C::unpack(xr[c], v[i]);
#pragma unroll
      for (int e = 0; e < C::kN; ++e) ss = fmaf(v[i][e], v[i][e], ss);
    }
  }
  ss = warp_sum(ss);
  __shared__ float part[kRowThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int i = 0; i < kRowThreads / 32; ++i) ss += part[i];
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < n_chunks) {
      float out[C::kN];
#pragma unroll
      for (int e = 0; e < C::kN; e += 4) {
        const float4 wv = w4[(c * C::kN + e) / 4];
        out[e] = v[i][e] * inv * wv.x;
        out[e + 1] = v[i][e + 1] * inv * wv.y;
        out[e + 2] = v[i][e + 2] * inv * wv.z;
        out[e + 3] = v[i][e + 3] * inv * wv.w;
      }
      yr[c] = C::pack(out);
    }
  }
}

// One 256-thread block per row, any d: two strided passes.
template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_block_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y, int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  __shared__ float part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  ss = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) ss += part[i];
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
  T* yr = y + row * d;
  for (int c = threadIdx.x; c < d; c += kThreads) store(yr + c, to_f32(xr[c]) * inv * w[c]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* x, const float* w, void* y, int n, int d, float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (d <= kWarpMaxD) {
    const int blocks = (n + kThreads / 32 - 1) / (kThreads / 32);
    rmsnorm_warp_kernel<T><<<blocks, kThreads, 0, stream>>>(xt, w, yt, n, d, eps);
  } else if (d <= kMaxD && d % Chunk<T>::kN == 0 && aligned16(x) && aligned16(w) &&
             aligned16(y)) {
    rmsnorm_row_kernel<T><<<n, kRowThreads, 0, stream>>>(xt, w, yt, d, eps);
  } else {
    rmsnorm_block_kernel<T><<<n, kThreads, 0, stream>>>(xt, w, yt, d, eps);
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
