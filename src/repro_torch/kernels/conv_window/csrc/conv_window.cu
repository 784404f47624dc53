// Head-count window CNN scorer, float32 (the paper's §5 hot spot).
//
// Replaces the Pallas TPU kernel repro/kernels/conv_window/kernel.py
// (_conv_window_kernel, launched by conv_window_scores). Per 12x12 window:
//   conv 3x3x1x8 -> ReLU -> 2x2 max-pool -> conv 3x3x8x16 -> ReLU
//   -> mean over the 3x3 positions -> fc 16 -> 1.
// Weights keep the reference's HWIO layout: w1 (3,3,1,8), w2 (3,3,8,16).
//
// Design: one warp per window, eight windows per 256-thread block. The
// weights (5.1 KB) are staged in shared memory once per block; each warp
// keeps its window (12x12), pooled map (5x5x8) and conv2 output (3x3x16) in
// shared memory, so nothing but the window and the score touches device
// memory. Plain FMAs on the CUDA cores; no tensor cores (the convolutions
// are 9- and 72-deep dot products on tiny odd shapes, 12->10->5->3).
//
// What bounds it on the H100: ~17.6 k multiply-adds per window against 576
// bytes read, so it is operation-bound at full batch (5452 windows), and
// launch-bound at the runtime's batch of one window per task.
// Summation order differs from XLA's convolutions, so results agree with
// the reference to float32 rounding, not bitwise.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWin = 12, kC1 = 8, kC2 = 16, kP = 5, kH2 = 3;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32) conv_window_kernel(
    const float* __restrict__ windows,  // (n, 12, 12)
    const float* __restrict__ w1,       // (3, 3, 1, 8)
    const float* __restrict__ b1,       // (8,)
    const float* __restrict__ w2,       // (3, 3, 8, 16)
    const float* __restrict__ b2,       // (16,)
    const float* __restrict__ fc,       // (16,)
    const float* __restrict__ fc_b,     // (1,)
    float* __restrict__ out,            // (n,)
    int n) {
  __shared__ float s_w1[9 * kC1];
  __shared__ float s_b1[kC1];
  __shared__ float s_w2[9 * kC1 * kC2];
  __shared__ float s_b2[kC2];
  __shared__ float s_fc[kC2];
  __shared__ float s_win[kWarpsPerBlock][kWin * kWin];
  __shared__ float s_pool[kWarpsPerBlock][kP * kP * kC1];   // (y, x, c)
  __shared__ float s_h2[kWarpsPerBlock][kH2 * kH2 * kC2];   // (y, x, c)

  for (int t = threadIdx.x; t < 9 * kC1 * kC2; t += blockDim.x) s_w2[t] = w2[t];
  for (int t = threadIdx.x; t < 9 * kC1; t += blockDim.x) s_w1[t] = w1[t];
  if (threadIdx.x < kC1) s_b1[threadIdx.x] = b1[threadIdx.x];
  if (threadIdx.x < kC2) {
    s_b2[threadIdx.x] = b2[threadIdx.x];
    s_fc[threadIdx.x] = fc[threadIdx.x];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* win = s_win[warp];
  float* pool = s_pool[warp];
  float* h2 = s_h2[warp];
  const float bias_fc = fc_b[0];

  for (int w = blockIdx.x * kWarpsPerBlock + warp; w < n;
       w += gridDim.x * kWarpsPerBlock) {
    const float* src = windows + static_cast<size_t>(w) * (kWin * kWin);
    for (int t = lane; t < kWin * kWin; t += 32) win[t] = src[t];
    __syncwarp();

    // conv1 + ReLU + 2x2 max-pool: 5x5x8 outputs, four conv taps each.
    for (int o = lane; o < kP * kP * kC1; o += 32) {
      const int c = o % kC1;
      const int px = (o / kC1) % kP;
      const int py = o / (kC1 * kP);
      float best = -CUDART_INF_F;
      for (int sy = 0; sy < 2; ++sy) {
        for (int sx = 0; sx < 2; ++sx) {
          const int y = 2 * py + sy, x = 2 * px + sx;
          float acc = 0.f;
          for (int dy = 0; dy < 3; ++dy)
            for (int dx = 0; dx < 3; ++dx)
              acc = fmaf(win[(y + dy) * kWin + (x + dx)], s_w1[(dy * 3 + dx) * kC1 + c], acc);
          best = fmaxf(best, fmaxf(acc + s_b1[c], 0.f));
        }
      }
      pool[o] = best;
    }
    __syncwarp();

    // conv2 + ReLU: 3x3x16 outputs, 72-deep dot products.
    for (int o = lane; o < kH2 * kH2 * kC2; o += 32) {
      const int co = o % kC2;
      const int x = (o / kC2) % kH2;
      const int y = o / (kC2 * kH2);
      float acc = 0.f;
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) {
          const float* p = pool + ((y + dy) * kP + (x + dx)) * kC1;
          const float* k = s_w2 + (dy * 3 + dx) * kC1 * kC2 + co;
          for (int ci = 0; ci < kC1; ++ci) acc = fmaf(p[ci], k[ci * kC2], acc);
        }
      h2[o] = fmaxf(acc + s_b2[co], 0.f);
    }
    __syncwarp();

    // Mean over the nine positions, then fc 16 -> 1 reduced across lanes.
    float t = 0.f;
    if (lane < kC2) {
      float s = 0.f;
      for (int p = 0; p < kH2 * kH2; ++p) s += h2[p * kC2 + lane];
      t = (s / 9.f) * s_fc[lane];
    }
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) out[w] = t + bias_fc;
    __syncwarp();  // the next window overwrites this warp's buffers
  }
}

}  // namespace

// Returns a cudaError_t (0 on a clean launch).
extern "C" int conv_window_launch(const float* windows, const float* w1,
                                  const float* b1, const float* w2,
                                  const float* b2, const float* fc,
                                  const float* fc_b, float* out, int n,
                                  void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 65535) blocks = 65535;
  conv_window_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      windows, w1, b1, w2, b2, fc, fc_b, out, n);
  return static_cast<int>(cudaGetLastError());
}
