// Head-count window CNN scorer, float32 (the paper's §5 hot spot).
//
// Replaces the Pallas TPU kernel repro/kernels/conv_window/kernel.py
// (_conv_window_kernel, launched by conv_window_scores). Per 12x12 window:
//   conv 3x3x1x8 -> ReLU -> 2x2 max-pool -> conv 3x3x8x16 -> ReLU
//   -> mean over the 3x3 positions -> fc 16 -> 1.
// Weights keep the reference's HWIO layout: w1 (3,3,1,8), w2 (3,3,8,16).
// Packed, they are one float32 buffer of 1265: w1 72 | b1 8 | w2 1152 |
// b2 16 | fc 16 | fc_b 1, every piece starting at a multiple of 4 floats.
//
// Two kernels, one for each regime the port runs. Both use plain float32
// FMAs on the CUDA cores: the products are 9 and 72 deep on odd shapes
// (12 -> 10 -> 5 -> 3), and TF32 tensor cores would not hold 1e-5.
//
// conv_window_frame_kernel: the head count's main path, one launch per CNN
// task. It reads its window straight from the normalized int32 frame
// (frame[base + r*row_stride + c*col_stride]), scales each pixel by IEEE
// division by 65535 as the reference's task body does, and writes a 0-dim
// score. 576 bytes of work against a launch of microseconds: it is bound by
// latency, so it is one CTA with short dependent chains. Every weight a
// thread needs is loaded into registers through the read-only path at
// entry (they sit in L2 after the first task), in the shadow of the frame
// read; then three barriers:
//   conv1 + ReLU + pool: one thread per pooled output (5x5x8 = 200), a 4x4
//     patch from shared memory, 36 FMAs;
//   conv2: 144 outputs x 4 slices of the 72-deep product (576 threads). A
//     slice is one pair of input channels over the nine taps, so every
//     address is a constant offset and the pooled pair one 8-byte load;
//     18 FMAs, the slices summed by two shuffles;
//   ReLU, fc and the mean: one block reduction (shuffles within each warp,
//     then one warp over the 18 warp sums).
//
// conv_window_batch_kernel: repro's own contract, windows [N,12,12] ->
// scores [N], built for throughput. ~17.6k FMAs per 576 bytes read: bound
// by operations at full batch. A persistent grid of at most one CTA per SM,
// each taking tiles of T windows (T = ceil(N / SMs), at most 48, so the
// head count's 5452 windows are one tile of 41-42 per SM), 8 threads a
// window. Every weight load is issued at entry, before the windows are
// staged with 16-byte loads, so the CTA pays one round trip to memory.
//   conv1 + ReLU + pool: a thread per (window, channel), its nine taps in
//     registers, each input row loaded once (36 16-byte loads for 900
//     FMAs), the row's 20 conv outputs advanced tap by tap.
//   conv2: an SM delivers 32 floats a clock from shared memory to registers
//     against 128 FMAs, so a thread holds a register tile: 8 output
//     channels x 9 positions (72 accumulators) over 2 of the 8 input
//     channels, 13 shared loads per 144 FMAs. The pooled map sits
//     channel-innermost (window stride 204 floats) and w2 in rows of 20
//     floats with the upper 8 channels at 12, so the loads are free of bank
//     conflicts. The input quarters are summed by a reduce-scatter of 36 +
//     18 shuffles; each lane finishes 18 outputs (ReLU, fc) and the
//     window's eight lanes sum the score.
// What bounds it: at 42 windows an SM the register file gives a window
// 1560 registers; the tile above takes 168 a thread, so 10.5 warps an SM,
// too few to hide the latency of its loads, shuffles and FMA chains. More
// threads a window need smaller tiles, which shared memory cannot feed, or
// spill (PERF.md).
//
// Summation order differs from XLA's convolutions, so results agree with
// the reference to float32 rounding, not bitwise.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWin = 12, kC1 = 8, kC2 = 16, kP = 5, kH2 = 3;
constexpr int kWinFloats = kWin * kWin;  // 144
// Packed weights: offsets in floats.
constexpr int kOffW1 = 0, kOffB1 = 72, kOffW2 = 80, kOffB2 = 1232, kOffFc = 1248;
constexpr int kOffFcB = 1264;

// -- one window per launch ----------------------------------------------------

constexpr int kSlices = 4;                              // conv2 K slices
constexpr int kFrameThreads = kH2 * kH2 * kC2 * kSlices;  // 576

__global__ void __launch_bounds__(kFrameThreads) conv_window_frame_kernel(
    const int* __restrict__ frame,   // normalized frame, uint16 values in int32
    const float* __restrict__ w,     // packed weights (1265)
    int base, int row_stride, int col_stride,
    float* __restrict__ out) {       // 0-dim score
  __shared__ float s_win[kWinFloats];
  __shared__ __align__(16) float s_pool[kP * kP * kC1];  // (y, x, c)
  __shared__ float s_warp[kFrameThreads / 32];
  const int t = threadIdx.x;

  // conv2 role: output o = t / 4 at position (oy, ox), channel co; input
  // channels 2q and 2q + 1 of every tap.
  const int q = t & 3;
  const int co = (t >> 2) & (kC2 - 1);
  const int pos = t >> 6;
  const int oy = pos / kH2, ox = pos - kH2 * oy;
  float w2r[18];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      w2r[2 * tap + j] = __ldg(w + kOffW2 + (tap * kC1 + 2 * q + j) * kC2 + co);
  }
  const float b2 = __ldg(w + kOffB2 + co);
  const float fc = __ldg(w + kOffFc + co);

  // conv1 role (t < 200): pooled output (py, px) of channel c.
  const int c = t & (kC1 - 1);
  const int pp = t >> 3;
  float w1r[9];
  float b1 = 0.f;
  if (t < kP * kP * kC1) {
#pragma unroll
    for (int i = 0; i < 9; ++i) w1r[i] = __ldg(w + kOffW1 + i * kC1 + c);
    b1 = __ldg(w + kOffB1 + c);
  }

  if (t < kWinFloats) {
    const int r = t / kWin, cc = t - kWin * r;
    const int v = __ldg(frame + base + r * row_stride + cc * col_stride);
    s_win[t] = __fdiv_rn(static_cast<float>(v), 65535.f);
  }
  __syncthreads();

  if (t < kP * kP * kC1) {
    const int py = pp / kP, px = pp - kP * py;
    float patch[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) patch[i][j] = s_win[(2 * py + i) * kWin + 2 * px + j];
    float best = -CUDART_INF_F;
#pragma unroll
    for (int sy = 0; sy < 2; ++sy)
#pragma unroll
      for (int sx = 0; sx < 2; ++sx) {
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc = fmaf(patch[sy + dy][sx + dx], w1r[dy * 3 + dx], acc);
        best = fmaxf(best, acc + b1);
      }
    s_pool[pp * kC1 + c] = fmaxf(best, 0.f);
  }
  __syncthreads();

  const float* p = s_pool + (oy * kP + ox) * kC1 + 2 * q;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float2 v = *reinterpret_cast<const float2*>(p + (dy * kP + dx) * kC1);
      acc = fmaf(v.x, w2r[2 * (dy * 3 + dx)], acc);
      acc = fmaf(v.y, w2r[2 * (dy * 3 + dx) + 1], acc);
    }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  // Each of the four lanes of an output holds its sum; the reduction over
  // lanes 4 apart adds the warp's eight outputs once each.
  float s = fmaxf(acc + b2, 0.f) * fc;
  for (int off = 4; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((t & 31) == 0) s_warp[t >> 5] = s;
  __syncthreads();

  if (t < 32) {
    float v = t < kFrameThreads / 32 ? s_warp[t] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (t == 0) out[0] = v / 9.f + __ldg(w + kOffFcB);
  }
}

// -- many windows per launch --------------------------------------------------

constexpr int kMaxTile = 48;         // windows per CTA tile
constexpr int kThreadsPerWin = 8;    // conv1: a channel; conv2: (co half, ci quarter)
constexpr int kPoolStride = 204;     // floats per window's pooled map (200 + 4)
// w2 in shared memory: one row of 20 floats per (tap, ci), co 0-7 at 0 and
// co 8-15 at 12, so a window's eight conv2 lanes read eight distinct bank
// groups.
constexpr int kW2Row = 20, kW2Hi = 12;
constexpr int kSW2 = 0, kSB2 = kSW2 + 72 * kW2Row, kSFc = kSB2 + 16, kSFcB = kSFc + 16;
constexpr int kSWeights = kSFcB + 4;  // 1476 floats
constexpr int kDepth = 8;             // 16-byte loads in flight per thread when staging windows

__host__ __device__ constexpr int batch_smem_floats(int tile) {
  return kSWeights + tile * (kWinFloats + kPoolStride);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copies n floats to shared memory: 16 bytes at a time where both ends
// allow it, eight loads in flight per thread before the first store.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  if (!aligned16(src) || !aligned16(dst) || (n & 3)) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
    return;
  }
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  const int n4 = n / 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += kDepth * blockDim.x) {
    float4 buf[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < n4) buf[k] = __ldg(s4 + i);
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < n4) d4[i] = buf[k];
    }
  }
}

__global__ void __launch_bounds__(kThreadsPerWin * kMaxTile) conv_window_batch_kernel(
    const float* __restrict__ windows,  // (n, 12, 12)
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ fc, const float* __restrict__ fc_b,
    float* __restrict__ out, int n, int tile) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // w2 rows, then b2, fc, fc_b
  float* s_win = s_w + kSWeights;                // (tile, 144)
  float* s_pool = s_win + tile * kWinFloats;     // (tile, 204): (y, x, c)
  const int t = threadIdx.x;

  const int wi = t >> 3;   // the thread's window within the tile
  const int r = t & 7;     // conv1: channel r; conv2: co half r>>2, ci pair r&3
  // A window's eight lanes: all present (8 | blockDim) and on one branch.
  const unsigned group = 0xffu << (t & 24);

  // One round trip to memory: every load of the weights is issued before
  // the first tile's windows are staged, and stored only after its conv1.
  // conv1's nine taps and bias live in registers; w2 (re-pitched) and the
  // epilogue's b2, fc, fc_b go to shared memory.
  float k1[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k1[i] = __ldg(w1 + i * kC1 + r);
  const float bias1 = __ldg(b1 + r);
  const bool w2_vec = aligned16(w2);
  const float4* w2v = reinterpret_cast<const float4*>(w2);
  float4 w2buf[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = t + k * blockDim.x;
    if (w2_vec && i < 72 * 4) w2buf[k] = __ldg(w2v + i);
  }
  const float small = t < 16 ? __ldg(b2 + t) : t < 32 ? __ldg(fc + t - 16)
                    : t == 32 ? __ldg(fc_b) : 0.f;

  for (int first = blockIdx.x * tile; first < n; first += gridDim.x * tile) {
    const int cnt = min(tile, n - first);
    stage(s_win, windows + static_cast<size_t>(first) * kWinFloats, cnt * kWinFloats);
    __syncthreads();

    // conv1 + ReLU + 2x2 max-pool: thread (window, channel r). Pooled row py
    // reads input rows 2py..2py+3; each input row is loaded once.
    if (wi < cnt) {
      const float4* win = reinterpret_cast<const float4*>(s_win + wi * kWinFloats);
      float* pool = s_pool + wi * kPoolStride + r;
      float x[kWin][kWin];
#pragma unroll
      for (int py = 0; py < kP; ++py) {
#pragma unroll
        for (int i = (py == 0 ? 0 : 2); i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float4 v = win[(2 * py + i) * 3 + j];
            x[2 * py + i][4 * j] = v.x;
            x[2 * py + i][4 * j + 1] = v.y;
            x[2 * py + i][4 * j + 2] = v.z;
            x[2 * py + i][4 * j + 3] = v.w;
          }
        // Tap-major: the row's 20 conv outputs advance together, 20
        // independent FMAs between dependent ones.
        float acc[kP][4];
#pragma unroll
        for (int px = 0; px < kP; ++px)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[px][k] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int px = 0; px < kP; ++px)
#pragma unroll
              for (int k = 0; k < 4; ++k)
                acc[px][k] = fmaf(x[2 * py + (k >> 1) + dy][2 * px + (k & 1) + dx],
                                  k1[dy * 3 + dx], acc[px][k]);
#pragma unroll
        for (int px = 0; px < kP; ++px) {
          const float best = fmaxf(fmaxf(acc[px][0], acc[px][1]), fmaxf(acc[px][2], acc[px][3]));
          pool[(py * kP + px) * kC1] = fmaxf(best + bias1, 0.f);
        }
      }
    }
    if (first == blockIdx.x * tile) {  // the weights, once per CTA
      for (int i = t; i < 72 * 4; i += blockDim.x) {  // w2 in 16-byte units, re-pitched
        const int g = i & 3;
        float* dst = s_w + kSW2 + (i >> 2) * kW2Row + (g < 2 ? 4 * g : kW2Hi + 4 * (g - 2));
        if (!w2_vec) {
#pragma unroll
          for (int k = 0; k < 4; ++k) dst[k] = __ldg(w2 + 4 * i + k);
        } else {
          *reinterpret_cast<float4*>(dst) =
              i == t ? w2buf[0] : i == t + blockDim.x ? w2buf[1] : __ldg(w2v + i);
        }
      }
      if (t < 33) s_w[t < 16 ? kSB2 + t : t < 32 ? kSFc + t - 16 : kSFcB] = small;
      for (int i = t + blockDim.x; i < 33; i += blockDim.x)
        s_w[i < 16 ? kSB2 + i : i < 32 ? kSFc + i - 16 : kSFcB] =
            i < 16 ? __ldg(b2 + i) : i < 32 ? __ldg(fc + i - 16) : __ldg(fc_b);
    }
    __syncthreads();

    // conv2 + ReLU + fc: thread (window, output channels 8h..8h+7 at all nine
    // positions, input channels 2s and 2s+1 of every tap): 72 accumulators,
    // 13 shared loads per 144 FMAs. The four input quarters are then summed
    // by a reduce-scatter across the window's lanes (36 + 18 shuffles), each
    // lane left with 18 whole outputs; ReLU and fc on those, then a sum over
    // the eight lanes.
    if (wi < cnt) {
      const int h = r >> 2, s = r & 3;
      const float* pin = s_pool + wi * kPoolStride + 2 * s;
      const float* wrow = s_w + kSW2 + 2 * s * kW2Row + h * kW2Hi;
      float acc[72];  // [position p][output o]: p * 8 + o
#pragma unroll
      for (int i = 0; i < 72; ++i) acc[i] = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        float2 a[9];
#pragma unroll
        for (int p = 0; p < 9; ++p)
          a[p] = *reinterpret_cast<const float2*>(pin + ((p / 3 + dy) * kP + p % 3 + dx) * kC1);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4* wr = reinterpret_cast<const float4*>(wrow + (tap * kC1 + j) * kW2Row);
          const float4 k0 = wr[0], k1v = wr[1];
          const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
          for (int p = 0; p < 9; ++p) {
            const float xv = j == 0 ? a[p].x : a[p].y;
#pragma unroll
            for (int o = 0; o < 8; ++o) acc[p * 8 + o] = fmaf(xv, kv[o], acc[p * 8 + o]);
          }
        }
      }
      // Reduce-scatter over s: lanes with s bit 1 keep entries 36..71, then
      // bit 0 picks 18 of those.
      const bool hi1 = s & 2, hi0 = s & 1;
#pragma unroll
      for (int i = 0; i < 36; ++i) {
        const float keep = hi1 ? acc[36 + i] : acc[i];
        const float send = hi1 ? acc[i] : acc[36 + i];
        acc[i] = keep + __shfl_xor_sync(group, send, 2);
      }
#pragma unroll
      for (int i = 0; i < 18; ++i) {
        const float keep = hi0 ? acc[18 + i] : acc[i];
        const float send = hi0 ? acc[i] : acc[18 + i];
        acc[i] = keep + __shfl_xor_sync(group, send, 1);
      }
      // acc[i], i < 18: the whole sum of entry base + i, position (base + i) / 8,
      // output channel 8h + (base + i) % 8.
      const int base = (s >> 1) * 36 + (s & 1) * 18;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < 18; ++i) {
        const int co = 8 * h + (base + i) % 8;
        v = fmaf(fmaxf(acc[i] + s_w[kSB2 + co], 0.f), s_w[kSFc + co], v);
      }
      v += __shfl_xor_sync(group, v, 1);
      v += __shfl_xor_sync(group, v, 2);
      v += __shfl_xor_sync(group, v, 4);
      if (r == 0) out[first + wi] = v / 9.f + s_w[kSFcB];
    }
    __syncthreads();  // the next tile overwrites s_win and s_pool
  }
}

int g_sm_count[64];  // per device, 0 until its first batch launch

}  // namespace


// Returns a cudaError_t (0 on a clean launch).
extern "C" int conv_window_frame_launch(const int* frame, const float* packed_w,
                                        float* out, int base, int row_stride,
                                        int col_stride, void* stream) {
  conv_window_frame_kernel<<<1, kFrameThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      frame, packed_w, base, row_stride, col_stride, out);
  return static_cast<int>(cudaGetLastError());
}

// Returns a cudaError_t (0 on a clean launch).
extern "C" int conv_window_launch(const float* windows, const float* w1,
                                  const float* b1, const float* w2,
                                  const float* b2, const float* fc,
                                  const float* fc_b, float* out, int n,
                                  void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sm_count[dev] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(conv_window_batch_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               batch_smem_floats(kMaxTile) * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sm_count[dev] = sms;
  }
  const int ctas = g_sm_count[dev];
  int tile = (n + ctas - 1) / ctas;
  if (tile > kMaxTile) tile = kMaxTile;
  const int tiles = (n + tile - 1) / tile;
  const int blocks = tiles < ctas ? tiles : ctas;
  conv_window_batch_kernel<<<blocks, kThreadsPerWin * tile, batch_smem_floats(tile) * 4,
                             static_cast<cudaStream_t>(stream)>>>(
      windows, w1, b1, w2, b2, fc, fc_b, out, n, tile);
  return static_cast<int>(cudaGetLastError());
}
