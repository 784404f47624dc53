// Causal GQA flash attention (forward), online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_bkv). Layout as there:
//   q, o [BKV, Sq, G, hd]; k, v [BKV, Sk, hd]; bfloat16 or float32;
//   hd 64 or 128. The G query heads that share one KV head sit next to
//   each other, so the (query, head) rows of one BKV slice are contiguous.
// Semantics as there: scores s = (q . k) * hd^-0.5 in float32; causal mask
// on absolute positions counted from 0 on both sides (key j is visible to
// query i iff j <= i), masked scores -1e30; running max m, running sum l of
// the float32 probabilities, and a float32 accumulator; the probabilities
// are rounded to v's type before the PV product; o = acc / max(l, 1e-30).
// Unlike the Pallas wrapper, any Sq and Sk: the ragged tail is masked.
//
// Design: one CTA of 8 warps per (BKV slice, 32 consecutive (query, head)
// rows); each warp owns 4 rows. The q rows are staged once in shared memory
// as float32; the CTA loops over 64-key tiles of k and v staged in shared
// memory (k rows padded by one float so that lanes reading different keys
// hit different banks). Scores: each lane owns two keys of the tile and
// walks hd with float4 broadcasts of q. Softmax statistics reduce across
// the warp with shuffles. PV: the warp's probabilities go through shared
// memory; each lane owns hd/32 output columns, so a row's accumulator
// (m, l, acc) stays in registers for the whole k loop. Key tiles wholly
// above the CTA's last query position are skipped. FMAs on the CUDA cores;
// no tensor cores (mma.sync / wgmma and TMA are later work).
//
// What bounds it on the H100: operations. The serve prefill shape (B 4,
// S 512, H 32, KV 8, hd 128, causal) needs 4·B·H·S²·hd/2 = 8.6 GFLOP
// against 8.4 MB of q, k, v and o; the bound is the bf16 tensor-core peak
// (989 TFLOP/s dense), which these CUDA-core FMAs cannot reach: the kernel
// is correct and simple first, not fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per CTA
constexpr int kBK = 64;                        // keys per k/v tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// A probability rounded to v's type, as the reference casts p before PV.
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __bfloat162float(__float2bfloat16(v));
}

template <int HD>
struct Smem {  // sizes in floats
  static constexpr int kKStride = HD + 1;
  static constexpr int kQ = kRows * HD;
  static constexpr int kK = kBK * kKStride;
  static constexpr int kV = kBK * HD;
  static constexpr int kP = kRows * kBK;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int sq, int sk, int g, float scale, int causal) {
  constexpr int kCols = HD / 32;  // output columns per lane
  using S = Smem<HD>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + S::kQ;
  float* vs = ks + S::kK;
  float* ps = vs + S::kV;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long rows_total = static_cast<long long>(sq) * g;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long slice = blockIdx.y;
  const int n_live = static_cast<int>(min(static_cast<long long>(kRows), rows_total - r0));
  const T* qb = q + (slice * rows_total + r0) * HD;
  const T* kb = k + slice * sk * HD;
  const T* vb = v + slice * sk * HD;
  T* ob = o + (slice * rows_total + r0) * HD;

  for (int i = tid; i < kRows * HD; i += blockDim.x)
    qs[i] = i < n_live * HD ? to_f32(qb[i]) : 0.f;

  int qpos[kRowsPerWarp];  // query position of each row; -1 past the end
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    qpos[i] = r < n_live ? static_cast<int>((r0 + r) / g) : -1;
  }
  int last_key = sk - 1;
  if (causal) last_key = min(last_key, static_cast<int>((r0 + n_live - 1) / g));
  const int n_tiles = last_key / kBK + 1;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const float* qw = qs + warp * kRowsPerWarp * HD;
  float* pw = ps + warp * kRowsPerWarp * kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBK * HD; i += blockDim.x) {
      const int j = i / HD, c = i % HD;
      const bool in = k0 + j < sk;
      const long long src = static_cast<long long>(k0 + j) * HD + c;
      ks[j * S::kKStride + c] = in ? to_f32(kb[src]) : 0.f;
      vs[i] = in ? to_f32(vb[src]) : 0.f;
    }
    __syncthreads();

    // Scores of this warp's rows against keys k0 + lane and k0 + lane + 32.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    const float* ka = ks + lane * S::kKStride;
    const float* kz = ks + (lane + 32) * S::kKStride;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float a0 = ka[c], a1 = ka[c + 1], a2 = ka[c + 2], a3 = ka[c + 3];
      const float z0 = kz[c], z1 = kz[c + 1], z2 = kz[c + 2], z3 = kz[c + 3];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(qw + i * HD + c);
        s[i][0] = fmaf(x.x, a0, s[i][0]);
        s[i][0] = fmaf(x.y, a1, s[i][0]);
        s[i][0] = fmaf(x.z, a2, s[i][0]);
        s[i][0] = fmaf(x.w, a3, s[i][0]);
        s[i][1] = fmaf(x.x, z0, s[i][1]);
        s[i][1] = fmaf(x.y, z1, s[i][1]);
        s[i][1] = fmaf(x.z, z2, s[i][1]);
        s[i][1] = fmaf(x.w, z3, s[i][1]);
      }
    }

    // Online softmax, one row at a time; the statistics are warp-uniform.
    const int j0 = k0 + lane, j1 = k0 + lane + 32;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float s0 = s[i][0] * scale, s1 = s[i][1] * scale;
      if (j0 >= sk || (causal && j0 > qpos[i])) s0 = kNegInf;
      if (j1 >= sk || (causal && j1 > qpos[i])) s1 = kNegInf;
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      pw[i * kBK + lane] = round_as<T>(p0);
      pw[i * kBK + lane + 32] = round_as<T>(p1);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();

    // acc += p · v over the tile; lane owns columns lane + 32·c.
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        p[i] = *reinterpret_cast<const float4*>(pw + i * kBK + j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float v0 = vs[(j + 0) * HD + lane + 32 * c];
        const float v1 = vs[(j + 1) * HD + lane + 32 * c];
        const float v2 = vs[(j + 2) * HD + lane + 32 * c];
        const float v3 = vs[(j + 3) * HD + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          acc[i][c] = fmaf(p[i].x, v0, acc[i][c]);
          acc[i][c] = fmaf(p[i].y, v1, acc[i][c]);
          acc[i][c] = fmaf(p[i].z, v2, acc[i][c]);
          acc[i][c] = fmaf(p[i].w, v3, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (qpos[i] < 0) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + static_cast<long long>(warp * kRowsPerWarp + i) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(orow + lane + 32 * c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bkv, int sq,
           int sk, int g, float scale, int causal, cudaStream_t stream) {
  const long long rows = static_cast<long long>(sq) * g;
  const long long tiles = (rows + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL || bkv > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(bkv));
  flash_kernel<T, HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, g, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128. Returns a cudaError_t
// (0 on a clean launch).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int bkv, int sq, int sk, int g, int hd,
                                      float scale, int causal, int dtype, void* stream) {
  if (bkv < 1 || sq < 1 || sk < 1 || g < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal != 0;
  if (dtype == 0 && hd == 64) return launch<float, 64>(q, k, v, o, bkv, sq, sk, g, scale, c, s);
  if (dtype == 0 && hd == 128) return launch<float, 128>(q, k, v, o, bkv, sq, sk, g, scale, c, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, bkv, sq, sk, g, scale, c, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, bkv, sq, sk, g, scale, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
