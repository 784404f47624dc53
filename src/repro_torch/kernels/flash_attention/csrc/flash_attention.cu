// Causal GQA flash attention (forward), online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_bkv). Layout as there:
//   q, o [BKV, Sq, G, hd]; k, v [BKV, Sk, hd]; bfloat16 (hd 64, 112 or 128)
//   or float32 (hd 64 or 128). The G query heads that share one KV head sit
//   next to each other, so the (query, head) rows of one BKV slice are
//   contiguous.
// Semantics as there: scores s = (q . k) * hd^-0.5 in float32; causal mask
// on absolute positions counted from 0 on both sides (key j is visible to
// query i iff j <= i; for rows that are a block of a longer sequence from
// position q_start on, iff j <= q_start + i),
// masked scores -1e30; running max m, running sum l of
// the float32 probabilities, and a float32 accumulator; the probabilities
// are rounded to v's type before the PV product; o = acc / max(l, 1e-30).
// Unlike the Pallas wrapper, any Sq and Sk: the ragged tail is masked.
//
// What bounds it on the H100: operations. The serve prefill shape (B 4,
// S 512, H 32, KV 8, hd 128, causal) needs 4·B·H·S²·hd/2 = 8.6 GFLOP
// against 8.4 MB of q, k, v and o: 0.0087 ms at the bf16 tensor-core peak
// (989 TFLOP/s dense), 0.13 ms at the float32 CUDA-core peak. So the bf16
// products must run on the tensor cores.
//
// bfloat16 design (flash_mma_kernel). One CTA of 8 warps takes 128
// consecutive (query, head) rows of one BKV slice (at G = 4: 32 positions ×
// 4 heads, which share every k/v tile); each warp owns 16 rows. QKᵀ and PV
// run on mma.sync.m16n8k16 (bf16 in, float32 accumulate). mma.sync rather
// than wgmma: its fragments are fixed register layouts that need no shared
// memory descriptors or swizzle modes, any hd that is a multiple of 16 fits
// (112 included), the S accumulator of QKᵀ is already in the layout of PV's
// A operand, and a 128-row CTA needs no warpgroup-wide synchronisation; the
// price is about half of wgmma's peak rate, far above what a 0.05 ms launch
// of this size can use. The warp's q fragments are loaded once into
// registers. k and v tiles of 64 keys stay bf16 in shared memory, rows
// padded by 16 bytes so that the eight row addresses of each ldmatrix phase
// fall in different banks, double-buffered with cp.async so that the next
// tile's copy is in flight during this tile's products. ldmatrix feeds K
// (as QKᵀ's column-major B) and V (.trans, as PV's B). The online softmax
// runs on the S fragments in registers, in base 2 (s·hd^-0.5·log2 e, then
// exp2), with the row max reduced over the 4 lanes that share a row; each
// lane keeps partial row sums of the unrounded p and the quad sums them at
// the end. p is rounded to bf16 and packed straight into PV's A fragments:
// no round trip through shared memory. Causal: key tiles above the CTA's
// last position are never loaded, a warp skips the products of a tile that
// lies wholly above its own rows, and only tiles that cross the diagonal or
// the Sk tail are masked. Grid: (BKV, row tiles), row tiles numbered from
// the last, so the CTAs with the most keys start first. The shared-memory
// opt-in (70 KB at hd 128) is made once per device and instantiation.
//
// float32 design (flash_f32_kernel): exact float32 on the CUDA cores, for
// checks against repro's 2e-5 (TF32 tensor cores would break it). One CTA
// of 8 warps per 32 (query, head) rows; k and v tiles staged as float32,
// scores by lane-owned keys, PV by lane-owned output columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

// Makes the dynamic shared-memory opt-in of `kernel` once per device (made
// on every launch, the same call cost the mLSTM kernel's caller 0.9 ms).
// One flag array per kernel instantiation, the caller's static.
template <typename K>
cudaError_t smem_optin_once(K kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done[device] = true;
  return err;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores.

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;  // (query, head) rows per CTA
constexpr int kBK = 64;             // keys per k/v tile
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int kStride = HD + 8;        // bf16 per shared row: 16 bytes of pad
  static constexpr int kElems = kBK * kStride;  // one k or v tile
  static constexpr size_t kBytes = 2 /*stages*/ * 2 /*k, v*/ * kElems * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a · b: a 16×16 (row), b 16×8 (col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Issues the copies of keys [k0, k0 + kBK) of k and v into one stage; keys
// at or past sk are zero-filled, so that p = 0 never meets a stale v.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                          const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                          int k0, int sk) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = k0 + r < sk;
    const long long src = static_cast<long long>(in ? k0 + r : 0) * HD + c;
    cp_async16(ks + r * Tile<HD>::kStride + c, kb + src, in ? 16 : 0);
    cp_async16(vs + r * Tile<HD>::kStride + c, vb + src, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int sq, int sk, int g,
    float scale_log2, int causal, int q_start) {
  constexpr int kSteps = HD / 16;   // k-steps of QKᵀ
  constexpr int kOut = HD / 8;      // n-tiles of the output
  constexpr int kKeyTiles = kBK / 8;  // n-tiles of S
  constexpr int kPSteps = kBK / 16;   // k-steps of PV
  using TL = Tile<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row within 8, column pair
  const long long rows_total = static_cast<long long>(sq) * g;
  const long long r0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) * kRows;
  const long long slice = blockIdx.x;
  const int n_live = static_cast<int>(min(static_cast<long long>(kRows), rows_total - r0));
  const __nv_bfloat16* kb = k + slice * sk * HD;
  const __nv_bfloat16* vb = v + slice * sk * HD;

  // This lane's two rows (fragment rows gq and gq + 8 of the warp's 16);
  // rows past the end read q = 0 and are never stored.
  const int la = warp * 16 + gq, lb = la + 8;
  const bool live_a = la < n_live, live_b = lb < n_live;
  const int pos_a = live_a ? q_start + static_cast<int>((r0 + la) / g) : 0x7fffffff;
  const int pos_b = live_b ? q_start + static_cast<int>((r0 + lb) / g) : 0x7fffffff;
  const int first_pos = q_start + static_cast<int>(r0 / g);
  int last_key = sk - 1;
  if (causal) last_key = min(last_key, q_start + static_cast<int>((r0 + n_live - 1) / g));
  const int n_tiles = last_key / kBK + 1;
  // The warp's last live position: tiles wholly above it are all masked.
  const int warp_last = q_start + static_cast<int>(
      (r0 + min(warp * 16 + 15, max(n_live - 1, 0))) / g);

  load_tile<HD>(smem, smem + TL::kElems, kb, vb, 0, sk);
  cp_async_commit();

  // q fragments (A operand of QKᵀ), loaded once: a0/a2 row la, a1/a3 row lb.
  uint32_t qf[kSteps][4];
  {
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(
        q + (slice * rows_total + r0 + (live_a ? la : 0)) * HD);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(
        q + (slice * rows_total + r0 + (live_b ? lb : 0)) * HD);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = (s * 16 + tq * 2) / 2;  // in pairs of bf16
      qf[s][0] = live_a ? qa[c] : 0u;
      qf[s][1] = live_b ? qb[c] : 0u;
      qf[s][2] = live_a ? qa[c + 4] : 0u;
      qf[s][3] = live_b ? qb[c + 4] : 0u;
    }
  }

  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;  // l: this lane's partial sums

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      load_tile<HD>(smem + 2 * nxt * TL::kElems, smem + (2 * nxt + 1) * TL::kElems, kb, vb,
                    k0 + kBK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread's copies
    const __nv_bfloat16* ks = smem + 2 * (t & 1) * TL::kElems;
    const __nv_bfloat16* vs = ks + TL::kElems;

    if (!causal || k0 <= warp_last) {
      // S = q · kᵀ for the warp's 16 rows × 64 keys.
      float s[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
#pragma unroll
        for (int j = 0; j < kKeyTiles; j += 2) {
          uint32_t b[4];
          const int key = j * 8 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(b, ks + key * TL::kStride + st * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[j], qf[st], b[0], b[1]);
          mma_bf16(s[j + 1], qf[st], b[2], b[3]);
        }
      }

      // Scale to base 2 and mask; only tiles across the diagonal or the tail.
      const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > first_pos);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (masked) {
            const int key = k0 + j * 8 + tq * 2 + (e & 1);
            const int pos = e < 2 ? pos_a : pos_b;
            if (key >= sk || (causal && key > pos)) x = kNegInf;
          }
          s[j][e] = x;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
      // A row's 64 scores lie in the 4 lanes of one quad.
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        s[j][0] = exp2f(s[j][0] - mn_a);
        s[j][1] = exp2f(s[j][1] - mn_a);
        s[j][2] = exp2f(s[j][2] - mn_b);
        s[j][3] = exp2f(s[j][3] - mn_b);
        sum_a += s[j][0] + s[j][1];
        sum_b += s[j][2] + s[j][3];
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        acc[n][0] *= alpha_a;
        acc[n][1] *= alpha_a;
        acc[n][2] *= alpha_b;
        acc[n][3] *= alpha_b;
      }

      // acc += p · v; p rounded to bf16 in the A fragment (S's C layout,
      // two key tiles per k-step), v through ldmatrix.trans.
#pragma unroll
      for (int ps = 0; ps < kPSteps; ++ps) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * ps][0], s[2 * ps][1]);
        pa[1] = pack_bf16(s[2 * ps][2], s[2 * ps][3]);
        pa[2] = pack_bf16(s[2 * ps + 1][0], s[2 * ps + 1][1]);
        pa[3] = pack_bf16(s[2 * ps + 1][2], s[2 * ps + 1][3]);
#pragma unroll
        for (int n = 0; n < kOut; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (ps * 16 + (lane & 15)) * TL::kStride + n * 8 +
                                   (lane >> 4) * 8);
          mma_bf16(acc[n], pa, b[0], b[1]);
          mma_bf16(acc[n + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* oa = o + (slice * rows_total + r0 + la) * HD + tq * 2;
  __nv_bfloat16* ob = o + (slice * rows_total + r0 + lb) * HD + tq * 2;
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
    if (live_a)
      *reinterpret_cast<uint32_t*>(oa + n * 8) = pack_bf16(acc[n][0] / den_a, acc[n][1] / den_a);
    if (live_b)
      *reinterpret_cast<uint32_t*>(ob + n * 8) = pack_bf16(acc[n][2] / den_b, acc[n][3] / den_b);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bkv, int sq, int sk, int g,
           float scale, int causal, int q_start, cudaStream_t stream) {
  const long long tiles = (static_cast<long long>(sq) * g + kRows - 1) / kRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted[kMaxDevices] = {};
  cudaError_t err = smem_optin_once(flash_mma_kernel<HD>, Tile<HD>::kBytes, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bkv), static_cast<unsigned>(tiles));
  flash_mma_kernel<HD><<<grid, kThreads, Tile<HD>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, g,
      scale * kLog2e, causal, q_start);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: CUDA cores, exact.

namespace f32 {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per CTA
constexpr int kBK = 64;                        // keys per k/v tile

template <int HD>
struct Smem {  // sizes in floats
  static constexpr int kKStride = HD + 1;
  static constexpr int kQ = kRows * HD;
  static constexpr int kK = kBK * kKStride;
  static constexpr int kV = kBK * HD;
  static constexpr int kP = kRows * kBK;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

// One CTA of 8 warps per (BKV slice, 32 consecutive (query, head) rows);
// each warp owns 4 rows. The q rows are staged once in shared memory; the
// CTA loops over 64-key tiles of k and v staged in shared memory (k rows
// padded by one float so that lanes reading different keys hit different
// banks). Scores: each lane owns two keys of the tile and walks hd with
// float4 broadcasts of q. Softmax statistics reduce across the warp with
// shuffles. PV: the warp's probabilities go through shared memory; each
// lane owns hd/32 output columns, so a row's accumulator (m, l, acc) stays
// in registers for the whole k loop. Key tiles wholly above the CTA's last
// query position are skipped.
template <int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int sq, int sk, int g, float scale, int causal, int q_start) {
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
  const float* qb = q + (slice * rows_total + r0) * HD;
  const float* kb = k + slice * sk * HD;
  const float* vb = v + slice * sk * HD;
  float* ob = o + (slice * rows_total + r0) * HD;

  for (int i = tid; i < kRows * HD; i += blockDim.x) qs[i] = i < n_live * HD ? qb[i] : 0.f;

  int qpos[kRowsPerWarp];  // query position of each row; -1 past the end
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    qpos[i] = r < n_live ? q_start + static_cast<int>((r0 + r) / g) : -1;
  }
  int last_key = sk - 1;
  if (causal) last_key = min(last_key, q_start + static_cast<int>((r0 + n_live - 1) / g));
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
      ks[j * S::kKStride + c] = in ? kb[src] : 0.f;
      vs[i] = in ? vb[src] : 0.f;
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
      pw[i * kBK + lane] = p0;
      pw[i * kBK + lane + 32] = p1;
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
    float* orow = ob + static_cast<long long>(warp * kRowsPerWarp + i) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[lane + 32 * c] = acc[i][c] / denom;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bkv, int sq, int sk, int g,
           float scale, int causal, int q_start, cudaStream_t stream) {
  const long long tiles = (static_cast<long long>(sq) * g + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL || bkv > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted[kMaxDevices] = {};
  cudaError_t err = smem_optin_once(flash_f32_kernel<HD>, Smem<HD>::kBytes, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(bkv));
  flash_f32_kernel<HD><<<grid, kWarps * 32, Smem<HD>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, sk, g, scale, causal, q_start);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// dtype: 0 = float32 (hd 64 or 128), 1 = bfloat16 (hd 64, 112 or 128).
// Causal rows may be a block of a longer sequence from query position
// q_start on: query row i sees the keys at positions <= q_start + i
// (q_start 0: the rows from position 0). Returns a cudaError_t (0 on a
// clean launch).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int bkv, int sq, int sk, int g, int hd, float scale,
                                      int causal, int q_start, int dtype, void* stream) {
  if (bkv < 1 || sq < 1 || sk < 1 || g < 1 || q_start < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal != 0, q0 = q_start;
  if (dtype == 0 && hd == 64) return f32::launch<64>(q, k, v, o, bkv, sq, sk, g, scale, c, q0, s);
  if (dtype == 0 && hd == 128)
    return f32::launch<128>(q, k, v, o, bkv, sq, sk, g, scale, c, q0, s);
  if (dtype == 1 && hd == 64) return tc::launch<64>(q, k, v, o, bkv, sq, sk, g, scale, c, q0, s);
  if (dtype == 1 && hd == 112)
    return tc::launch<112>(q, k, v, o, bkv, sq, sk, g, scale, c, q0, s);
  if (dtype == 1 && hd == 128)
    return tc::launch<128>(q, k, v, o, bkv, sq, sk, g, scale, c, q0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
