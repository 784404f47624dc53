// Chunked mLSTM cell (forward, zero initial state), float32 arithmetic.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_chunk/kernel.py
// (_mlstm_kernel, launched by mlstm_chunk_bh). Layout as there:
//   q, k, v, y [BH, S, hd] bfloat16 or float32; i_pre, f_pre [BH, S] float32;
//   chunks of L <= 128 positions, L dividing S.
// Per chunk, with cumf the inclusive sum of log_sigmoid(f) inside the chunk,
// D[a,b] = cumf_a - cumf_b + i_b (b <= a), m_a = max(max_b D[a,b],
// cumf_a + m_prev) and g_a = exp(cumf_a + m_prev - m_a):
//   W = exp(D - m) * (q k^T)                           [L, L], causal
//   y = (W v + g * (q C)) / max(|W 1 + g * (q n)|, 1)  [L, hd]
//   C <- gdec * C + (gsrc * k)^T v,  n <- gdec * n + (gsrc * k)^T 1
// and m <- m_new, exactly as the Pallas kernel and the plain version
// (../ref.py, mlstm_chunk_terms) compute them, all in float32. y is written
// in the input's type; the final C [BH, hd, hd], n [BH, hd] and m [BH] in
// float32.
//
// Design. The TPU walks the chunks of one (b, h) in order and keeps C
// [hd, hd] in VMEM. Here C is 4 MiB of float32 per (b, h) at hd 1024, more
// than one block's shared memory, and one block per (b, h) would use 16 of
// 132 SMs at the serve shape. Three kernels, in order on one stream:
//   1. gates: one block per (b, h) walks the chunks: log-sigmoid, cumf (a
//      left-to-right sum, as the plain version adds), the m chain, g, gsrc,
//      gdec. These depend on neither q, k nor v.
//   2. W: one block per (32 rows, chunk, b·h) forms W = exp(D - m) * (q k^T)
//      and its row sums; none of this depends on the carried state.
//   3. state: one block per (32 columns of v, C and y; b·h). Each block
//      keeps its [hd, 32] slice of C in shared memory and loops over the
//      chunks: y[:, e] = W v[:, e] + g q C[:, e], then the update of C[:, e].
//      The columns are independent, so 16 (b, h) fill 512 blocks. Each block
//      also carries all of n and forms q.n itself (2·L·hd operations a
//      chunk beside its 4·L·hd·32), so the denominator needs no other block.
// Products run on the CUDA cores in float32 (register tiles of 4 x 4 per
// thread, operands staged in shared memory through registers, the next
// tile's loads in flight during the current tile's products); -fmad stays
// on: the contracted products round once where the plain version rounds
// twice, which the rounding bound checked on the card allows for.
//
// What bounds it on the H100: float32 operations. Per (b·h, chunk) the
// products take about 2·2·L·hd^2 (q C and the C update) + 2·2·L^2·hd (q k^T
// and W v) operations: 38.7 GFLOP at B·H 16, S 512, hd 1024, L 128, or 32.3
// counting only what the data needs (causal halves, no q C while C is
// zero): 0.58 or 0.48 ms at 67 TFLOP/s, against 134 MB of inputs and outputs (0.04
// ms at 3.35 TB/s). Tensor cores would need TF32 or lower, which the
// float32 contract rules out. The design spreads the hd^2 work over every
// SM. What holds it back (PERF.md): the C slice takes 170 KB of shared
// memory, so an SM runs one block of 8 warps, and those wait at each
// tile's two barriers; larger register tiles with q and W staged
// transposed (float4 reads), or a C slice split across a cluster, are the
// next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;   // longest chunk
constexpr int kCols = 32;    // columns of C / v / y per state block
constexpr int kTile = 32;    // reduction tile: keys, or hd in q k^T and q C
constexpr int kTileP = kTile + 1;
constexpr int kDRows = 128;  // rows of C per update tile
constexpr int kPer = kMaxL * kTile / kThreads;  // tile elements per thread
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;
static_assert(kTile * kDRows == kMaxL * kTile && kCols == kTile,
              "the staged tiles share one size");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// A loop over tiles staged through shared memory: load(t, r) reads tile t
// from device memory into registers, store(r) writes them to shared memory,
// compute(t) works on the staged tile. The next tile's loads are issued
// before the current tile's products, so their latency overlaps them.
template <typename Load, typename Store, typename Compute>
__device__ __forceinline__ void tile_loop(int n_tiles, Load load, Store store_tile,
                                          Compute compute) {
  float r[kPer];
  if (n_tiles > 0) load(0, r);
  for (int t = 0; t < n_tiles; ++t) {
    store_tile(r);
    __syncthreads();
    if (t + 1 < n_tiles) load(t + 1, r);
    compute(t);
    __syncthreads();
  }
}

// Per-position gate terms, chained over the chunks of one (b, h).
struct Gates {
  float* cumf;    // [BH, S]
  float* mrow;    // [BH, S]  m_a
  float* ginter;  // [BH, S]  g_a
  float* gsrc;    // [BH, S]
  float* wsum;    // [BH, S]  sum_b W[a, b]
  float* gdec;    // [BH, nc]
  float* w;       // [BH, nc, L, L]
};

__global__ void __launch_bounds__(kMaxL) mlstm_gate_kernel(
    const float* __restrict__ ip, const float* __restrict__ fp, Gates g,
    float* __restrict__ m_out, int S, int L) {
  __shared__ float cumf[kMaxL], ic[kMaxL], src[kMaxL];
  __shared__ float m_prev_s, m_new_s;
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int nc = S / L;
  if (tid == 0) m_prev_s = kNegInf;  // the zero initial state
  for (int c = 0; c < nc; ++c) {
    const long long p0 = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
    if (tid < L) {
      const float x = fp[p0 + tid];
      cumf[tid] = fminf(x, 0.f) - log1pf(expf(-fabsf(x)));  // log_sigmoid
      ic[tid] = ip[p0 + tid];
    }
    __syncthreads();
    if (tid == 0) {
      float acc = cumf[0];
      for (int t = 1; t < L; ++t) {
        acc = acc + cumf[t];
        cumf[t] = acc;
      }
    }
    __syncthreads();
    const float m_prev = m_prev_s;
    const float last = cumf[L - 1];
    if (tid < L) {
      const float ca = cumf[tid];
      float m_intra = kNegInf;
      for (int b = 0; b <= tid; ++b) m_intra = fmaxf(m_intra, (ca - cumf[b]) + ic[b]);
      const float m_inter = ca + m_prev;
      const float m_a = fmaxf(m_intra, m_inter);
      g.cumf[p0 + tid] = ca;
      g.mrow[p0 + tid] = m_a;
      g.ginter[p0 + tid] = expf(m_inter - m_a);
      src[tid] = (last - ca) + ic[tid];
    }
    __syncthreads();
    if (tid == 0) {
      float mx = src[0];
      for (int b = 1; b < L; ++b) mx = fmaxf(mx, src[b]);
      const float m_new = fmaxf(last + m_prev, mx);
      m_new_s = m_new;
      g.gdec[static_cast<long long>(bh) * nc + c] = expf((last + m_prev) - m_new);
    }
    __syncthreads();
    if (tid < L) g.gsrc[p0 + tid] = expf(src[tid] - m_new_s);
    if (tid == 0) m_prev_s = m_new_s;
    __syncthreads();
  }
  if (tid == 0) m_out[bh] = m_prev_s;
}

// W for 32 rows of one chunk: warp w owns rows 4w..4w+3 of the block, lane
// l the keys l, l+32, l+64, l+96.
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_w_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ ip,
    Gates g, int S, int hd, int L) {
  __shared__ float qs[32][kTileP];
  __shared__ float ks[kMaxL][kTileP];
  const int r0 = blockIdx.x * 32, c = blockIdx.y, bh = blockIdx.z;
  const int nc = S / L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long p0 = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
  const int n_keys = min(L, r0 + 32);  // keys any row of this block sees
  float acc[4][4] = {};
  for (int d0 = 0; d0 < hd; d0 += kTile) {
    for (int i = tid; i < 32 * kTile; i += kThreads) {
      const int r = i / kTile, dd = i % kTile;
      qs[r][dd] = r0 + r < L ? to_f32(q[(p0 + r0 + r) * hd + d0 + dd]) : 0.f;
    }
    for (int i = tid; i < kMaxL * kTile; i += kThreads) {
      const int b = i / kTile, dd = i % kTile;
      ks[b][dd] = b < n_keys ? to_f32(k[(p0 + b) * hd + d0 + dd]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < kTile; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[warp * 4 + i][dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[lane + 32 * j][dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += qv[i] * kv[j];
    }
    __syncthreads();
  }
  float* wc = g.w + (static_cast<long long>(bh) * nc + c) * L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = r0 + warp * 4 + i;
    if (a >= L) continue;  // uniform across the warp
    const float ca = g.cumf[p0 + a], ma = g.mrow[p0 + a];
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = lane + 32 * j;
      float wv = 0.f;
      if (b <= a) wv = expf(((ca - g.cumf[p0 + b]) + ip[p0 + b]) - ma) * acc[i][j];
      if (b < L) wc[static_cast<long long>(a) * L + b] = wv;
      rs += wv;
    }
    rs = warp_sum(rs);
    if (lane == 0) g.wsum[p0 + a] = rs;
  }
}

// Outputs and state for 32 columns of one (b, h). Thread t owns rows
// 4·(t/8) .. +3 and columns 4·(t%8) .. +3 of each [128, 32] tile. Every
// block also carries the whole normalizer n (hd floats) and q.n, cheap
// beside its slice of C, so the denominator needs no other block.
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_state_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Gates g,
    T* __restrict__ y, float* __restrict__ c_out, float* __restrict__ n_out, int S, int hd,
    int L) {
  extern __shared__ __align__(16) float sm[];
  float* Cs = sm;                       // [hd][kCols]
  float* Vs = Cs + hd * kCols;          // [kMaxL][kCols]
  float* Ts = Vs + kMaxL * kCols;       // [kMaxL][kTileP] or [kTile][kDRows]
  float* ns = Ts + kMaxL * kTileP;      // [hd]
  float* gi = ns + hd;                  // [kMaxL]
  float* dn = gi + kMaxL;               // [kMaxL]
  float* gs = dn + kMaxL;               // [kMaxL]
  const int e0 = blockIdx.x * kCols, bh = blockIdx.y;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int nc = S / L;
  const int n_bt = (L + kTile - 1) / kTile;   // key tiles per chunk
  for (int i = tid; i < hd * kCols; i += kThreads) Cs[i] = 0.f;
  for (int i = tid; i < hd; i += kThreads) ns[i] = 0.f;

  auto store_rows = [&](float (&r)[kPer]) {  // a [kMaxL][kTile] tile, padded rows
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      Ts[(i / kTile) * kTileP + i % kTile] = r[j];
    }
  };
  auto store_flat = [&](float (&r)[kPer]) {  // a [kTile][kDRows] tile
#pragma unroll
    for (int j = 0; j < kPer; ++j) Ts[tid + j * kThreads] = r[j];
  };

  for (int c = 0; c < nc; ++c) {
    const long long p0 = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
    const float* wc = g.w + (static_cast<long long>(bh) * nc + c) * L * L;
    __syncthreads();
    {
      float r[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads, b = i / kCols, e = i % kCols;
        r[j] = b < L ? to_f32(v[(p0 + b) * hd + e0 + e]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) Vs[tid + j * kThreads] = r[j];
    }
    if (tid < kMaxL) {
      gi[tid] = tid < L ? g.ginter[p0 + tid] : 0.f;
      gs[tid] = tid < L ? g.gsrc[p0 + tid] : 0.f;
    }
    __syncthreads();

    // y_intra = W v
    float yi[4][4] = {}, ye[4][4] = {};
    tile_loop(
        n_bt,
        [&](int t, float (&r)[kPer]) {
          const int b0 = t * kTile;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const int i = tid + j * kThreads, a = i / kTile, b = b0 + i % kTile;
            r[j] = a < L && b < L ? wc[static_cast<long long>(a) * L + b] : 0.f;
          }
        },
        store_rows,
        [&](int t) {
          const int b0 = t * kTile;
#pragma unroll 8
          for (int bb = 0; bb < kTile; ++bb) {
            const float4 vv = *reinterpret_cast<const float4*>(Vs + (b0 + bb) * kCols + cg * 4);
            const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float wv = Ts[(rg * 4 + i) * kTileP + bb];
#pragma unroll
              for (int j = 0; j < 4; ++j) yi[i][j] += wv * vj[j];
            }
          }
        });

    // y_inter = q C_prev and q.n_prev; C, n and g are zero in the first chunk
    float qn_acc = 0.f;
    tile_loop(
        c > 0 ? hd / kTile : 0,
        [&](int t, float (&r)[kPer]) {
          const int d0 = t * kTile;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const int i = tid + j * kThreads, a = i / kTile;
            r[j] = a < L ? to_f32(q[(p0 + a) * hd + d0 + i % kTile]) : 0.f;
          }
        },
        store_rows,
        [&](int t) {
          const int d0 = t * kTile;
#pragma unroll 8
          for (int dd = 0; dd < kTile; ++dd) {
            const float4 cc = *reinterpret_cast<const float4*>(Cs + (d0 + dd) * kCols + cg * 4);
            const float cj[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float qv = Ts[(rg * 4 + i) * kTileP + dd];
#pragma unroll
              for (int j = 0; j < 4; ++j) ye[i][j] += qv * cj[j];
            }
          }
          if (tid < kMaxL) {
#pragma unroll 8
            for (int dd = 0; dd < kTile; ++dd) qn_acc += Ts[tid * kTileP + dd] * ns[d0 + dd];
          }
        });
    if (tid < kMaxL) dn[tid] = tid < L ? g.wsum[p0 + tid] + gi[tid] * qn_acc : 1.f;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = rg * 4 + i;
      if (a >= L) continue;
      const float scale = fmaxf(fabsf(dn[a]), 1.f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(y + (p0 + a) * hd + e0 + cg * 4 + j, (yi[i][j] + gi[a] * ye[i][j]) / scale);
    }

    // C <- gdec C + (gsrc k)^T v and n <- gdec n + (gsrc k)^T 1, in tiles of
    // kDRows rows of C by kTile keys
    const float gdec = g.gdec[static_cast<long long>(bh) * nc + c];
    float acc[4][4] = {};
    float n_acc = 0.f;
    tile_loop(
        ((hd + kDRows - 1) / kDRows) * n_bt,
        [&](int t, float (&r)[kPer]) {
          const int r0 = (t / n_bt) * kDRows, b0 = (t % n_bt) * kTile;
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            const int i = tid + j * kThreads, b = b0 + i / kDRows, d = r0 + i % kDRows;
            r[j] = b < L && d < hd ? to_f32(k[(p0 + b) * hd + d]) * gs[b] : 0.f;
          }
        },
        store_flat,
        [&](int t) {
          const int r0 = (t / n_bt) * kDRows, b0 = (t % n_bt) * kTile;
#pragma unroll 8
          for (int bb = 0; bb < kTile; ++bb) {
            const float4 kk = *reinterpret_cast<const float4*>(Ts + bb * kDRows + rg * 4);
            const float4 vv = *reinterpret_cast<const float4*>(Vs + (b0 + bb) * kCols + cg * 4);
            const float ki[4] = {kk.x, kk.y, kk.z, kk.w};
            const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] += ki[i] * vj[j];
          }
          if (tid < kDRows) {
#pragma unroll 8
            for (int bb = 0; bb < kTile; ++bb) n_acc += Ts[bb * kDRows + tid];
          }
          if (t % n_bt != n_bt - 1) return;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = r0 + rg * 4 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (d < hd) {
                float* cp = Cs + d * kCols + cg * 4 + j;
                *cp = *cp * gdec + acc[i][j];
              }
              acc[i][j] = 0.f;
            }
          }
          if (tid < kDRows && r0 + tid < hd) ns[r0 + tid] = ns[r0 + tid] * gdec + n_acc;
          n_acc = 0.f;
        });
  }
  __syncthreads();
  for (int i = tid; i < hd * kCols; i += kThreads) {
    const int d = i / kCols, e = i % kCols;
    c_out[(static_cast<long long>(bh) * hd + d) * hd + e0 + e] = Cs[i];
  }
  if (blockIdx.x == 0)
    for (int d = tid; d < hd; d += kThreads) n_out[static_cast<long long>(bh) * hd + d] = ns[d];
}

size_t state_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(hd) * (kCols + 1) + kMaxL * kCols +
                          kMaxL * kTileP + 3 * kMaxL);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* ip, const float* fp,
           void* y, float* c_out, float* n_out, float* m_out, float* scratch, int bh, int s,
           int hd, int l, cudaStream_t stream) {
  const int nc = s / l;
  const long long ns = static_cast<long long>(bh) * s;
  Gates g;
  g.cumf = scratch;
  g.mrow = g.cumf + ns;
  g.ginter = g.mrow + ns;
  g.gsrc = g.ginter + ns;
  g.wsum = g.gsrc + ns;
  g.gdec = g.wsum + ns;
  g.w = g.gdec + static_cast<long long>(bh) * nc;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);

  mlstm_gate_kernel<<<bh, kMaxL, 0, stream>>>(ip, fp, g, m_out, s, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  mlstm_w_kernel<T><<<dim3((l + 31) / 32, nc, bh), kThreads, 0, stream>>>(qt, kt, ip, g, s, hd, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // The shared-memory opt-in holds for the current device only. It is made
  // once per device and element type (made on every launch, it cost the
  // caller 0.9 ms a call on an H100); past the card's limit (hd above 1472
  // on an H100) it fails, and the launch with it.
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static size_t smem_set[kMaxDevices] = {};  // the largest opt-in made so far
  const size_t smem = state_smem_bytes(hd);
  if (smem > smem_set[device]) {
    err = cudaFuncSetAttribute(mlstm_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = smem;
  }
  mlstm_state_kernel<T><<<dim3(hd / kCols, bh), kThreads, smem, stream>>>(
      qt, kt, vt, g, static_cast<T*>(y), c_out, n_out, s, hd, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch one launch needs (gate terms and W).
extern "C" long long mlstm_chunk_scratch_floats(int bh, int s, int l) {
  const long long nc = s / l;
  return static_cast<long long>(bh) * (5LL * s + nc + nc * l * l);
}

// dtype: 0 float32, 1 bfloat16 (q, k, v and y). Returns a cudaError_t.
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v, const float* ip,
                                  const float* fp, void* y, float* c_out, float* n_out,
                                  float* m_out, float* scratch, int bh, int s, int hd, int l,
                                  int dtype, cudaStream_t stream) {
  if (bh <= 0 || s <= 0 || l <= 0 || l > kMaxL || s % l != 0 || hd <= 0 || hd % kCols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, ip, fp, y, c_out, n_out, m_out, scratch, bh, s, hd, l, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ip, fp, y, c_out, n_out, m_out, scratch, bh, s, hd, l,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
