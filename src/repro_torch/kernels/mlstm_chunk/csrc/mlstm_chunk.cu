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
// than one SM holds, and one block per (b, h) would use 16 of 132 SMs at
// the serve shape. Three kernels, in order on one stream:
//   1. gates: one block per (b, h) walks the chunks: log-sigmoid, cumf (a
//      left-to-right sum, as the plain version adds), the m chain, g, gsrc,
//      gdec. These depend on neither q, k nor v, so m is the plain
//      version's to the bit.
//   2. W: W = exp(D - m) * (q k^T) and its row sums; none of this depends
//      on the carried state.
//   3. state: one block per (a slice of the columns of v, C and y; b·h)
//      loops over the chunks: y[:, e] = W v[:, e] + g q C[:, e], then the
//      update of C[:, e]. The columns are independent. Every block also
//      carries all of n and forms q.n itself, so the denominator needs no
//      other block.
//
// bfloat16 (the served path): every product on the tensor cores.
// mma.sync.m16n8k16 (bf16 in, float32 accumulate), as the flash kernel
// uses. q, k and v are bf16, so their products are exact in the float32
// accumulator. Each float32 operand (W, C, gsrc*k) is split in registers
// into hi + mid + lo bf16 pieces, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid); both differences are exact in float32 and lo is
// exact in bf16, so hi + mid + lo == x: the three products of one MMA each
// carry float32's 24-bit significand, and the sum is taken in float32 as
// the plain version takes it. Two pieces would carry 16 bits, below the
// state bound of about 2^-15.5 (chip_smoke.py, mlstm_bounds). The
// float32 contract holds: float32 operands, float32 sums (in another
// order, and rounded per MMA rather than per term), float32 state.
//   W stage (mlstm_w_mma_kernel): a block of 4 warps per 16 rows, which
// split hd and sum their partials in shared memory; q and k fragments come
// straight from device memory as 16-byte loads (the next group's in flight
// during this one's products), the k index of each 32-wide group permuted
// the same way in both operands.
//   State stage (mlstm_state_mma_kernel): the block owns 32 columns of C
// and keeps them transposed, C^T [32, hd], as MMA accumulators in registers
// across the chunks: each of 16 warps holds both 16-row halves of two
// 32-wide d groups (64 floats a thread at hd 1024). Of the candidates (C^T
// in registers, a narrower slice in shared memory, a slice split over a
// cluster) this is the one that moves C nowhere: the accumulator fragment
// of C^T is already the A operand of y^T = C^T q^T (as flash reuses S as
// P's operand), and the update C^T = gdec C^T + v^T (gsrc*k) accumulates
// into the same fragment. The d order inside each group is permuted so
// that a lane's q and k values are 16 contiguous bytes, loaded once for
// both halves (the next ones in flight during this step's products); k
// reaches the B layout through movmatrix.trans, and each split of gsrc*k
// feeds both halves. The reduction of y^T over d crosses the warps: each
// writes its partial of a 16-row pass to shared memory and the block sums
// them in warp order (deterministic). 512 threads at 128 registers, 75 KB
// of shared memory: one block of 16 warps an SM, 32 blocks per (b, h) at hd
// 1024. Tried on the H100 and dropped: 16 columns a block at two blocks an
// SM, and q and k staged in shared memory with cp.async (both slower: the
// kernel waits on its own dependent chains, not on memory).
//
// float32: the CUDA cores (mlstm_w_f32_kernel, mlstm_state_f32_kernel),
// for the float32 copy of the model that checks the path end to end.
// Register tiles of 4 x 4, operands staged in shared memory through
// registers with the next tile's loads in flight; the [hd, 32] C slice
// lives in shared memory (one block of 8 warps an SM).
//
// What bounds it on the H100. Per (b·h, chunk) the products take 2·L·hd^2
// (C update) + 2·L·hd^2 (q C, past the first chunk) + L(L+1)·hd (W v) +
// L(L+1)·hd (q k^T) operations, 32.3 GFLOP at B·H 16, S 512, hd 1024, L
// 128 against 134 MB of inputs and outputs (0.04 ms at 3.35 TB/s). In
// bf16 the split products run three passes on the tensor cores: 31.1
// GFLOP x 3 at 989 TFLOP/s, 0.095 ms. What the design pays beyond that:
// each of the 32 blocks of a (b, h) reads all of the chunk's q and k (512
// KB a chunk) from L2; the reduction of y over the warps; the split's ALU
// work; and above all latency: 16 warps an SM, each a chain of dependent
// splits and MMAs, keep the tensor cores busy a small share of the time.
// In float32 the products run on the CUDA cores (0.48 ms at 67 TFLOP/s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxL = 128;   // longest chunk
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Makes the dynamic shared-memory opt-in of `kernel` once per device (made
// on every launch it cost the caller 0.9 ms a call on an H100), for the
// largest size asked so far. Past the card's limit it fails, and the
// launch with it.
template <typename K>
cudaError_t smem_optin_once(K kernel, size_t bytes, size_t (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done[device] = bytes;
  return err;
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

// ---------------------------------------------------------------------------
// float32: CUDA cores.

namespace f32 {

constexpr int kThreads = 256;
constexpr int kCols = 32;    // columns of C / v / y per state block
constexpr int kTile = 32;    // reduction tile: keys, or hd in q k^T and q C
constexpr int kTileP = kTile + 1;
constexpr int kDRows = 128;  // rows of C per update tile
constexpr int kPer = kMaxL * kTile / kThreads;  // tile elements per thread
static_assert(kTile * kDRows == kMaxL * kTile && kCols == kTile,
              "the staged tiles share one size");

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

// W for 32 rows of one chunk: warp w owns rows 4w..4w+3 of the block, lane
// l the keys l, l+32, l+64, l+96.
__global__ void __launch_bounds__(kThreads) mlstm_w_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ ip,
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
      qs[r][dd] = r0 + r < L ? q[(p0 + r0 + r) * hd + d0 + dd] : 0.f;
    }
    for (int i = tid; i < kMaxL * kTile; i += kThreads) {
      const int b = i / kTile, dd = i % kTile;
      ks[b][dd] = b < n_keys ? k[(p0 + b) * hd + d0 + dd] : 0.f;
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
__global__ void __launch_bounds__(kThreads) mlstm_state_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    Gates g, float* __restrict__ y, float* __restrict__ c_out, float* __restrict__ n_out,
    int S, int hd, int L) {
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
        r[j] = b < L ? v[(p0 + b) * hd + e0 + e] : 0.f;
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
            r[j] = a < L ? q[(p0 + a) * hd + d0 + i % kTile] : 0.f;
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
        y[(p0 + a) * hd + e0 + cg * 4 + j] = (yi[i][j] + gi[a] * ye[i][j]) / scale;
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
            r[j] = b < L && d < hd ? k[(p0 + b) * hd + d] * gs[b] : 0.f;
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

int launch(const float* q, const float* k, const float* v, const float* ip, Gates g,
           float* y, float* c_out, float* n_out, int bh, int s, int hd, int l,
           cudaStream_t stream) {
  const int nc = s / l;
  mlstm_w_f32_kernel<<<dim3((l + 31) / 32, nc, bh), kThreads, 0, stream>>>(q, k, ip, g, s, hd,
                                                                            l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // past the card's limit (hd above 1472 on an H100) the opt-in fails
  static size_t opted[kMaxDevices] = {};
  const size_t smem = state_smem_bytes(hd);
  err = smem_optin_once(mlstm_state_f32_kernel, smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_state_f32_kernel<<<dim3(hd / kCols, bh), kThreads, smem, stream>>>(
      q, k, v, g, y, c_out, n_out, s, hd, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, float32 operands split into three bf16 pieces.

namespace tc {

constexpr int kWSplit = 4;             // W stage: warps that split hd for one 16-row tile
constexpr int kWarps = 16;             // state stage: warps that split hd
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;              // columns of C / v / y a state block: two halves of 16
constexpr int kGroups = 2;             // 32-wide d groups a warp holds
constexpr int kMaxHd = 32 * kWarps * kGroups;
constexpr int kVStride = kCols + 8;    // bf16 a staged v row: 80 bytes, ldmatrix without conflicts

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The transpose of the 8 x 8 bf16 matrix held one 2-element row piece a
// lane (lane 4r + c holds row r, columns 2c and 2c + 1), in the same layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// A float32 pair as three bf16 pairs whose sum is the pair exactly (the
// first value in the low halves).
struct Split {
  uint32_t hi, mid, lo;
};
__device__ __forceinline__ Split split3(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;  // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);  // exact
  return {bits(h), bits(m), bits(l)};
}

// d += A · b for a float32 B operand given as pieces (b0, b1 of one
// fragment each split): three MMAs, the small pieces first.
__device__ __forceinline__ void mma_split_b(float (&d)[4], const uint32_t (&a)[4], Split b0,
                                            Split b1) {
  mma_bf16(d, a, b0.lo, b1.lo);
  mma_bf16(d, a, b0.mid, b1.mid);
  mma_bf16(d, a, b0.hi, b1.hi);
}

// W for 16 rows of one chunk. The 4 warps of the block split hd (warp w
// takes the 32-wide groups w, w + 4, ...) over the key tiles up to the
// block's last row, the next group's loads in flight during this group's
// products; warp 0 sums the partials in warp order. Inside each group, lane
// (g, t) takes the 8 contiguous values at 8t for both operands: the k index
// of the MMA is permuted alike in A and B.
__global__ void __launch_bounds__(32 * kWSplit) mlstm_w_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const float* __restrict__ ip, Gates g, int S, int hd, int L) {
  __shared__ float red[kWSplit - 1][16][kMaxL + 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int c = blockIdx.y, bh = blockIdx.z, nc = S / L;
  const int r0 = blockIdx.x * 16;
  const long long p0 = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
  const int ra = r0 + gq, rb = ra + 8;
  const int n_tiles = min(r0 + 15, L - 1) / 8 + 1;
  const int n_groups = hd / 32;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  uint4 qa, qb, kt[kMaxL / 8];
  auto load = [&](int grp) {
    const int dc = grp * 32 + 8 * tq;
    const bool in = grp < n_groups;
    qa = in && ra < L ? ldg16(q + (p0 + ra) * hd + dc) : zero;
    qb = in && rb < L ? ldg16(q + (p0 + rb) * hd + dc) : zero;
#pragma unroll
    for (int nt = 0; nt < kMaxL / 8; ++nt) {
      const int b = nt * 8 + gq;
      kt[nt] = in && nt < n_tiles && b < L ? ldg16(k + (p0 + b) * hd + dc) : zero;
    }
  };
  float acc[kMaxL / 8][4] = {};
  load(warp);
  for (int grp = warp; grp < n_groups; grp += kWSplit) {
    const uint32_t a0[4] = {qa.x, qb.x, qa.y, qb.y};
    const uint32_t a1[4] = {qa.z, qb.z, qa.w, qb.w};
    uint4 kc[kMaxL / 8];
#pragma unroll
    for (int nt = 0; nt < kMaxL / 8; ++nt) kc[nt] = kt[nt];
    load(grp + kWSplit);
#pragma unroll
    for (int nt = 0; nt < kMaxL / 8; ++nt) {
      if (nt < n_tiles) {
        mma_bf16(acc[nt], a0, kc[nt].x, kc[nt].y);
        mma_bf16(acc[nt], a1, kc[nt].z, kc[nt].w);
      }
    }
  }
  if (warp > 0) {
#pragma unroll
    for (int nt = 0; nt < kMaxL / 8; ++nt) {
      if (nt < n_tiles) {
        float* p = &red[warp - 1][gq][nt * 8 + 2 * tq];
        p[0] = acc[nt][0];
        p[1] = acc[nt][1];
        p[8 * (kMaxL + 4)] = acc[nt][2];
        p[8 * (kMaxL + 4) + 1] = acc[nt][3];
      }
    }
  }
  __syncthreads();
  if (warp > 0) return;

  float* wc = g.w + (static_cast<long long>(bh) * nc + c) * L * L;
  const float ca = ra < L ? g.cumf[p0 + ra] : 0.f, ma = ra < L ? g.mrow[p0 + ra] : 0.f;
  const float cb = rb < L ? g.cumf[p0 + rb] : 0.f, mb = rb < L ? g.mrow[p0 + rb] : 0.f;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int nt = 0; nt < kMaxL / 8; ++nt) {
    if (nt < n_tiles) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int b = nt * 8 + 2 * tq + j;
        float sa = acc[nt][j], sb = acc[nt][2 + j];
#pragma unroll
        for (int w = 0; w < kWSplit - 1; ++w) {
          sa += red[w][gq][b];
          sb += red[w][gq + 8][b];
        }
        if (b < L) {
          const float cf = g.cumf[p0 + b], ib = ip[p0 + b];
          float wa = 0.f, wb = 0.f;
          if (b <= ra && ra < L) wa = expf(((ca - cf) + ib) - ma) * sa;
          if (b <= rb && rb < L) wb = expf(((cb - cf) + ib) - mb) * sb;
          if (ra < L) wc[static_cast<long long>(ra) * L + b] = wa;
          if (rb < L) wc[static_cast<long long>(rb) * L + b] = wb;
          rs_a += wa;
          rs_b += wb;
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, o);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, o);
  }
  if (tq == 0) {
    if (ra < L) g.wsum[p0 + ra] = rs_a;
    if (rb < L) g.wsum[p0 + rb] = rs_b;
  }
}

constexpr int kPass = 16;               // rows of y^T per pass over C^T
constexpr int kPartStride = kPass + 4;  // floats a row of a warp's partial y^T
constexpr int kYStride = kMaxL + 4;     // floats a row of the summed y_inter^T

constexpr size_t state_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kWarps) * kCols * kPartStride  // partial y^T
                          + kCols * kYStride                                 // summed y^T
                          + kWarps * kPass + kMaxL                           // q.n
                          + hd + 3 * kMaxL)                                  // n, g, gsrc, wsum
         + sizeof(__nv_bfloat16) * kMaxL * kVStride;                         // v
}

// The A fragment of v^T (16 columns from e_off by the 16 keys of step kb)
// from the staged v [key][e].
__device__ __forceinline__ void load_vt(uint32_t (&va)[4], const __nv_bfloat16* vs, int kb,
                                        int e_off, int lane) {
  ldmatrix_x4_trans(va, vs + (kb * 16 + (lane >> 4) * 8 + (lane & 7)) * kVStride + e_off +
                            ((lane >> 3) & 1) * 8);
}

// Outputs and state for 32 columns e0 .. e0 + 31 of one (b, h).
//   C^T [32, hd] lives in registers: warp w holds both 16-row halves h of
// the d groups w + 16i (i < kGroups), as four 16 x 8 accumulator tiles a
// half and group. Tile t, column n of group base d32 is d = d32 + 8(n / 2) +
// 2t + n % 2, so lane (g, t') holds C^T[e0 + 16h + g (+8)][d32 + 8t' + 2t
// (+1)]: its q and k values of a group are the 8 contiguous ones at d32 +
// 8t', loaded once for both halves, and each split of gsrc·k feeds both.
__global__ void __launch_bounds__(kThreads, 1) mlstm_state_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, Gates g, __nv_bfloat16* __restrict__ y,
    float* __restrict__ c_out, float* __restrict__ n_out, int S, int hd, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);   // [kWarps][kCols][kPartStride]
  float* ye = part + kWarps * kCols * kPartStride;    // [kCols][kYStride]
  float* part_qn = ye + kCols * kYStride;             // [kWarps][kPass]
  float* qn_s = part_qn + kWarps * kPass;             // [kMaxL]
  float* ns = qn_s + kMaxL;                           // [hd]
  float* gi = ns + hd;                                // [kMaxL]
  float* gs = gi + kMaxL;                             // [kMaxL]
  float* ws = gs + kMaxL;                             // [kMaxL]
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(ws + kMaxL);  // [kMaxL][kVStride]

  const int e0 = blockIdx.x * kCols, bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int nc = S / L;
  const int n_groups = hd / 32;
  const int n_busy = min(kWarps, n_groups);  // warps that hold a d group
  const int n_bk = (L + 15) / 16;            // 16-key steps of a chunk
  const int n_pass = (L + kPass - 1) / kPass;
  const int yh = warp / 8, ar = (warp % 8) * 16;  // the warp's half and rows of W v and of y
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < hd; i += kThreads) ns[i] = 0.f;

  float C[kGroups][2][4][4] = {};

  for (int c = 0; c < nc; ++c) {
    const long long p0 = static_cast<long long>(bh) * S + static_cast<long long>(c) * L;
    const float* wc = g.w + (static_cast<long long>(bh) * nc + c) * L * L;
    __syncthreads();  // the last chunk's readers of v, the gates, ye and q.n are done
    for (int i = tid; i < kMaxL * (kCols / 8); i += kThreads) {
      const int b = i / (kCols / 8), h = i % (kCols / 8);
      const uint4 val = b < L ? ldg16(v + (p0 + b) * hd + e0 + 8 * h) : zero;
      *reinterpret_cast<uint4*>(vs + b * kVStride + 8 * h) = val;
    }
    if (tid < kMaxL) {
      gi[tid] = tid < L ? g.ginter[p0 + tid] : 0.f;
      gs[tid] = tid < L ? g.gsrc[p0 + tid] : 0.f;
      ws[tid] = tid < L ? g.wsum[p0 + tid] : 0.f;
    }

    // y_inter^T = C^T q^T and q.n over this warp's d groups, 16 rows a
    // pass; the warps' partials are summed in warp order. C and n are zero
    // in the first chunk.
    for (int pass = 0; c > 0 && pass < n_pass; ++pass) {
      const int a0 = pass * kPass;
      if (warp < n_busy) {
        float P[2][kPass / 8][4] = {};
        float qn[kPass / 8] = {};
        uint4 qv[kPass / 8];
        auto load_q = [&](int i) {
          const int grp = warp + kWarps * i;
#pragma unroll
          for (int nt = 0; nt < kPass / 8; ++nt) {
            const int a = a0 + nt * 8 + gq;
            qv[nt] = grp < n_groups && a < L ? ldg16(q + (p0 + a) * hd + grp * 32 + 8 * tq)
                                             : zero;
          }
        };
        load_q(0);
#pragma unroll
        for (int i = 0; i < kGroups; ++i) {
          uint4 qc[kPass / 8];
#pragma unroll
          for (int nt = 0; nt < kPass / 8; ++nt) qc[nt] = qv[nt];
          if (i + 1 < kGroups) load_q(i + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              const Split s0 = split3(C[i][h][2 * ks][0], C[i][h][2 * ks][1]);
              const Split s1 = split3(C[i][h][2 * ks][2], C[i][h][2 * ks][3]);
              const Split s2 = split3(C[i][h][2 * ks + 1][0], C[i][h][2 * ks + 1][1]);
              const Split s3 = split3(C[i][h][2 * ks + 1][2], C[i][h][2 * ks + 1][3]);
              const uint32_t ahi[4] = {s0.hi, s1.hi, s2.hi, s3.hi};
              const uint32_t amid[4] = {s0.mid, s1.mid, s2.mid, s3.mid};
              const uint32_t alo[4] = {s0.lo, s1.lo, s2.lo, s3.lo};
#pragma unroll
              for (int nt = 0; nt < kPass / 8; ++nt)
                mma_bf16(P[h][nt], alo, ks ? qc[nt].z : qc[nt].x, ks ? qc[nt].w : qc[nt].y);
#pragma unroll
              for (int nt = 0; nt < kPass / 8; ++nt)
                mma_bf16(P[h][nt], amid, ks ? qc[nt].z : qc[nt].x, ks ? qc[nt].w : qc[nt].y);
#pragma unroll
              for (int nt = 0; nt < kPass / 8; ++nt)
                mma_bf16(P[h][nt], ahi, ks ? qc[nt].z : qc[nt].x, ks ? qc[nt].w : qc[nt].y);
            }
          }
          const int grp = warp + kWarps * i;
          if (grp < n_groups) {
            const int dc = grp * 32 + 8 * tq;
            const float4 n0 = *reinterpret_cast<const float4*>(ns + dc);
            const float4 n1 = *reinterpret_cast<const float4*>(ns + dc + 4);
#pragma unroll
            for (int nt = 0; nt < kPass / 8; ++nt) {
              const float2 x0 = unpack(qc[nt].x), x1 = unpack(qc[nt].y);
              const float2 x2 = unpack(qc[nt].z), x3 = unpack(qc[nt].w);
              qn[nt] += x0.x * n0.x + x0.y * n0.y + x1.x * n0.z + x1.y * n0.w +
                        x2.x * n1.x + x2.y * n1.y + x3.x * n1.z + x3.y * n1.w;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int nt = 0; nt < kPass / 8; ++nt) {
            float* pr = part + (warp * kCols + 16 * h + gq) * kPartStride + nt * 8 + 2 * tq;
            *reinterpret_cast<float2*>(pr) = make_float2(P[h][nt][0], P[h][nt][1]);
            *reinterpret_cast<float2*>(pr + 8 * kPartStride) =
                make_float2(P[h][nt][2], P[h][nt][3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kPass / 8; ++nt) {
          float t = qn[nt];
          t += __shfl_xor_sync(0xffffffffu, t, 1);
          t += __shfl_xor_sync(0xffffffffu, t, 2);
          if (tq == 0) part_qn[warp * kPass + nt * 8 + gq] = t;
        }
      }
      __syncthreads();  // every partial of the pass is written
      for (int x = tid; x < kCols * kPass; x += kThreads) {
        const int e = x / kPass, a = x % kPass;
        const float* pr = part + e * kPartStride + a;
        float t = pr[0];
        for (int w = 1; w < n_busy; ++w) t += pr[w * kCols * kPartStride];
        ye[e * kYStride + a0 + a] = t;
      }
      if (tid < kPass) {
        float t = part_qn[tid];
        for (int w = 1; w < n_busy; ++w) t += part_qn[w * kPass + tid];
        qn_s[a0 + tid] = t;
      }
      __syncthreads();  // the partials may be written again
    }

    // y_intra^T = v^T W^T for this warp's 16 rows and 16 columns: keys b <= a.
    __syncthreads();  // v and the gates are staged
    float YI[2][4] = {};
    if (ar < L) {
      for (int kb = 0; kb <= ar / 16 && kb < n_bk; ++kb) {
        uint32_t va[4];
        load_vt(va, vs, kb, 16 * yh, lane);
        const int b = kb * 16 + 2 * tq;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int a = ar + nt * 8 + gq;
          const float* wr = wc + static_cast<long long>(a) * L;
          const bool in = a < L;
          const float w0 = in && b <= a ? wr[b] : 0.f;
          const float w1 = in && b + 1 <= a ? wr[b + 1] : 0.f;
          const float w8 = in && b + 8 <= a ? wr[b + 8] : 0.f;
          const float w9 = in && b + 9 <= a ? wr[b + 9] : 0.f;
          mma_split_b(YI[nt], va, split3(w0, w1), split3(w8, w9));
        }
      }
    }

    // C^T <- gdec C^T + v^T (gsrc k) and n <- gdec n + (gsrc k)^T 1 for this
    // warp's d groups: C^T is scaled first and the products accumulate into
    // it. The next key step's k rows are in flight during this one's.
    if (warp < n_busy) {
      const float gdec = g.gdec[static_cast<long long>(bh) * nc + c];
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int grp = warp + kWarps * i;
        if (grp < n_groups) {
          const int d32 = grp * 32;
          const __nv_bfloat16* kg = k + p0 * hd + d32 + 8 * tq;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
              for (int r = 0; r < 4; ++r) C[i][h][t][r] *= gdec;
          float nsum[4] = {};
          uint4 klo = gq < L ? ldg16(kg + static_cast<long long>(gq) * hd) : zero;
          uint4 khi = gq + 8 < L ? ldg16(kg + static_cast<long long>(gq + 8) * hd) : zero;
          for (int kb = 0; kb < n_bk; ++kb) {
            const int b_next = (kb + 1) * 16 + gq;
            const uint4 nlo = b_next < L ? ldg16(kg + static_cast<long long>(b_next) * hd) : zero;
            const uint4 nhi =
                b_next + 8 < L ? ldg16(kg + static_cast<long long>(b_next + 8) * hd) : zero;
            uint32_t va[2][4];
            load_vt(va[0], vs, kb, 0, lane);
            load_vt(va[1], vs, kb, 16, lane);
            const int bb = kb * 16 + 2 * tq;
            const float2 g01 = *reinterpret_cast<const float2*>(gs + bb);
            const float2 g89 = *reinterpret_cast<const float2*>(gs + bb + 8);
            const uint32_t wlo[4] = {klo.x, klo.y, klo.z, klo.w};
            const uint32_t whi[4] = {khi.x, khi.y, khi.z, khi.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              // lane (g, t'): k rows bb, bb + 1 (and + 8) at d = d32 + 8(g/2) + 2t + g%2
              const float2 x01 = unpack(movmatrix_trans(wlo[t]));
              const float2 x89 = unpack(movmatrix_trans(whi[t]));
              const float k0 = x01.x * g01.x, k1 = x01.y * g01.y;
              const float k8 = x89.x * g89.x, k9 = x89.y * g89.y;
              nsum[t] += (k0 + k1) + (k8 + k9);
              const Split b0 = split3(k0, k1), b1 = split3(k8, k9);
              mma_bf16(C[i][0][t], va[0], b0.lo, b1.lo);
              mma_bf16(C[i][1][t], va[1], b0.lo, b1.lo);
              mma_bf16(C[i][0][t], va[0], b0.mid, b1.mid);
              mma_bf16(C[i][1][t], va[1], b0.mid, b1.mid);
              mma_bf16(C[i][0][t], va[0], b0.hi, b1.hi);
              mma_bf16(C[i][1][t], va[1], b0.hi, b1.hi);
            }
            klo = nlo;
            khi = nhi;
          }
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float t2 = nsum[t];
            t2 += __shfl_xor_sync(0xffffffffu, t2, 1);
            t2 += __shfl_xor_sync(0xffffffffu, t2, 2);
            const int d = d32 + 8 * (gq >> 1) + 2 * t + (gq & 1);
            if (tq == 0) ns[d] = ns[d] * gdec + t2;
          }
        }
      }
    }

    // y = (W v + g q C) / max(|W 1 + g q.n|, 1) for this warp's rows and half.
    if (ar < L) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int a = ar + nt * 8 + 2 * tq + j;
          if (a < L) {
            const float ye0 = c > 0 ? ye[(16 * yh + gq) * kYStride + a] : 0.f;
            const float ye1 = c > 0 ? ye[(16 * yh + gq + 8) * kYStride + a] : 0.f;
            const float qn = c > 0 ? qn_s[a] : 0.f;
            const float scale = fmaxf(fabsf(ws[a] + gi[a] * qn), 1.f);
            __nv_bfloat16* yr = y + (p0 + a) * hd + e0 + 16 * yh;
            yr[gq] = __float2bfloat16((YI[nt][j] + gi[a] * ye0) / scale);
            yr[gq + 8] = __float2bfloat16((YI[nt][2 + j] + gi[a] * ye1) / scale);
          }
        }
      }
    }
  }

  __syncthreads();
  if (warp < n_busy) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int grp = warp + kWarps * i;
      if (grp < n_groups) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const long long d = grp * 32 + 8 * tq + 2 * t;
            float* row0 = c_out + (static_cast<long long>(bh) * hd + d) * hd + e0 + 16 * h;
            float* row1 = row0 + hd;
            row0[gq] = C[i][h][t][0];
            row1[gq] = C[i][h][t][1];
            row0[gq + 8] = C[i][h][t][2];
            row1[gq + 8] = C[i][h][t][3];
          }
        }
      }
    }
  }
  if (blockIdx.x == 0)
    for (int d = tid; d < hd; d += kThreads) n_out[static_cast<long long>(bh) * hd + d] = ns[d];
}

int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const float* ip, Gates g, __nv_bfloat16* y, float* c_out, float* n_out, int bh,
           int s, int hd, int l, cudaStream_t stream) {
  const int nc = s / l;
  mlstm_w_mma_kernel<<<dim3((l + 15) / 16, nc, bh), 32 * kWSplit, 0, stream>>>(q, k, ip, g, s,
                                                                              hd, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static size_t opted[kMaxDevices] = {};
  err = smem_optin_once(mlstm_state_mma_kernel, state_smem_bytes(kMaxHd), opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_state_mma_kernel<<<dim3(hd / kCols, bh), kThreads, state_smem_bytes(hd), stream>>>(
      q, k, v, g, y, c_out, n_out, s, hd, l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

Gates gates_in(float* scratch, int bh, int s, int l) {
  const long long ns = static_cast<long long>(bh) * s;
  Gates g;
  g.cumf = scratch;
  g.mrow = g.cumf + ns;
  g.ginter = g.mrow + ns;
  g.gsrc = g.ginter + ns;
  g.wsum = g.gsrc + ns;
  g.gdec = g.wsum + ns;
  g.w = g.gdec + static_cast<long long>(bh) * (s / l);
  return g;
}

}  // namespace

// Floats of scratch one launch needs (gate terms and W).
extern "C" long long mlstm_chunk_scratch_floats(int bh, int s, int l) {
  const long long nc = s / l;
  return static_cast<long long>(bh) * (5LL * s + nc + nc * l * l);
}

// dtype: 0 float32, 1 bfloat16 (q, k, v and y; hd at most 1024). Returns a
// cudaError_t.
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v, const float* ip,
                                  const float* fp, void* y, float* c_out, float* n_out,
                                  float* m_out, float* scratch, int bh, int s, int hd, int l,
                                  int dtype, cudaStream_t stream) {
  if (bh <= 0 || s <= 0 || l <= 0 || l > kMaxL || s % l != 0 || hd <= 0 || hd % 32 != 0 ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && hd > tc::kMaxHd))
    return static_cast<int>(cudaErrorInvalidValue);
  const Gates g = gates_in(scratch, bh, s, l);
  mlstm_gate_kernel<<<bh, kMaxL, 0, stream>>>(ip, fp, g, m_out, s, l);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0)
    return f32::launch(static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), ip, g, static_cast<float*>(y), c_out,
                       n_out, bh, s, hd, l, stream);
  return tc::launch(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v), ip, g,
                    static_cast<__nv_bfloat16*>(y), c_out, n_out, bh, s, hd, l, stream);
}
