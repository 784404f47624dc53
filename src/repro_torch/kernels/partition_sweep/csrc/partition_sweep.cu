// Fused CSR column sweep + burst DP for one task graph (paper §4.2-§4.4).
//
// Replaces the Pallas TPU kernel repro/kernels/partition_sweep/kernel.py
// (_sweep_kernel, launched by sweep_columns_call). It computes what that
// kernel computes, not its TPU tiling: the (N, n_tiles) sequential grid with
// VMEM scratch becomes one loop over columns j = 1..N inside one CTA.
//
// Per column j, with the live column col[i] = E<i,j> in shared memory:
//   col[i] += (E_task(j) + S(j))                          for i < j
//   per read slot k of task j, in CSR order:
//     col[i] += E_r(k)          where lt(k) < i < j       (new loads)
//     col[i] -= E_w(k)          where linf(k) == j, writer(k) >= 1,
//                               i <= writer(k)            (store freed)
//   col[j] = ((E_s + sum_k E_r(k)) + E_task(j)) + S(j)     (new burst <j,j>)
// then one DP combine per lane q over i = 1..j:
//   cand = combine(prev[q][i-1], col[i] <= budget[q] ? col[i] : inf)
//   sum / exact-K sum: combine = +; minimax / exact-K max: combine = max;
//   exact-K lane b reads prev = dp[b-1] (lane 0: +inf); other modes dp[q].
// The lane's minimum and its first (smallest i) argmin go to mns/bests.
//
// Bit parity: every element of the column is owned by one thread, which
// applies its additions in slot order, exactly as the numpy oracle
// (repro/kernels/partition_sweep/ref.py::_iter_columns) does. The kernel has
// no products (slot costs and budgets are priced on the host), and the file
// is compiled with -fmad=false all the same. The argmin is a lexicographic
// (value, index) minimum, so ties keep the smallest i whatever the order of
// the reduction — numpy's first-minimum.
//
// What bounds it on the H100: the chain of N dependent columns, each ending
// in block barriers, in a single CTA — latency, not bytes or FLOPs. Lanes
// are spread over warps (each warp reduces its slice with shuffles) so a
// column costs two barriers whatever the lane count. The sort task's
// ~5452 read slots each sweep up to N elements serially per thread; that
// and the single CTA are the known costs, left for a later change.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool lex_less(double v, int i, double bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

template <bool EXACT_K, bool COMBINE_MAX>
__global__ void __launch_bounds__(kThreads) sweep_kernel(
    const int* __restrict__ read_ptr,       // (n+1,)
    const double* __restrict__ e_task,      // (n,)
    const double* __restrict__ store_add,   // (n,)
    double e_startup,
    const double* __restrict__ slot_cost,   // (nnz,) E_r per read slot
    const double* __restrict__ slot_free,   // (nnz,) E_w of the read packet
    const int* __restrict__ slot_lt,        // (nnz,)
    const int* __restrict__ slot_writer,    // (nnz,)
    const int* __restrict__ slot_linf,      // (nnz,)
    const double* __restrict__ budget,      // (nq,) tolerance-scaled
    double* __restrict__ mns,               // (n, nq) out
    int* __restrict__ bests,                // (n, nq) out
    double* dp,                             // (nq, n+1) scratch: dp[q][i]
    int n, int nq) {
  extern __shared__ double smem[];
  const int n_part = nq > kWarps ? nq : kWarps;
  double* col = smem;                                  // [n + 1]
  double* part_v = smem + (n + 1);                     // [n_part]
  int* part_i = reinterpret_cast<int*>(part_v + n_part);  // [n_part]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t stride = static_cast<size_t>(n) + 1;

  // Lanes over warps: with nq <= kWarps, G warps share one lane's i-range;
  // otherwise each warp walks whole i-ranges of lanes warp, warp+kWarps, ...
  const int G = nq <= kWarps ? kWarps / nq : 1;
  const int q_first = warp / G;
  const int q_step = nq <= kWarps ? nq : kWarps;
  const int g = warp % G;

  for (int q = tid; q < nq; q += kThreads)
    dp[q * stride] = EXACT_K ? (q == 0 ? 0.0 : CUDART_INF) : 0.0;
  __syncthreads();

  for (int j = 1; j <= n; ++j) {
    const double e_j = e_task[j - 1];
    const double s_j = store_add[j - 1];
    const double ext = e_j + s_j;
    for (int i = 1 + tid; i < j; i += kThreads) col[i] += ext;

    double sum_er = 0.0;
    const int p1 = read_ptr[j];
    for (int k = read_ptr[j - 1]; k < p1; ++k) {
      const double er = slot_cost[k];
      sum_er += er;
      const int lt = slot_lt[k];
      const int w = slot_writer[k];
      const bool freed = slot_linf[k] == j && w >= 1;
      const double fr = slot_free[k];
      for (int i = 1 + tid; i < j; i += kThreads) {
        double v = col[i];
        if (i > lt) v += er;
        if (freed && i <= w) v -= fr;
        col[i] = v;
      }
    }
    if ((j - 1) % kThreads == tid) col[j] = ((e_startup + sum_er) + e_j) + s_j;
    __syncthreads();

    for (int q = q_first; q < nq; q += q_step) {
      const double bq = budget[q];
      const double* prev = EXACT_K ? (q == 0 ? nullptr : dp + (q - 1) * stride)
                                   : dp + q * stride;
      double bv = CUDART_INF;
      int bi = INT_MAX;
      for (int i = 1 + g * 32 + lane; i <= j; i += G * 32) {
        const double c = col[i];
        const double m = c <= bq ? c : CUDART_INF;
        const double p = prev != nullptr ? prev[i - 1] : CUDART_INF;
        const double cand = COMBINE_MAX ? fmax(p, m) : p + m;
        if (lex_less(cand, i, bv, bi)) {
          bv = cand;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (lex_less(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        part_v[q * G + g] = bv;
        part_i[q * G + g] = bi;
      }
    }
    __syncthreads();

    // Combine the G partials of each lane. Nothing below touches col, and
    // the next column's DP reads dp only after its first barrier.
    for (int q = tid; q < nq; q += kThreads) {
      double bv = part_v[q * G];
      int bi = part_i[q * G];
      for (int h = 1; h < G; ++h) {
        if (lex_less(part_v[q * G + h], part_i[q * G + h], bv, bi)) {
          bv = part_v[q * G + h];
          bi = part_i[q * G + h];
        }
      }
      dp[q * stride + j] = bv;
      mns[static_cast<size_t>(j - 1) * nq + q] = bv;
      bests[static_cast<size_t>(j - 1) * nq + q] = bi;
    }
  }
}

}  // namespace

extern "C" long long partition_sweep_smem_bytes(int n, int nq) {
  const long long n_part = nq > kWarps ? nq : kWarps;
  return (static_cast<long long>(n) + 1) * 8 + n_part * (8 + 4);
}

// exact_k: lanes are burst counts b = 0..K; combine_max: `max` instead of `+`.
// Returns a cudaError_t (0 on a clean launch).
extern "C" int partition_sweep_launch(
    const int* read_ptr, const double* e_task, const double* store_add,
    double e_startup, const double* slot_cost, const double* slot_free,
    const int* slot_lt, const int* slot_writer, const int* slot_linf,
    const double* budget, double* mns, int* bests, double* dp, int n, int nq,
    int exact_k, int combine_max, void* stream) {
  if (n < 1 || nq < 1) return static_cast<int>(cudaErrorInvalidValue);
  using Kern = void (*)(const int*, const double*, const double*, double,
                        const double*, const double*, const int*, const int*,
                        const int*, const double*, double*, int*, double*, int,
                        int);
  Kern kern = exact_k ? (combine_max ? sweep_kernel<true, true> : sweep_kernel<true, false>)
                      : (combine_max ? sweep_kernel<false, true> : sweep_kernel<false, false>);
  const long long smem = partition_sweep_smem_bytes(n, nq);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<1, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      read_ptr, e_task, store_add, e_startup, slot_cost, slot_free, slot_lt,
      slot_writer, slot_linf, budget, mns, bests, dp, n, nq);
  return static_cast<int>(cudaGetLastError());
}
