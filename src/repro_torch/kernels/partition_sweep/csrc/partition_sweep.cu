// Fused CSR column sweep + burst DP for one task graph (paper §4.2-§4.4).
//
// Replaces the Pallas TPU kernel repro/kernels/partition_sweep/kernel.py
// (_sweep_kernel, launched by sweep_columns_call). It computes what that
// kernel computes, not its TPU tiling: the (N, n_tiles) sequential grid with
// VMEM scratch becomes one loop over columns j = 1..N inside one thread-block
// cluster.
//
// Per column j, with the live column col[i] = E<i,j>:
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
// What bounds it on the H100: the chain of N dependent columns — latency,
// not bytes or FLOPs (the roofline bound, 0.04 ms for the head count's
// three modes, ignores the chain). The design cuts the time of one link:
//   - One launch of a thread-block cluster of 1024-thread CTAs: 8 (the
//     portable size), or 16 where one warp walks each lane's i-range (17
//     lanes or more; the size is chosen on the host: kernel.py,
//     sweep_layout). CTA r owns the i-range [r·P + 1, (r+1)·P], P =
//     ceil(N / CTAs): its slice of the column, held in the registers of its
//     last threads (4 consecutive elements an owner), and of every lane's
//     dp row, stored shifted so that the CTA owning i holds dp[q][i-1] in
//     its own shared memory: the DP of a column touches no other CTA, and
//     exact-K lane b reads lane b-1 locally. At N = 5458 and 19 lanes over
//     16 CTAs that is 52 KB of dp and 2.7 KB of column a CTA. Where the dp
//     rows and the pushed entries do not fit in shared memory (large Q
//     grids), they live in device memory, each CTA's in its own region: a
//     layout the host chooses, not a fallback.
//   - Each CTA applies every read slot of task j to its own slice only.
//   - Each of the (at most 4) warps that share a lane forms the lexicographic
//     (value, index) minimum of its share of the CTA's i < j with shuffles
//     and pushes it into every CTA's shared memory (distributed shared
//     memory, three columns in flight); one cluster barrier a column. Every
//     CTA then merges a lane from its local entries in one warp, with the
//     diagonal candidate i = j, which each CTA forms from the last column's
//     result: the CTA that owns i = j + 1 keeps dp[q][j], so column j + 1's
//     entries can be formed before column j is merged.
//   - The columns are software-pipelined: between its arrival at column j's
//     barrier and the wait on it, a CTA merges column j - 1 and updates its
//     slice to column j + 1. Only the owners' and the merging warps (the
//     last ones) walk the slots, behind a named barrier of their own, so
//     the warps that form the entries never wait on an update.
//   - e_task, store_add, read_ptr and the five slot arrays are staged into
//     shared memory with cp.async in windows of 256 columns and 256 slots,
//     double-buffered: the next window is in flight while this one is
//     read, so no dependent load from device memory stays on the column
//     chain. The sort task's 5452 slots cross 22 windows.
// Per column: one CTA barrier and one cluster barrier. What remains
// (PERF.md): the release of the pushed entries at the cluster barrier, and
// the DP's reads of every lane's dp row and of the column from shared
// memory, about 16 bytes per (i, lane) each column.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;            // column elements an owner thread holds
constexpr int kMaxSlice = kPer * kThreads;
constexpr int kMaxCluster = 16;
constexpr int kMaxG = 4;           // most warps that share one lane's i-range
constexpr int kSlots = 3;          // columns of pushed entries in flight
constexpr int kColWin = 256;       // columns a staged window
constexpr int kSlotWin = 256;      // read slots a staged window
constexpr int kMaxDevices = 64;

// Shared memory of one CTA: the staging windows and the column slice; in
// the shared layout also the dp slice [nq][slice] and the entries pushed to
// it [2][cluster][nq·G]. Must agree with kernel.py, sweep_smem_bytes.
__host__ __device__ constexpr long long stage_bytes() {
  return 2LL * kColWin * 8 * 2          // e_task, store_add
         + 2LL * kSlotWin * 8 * 2       // slot_cost, slot_free
         + 2LL * (kColWin + 1) * 4      // read_ptr
         + 2LL * kSlotWin * 4 * 3;      // slot_lt, slot_writer, slot_linf
}
// Warps that share one lane's i-range; each pushes one entry a column.
__host__ __device__ constexpr int lane_warps(int nq) {
  return nq >= kWarps ? 1 : (kWarps / nq < kMaxG ? kWarps / nq : kMaxG);
}
__host__ __device__ constexpr long long smem_bytes(int slice, int nq, int cluster,
                                                   bool dp_in_smem) {
  return stage_bytes() + 8LL * slice +
         (dp_in_smem ? 8LL * nq * (slice + 2) + 12LL * kSlots * cluster * nq * lane_warps(nq)
                     : 0);
}

__device__ __forceinline__ bool lex_less(double v, int i, double bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Inputs {
  const int* read_ptr;       // (n+1,)
  const double* e_task;      // (n,)
  const double* store_add;   // (n,)
  double e_startup;
  const double* slot_cost;   // (nnz,) E_r per read slot
  const double* slot_free;   // (nnz,) E_w of the read packet
  const int* slot_lt;        // (nnz,)
  const int* slot_writer;    // (nnz,)
  const int* slot_linf;      // (nnz,)
  const double* budget;      // (nq,) tolerance-scaled
  double* mns;               // (n, nq) out
  int* bests;                // (n, nq) out
  double* dp;                // device layout: (cluster, nq·(slice + 2)); else unused
  double* part_v;            // device layout: (cluster, 2, nq); else unused
  int* part_i;               // device layout: (cluster, 2, nq); else unused
  int n, nq, slice;
};

__device__ __forceinline__ void cluster_arrive() {  // release
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {  // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The lexicographic minimum of the warp's (value, index) pairs, in every lane.
__device__ __forceinline__ void warp_lex_min(double& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (lex_less(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

template <bool EXACT_K, bool COMBINE_MAX, bool DP_SMEM>
__global__ void __launch_bounds__(kThreads, 1) sweep_kernel(const Inputs in) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int n = in.n, nq = in.nq, slice = in.slice;
  const int lo = rank * slice + 1;                 // this CTA's first i
  const int hi = min(lo + slice - 1, n);           // and its last (hi < lo: none)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Lanes over warps: G warps share one lane's i-range (warps past nq·G
  // idle); with nq > kWarps each warp walks whole i-ranges of lanes warp,
  // warp + kWarps, ... Each of the G warps of lane q pushes one entry a
  // column to every CTA: entries [slot][q][sender rank][g], R = csize·G a
  // lane, so a warp merges lane q from R contiguous entries.
  const int G = lane_warps(nq);
  const int R = csize * G;
  const int q_first = warp / G;
  const int q_step = nq <= kWarps ? kWarps / G : kWarps;
  const int g = warp % G;
  const int q_merge = kWarps - 1 - warp;  // the first lane this warp merges
  const double bq_first = q_first < nq ? in.budget[q_first] : 0.0;
  const double bq_merge = q_merge < nq ? in.budget[q_merge] : 0.0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* et_s = reinterpret_cast<double*>(smem_raw);   // [2][kColWin]
  double* sa_s = et_s + 2 * kColWin;                    // [2][kColWin]
  double* sc_s = sa_s + 2 * kColWin;                    // [2][kSlotWin]
  double* sf_s = sc_s + 2 * kSlotWin;                   // [2][kSlotWin]
  double* col_s = sf_s + 2 * kSlotWin;                  // [slice]
  double* dp_sm = col_s + slice;                        // [nq][slice], [2][nq] (shared layout)
  double* pv_sm = dp_sm + (DP_SMEM ? nq * (slice + 2) : 0);  // [kSlots][nq][R] (shared layout)
  int* rp_s = reinterpret_cast<int*>(pv_sm + (DP_SMEM ? kSlots * nq * R : 0));  // [2][kColWin + 1]
  int* sl_s = rp_s + 2 * (kColWin + 1);                 // [2][kSlotWin]
  int* sw_s = sl_s + 2 * kSlotWin;                      // [2][kSlotWin]
  int* sn_s = sw_s + 2 * kSlotWin;                      // [2][kSlotWin]
  int* pi_sm = sn_s + 2 * kSlotWin;                     // [kSlots][nq][R] (shared layout)

  // This CTA's dp slice, dp_at(q, p) = dp[q][lo + p - 1], then dp[q][j] of
  // the last two columns (dpl), and the entries the CTAs push to it.
  const long long box = static_cast<long long>(kSlots) * nq * R;
  double* dp = DP_SMEM ? dp_sm : in.dp + static_cast<long long>(rank) * nq * (slice + 2);
  double* dpl = dp + static_cast<long long>(nq) * slice;
  double* pv = DP_SMEM ? pv_sm : in.part_v + rank * box;
  int* pi = DP_SMEM ? pi_sm : in.part_i + rank * box;

  // The column's elements live in the registers of the last threads, kPer
  // consecutive ones a thread (col[own + m]).
  const int own = lo + (kThreads - 1 - tid) * kPer;
  // The update group: the owners' warps and the merging warps (the last
  // ones). Only they walk the slots and stage the windows, behind a named
  // barrier of their own, so a warp that only forms partials never waits
  // on an update.
  const int first_owner = kThreads - (slice + kPer - 1) / kPer;
  const int u_lo = min(first_owner / 32, kWarps - min(nq, kWarps));
  const bool in_update = warp >= u_lo;
  const int n_up = (kWarps - u_lo) * 32, utid = tid - u_lo * 32;
  const int slot_end = in.read_ptr[n];
  auto issue_cols = [&](int w) {   // columns w·kColWin + 1 .. (w+1)·kColWin
    const int base = w * kColWin, buf = w & 1;
    for (int x = utid; x <= kColWin; x += n_up) {
      if (x < kColWin && base + x < n) {
        cp_async8(et_s + buf * kColWin + x, in.e_task + base + x);
        cp_async8(sa_s + buf * kColWin + x, in.store_add + base + x);
      }
      if (base + x <= n) cp_async4(rp_s + buf * (kColWin + 1) + x, in.read_ptr + base + x);
    }
    cp_async_commit();
  };
  auto issue_slots = [&](int w) {  // read slots w·kSlotWin .. (w+1)·kSlotWin - 1
    const int base = w * kSlotWin, buf = w & 1;
    for (int x = utid; x < kSlotWin; x += n_up) {
      const int k = base + x;
      if (k < slot_end) {
        cp_async8(sc_s + buf * kSlotWin + x, in.slot_cost + k);
        cp_async8(sf_s + buf * kSlotWin + x, in.slot_free + k);
        cp_async4(sl_s + buf * kSlotWin + x, in.slot_lt + k);
        cp_async4(sw_s + buf * kSlotWin + x, in.slot_writer + k);
        cp_async4(sn_s + buf * kSlotWin + x, in.slot_linf + k);
      }
    }
    cp_async_commit();
  };

  int col_win = 0;
  int slot_win = in.read_ptr[0] / kSlotWin;
  double v[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) v[m] = 0.0;

  auto update_group_sync = [&]() {
    asm volatile("bar.sync 1, %0;\n" ::"r"(n_up) : "memory");
  };

  // Column j's update of this thread's elements (i < j) and its diagonal
  // col[j], from the staged windows; every thread walks the same slots.
  auto update = [&](int j) -> double {
    const int w = (j - 1) / kColWin;
    if (w != col_win) {  // into the next window, staged one window ago
      cp_async_wait_all();
      update_group_sync();
      issue_cols(w + 1);
      col_win = w;
    }
    const int x = (j - 1) - w * kColWin, cb = w & 1;
    const double e_j = et_s[cb * kColWin + x];
    const double s_j = sa_s[cb * kColWin + x];
    const int k0 = rp_s[cb * (kColWin + 1) + x];
    const int k1 = rp_s[cb * (kColWin + 1) + x + 1];
    const double ext = e_j + s_j;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int i = own + m;
      if (i < j && i <= hi) v[m] += ext;
    }
    double sum_er = 0.0;
    for (int k = k0; k < k1; ++k) {
      const int sw = k / kSlotWin;
      if (sw != slot_win) {  // uniform across the update group
        cp_async_wait_all();
        update_group_sync();
        issue_slots(sw + 1);
        slot_win = sw;
      }
      const int y = (sw & 1) * kSlotWin + (k - sw * kSlotWin);
      const double er = sc_s[y];
      sum_er += er;
      const int lt = sl_s[y];
      const int wr = sw_s[y];
      const bool freed = sn_s[y] == j && wr >= 1;
      const double fr = sf_s[y];
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int i = own + m;
        if (i < j && i <= hi) {
          if (i > lt) v[m] += er;
          if (freed && i <= wr) v[m] -= fr;
        }
      }
    }
    const double diag = ((in.e_startup + sum_er) + e_j) + s_j;
#pragma unroll
    for (int m = 0; m < kPer; ++m)
      if (own + m == j) v[m] = diag;
    return diag;
  };

  // Column jj's result, a warp a lane: the pushed entries (every i < jj)
  // and the diagonal candidate combine(dp[q'][jj-1], col[jj]), which every
  // CTA forms itself. Every CTA keeps dp[q][jj] in dpl; the owner of
  // i = jj + 1 also in its dp slice; CTA q % csize writes the tables.
  auto merge = [&](int jj, double diag) {
    const long long base = static_cast<long long>(jj % kSlots) * nq * R;
    const bool owns_next = jj + 1 <= hi && jj + 1 >= lo;
    const double* last = dpl + ((jj - 1) & 1) * nq;
    for (int q = kWarps - 1 - warp; q < nq; q += kWarps) {
      double bv = CUDART_INF;
      int bi = INT_MAX;
      for (int e = lane; e < R; e += 32) {
        const long long idx = base + static_cast<long long>(q) * R + e;
        const double ov = DP_SMEM ? pv[idx] : __ldcg(pv + idx);
        const int oi = DP_SMEM ? pi[idx] : __ldcg(pi + idx);
        if (lex_less(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      warp_lex_min(bv, bi);
      if (lane == 0) {
        const double mk = diag <= (q == q_merge ? bq_merge : in.budget[q]) ? diag : CUDART_INF;
        const double pr = EXACT_K ? (q == 0 ? CUDART_INF : last[q - 1]) : last[q];
        const double cand = COMBINE_MAX ? fmax(pr, mk) : pr + mk;
        if (lex_less(cand, jj, bv, bi)) {  // i = jj: above every pushed index
          bv = cand;
          bi = jj;
        }
        dpl[(jj & 1) * nq + q] = bv;
        if (owns_next) dp[static_cast<long long>(q) * slice + (jj + 1 - lo)] = bv;
        if (q % csize == rank) {
          in.mns[static_cast<long long>(jj - 1) * nq + q] = bv;
          in.bests[static_cast<long long>(jj - 1) * nq + q] = bi;
        }
      }
    }
  };

  if (in_update) {
    issue_cols(0);
    issue_cols(1);
    issue_slots(slot_win);
    issue_slots(slot_win + 1);
  }
  for (int q = tid; q < nq; q += kThreads) {
    const double d0 = EXACT_K ? (q == 0 ? 0.0 : CUDART_INF) : 0.0;  // dp[q][0]
    dpl[q] = d0;
    if (rank == 0) dp[static_cast<long long>(q) * slice] = d0;
  }
  cp_async_wait_all();
  cluster.sync();  // every CTA of the cluster runs before any pushes to it

  // Software-pipelined over the columns: iteration j forms and pushes
  // column j's entries (i < j, which need dp up to j - 2), merges column
  // j - 1 (its entries arrived at the last barrier) and updates the column
  // to j + 1, all between the arrival at column j's cluster barrier and the
  // wait on it.
  double diag_prev = 0.0;            // col[j - 1]
  double diag_cur = in_update ? update(1) : 0.0;  // col[j]
  for (int j = 1; j <= n; ++j) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int i = own + m;
      if (i < j && i <= hi) col_s[i - lo] = v[m];
    }
    __syncthreads();  // col_s, and dp from merge(j - 2)

    const int p_end = min(hi, j - 1) - lo;  // last p, or negative
    const long long slot = static_cast<long long>(j % kSlots) * nq * R + rank * G + g;
    for (int q = q_first; q < nq; q += q_step) {
      const double bq = q == q_first ? bq_first : in.budget[q];
      const double* prev = EXACT_K ? (q == 0 ? nullptr : dp + static_cast<long long>(q - 1) * slice)
                                   : dp + static_cast<long long>(q) * slice;
      double bv = CUDART_INF;
      int bi = INT_MAX;
      for (int p = g * 32 + lane; p <= p_end; p += G * 32) {
        const double c = col_s[p];
        const double mk = c <= bq ? c : CUDART_INF;
        const double pr = prev != nullptr ? prev[p] : CUDART_INF;
        const double cand = COMBINE_MAX ? fmax(pr, mk) : pr + mk;
        if (lex_less(cand, lo + p, bv, bi)) {
          bv = cand;
          bi = lo + p;
        }
      }
      warp_lex_min(bv, bi);
      if (lane < csize) {
        const long long idx = slot + static_cast<long long>(q) * R;
        if (DP_SMEM) {
          cluster.map_shared_rank(pv, lane)[idx] = bv;
          cluster.map_shared_rank(pi, lane)[idx] = bi;
        } else {
          __stcg(in.part_v + lane * box + idx, bv);
          __stcg(in.part_i + lane * box + idx, bi);
        }
      }
    }
    if (j > 1) merge(j - 1, diag_prev);
    if (!DP_SMEM) __threadfence();
    cluster_arrive();
    diag_prev = diag_cur;
    if (j < n && in_update) diag_cur = update(j + 1);
    cluster_wait();
  }
  merge(n, diag_prev);
}

using Kern = void (*)(Inputs);

template <bool EXACT_K, bool COMBINE_MAX>
Kern pick(bool dp_in_smem) {
  return dp_in_smem ? sweep_kernel<EXACT_K, COMBINE_MAX, true>
                    : sweep_kernel<EXACT_K, COMBINE_MAX, false>;
}

// What was opted in so far, per device and kernel: the largest dynamic
// shared memory, and clusters above the portable size.
struct OptIn {
  size_t smem = 0;
  bool big_cluster = false;
};

template <bool EXACT_K, bool COMBINE_MAX, bool DP_SMEM>
OptIn& opted(int device) {
  static OptIn done[kMaxDevices] = {};
  return done[device];
}

OptIn& opted_for(int device, bool exact_k, bool combine_max, bool dp_in_smem) {
  if (exact_k)
    return combine_max ? (dp_in_smem ? opted<true, true, true>(device)
                                     : opted<true, true, false>(device))
                       : (dp_in_smem ? opted<true, false, true>(device)
                                     : opted<true, false, false>(device));
  return combine_max ? (dp_in_smem ? opted<false, true, true>(device)
                                   : opted<false, true, false>(device))
                     : (dp_in_smem ? opted<false, false, true>(device)
                                   : opted<false, false, false>(device));
}

}  // namespace

extern "C" long long partition_sweep_smem_bytes(int slice, int nq, int cluster, int dp_in_smem) {
  return smem_bytes(slice, nq, cluster, dp_in_smem != 0);
}

// exact_k: lanes are burst counts b = 0..K; combine_max: `max` instead of `+`.
// cluster CTAs, each owning `slice` of the i-range; dp_in_smem 0 puts the dp
// slices and the pushed entries in dp (cluster·nq·(slice + 2) doubles),
// part_v (cluster·kSlots·nq·cluster·G doubles) and part_i (as many ints), G
// the warps that share a lane. Returns a cudaError_t (0 on a clean launch).
extern "C" int partition_sweep_launch(
    const int* read_ptr, const double* e_task, const double* store_add,
    double e_startup, const double* slot_cost, const double* slot_free,
    const int* slot_lt, const int* slot_writer, const int* slot_linf,
    const double* budget, double* mns, int* bests, double* dp, double* part_v, int* part_i,
    int n, int nq, int exact_k, int combine_max, int cluster, int slice, int dp_in_smem,
    void* stream) {
  if (n < 1 || nq < 1 || cluster < 1 || cluster > kMaxCluster || slice < 1 ||
      slice > kMaxSlice || static_cast<long long>(slice) * cluster < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!dp_in_smem && (dp == nullptr || part_v == nullptr || part_i == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Kern kern = exact_k ? (combine_max ? pick<true, true>(dp_in_smem)
                                     : pick<true, false>(dp_in_smem))
                      : (combine_max ? pick<false, true>(dp_in_smem)
                                     : pick<false, false>(dp_in_smem));
  const long long smem = smem_bytes(slice, nq, cluster, dp_in_smem != 0);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  OptIn& done = opted_for(device, exact_k != 0, combine_max != 0, dp_in_smem != 0);
  if (static_cast<size_t>(smem) > done.smem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    done.smem = static_cast<size_t>(smem);
  }
  if (cluster > 8 && !done.big_cluster) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    done.big_cluster = true;
  }
  Inputs in{read_ptr, e_task,  store_add, e_startup, slot_cost, slot_free, slot_lt,
            slot_writer, slot_linf, budget, mns, bests, dp, part_v, part_i, n, nq, slice};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, in);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
