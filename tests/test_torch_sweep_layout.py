"""The CUDA sweep's cluster layout, checked on the CPU.

``sweep_layout`` cuts the i-range of a column over the CTAs of one cluster
and picks shared or device memory for the dp slices; the kernel
(``csrc/partition_sweep.cu``) takes that layout as given. These tests show
that every i is owned exactly once and that the layout stays within the
H100's shared-memory and cluster limits, for THERMAL, N 1 and the largest N
the one-CTA kernel before it accepted; that the byte count and constants
agree with the CUDA source; and that a sweep cut the kernel's way (each
warp's entries and the diagonal merged lexicographically, dp stored
shifted) gives the plain version's tables bit for bit.
"""

import random
import re

import numpy as np
import pytest
import torch

from repro_torch.core.apps import headcount as hc
from repro_torch.core.cost import CostModel, LinearTransfer
from repro_torch.core.graph import GraphBuilder
from repro_torch.kernels import _build
from repro_torch.kernels.partition_sweep import kernel as K
from repro_torch.kernels.partition_sweep.ops import budget_lanes, device_slots
from repro_torch.kernels.partition_sweep.ref import sweep_columns_plain

H100_SMEM_OPTIN = 232_448     # bytes one block may opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_PORTABLE_CLUSTER = 8     # CTAs a cluster may hold without the non-portable attribute
H100_MAX_CLUSTER = 16         # and with it
THERMAL_N = 5458


def parent_accepts(n: int, nq: int) -> bool:
    """The one-CTA kernel's rule: the whole column plus one partial per warp
    or lane in shared memory."""
    return (n + 1) * 8 + max(nq, 32) * 12 <= H100_SMEM_OPTIN


def largest_parent_n(nq: int) -> int:
    return (H100_SMEM_OPTIN - max(nq, 32) * 12) // 8 - 1


CASES = [(THERMAL_N, 1), (THERMAL_N, 9), (THERMAL_N, 19), (THERMAL_N, 48), (1, 1), (1, 19),
         (3, 4), (45, 9), (largest_parent_n(1), 1), (largest_parent_n(32), 32),
         (1, (H100_SMEM_OPTIN - 16) // 12)]


@pytest.mark.parametrize("n,nq", CASES)
def test_layout_owns_every_i_once_within_h100_limits(n, nq):
    assert parent_accepts(n, nq)
    lay = K.sweep_layout(n, nq, H100_SMEM_OPTIN)
    owned = np.zeros(n + 2, dtype=np.int64)
    for lo, hi in lay.owned():
        if hi >= lo:
            owned[lo:hi + 1] += 1
            assert hi - lo + 1 <= lay.slice
    assert owned[0] == 0 and owned[n + 1] == 0 and (owned[1:n + 1] == 1).all()
    assert lay.cluster * lay.slice >= n
    # past the portable size only where one warp walks each lane's i-range
    assert lay.cluster <= (H100_MAX_CLUSTER if K.lane_warps(nq) == 1 else H100_PORTABLE_CLUSTER)
    assert lay.slice <= K.MAX_SLICE
    assert lay.smem_bytes == K.sweep_smem_bytes(lay.slice, nq, lay.cluster, lay.dp_in_smem)
    assert lay.smem_bytes <= H100_SMEM_OPTIN
    # the dp slices go to device memory only where they do not fit
    assert lay.dp_in_smem == (K.sweep_smem_bytes(lay.slice, nq, lay.cluster, True)
                              <= H100_SMEM_OPTIN)


def test_thermal_layouts():
    """THERMAL's three modes keep dp in shared memory: minimax and the
    9-lane grid over 8 CTAs, exact-K's 19 lanes over 16 (52 KB of dp a
    CTA); a 96-point Q grid takes the device layout."""
    for nq in (1, 9):
        lay = K.sweep_layout(THERMAL_N, nq, H100_SMEM_OPTIN)
        assert lay.dp_in_smem and (lay.cluster, lay.slice) == (8, 683)
    lay = K.sweep_layout(THERMAL_N, 19, H100_SMEM_OPTIN)
    assert lay.dp_in_smem and (lay.cluster, lay.slice) == (16, 342)
    assert 8 * 19 * (342 + 2) == 52_288
    assert not K.sweep_layout(THERMAL_N, 96, H100_SMEM_OPTIN).dp_in_smem


def test_layout_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="n >= 1"):
        K.sweep_layout(0, 1, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="at most"):
        K.sweep_layout(K.CLUSTER * K.MAX_SLICE + 1, 1, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="at most"):
        K.sweep_layout(K.MAX_CLUSTER * K.MAX_SLICE + 1, 32, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="shared memory"):
        K.sweep_layout(THERMAL_N, 1, 20_000)
    with pytest.raises(ValueError, match="cluster"):
        K.sweep_layout(10, 1, H100_SMEM_OPTIN, cluster=K.MAX_CLUSTER + 1)


def test_layout_constants_match_the_cuda_source():
    text = (_build._PKG / "partition_sweep/csrc/partition_sweep.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
                   .split("/")[0].split("*")[-1].strip())

    assert const("kThreads") == K.THREADS
    assert const("kPer") * K.THREADS == K.MAX_SLICE
    assert const("kColWin") == K.COL_WINDOW and const("kSlotWin") == K.SLOT_WINDOW
    assert const("kMaxCluster") == K.MAX_CLUSTER
    assert const("kMaxG") == K.MAX_LANE_WARPS and const("kSlots") == K.SLOTS
    argtypes, restype = _build._SIGNATURES["partition_sweep_smem_bytes"]
    assert len(argtypes) == 4 and restype is _build.ctypes.c_longlong


def test_sweep_launch_signature():
    """The declared ctypes signature of the sweep's launcher matches its C
    definition: the argument count, a double for the one double scalar."""
    argtypes, restype = _build._SIGNATURES["partition_sweep_launch"]
    text = (_build._PKG / "partition_sweep/csrc/partition_sweep.cu").read_text()
    head = text[text.index('extern "C" int partition_sweep_launch('):]
    params = [p.split() for p in head[head.index("(") + 1:head.index(")")].split(",")]
    assert len(params) == len(argtypes) == 23 and restype is _build.ctypes.c_int
    double_scalar = [p[-2] == "double" and "*" not in "".join(p) for p in params]
    assert [a is _build.ctypes.c_double for a in argtypes] == double_scalar


def cluster_sweep(args, budget, exact_k, combine_max, lay):
    """The sweep cut as the kernel cuts it: CTA r owns i in its slice and
    dp[q][i-1] for those i (shifted); per column j each of the G warps of a
    lane forms the (value, first index) entry of its strided share of the
    CTA's i < j, and the column's result is the lexicographic minimum of
    every CTA's entries and of the diagonal candidate at i = j, formed from
    the previous column's result. numpy float64, slot order per element."""
    (read_ptr, e_task, store_add, e_s, cost, free, lt, wr, linf) = (
        a.numpy() if isinstance(a, torch.Tensor) else a for a in args)
    n, nq = len(e_task), len(budget)
    G, big = K.lane_warps(nq), np.iinfo(np.int32).max
    col = np.zeros(n + 1)
    dp = np.full((nq, n + 1), np.nan)        # dp[q][i-1] held by the owner of i
    dp[:, 0] = 0.0 if not exact_k else np.where(np.arange(nq) == 0, 0.0, np.inf)
    mns = np.empty((n, nq))
    bests = np.empty((n, nq), dtype=np.int32)

    def cand(q, i):
        c = col[i] if col[i] <= budget[q] else np.inf
        p = (dp[q - 1][i - 1] if q > 0 else np.inf) if exact_k else dp[q][i - 1]
        return max(p, c) if combine_max else p + c

    for j in range(1, n + 1):
        ext = e_task[j - 1] + store_add[j - 1]
        col[1:j] += ext
        sum_er = 0.0
        for k in range(read_ptr[j - 1], read_ptr[j]):
            sum_er += cost[k]
            for i in range(1, j):
                if i > lt[k]:
                    col[i] += cost[k]
                if linf[k] == j and wr[k] >= 1 and i <= wr[k]:
                    col[i] -= free[k]
        col[j] = ((e_s + sum_er) + e_task[j - 1]) + store_add[j - 1]
        for q in range(nq):
            entries = []
            for lo, hi in lay.owned():
                for g in range(G):
                    entry = (np.inf, big)
                    for lane in range(32):
                        for p in range(g * 32 + lane, min(hi, j - 1) - lo + 1, G * 32):
                            entry = min(entry, (cand(q, lo + p), lo + p))
                    entries.append(entry)
            mns[j - 1, q], bests[j - 1, q] = min(min(entries), (cand(q, j), j))
        dp[:, j] = mns[j - 1]
    return mns, bests


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("seed", range(4))
def test_cluster_cut_equals_plain_bitwise(seed, cluster):
    rng = random.Random(4000 + seed)
    b = GraphBuilder()
    b.packet("ext", 2 ** rng.randint(3, 9), external=True)
    avail = ["ext"]
    for t in range(rng.randint(9, 30)):
        writes = [f"p{t}"]
        b.packet(f"p{t}", 2 ** rng.randint(3, 9), keep=rng.random() < 0.3)
        b.task(f"t{t}", reads=rng.sample(avail, rng.randint(0, min(3, len(avail)))),
               writes=writes, cost=rng.choice([0.25, 0.5, 1.0]))
        avail.extend(writes)
    g = b.build()
    cost = CostModel(0.25, LinearTransfer(0.25, 2.0 ** -10), LinearTransfer(0.0, 2.0 ** -12))
    csr = g.to_csr_arrays()
    args = device_slots(csr, cost, torch.device("cpu"))
    e_app = g.total_task_cost()
    for q_values, objective, k, kobj in (
            ((None, 0.0, 0.4 * e_app, 1.1 * e_app), "sum", None, "sum"),
            ((), "minimax", None, "sum"),
            ((0.6 * e_app,), "exact_k", max(1, g.n_tasks // 3), "sum"),
            ((0.6 * e_app,), "exact_k", max(1, g.n_tasks // 3), "max")):
        budget, exact_k, cmax = budget_lanes(q_values, objective, k, kobj)
        lay = K.sweep_layout(g.n_tasks, len(budget), H100_SMEM_OPTIN, cluster=cluster)
        assert lay.owned()[1][0] <= g.n_tasks  # the i-range crosses a slice boundary
        got = cluster_sweep(args, budget, exact_k, cmax, lay)
        want = sweep_columns_plain(*args, torch.as_tensor(budget), exact_k=exact_k,
                                   combine_max=cmax)
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())


def test_thermal_graph_slices():
    """THERMAL's read slots straddle the slices: some packet is loaded over
    an i-range that crosses a CTA's boundary."""
    csr = hc.build_graph(hc.THERMAL).to_csr_arrays()
    lay = K.sweep_layout(csr.n_tasks, 19, H100_SMEM_OPTIN)
    ptr = csr.read_ptr.astype(np.int64)
    task = np.repeat(np.arange(1, csr.n_tasks + 1), np.diff(ptr))
    first_slice = (csr.read_lt + 1 - 1) // lay.slice   # slice of i = lt + 1
    last_slice = (task - 1 - 1) // lay.slice           # slice of i = j - 1
    assert ((last_slice > first_slice) & (task - 1 > csr.read_lt)).any()
