"""Partitions, the numpy DP, its oracles and the paper's baselines (§4.3-§6.3).

The port's copy of ``repro/core/partition.py``. The DP that the façade's
``numpy`` backend runs (:func:`_optimal_multi` over a Q grid, :func:`q_min`
for §4.4, :func:`_optimal_k` for exactly K bursts) walks the
:class:`~repro_torch.core.burst.ColumnSweep` of a :class:`TaskGraph`;
:func:`dijkstra_partition` (the paper's state-graph search) and
:func:`brute_force_partition` / :func:`q_min_bruteforce` (exhaustive) are
test oracles. The sweep kernel (:mod:`repro_torch.core.partition_torch`)
computes the same tables on the card, and this module prices and validates
what either chose.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .burst import BurstDetail, ColumnSweep, burst_cost, burst_detail
from .cost import CostModel
from .graph import TaskGraph

__all__ = [
    "BUDGET_REL",
    "BUDGET_ABS",
    "within_budget",
    "Partition",
    "Infeasible",
    "dijkstra_partition",
    "brute_force_partition",
    "q_min",
    "q_min_bruteforce",
    "single_task_partition",
    "whole_app_partition",
]


class Infeasible(ValueError):
    """No partition satisfies the Q_max bound (Q_max < Q_min)."""


# Budget tolerance: incremental columns accumulate in a different order than
# the reference burst model, so exactly-at-budget bursts may sit a few ulp
# above Q_max. Every solver path scales budgets with these two constants,
# which the bit-equality with the reference depends on.
BUDGET_REL = 1e-9
BUDGET_ABS = 1e-12


def within_budget(value, q) -> bool:
    """``value`` fits under ``q`` up to the global tolerance."""
    return value <= q * (1 + BUDGET_REL) + BUDGET_ABS


@dataclasses.dataclass
class Partition:
    """A partition of tasks 1..n into contiguous bursts, with full accounting
    (``e_total = e_startup_total + e_read_total + e_write_total + e_app``)."""

    bounds: List[Tuple[int, int]]            # [(i,j)] inclusive, 1-based
    bursts: List[BurstDetail]
    q_max: Optional[float]

    @property
    def n_bursts(self) -> int:
        return len(self.bounds)

    @property
    def e_app(self) -> float:
        return sum(b.e_task for b in self.bursts)

    @property
    def e_total(self) -> float:
        return sum(b.total for b in self.bursts)

    @property
    def e_overhead(self) -> float:
        """Everything that is not useful task execution."""
        return self.e_total - self.e_app

    @property
    def max_burst(self) -> float:
        return max((b.total for b in self.bursts), default=0.0)

    @property
    def transfer_bytes(self) -> int:
        return sum(b.read_bytes + b.write_bytes for b in self.bursts)

    def validate(self, graph: TaskGraph) -> None:
        """Structural sanity: contiguous cover of 1..n, budget respected."""
        expect = 1
        for (i, j) in self.bounds:
            if i != expect or j < i:
                raise AssertionError(f"non-contiguous partition at ⟨{i},{j}⟩")
            expect = j + 1
        if expect != graph.n_tasks + 1:
            raise AssertionError("partition does not cover all tasks")
        if self.q_max is not None:
            for b in self.bursts:
                if not within_budget(b.total, self.q_max):
                    raise AssertionError(
                        f"burst ⟨{b.i},{b.j}⟩ cost {b.total} exceeds Q_max {self.q_max}"
                    )

    def summary(self) -> str:
        """One line, ``repro``'s ``Partition.summary`` byte for byte."""
        return (
            f"bursts={self.n_bursts}  E_total={self.e_total:.6g}  "
            f"E_app={self.e_app:.6g}  overhead={self.e_overhead:.6g} "
            f"({100 * self.e_overhead / max(self.e_total, 1e-300):.3f}%)  "
            f"max_burst={self.max_burst:.6g}  bytes={self.transfer_bytes}"
        )


def _partition_from_bounds(
    graph: TaskGraph, cost: CostModel, bounds: Sequence[Tuple[int, int]],
    q_max: Optional[float],
) -> Partition:
    bursts = [burst_detail(graph, cost, i, j) for (i, j) in bounds]
    return Partition(list(bounds), bursts, q_max)


def _reconstruct(parent: np.ndarray, n: int) -> List[Tuple[int, int]]:
    bounds: List[Tuple[int, int]] = []
    j = n
    while j > 0:
        i = int(parent[j])
        bounds.append((i, j))
        j = i - 1
    bounds.reverse()
    return bounds


def _optimal_multi(
    graph: TaskGraph, cost: CostModel, q_values: Sequence[Optional[float]]
) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy DP over a Q grid, fused with the column sweep: one pass for
    every Q value (``None`` = unbounded). Returns ``(dp, parent)``, each
    ``(nq, n+1)``: ``dp[q, b]`` the least E_total of tasks 1..b,
    ``parent[q, b]`` the start of its last burst (the first minimum).

    The body of ``repro``'s ``_optimal_multi``; the façade's ``numpy``
    backend turns the tables into a ``TorchSweep``, whose reconstruction
    gives the partitions that function returned."""
    n = graph.n_tasks
    nq = len(q_values)
    qs = np.array(
        [np.inf if q is None else float(q) for q in q_values], dtype=np.float64
    )
    dp = np.full((nq, n + 1), np.inf, dtype=np.float64)
    dp[:, 0] = 0.0
    parent = np.zeros((nq, n + 1), dtype=np.int64)

    for j, col in zip(range(1, n + 1), ColumnSweep(graph, cost)):
        c = col[1 : j + 1]  # c[k] = E⟨k+1, j⟩, k = 0..j-1
        cand = dp[:, 0:j] + c[None, :]
        cand[c[None, :] > qs[:, None] * (1 + BUDGET_REL) + BUDGET_ABS] = np.inf
        best = np.argmin(cand, axis=1)
        dp[:, j] = cand[np.arange(nq), best]
        parent[:, j] = best + 1
    return dp, parent


def _optimal_k(
    graph: TaskGraph, cost: CostModel, n_bursts: int,
    q_max: Optional[float] = None, objective: str = "sum",
) -> Partition:
    """Optimal partition with exactly ``n_bursts`` bursts: DP over (bursts
    used, last task), O(K·n²). ``objective="sum"`` minimizes E_total,
    ``"max"`` the largest burst (the §4.4 minimax with a fixed count)."""
    n = graph.n_tasks
    if not 1 <= n_bursts <= max(n, 1):
        raise ValueError(f"n_bursts={n_bursts} out of range for {n} tasks")
    if n == 0:
        return Partition([], [], q_max)
    q = np.inf if q_max is None else float(q_max)
    combine = (lambda prev, c: prev + c) if objective == "sum" else np.maximum

    dp = np.full((n_bursts + 1, n + 1), np.inf)
    dp[0, 0] = 0.0
    parent = np.zeros((n_bursts + 1, n + 1), dtype=np.int64)
    for j, col in zip(range(1, n + 1), ColumnSweep(graph, cost)):
        c = col[1 : j + 1].copy()          # c[k] = E⟨k+1, j⟩
        c[c > q * (1 + BUDGET_REL) + BUDGET_ABS] = np.inf
        for b in range(1, n_bursts + 1):
            cand = combine(dp[b - 1, 0:j], c)
            best = int(np.argmin(cand))
            dp[b, j] = cand[best]
            parent[b, j] = best + 1
    if not np.isfinite(dp[n_bursts, n]):
        raise Infeasible(f"no {n_bursts}-burst partition within Q_max={q_max}")
    bounds: List[Tuple[int, int]] = []
    j, b = n, n_bursts
    while j > 0:
        i = int(parent[b, j])
        bounds.append((i, j))
        j, b = i - 1, b - 1
    bounds.reverse()
    part = _partition_from_bounds(graph, cost, bounds, q_max)
    part.validate(graph)
    return part


# ---------------------------------------------------------------------------
# Paper-faithful path: explicit state graph + Dijkstra (§4.3)
# ---------------------------------------------------------------------------


def dijkstra_partition(
    graph: TaskGraph, cost: CostModel, q_max: Optional[float] = None,
    prune: bool = True,
) -> Partition:
    """Dijkstra over the explicit state graph s_0..s_n.

    Implements the paper's pruning note: burst evaluation for a fixed start
    ``i`` stops as soon as the *execution-only* lower bound
    ``E_s + Σ E_task`` exceeds Q_max, since adding tasks never decreases it.
    O(n²) edges; intended for fidelity and tests (the fused DP above and
    the sweep kernel are the production paths).
    """
    n = graph.n_tasks
    q = np.inf if q_max is None else float(q_max)
    # Edge costs from the reference burst model, with pruning.
    edges: List[List[Tuple[int, float]]] = [[] for _ in range(n + 1)]  # from s_{i-1}
    for i in range(1, n + 1):
        lower = cost.e_startup
        for j in range(i, n + 1):
            lower += graph.task(j).cost
            if prune and not within_budget(lower, q):
                break
            e = burst_cost(graph, cost, i, j)
            if within_budget(e, q):
                edges[i - 1].append((j, e))
    dist = np.full(n + 1, np.inf)
    parent = np.zeros(n + 1, dtype=np.int64)
    dist[0] = 0.0
    pq: List[Tuple[float, int]] = [(0.0, 0)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        if u == n:
            break
        for (v, w) in edges[u]:
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                parent[v] = u + 1  # burst starts at task u+1
                heapq.heappush(pq, (nd, v))
    if not np.isfinite(dist[n]):
        raise Infeasible(f"Q_max={q_max} admits no partition")
    bounds = _reconstruct(parent, n)
    part = _partition_from_bounds(graph, cost, bounds, q_max)
    part.validate(graph)
    return part


def brute_force_partition(
    graph: TaskGraph, cost: CostModel, q_max: Optional[float] = None
) -> Partition:
    """Exhaustive search over all 2^(n-1) partitions (test oracle; n ≤ 20)."""
    n = graph.n_tasks
    if n > 20:
        raise ValueError("brute force limited to n ≤ 20")
    q = np.inf if q_max is None else float(q_max)
    best: Optional[Partition] = None
    for mask in range(1 << max(n - 1, 0)):
        bounds = []
        start = 1
        for b in range(1, n):
            if mask & (1 << (b - 1)):
                bounds.append((start, b))
                start = b + 1
        bounds.append((start, n))
        part = _partition_from_bounds(graph, cost, bounds, q_max)
        if not within_budget(part.max_burst, q):
            continue
        if best is None or part.e_total < best.e_total:
            best = part
    if best is None:
        raise Infeasible(f"Q_max={q_max} admits no partition")
    return best


# ---------------------------------------------------------------------------
# Storage minimization (§4.4): minimax / bottleneck path
# ---------------------------------------------------------------------------


def q_min(graph: TaskGraph, cost: CostModel) -> float:
    """Smallest storage capacity admitting a feasible partition."""
    n = graph.n_tasks
    if n == 0:
        return 0.0
    mm = np.full(n + 1, np.inf)
    mm[0] = 0.0
    for j, col in zip(range(1, n + 1), ColumnSweep(graph, cost)):
        c = col[1 : j + 1]
        mm[j] = np.minimum(np.maximum(mm[0:j], c), np.inf).min()
    return float(mm[n])


def q_min_bruteforce(graph: TaskGraph, cost: CostModel) -> float:
    n = graph.n_tasks
    best = np.inf
    for mask in range(1 << max(n - 1, 0)):
        bounds = []
        start = 1
        for b in range(1, n):
            if mask & (1 << (b - 1)):
                bounds.append((start, b))
                start = b + 1
        bounds.append((start, n))
        worst = max(burst_cost(graph, cost, i, j) for (i, j) in bounds)
        best = min(best, worst)
    return float(best)


def single_task_partition(
    graph: TaskGraph, cost: CostModel, naive_state_retention: bool = True
) -> Partition:
    """Paper baseline: one task per burst. With ``naive_state_retention``
    (the paper's *Single Task* scheme) every burst restores and saves the
    whole application data region in one coalesced DMA each way."""
    bounds = [(i, i) for i in range(1, graph.n_tasks + 1)]
    bursts = [burst_detail(graph, cost, i, i) for (i, _) in bounds]
    if naive_state_retention:
        all_bytes = graph.total_packet_bytes()
        for b in bursts:
            b.e_read = cost.read.bytes_cost(all_bytes)
            b.e_write = cost.write.bytes_cost(all_bytes)
            b.read_bytes = all_bytes
            b.write_bytes = all_bytes
            b.loads = ["<all application data>"]
            b.stores = ["<all application data>"]
    return Partition(bounds, bursts, None)


def whole_app_partition(graph: TaskGraph, cost: CostModel) -> Partition:
    """Paper baseline: the entire application as one atomic burst."""
    return _partition_from_bounds(graph, cost, [(1, graph.n_tasks)], None)
