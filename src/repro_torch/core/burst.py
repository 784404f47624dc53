"""Burst energy model E⟨i,j⟩ (paper §4.2).

:func:`burst_detail` / :func:`burst_cost` transliterate the paper's
equations and price the bursts of a partition the sweep kernel chose;
:class:`ColumnSweep` yields the columns E⟨·,j⟩ incrementally for the numpy
DP (the port's copy of ``repro/core/burst.py``; the sweep kernel replays
the same updates on the CSR export).

The incremental update (1-based, burst = tasks i..j):

    E⟨i,j⟩ = E⟨i,j-1⟩ + E_task(j)
           + Σ E_r(p)   for p ∈ reads(j) with l_j(p) < i          (new loads)
           + Σ E_w(p)   for p ∈ writes(j) with l_∞(p) > j         (new stores)
           - Σ E_w(p)   for p ∈ reads(j) with i ≤ writer(p) < j
                                         and l_∞(p) == j          (store no longer needed)
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np

from .cost import CostModel
from .graph import TaskGraph

__all__ = ["BurstDetail", "burst_detail", "burst_cost", "ColumnSweep"]


@dataclasses.dataclass
class BurstDetail:
    """Full accounting for one burst ⟨i,j⟩."""

    i: int
    j: int
    e_startup: float
    e_read: float
    e_write: float
    e_task: float
    loads: List[str]
    stores: List[str]
    read_bytes: int
    write_bytes: int

    @property
    def total(self) -> float:
        return self.e_startup + self.e_read + self.e_write + self.e_task


def burst_detail(graph: TaskGraph, cost: CostModel, i: int, j: int) -> BurstDetail:
    """E⟨i,j⟩ with a full load/store breakdown (paper §4.2, verbatim)."""
    if not (1 <= i <= j <= graph.n_tasks):
        raise ValueError(f"invalid burst ⟨{i},{j}⟩ for n_t={graph.n_tasks}")
    e_read = e_write = e_task = 0.0
    loads: List[str] = []
    stores: List[str] = []
    rbytes = wbytes = 0
    for k in range(i, j + 1):
        t = graph.task(k)
        lts = graph.read_last_touch[k - 1]
        for name, lt in zip(t.reads, lts):
            if lt < i:  # last use before the burst starts: load from NVM
                p = graph.packets[name]
                e_read += cost.e_r(p)
                rbytes += p.nbytes
                loads.append(name)
        e_task += t.cost
        for name in t.writes:
            if graph.l_inf[name] > j:  # used after the burst: store
                p = graph.packets[name]
                e_write += cost.e_w(p)
                wbytes += p.nbytes
                stores.append(name)
    return BurstDetail(
        i=i, j=j,
        e_startup=cost.e_startup,
        e_read=e_read, e_write=e_write, e_task=e_task,
        loads=loads, stores=stores,
        read_bytes=rbytes, write_bytes=wbytes,
    )


def burst_cost(graph: TaskGraph, cost: CostModel, i: int, j: int) -> float:
    """E⟨i,j⟩ (scalar)."""
    return burst_detail(graph, cost, i, j).total


class ColumnSweep:
    """Iterates j = 1..n_t, yielding the column ``E⟨·,j⟩``.

    After ``col = next(sweep)``, ``col[i]`` equals ``E⟨i,j⟩`` for
    ``1 <= i <= j`` (entries outside that range are undefined). The array
    yielded is a live buffer — callers must not mutate it.
    """

    def __init__(self, graph: TaskGraph, cost: CostModel):
        self.graph = graph
        self.cost = cost
        n = graph.n_tasks
        self._col = np.full(n + 2, np.nan, dtype=np.float64)
        # Precompute per-task constants.
        self._e_task = np.array([t.cost for t in graph.tasks], dtype=np.float64)
        self._store_add = np.zeros(n + 1, dtype=np.float64)  # Σ E_w over writes with l_inf > j
        for j in range(1, n + 1):
            t = graph.task(j)
            self._store_add[j] = sum(
                cost.e_w(graph.packets[w]) for w in t.writes if graph.l_inf[w] > j
            )

    def __iter__(self) -> Iterator[np.ndarray]:
        g, c = self.graph, self.cost
        col = self._col
        for j in range(1, g.n_tasks + 1):
            t = g.task(j)
            e_task_j = self._e_task[j - 1]
            store_j = self._store_add[j]
            lts = g.read_last_touch[j - 1]
            # 1) extend all existing bursts ⟨i, j-1⟩ with task j
            if j > 1:
                col[1:j] += e_task_j + store_j
                sum_er = 0.0
                for name, lt in zip(t.reads, lts):
                    p = g.packets[name]
                    er = c.e_r(p)
                    sum_er += er
                    if lt + 1 < j:  # loads appear for bursts starting after last touch
                        col[lt + 1 : j] += er
                    if g.l_inf[name] == j:
                        w = g.writer(name)
                        if w >= 1:  # store of p is no longer needed when writer in burst
                            col[1 : w + 1] -= c.e_w(p)
            else:
                sum_er = sum(c.e_r(g.packets[name]) for name in t.reads)
            # 2) the new single-task burst ⟨j,j⟩
            col[j] = c.e_startup + sum_er + e_task_j + store_j
            yield col
