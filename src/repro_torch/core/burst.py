"""Burst energy model E⟨i,j⟩ (paper §4.2), transliterated from the paper's
equations. Used to price the bursts of a partition the sweep kernel chose."""

from __future__ import annotations

import dataclasses
from typing import List

from .cost import CostModel
from .graph import TaskGraph

__all__ = ["BurstDetail", "burst_detail", "burst_cost"]


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
