"""Partitions, the budget predicate and the paper's two baselines (§4.3, §6.3).

The non-DP half of ``repro/core/partition.py``: the DP itself runs in the
sweep kernel (:mod:`repro_torch.core.partition_torch`), and this module
prices and validates what it chose.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from .burst import BurstDetail, burst_detail
from .cost import CostModel
from .graph import TaskGraph

__all__ = [
    "BUDGET_REL",
    "BUDGET_ABS",
    "within_budget",
    "Partition",
    "Infeasible",
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


def _partition_from_bounds(
    graph: TaskGraph, cost: CostModel, bounds: Sequence[Tuple[int, int]],
    q_max: Optional[float],
) -> Partition:
    bursts = [burst_detail(graph, cost, i, j) for (i, j) in bounds]
    return Partition(list(bounds), bursts, q_max)


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
