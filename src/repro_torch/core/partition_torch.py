"""The partitioner on the sweep kernel: Q-grid sweeps, Q_min, exact-K.

The counterpart of the Pallas half of ``repro/core/partition_jax.py``
(``_sweep_pallas``, ``_q_min_pallas``, ``_optimal_k_pallas`` as
:func:`sweep`, :func:`q_min`, :func:`exact_k_partition`): the CSR
export goes through :func:`repro_torch.kernels.partition_sweep.ops.sweep_columns`
in the matching mode, and the column tables come back to the host, where the
parent walk and the burst pricing run in numpy float64 as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..kernels.partition_sweep import ops as sweep_ops
from .cost import CostModel
from .graph import GraphCSRArrays, TaskGraph
from .partition import Infeasible, Partition, _partition_from_bounds

__all__ = [
    "TorchSweep",
    "sweep_from_columns",
    "sweep",
    "q_min",
    "exact_k_partition",
]

AnyExport = Union[TaskGraph, GraphCSRArrays]


@dataclasses.dataclass
class TorchSweep:
    """Result of a Q-grid sweep over one graph (the fields of ``JaxSweep``).

    ``dp`` / ``parent`` are the full DP tables ((nq, N+1)); ``starts[q, i]``
    is True iff some burst starts at task ``i`` under Q_max[q];
    ``e_total[q]`` is inf (and ``feasible[q]`` False) where no partition fits.
    """

    n_tasks: int
    q_values: List[Optional[float]]
    dp: np.ndarray
    parent: np.ndarray
    e_total: np.ndarray
    feasible: np.ndarray
    starts: np.ndarray

    def bounds(self, qi: int) -> Optional[List[Tuple[int, int]]]:
        """Reconstructed burst bounds for Q index ``qi`` (None = infeasible)."""
        if not self.feasible[qi]:
            return None
        s = np.flatnonzero(self.starts[qi, 1 : self.n_tasks + 1]) + 1
        ends = [int(e) for e in s[1:] - 1] + [self.n_tasks]
        return list(zip(s.tolist(), ends))

    def to_partitions(
        self, graph: TaskGraph, cost: CostModel
    ) -> List[Optional[Partition]]:
        """Full :class:`Partition` objects (host burst details) per Q value."""
        out: List[Optional[Partition]] = []
        for qi, q in enumerate(self.q_values):
            b = self.bounds(qi)
            if b is None:
                out.append(None)
                continue
            part = _partition_from_bounds(graph, cost, b, q)
            part.validate(graph)
            out.append(part)
        return out


def _as_csr(graph: AnyExport) -> GraphCSRArrays:
    return graph.to_csr_arrays() if isinstance(graph, TaskGraph) else graph


def sweep_from_columns(
    n_tasks: int,
    q_values: Sequence[Optional[float]],
    mns: np.ndarray,
    bests: np.ndarray,
) -> TorchSweep:
    """Assemble a :class:`TorchSweep` from per-column DP tables
    (``mns[j-1, q]`` = dp[q, j], ``bests[j-1, q]`` = start of its last burst)."""
    N, nq = mns.shape
    dp = np.concatenate([np.zeros((nq, 1)), mns.T], axis=1)
    parent = np.zeros((nq, N + 1), dtype=np.int32)
    parent[:, 1:] = bests.T
    e_total = mns[n_tasks - 1].copy() if n_tasks >= 1 else np.zeros(nq)
    feasible = np.isfinite(e_total)
    starts = np.zeros((nq, N + 1), dtype=bool)
    for qi in range(nq):
        if not feasible[qi]:
            continue
        j = n_tasks
        while j > 0:
            i = int(parent[qi, j])
            starts[qi, i] = True
            j = i - 1
    return TorchSweep(
        n_tasks=int(n_tasks),
        q_values=list(q_values),
        dp=dp,
        parent=parent,
        e_total=e_total,
        feasible=feasible,
        starts=starts,
    )


def sweep(
    graph: AnyExport,
    cost: CostModel,
    q_values: Sequence[Optional[float]],
    device="cuda",
) -> TorchSweep:
    """Optimal partitions over a Q_max grid (``None`` = unbounded) in one
    kernel launch."""
    csr = _as_csr(graph)
    if csr.n_tasks == 0:
        nq = len(q_values)
        return TorchSweep(
            n_tasks=0, q_values=list(q_values), dp=np.zeros((nq, 1)),
            parent=np.zeros((nq, 1), dtype=np.int32), e_total=np.zeros(nq),
            feasible=np.ones(nq, dtype=bool), starts=np.zeros((nq, 1), dtype=bool),
        )
    mns, bests = sweep_ops.sweep_columns(csr, cost, q_values, device=device)
    return sweep_from_columns(csr.n_tasks, q_values, mns, bests)


def q_min(graph: AnyExport, cost: CostModel, device="cuda") -> float:
    """§4.4 storage minimization on the kernel's minimax mode: the smallest
    capacity admitting a feasible partition."""
    csr = _as_csr(graph)
    if csr.n_tasks == 0:
        return 0.0
    mns, _ = sweep_ops.sweep_columns(csr, cost, (), objective="minimax", device=device)
    return float(mns[csr.n_tasks - 1, 0])


def exact_k_partition(
    graph: TaskGraph,
    cost: CostModel,
    n_bursts: int,
    q_max: Optional[float] = None,
    objective: str = "sum",
    device="cuda",
) -> Partition:
    """Optimal partition with exactly ``n_bursts`` bursts on the kernel's
    exact-K mode; ``objective="max"`` minimizes the largest burst.

    The counterpart of ``_optimal_k_pallas``. It does not take the name of
    the reference's deprecated ``optimal_partition_k`` entry point, which
    the repository's no-legacy-imports guard forbids reaching by name."""
    if not isinstance(graph, TaskGraph):
        raise TypeError("exact_k needs the TaskGraph to price the reconstructed bursts")
    csr = graph.to_csr_arrays()
    n = csr.n_tasks
    if not 1 <= n_bursts <= max(n, 1):
        raise ValueError(f"n_bursts={n_bursts} out of range for {n} tasks")
    if n == 0:
        return Partition([], [], q_max)
    if objective not in ("sum", "max"):
        raise ValueError(f"objective must be 'sum' or 'max', got {objective!r}")
    vals, bsts = sweep_ops.sweep_columns(
        csr, cost, (q_max,), objective="exact_k", n_bursts=int(n_bursts),
        k_objective=objective, device=device,
    )
    if not np.isfinite(vals[n - 1, n_bursts]):
        raise Infeasible(f"no {n_bursts}-burst partition within Q_max={q_max}")
    bounds: List[Tuple[int, int]] = []
    j, b = n, n_bursts
    while j > 0:
        i = int(bsts[j - 1, b])
        bounds.append((i, j))
        j, b = i - 1, b - 1
    bounds.reverse()
    part = _partition_from_bounds(graph, cost, bounds, q_max)
    part.validate(graph)
    return part
