"""The partitioner's two engines: Q-grid sweeps, Q_min, exact-K.

The counterpart of ``repro/core/partition_jax.py``, both halves:

* **The sweep kernel** (the reference's Pallas half: ``_sweep_pallas``,
  ``_q_min_pallas``, ``_optimal_k_pallas`` as :func:`sweep`, :func:`q_min`,
  :func:`exact_k_partition`). The CSR export goes through
  :func:`repro_torch.kernels.partition_sweep.ops.sweep_columns` in the
  matching mode.
* **The dense sweep** (the reference's ``lax.scan`` half: ``_dp_sweep``,
  ``_qmin_sweep``, ``_exactk_sweep``, ``_sweep_jax_batched`` as
  :func:`sweep_dense`, :func:`q_min_dense`, :func:`exact_k_partition_dense`).
  Plain PyTorch float64 on the dense :class:`GraphArrays` export, a host
  loop over the columns, each column's update and DP combine vectorized
  over graphs × lanes; a batch of graphs pads to a common shape and solves
  in one pass. Up to ``_UNROLL_MAX`` read slots the column update applies
  the slots one by one in :class:`~repro_torch.core.burst.ColumnSweep`'s
  order, each add or subtract its own elementwise op, so the tables are
  bitwise equal to the numpy oracles; wider readers take one masked
  reduction, equal to ~ulp as in the reference.

In both, the column tables come back to the host, where the parent walk and
the burst pricing run in numpy float64 as in the reference.

**Q-grid sharding** (the reference's ``shard_q_grid`` and
``_sweep_jax_sharded``): :func:`sweep_sharded` splits the Q grid into
contiguous chunks (:func:`shard_q_grid`) and solves each on its own device,
or one after another on one device when there are fewer devices than
chunks. Each Q lane's DP reads only its own lane, so the gathered tables are
bitwise equal to the unsharded solve on either engine.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from ..device import resolve_device
from ..kernels.partition_sweep import ops as sweep_ops
from .cost import CostModel, cost_scalars
from .graph import GraphArrays, GraphCSRArrays, TaskGraph, stack_graph_arrays
from .partition import Infeasible, Partition, _partition_from_bounds

__all__ = [
    "TorchSweep",
    "sweep_from_columns",
    "sweep",
    "q_min",
    "exact_k_partition",
    "sweep_dense",
    "q_min_dense",
    "exact_k_partition_dense",
    "shard_q_grid",
    "sweep_sharded",
]

AnyExport = Union[TaskGraph, GraphArrays, GraphCSRArrays]

# Read-slot count above which the dense sweep's column update switches from
# the slot-by-slot loop (ColumnSweep's order, bitwise) to one masked
# reduction (a tree sum: ~ulp).
_UNROLL_MAX = 8


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
    if isinstance(graph, GraphArrays):
        raise TypeError("the sweep kernel consumes GraphCSRArrays; pass the "
                        "TaskGraph or use the dense sweep for a GraphArrays export")
    return graph.to_csr_arrays() if isinstance(graph, TaskGraph) else graph


def _as_arrays(graph: AnyExport) -> GraphArrays:
    if isinstance(graph, GraphCSRArrays):
        raise TypeError("the dense sweep consumes GraphArrays; pass the TaskGraph "
                        "or use the sweep kernel for a GraphCSRArrays export")
    return graph.to_arrays() if isinstance(graph, TaskGraph) else graph


def _empty_sweep(q_values: Sequence[Optional[float]]) -> TorchSweep:
    nq = len(q_values)
    return TorchSweep(
        n_tasks=0, q_values=list(q_values), dp=np.zeros((nq, 1)),
        parent=np.zeros((nq, 1), dtype=np.int32), e_total=np.zeros(nq),
        feasible=np.ones(nq, dtype=bool), starts=np.zeros((nq, 1), dtype=bool),
    )


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
        return _empty_sweep(q_values)
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
    return _k_partition(graph, cost, n_bursts, q_max, vals, bsts)


def _k_partition(graph, cost, n_bursts, q_max, vals, bsts) -> Partition:
    """Walk exact-K tables ``(N, K+1)`` (lane b = dp[b, j]) back into the
    partition, priced on the graph."""
    n = graph.n_tasks
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


# ---------------------------------------------------------------------------
# The dense sweep
# ---------------------------------------------------------------------------


def _sweep_inputs(ga: GraphArrays, cost: CostModel, dev: torch.device) -> dict:
    """A stacked dense export (leading batch axis) priced under ``cost``, on
    ``dev``. Every product and sum is taken here in numpy float64 in the
    oracle's order — slot costs ``c0·w + c1·|p|``, the store term S(j) write
    slot by write slot, E_task(j) + S(j), and the diagonal
    ``((E_s + Σ E_r) + E_task) + S`` read slot by read slot — so no value is
    re-rounded on the device. ``free_to[b, j, r]`` is the writer of a read
    packet whose last use is task j (its store is charged back for bursts
    starting at or before it), else 0."""
    e_s, r_c0, r_c1, w_c0, w_c1 = cost_scalars(cost)
    n_pad, r_pad = ga.n_pad, ga.r_pad
    read_cost = ga.read_valid * (r_c0 * ga.read_c0w + r_c1 * ga.read_bytes)
    read_free = ga.read_valid * (w_c0 * ga.read_c0w + w_c1 * ga.read_bytes)
    write_cost = ga.write_valid * (w_c0 * ga.write_c0w + w_c1 * ga.write_bytes)
    j_col = np.arange(1, n_pad + 1)
    store_add = np.zeros(ga.e_task.shape)
    for w in range(ga.w_pad):
        store_add = np.where(ga.write_linf[..., w] > j_col, store_add + write_cost[..., w],
                             store_add)
    sum_er = np.zeros(ga.e_task.shape)
    for r in range(r_pad):
        sum_er = sum_er + read_cost[..., r]
    diag = ((e_s + sum_er) + ga.e_task) + store_add
    freed = (ga.read_linf == j_col[:, None]) & (ga.read_writer >= 1)
    free_to = np.where(freed, ga.read_writer, 0)

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    return {"extend": t(ga.e_task + store_add), "diag": t(diag),
            "read_cost": t(read_cost), "read_free": t(np.where(freed, read_free, 0.0)),
            "read_lt": t(ga.read_lt, torch.int64), "free_to": t(free_to, torch.int64)}


def _advance_column(col: torch.Tensor, xs: dict, j: int, i_idx: torch.Tensor) -> torch.Tensor:
    """Task j's updates to the live columns ``col`` ``(B, N+1)``: extend
    every burst ⟨i, j-1⟩ with task j (its cost and store, then each read
    slot's load for bursts starting after the packet's last touch and the
    charge-back of a store the burst absorbs), then start ⟨j, j⟩. Entry 0
    is never read."""
    if j > 1:
        col[:, 1:j] += xs["extend"][:, j - 1 : j]
        lt = xs["read_lt"][:, j - 1, :, None]              # (B, R, 1)
        loads = (i_idx > lt) & (i_idx < j)                 # (B, R, N+1)
        frees = i_idx <= xs["free_to"][:, j - 1, :, None]
        er, ef = xs["read_cost"][:, j - 1], xs["read_free"][:, j - 1]
        if er.shape[1] <= _UNROLL_MAX:
            for r in range(er.shape[1]):
                col = torch.where(loads[:, r], col + er[:, r : r + 1], col)
                col = torch.where(frees[:, r], col - ef[:, r : r + 1], col)
        else:
            add = (er[:, :, None] * loads).sum(1)
            sub = (ef[:, :, None] * frees).sum(1)
            col = torch.where(i_idx < j, col + add - sub, col)
    col[:, j] = xs["diag"][:, j - 1]
    return col


def _dense_columns(ga: GraphArrays, cost: CostModel, budget: np.ndarray, dev, *,
                   exact_k: bool, combine_max: bool) -> Tuple[np.ndarray, np.ndarray]:
    """The dense sweep fused with one DP combine over ``L`` budget lanes,
    for a stacked export of B graphs: → numpy (mns, bests), each
    ``(B, N, L)``, with the layout of the sweep kernel's tables
    (``mns[b, j-1, l]`` = dp[l, j]). Lanes are Q values (``"sum"``), one
    unbounded lane with ``max`` (minimax), or burst counts 0..K where lane b
    combines against dp[b-1] (exact-K). The argmin is numpy's first
    minimum."""
    xs = _sweep_inputs(ga, cost, dev)
    B, N = ga.e_task.shape
    L = int(budget.shape[0])
    inf = float("inf")
    i_idx = torch.arange(N + 1, device=dev)
    ar = torch.arange(1, N + 1, device=dev)
    big = torch.tensor(N + 1, device=dev)
    bud = torch.as_tensor(budget, dtype=torch.float64).to(dev)[None, :, None]
    # lane 0 of ``dp`` is an all-inf row: exact-K's lane b reads lane b-1
    # of the table, which is ``dp[:, b]`` here, a view
    dp = torch.full((B, L + 1, N + 1), inf, dtype=torch.float64, device=dev)
    if exact_k:
        dp[:, 1, 0] = 0.0
    else:
        dp[:, 1:, 0] = 0.0
    bests = torch.empty((B, L, N), dtype=torch.int64, device=dev)
    col = torch.zeros((B, N + 1), dtype=torch.float64, device=dev)
    for j in range(1, N + 1):
        col = _advance_column(col, xs, j, i_idx)
        c = col[:, None, 1 : j + 1]                                   # (B, 1, j)
        masked = torch.where(c <= bud, c, inf)                        # (B, L, j)
        prev = dp[:, :L, :j] if exact_k else dp[:, 1:, :j]
        cand = torch.maximum(prev, masked) if combine_max else prev + masked
        m = cand.min(dim=2).values
        bests[:, :, j - 1] = torch.where(cand == m[:, :, None], ar[:j], big).min(dim=2).values
        dp[:, 1:, j] = m
    mns = dp[:, 1:, 1:].transpose(1, 2).cpu().numpy()
    return mns, bests.transpose(1, 2).to(torch.int32).cpu().numpy()


def _stacked(graphs: Sequence[AnyExport]) -> Tuple[List[GraphArrays], GraphArrays]:
    arrays = [_as_arrays(g) for g in graphs]
    return arrays, stack_graph_arrays(arrays)


def _dp_sweep(graphs, cost, q_values, dev) -> List[TorchSweep]:
    """Sum DP over the Q grid for a batch: one padded pass, each graph's
    tables cut back to its own tasks (equal to its own solve)."""
    budget, _, _ = sweep_ops.budget_lanes(q_values, "sum", None, "sum")
    arrays, stacked = _stacked(graphs)
    mns, bests = _dense_columns(stacked, cost, budget, dev, exact_k=False,
                                combine_max=False)
    return [sweep_from_columns(a.n_tasks, q_values, mns[b, : a.n_tasks], bests[b, : a.n_tasks])
            for b, a in enumerate(arrays)]


def _qmin_sweep(graph, cost, dev) -> float:
    """§4.4 storage minimization: the same columns with the minimax combine
    (exact in float64)."""
    budget, _, _ = sweep_ops.budget_lanes((), "minimax", None, "sum")
    a = _as_arrays(graph)
    mns, _ = _dense_columns(stack_graph_arrays([a]), cost, budget, dev, exact_k=False,
                            combine_max=True)
    return float(mns[0, a.n_tasks - 1, 0])


def _exactk_sweep(graph, cost, n_bursts, q_max, objective, dev):
    budget, _, cmax = sweep_ops.budget_lanes((q_max,), "exact_k", n_bursts, objective)
    a = _as_arrays(graph)
    mns, bests = _dense_columns(stack_graph_arrays([a]), cost, budget, dev, exact_k=True,
                                combine_max=cmax)
    return mns[0], bests[0]


def sweep_dense(
    graphs: Sequence[AnyExport],
    cost: CostModel,
    q_values: Sequence[Optional[float]],
    device="cuda",
) -> List[TorchSweep]:
    """Optimal partitions of every graph over a Q_max grid (``None`` =
    unbounded), the graphs padded to one shape and solved in one dense pass
    on ``device`` (the counterpart of ``_sweep_jax_batched``)."""
    dev = resolve_device(device)
    out: List[Optional[TorchSweep]] = [None] * len(graphs)
    nonempty = []
    for k, g in enumerate(graphs):
        if _as_arrays(g).n_tasks == 0:
            out[k] = _empty_sweep(q_values)
        else:
            nonempty.append(k)
    if nonempty:
        solved = _dp_sweep([graphs[k] for k in nonempty], cost, q_values, dev)
        for k, res in zip(nonempty, solved):
            out[k] = res
    return out  # type: ignore[return-value]


def q_min_dense(graph: AnyExport, cost: CostModel, device="cuda") -> float:
    """§4.4 Q_min on the dense sweep (the counterpart of ``_q_min_scan``)."""
    dev = resolve_device(device)
    if _as_arrays(graph).n_tasks == 0:
        return 0.0
    return _qmin_sweep(graph, cost, dev)


def exact_k_partition_dense(
    graph: TaskGraph,
    cost: CostModel,
    n_bursts: int,
    q_max: Optional[float] = None,
    objective: str = "sum",
    device="cuda",
) -> Partition:
    """Exactly ``n_bursts`` bursts on the dense sweep (the counterpart of
    ``_optimal_k_scan``); ``objective="max"`` minimizes the largest burst."""
    dev = resolve_device(device)
    if not isinstance(graph, TaskGraph):
        raise TypeError("exact_k needs the TaskGraph to price the reconstructed bursts")
    n = graph.n_tasks
    if not 1 <= n_bursts <= max(n, 1):
        raise ValueError(f"n_bursts={n_bursts} out of range for {n} tasks")
    if n == 0:
        return Partition([], [], q_max)
    if objective not in ("sum", "max"):
        raise ValueError(f"objective must be 'sum' or 'max', got {objective!r}")
    vals, bsts = _exactk_sweep(graph, cost, int(n_bursts), q_max, objective, dev)
    return _k_partition(graph, cost, n_bursts, q_max, vals, bsts)


# ---------------------------------------------------------------------------
# Q-grid sharding
# ---------------------------------------------------------------------------


def shard_q_grid(n_q: int, n_shards: int) -> List[Tuple[int, int]]:
    """Balanced contiguous ``[start, stop)`` chunks covering ``range(n_q)``.

    The first ``n_q % n_shards`` chunks are one element longer; ``n_shards``
    is clamped so every chunk is non-empty.
    """
    if n_q < 1:
        raise ValueError("shard_q_grid needs at least one Q point")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n_shards = min(n_shards, n_q)
    base, rem = divmod(n_q, n_shards)
    edges = [0]
    for s in range(n_shards):
        edges.append(edges[-1] + base + (1 if s < rem else 0))
    return list(zip(edges[:-1], edges[1:]))


def _merge_sweeps(q_values: Sequence[Optional[float]],
                  chunk_sweeps: Sequence[Sequence[TorchSweep]]) -> List[TorchSweep]:
    """Concatenate per-chunk sweeps (chunk-major) back into full-grid ones."""
    out: List[TorchSweep] = []
    for g in range(len(chunk_sweeps[0])):
        parts = [cs[g] for cs in chunk_sweeps]
        out.append(TorchSweep(
            n_tasks=parts[0].n_tasks,
            q_values=list(q_values),
            **{f: np.concatenate([getattr(p, f) for p in parts], axis=0)
               for f in ("dp", "parent", "e_total", "feasible", "starts")},
        ))
    return out


def sweep_sharded(
    graphs: Sequence[AnyExport],
    cost: CostModel,
    q_values: Sequence[Optional[float]],
    *,
    n_shards: int,
    devices: Optional[Sequence] = None,
    dense: bool = False,
    device="cuda",
) -> List[TorchSweep]:
    """Every graph's sweep over the Q grid, solved in :func:`shard_q_grid`
    chunks: chunk ``s`` on ``devices[s]`` when there are as many devices as
    chunks, else every chunk on ``device``, one after another. ``dense``
    picks the dense sweep (one padded pass per chunk), else the sweep kernel
    (one launch per graph and chunk). Bitwise equal to the unsharded
    solve."""
    if not graphs:
        return []
    chunks = shard_q_grid(len(q_values), n_shards)
    if devices is not None and len(chunks) > 1 and len(devices) >= len(chunks):
        devs = list(devices[: len(chunks)])
    else:
        devs = [device] * len(chunks)
    qs = list(q_values)
    per_chunk = []
    for (lo, hi), dev in zip(chunks, devs):
        if dense:
            per_chunk.append(sweep_dense(graphs, cost, qs[lo:hi], device=dev))
        else:
            per_chunk.append([sweep(g, cost, qs[lo:hi], device=dev) for g in graphs])
    return _merge_sweeps(q_values, per_chunk)
