"""Swarm placement: bandwidth-aware multi-node partitioning.

The port's copy of ``repro/core/placement.py``, in numpy and the stdlib.
The paper partitions one batteryless node's *timeline* into energy-bounded
bursts. This module opens the same method to sensor swarms — NS-Optimizer
style relay chains of cooperating harvesting nodes (batteryless cameras)
that split one :class:`~repro_torch.core.graph.TaskGraph` *across* devices:

* a placement assigns tasks ``1..n`` to an ordered chain of nodes as
  ``k ≤ N`` contiguous, non-empty spans (trailing nodes stay dark);
* each node's span is itself burst-partitioned under that node's energy
  budget ``q_max`` and cost model — the paper's DP, run per node;
* crossing a span boundary ships the boundary's *live set* (exactly the
  packets an NVM commit would persist there) over a :class:`LinkModel`:
  bandwidth in mbps → per-byte transfer energy + per-hop latency, TX
  charged to the sender and RX to the receiver;
* a node's NVM must hold every packet whose live interval intersects its
  span — including pass-through packets it only relays — bounded by the
  node's ``memory_bytes``.

Two solver paths share one set of host-precomputed inputs
(:func:`placement_inputs`): the numpy grid DP (:func:`solve_placement_numpy`,
the oracle) and the torch float64 grid solver
(:mod:`repro_torch.core.placement_torch`, on the card or the CPU). Both are
reached through ``Engine.solve(PartitionSpec(..., placement=PlacementSpec(...)))``
and are bit-identical — including argmin tie-breaks — which
:func:`exhaustive_placement` (full enumeration with the DP's exact
accumulation order and tie-break key) pins on small graphs.

Tie-break contract (matching the single-node DPs' "smallest burst start
wins"): among minimum-energy placements the solver returns the one with the
fewest nodes, then lexicographically smallest span starts *read from the
end* (the DP reconstructs right-to-left, taking the first-min parent at
every step); each span's internal burst partition ties the same way.

Numpy + stdlib only — the torch half lives in :mod:`.placement_torch`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from .burst import ColumnSweep
from .cost import CostModel, LinearTransfer, cost_scalars
from .graph import TaskGraph
from .partition import BUDGET_ABS, BUDGET_REL
from ..obs.metrics import METRICS

__all__ = [
    "PLACEMENT_TABLE_VERSION",
    "PlacementError",
    "LinkModel",
    "NodeSpec",
    "PlacementSpec",
    "PlacementInputs",
    "PlacementSweep",
    "PlacementPlan",
    "PlacementTable",
    "placement_inputs",
    "solve_placement_numpy",
    "exhaustive_placement",
]

PLACEMENT_TABLE_VERSION = 1

#: Solve counters (one cell per backend: the numpy oracle, the torch grid
#: solver on the card and on the CPU), registered with the obs registry.
PLACEMENT_COUNT = METRICS.counter_dict(
    "placement_solves", ("numpy", "scan", "scan-cpu"),
    "placement grid solves per backend",
)

class PlacementError(ValueError):
    """Malformed placement specs, grids, or tables."""


# ---------------------------------------------------------------------------
# The model: links and nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """One inter-node link: bandwidth (mbps) → transfer energy + latency.

    A hop at boundary ``b`` ships the live set L(b) — the packets an NVM
    commit would persist there. The sender pays
    ``tx = init_energy·ΣW + per_byte·ΣB`` (same linear shape as the paper's
    NVM transfer model: ``c0_weight`` amortizes the initiation term across
    coalesced sub-packets) and the receiver pays ``rx_fraction·tx``
    (radios listen roughly as expensively as they talk; 1.0 by default).

    ``energy_per_byte`` defaults to ``8 / (bandwidth_mbps · 1e6)`` — one
    byte's share of link time, i.e. "energy = seconds on the link", matching
    the cost models pricing bytes at ``1/bandwidth``. Pass an
    explicit Joules-per-byte figure for a physical radio.

    ``latency_s`` is reporting-only (it never enters the energy DP):
    ``init_s + nbytes·8/(bandwidth_mbps·1e6)``.
    """

    bandwidth_mbps: float
    energy_per_byte: Optional[float] = None
    init_energy: float = 0.0
    rx_fraction: float = 1.0
    init_s: float = 0.0
    name: str = ""

    def __post_init__(self) -> None:
        if not (self.bandwidth_mbps > 0.0) or math.isinf(self.bandwidth_mbps):
            raise PlacementError(
                f"bandwidth_mbps must be positive and finite, got "
                f"{self.bandwidth_mbps!r}"
            )
        for field in ("energy_per_byte", "init_energy", "rx_fraction", "init_s"):
            v = getattr(self, field)
            if v is None:
                continue
            if not math.isfinite(float(v)) or float(v) < 0.0:
                raise PlacementError(
                    f"{field} must be finite and >= 0, got {v!r}"
                )
        if not self.name:
            object.__setattr__(
                self, "name", f"link-{float(self.bandwidth_mbps):g}mbps"
            )

    @property
    def per_byte(self) -> float:
        """Energy per transferred byte (defaulted from the bandwidth)."""
        if self.energy_per_byte is not None:
            return float(self.energy_per_byte)
        return 8.0 / (float(self.bandwidth_mbps) * 1e6)

    def transfer(self) -> LinearTransfer:
        """The hop's TX cost as the repo-standard linear transfer model."""
        return LinearTransfer(c0=float(self.init_energy), c1=self.per_byte)

    def tx_energy(self, nbytes: float, c0_weight: float = 1.0) -> float:
        return float(self.init_energy) * float(c0_weight) + self.per_byte * float(nbytes)

    def hop_energy(self, nbytes: float, c0_weight: float = 1.0) -> float:
        """TX + RX for one live set (what the placement DP prices per cut)."""
        tx = self.tx_energy(nbytes, c0_weight)
        return tx + float(self.rx_fraction) * tx

    def latency_s(self, nbytes: float) -> float:
        """Store-and-forward hop latency for ``nbytes`` (reporting only)."""
        return float(self.init_s) + float(nbytes) * 8.0 / (
            float(self.bandwidth_mbps) * 1e6
        )


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One harvesting node in the relay chain.

    ``q_max`` — the node's per-burst energy budget (its harvest capacitor),
    ``None`` = unbounded; scaled by :attr:`PlacementSpec.q_scales`.
    ``memory_bytes`` — NVM capacity bounding the packets whose live interval
    intersects the node's span (relayed packets included); ``None`` =
    unbounded; scaled by :attr:`PlacementSpec.memory_scales`.
    ``cost`` — the node's transfer cost model (defaults to the spec-level
    model, so a homogeneous swarm needs no per-node models).
    ``compute_scale`` — multiplier on task execution energy (a slower or
    lower-voltage node runs the same kernels at a different cost).
    """

    q_max: Optional[float] = None
    memory_bytes: Optional[float] = None
    cost: Optional[CostModel] = None
    compute_scale: float = 1.0
    name: str = ""

    def __post_init__(self) -> None:
        if self.q_max is not None and not (float(self.q_max) > 0.0):
            raise PlacementError(f"q_max must be > 0 or None, got {self.q_max!r}")
        if self.memory_bytes is not None and not (float(self.memory_bytes) >= 0.0):
            raise PlacementError(
                f"memory_bytes must be >= 0 or None, got {self.memory_bytes!r}"
            )
        if not (
            math.isfinite(float(self.compute_scale))
            and float(self.compute_scale) > 0.0
        ):
            raise PlacementError(
                f"compute_scale must be positive and finite, got "
                f"{self.compute_scale!r}"
            )
        if self.cost is not None and not isinstance(self.cost, CostModel):
            raise PlacementError(
                f"cost must be a CostModel, got {type(self.cost).__name__}"
            )


@dataclasses.dataclass(frozen=True, eq=False)
class PlacementSpec:
    """The placement axis of a :class:`~repro_torch.core.engine.PartitionSpec`.

    ``nodes`` — an int (that many default :class:`NodeSpec` nodes) or an
    explicit per-node tuple; the chain order is the relay order.
    ``link`` / ``links`` — exactly one: a single :class:`LinkModel` or the
    bandwidth-sweep tuple (one grid axis per link).
    ``q_scales`` / ``memory_scales`` — multiplier grids applied to every
    node's ``q_max`` / ``memory_bytes`` (the Q and memory sweep axes).

    The solved grid is ``links × memory_scales × q_scales`` — one batched
    ``Engine.solve`` call covers the whole design space.
    """

    nodes: Union[int, Tuple[NodeSpec, ...]] = 2
    link: Optional[LinkModel] = None
    links: Optional[Tuple[LinkModel, ...]] = None
    q_scales: Tuple[float, ...] = (1.0,)
    memory_scales: Tuple[float, ...] = (1.0,)

    def __post_init__(self) -> None:
        if isinstance(self.nodes, int):
            if self.nodes < 1:
                raise PlacementError(f"nodes must be >= 1, got {self.nodes}")
            object.__setattr__(
                self, "nodes", tuple(NodeSpec() for _ in range(self.nodes))
            )
        else:
            object.__setattr__(self, "nodes", tuple(self.nodes))
            if not self.nodes:
                raise PlacementError("nodes= is empty")
            for nd in self.nodes:
                if not isinstance(nd, NodeSpec):
                    raise PlacementError(
                        f"nodes= entries must be NodeSpec, got "
                        f"{type(nd).__name__}"
                    )
        if (self.link is None) == (self.links is None):
            raise PlacementError(
                "give exactly one of link= (single) or links= (sweep)"
            )
        links = (self.link,) if self.link is not None else tuple(self.links)
        object.__setattr__(self, "links", links)
        object.__setattr__(self, "link", None)
        if not links:
            raise PlacementError("links= is empty")
        for lk in links:
            if not isinstance(lk, LinkModel):
                raise PlacementError(
                    f"links= entries must be LinkModel, got "
                    f"{type(lk).__name__}"
                )
        for field in ("q_scales", "memory_scales"):
            vals = tuple(float(v) for v in getattr(self, field))
            if not vals:
                raise PlacementError(f"{field}= is empty")
            for v in vals:
                if not (math.isfinite(v) and v > 0.0):
                    raise PlacementError(
                        f"{field} entries must be positive and finite, "
                        f"got {v!r}"
                    )
            object.__setattr__(self, field, vals)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        """(links, memory_scales, q_scales) — the solved grid's shape."""
        return (len(self.links), len(self.memory_scales), len(self.q_scales))


# ---------------------------------------------------------------------------
# Shared host precompute: both backends (and the exhaustive oracle) consume
# exactly these arrays, which is what makes bit-identity achievable — the
# only arithmetic a backend performs is the two DPs.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class PlacementInputs:
    """Host-precomputed placement problem (see :func:`placement_inputs`).

    Index conventions (all 1-based like the paper): ``energy[k-1, a, b]`` is
    node ``k``'s burst cost E_k⟨a,b⟩ (inf outside ``1 ≤ a ≤ b ≤ n``);
    ``mem[i, j]`` the NVM bytes node spanning ``i..j`` must hold;
    boundary arrays are indexed by the boundary ``b = 0..n`` (the cut after
    task ``b``). ``q_thresh`` / ``mem_thresh`` are budget thresholds with
    the solver tolerance already folded in
    (``cap·(1+BUDGET_REL)+BUDGET_ABS``), so backends compare with plain
    ``<=`` and agree bitwise.
    """

    graph: TaskGraph
    spec: PlacementSpec
    cost: CostModel                       # spec-level default node cost model
    node_costs: Tuple[CostModel, ...]     # resolved per node
    energy: np.ndarray      # (N, n+2, n+2) f64  E_k⟨a,b⟩
    q_thresh: np.ndarray    # (N, Z) f64         per (node, q_scale) budget
    mem: np.ndarray         # (n+2, n+2) f64     span NVM footprint
    mem_thresh: np.ndarray  # (N, M) f64         per (node, memory_scale)
    live_bytes: np.ndarray  # (n+1,) f64         ΣB of the live set per boundary
    live_c0w: np.ndarray    # (n+1,) f64         ΣW (c0 weights) per boundary
    hop_tx: np.ndarray      # (L, n+1) f64       sender energy per boundary
    hop_rx: np.ndarray      # (L, n+1) f64       receiver energy per boundary
    hop_total: np.ndarray   # (L, n+1) f64       tx + rx (what the DP adds)
    hop_latency: np.ndarray  # (L, n+1) f64      store-and-forward seconds

    @property
    def n_tasks(self) -> int:
        return self.graph.n_tasks

    @property
    def n_nodes(self) -> int:
        return len(self.node_costs)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return self.spec.grid_shape


def _scaled_graph(graph: TaskGraph, scale: float) -> TaskGraph:
    """The graph with every task's execution cost scaled (compute_scale):
    burst costs then come out of the *paper's* recurrence unchanged."""
    if scale == 1.0:
        return graph
    tasks = [dataclasses.replace(t, cost=t.cost * scale) for t in graph.tasks]
    return TaskGraph(tasks, graph.packets.values())


def _burst_matrix(graph: TaskGraph, cost: CostModel) -> np.ndarray:
    """E⟨a,b⟩ for ``1 ≤ a ≤ b ≤ n`` from one incremental column sweep;
    inf everywhere else (so infeasible spans mask themselves)."""
    n = graph.n_tasks
    out = np.full((n + 2, n + 2), np.inf, dtype=np.float64)
    for b, col in zip(range(1, n + 1), ColumnSweep(graph, cost)):
        out[1 : b + 1, b] = col[1 : b + 1]
    return out


def placement_inputs(
    graph: TaskGraph, cost: CostModel, spec: PlacementSpec
) -> PlacementInputs:
    """Precompute every array both backends consume (see the class doc).

    One :class:`~repro_torch.core.burst.ColumnSweep` per *distinct*
    (cost model, compute_scale) pair — a homogeneous N-node swarm pays for
    one sweep, not N.
    """
    if not isinstance(graph, TaskGraph):
        raise PlacementError(
            f"placement needs the TaskGraph (the per-node column sweeps walk "
            f"its structure), got {type(graph).__name__}"
        )
    n = graph.n_tasks
    if n == 0:
        raise PlacementError("placement needs at least one task")
    nodes = spec.nodes
    N = len(nodes)
    L, M, Z = spec.grid_shape

    node_costs = tuple(nd.cost if nd.cost is not None else cost for nd in nodes)
    energy = np.empty((N, n + 2, n + 2), dtype=np.float64)
    cache: Dict[Tuple[int, float], np.ndarray] = {}
    for k, nd in enumerate(nodes):
        key = (id(node_costs[k]), float(nd.compute_scale))
        mat = cache.get(key)
        if mat is None:
            mat = _burst_matrix(
                _scaled_graph(graph, float(nd.compute_scale)), node_costs[k]
            )
            cache[key] = mat
        energy[k] = mat

    # Budget thresholds with the shared solver tolerance folded in once, so
    # every backend's feasibility mask is a plain `<=` on identical floats.
    q_caps = np.array(
        [np.inf if nd.q_max is None else float(nd.q_max) for nd in nodes]
    )
    q_thresh = (
        q_caps[:, None] * np.asarray(spec.q_scales)[None, :] * (1.0 + BUDGET_REL)
        + BUDGET_ABS
    )
    m_caps = np.array(
        [
            np.inf if nd.memory_bytes is None else float(nd.memory_bytes)
            for nd in nodes
        ]
    )
    mem_thresh = (
        m_caps[:, None] * np.asarray(spec.memory_scales)[None, :]
        * (1.0 + BUDGET_REL)
        + BUDGET_ABS
    )

    # Span NVM footprint: packet p (writer w, last use l) occupies the node
    # spanning i..j iff its live interval [w, l] intersects [i, j] — i.e.
    # w <= j and l >= i. One rectangle add per packet.
    mem = np.zeros((n + 2, n + 2), dtype=np.float64)
    live_bytes = np.zeros(n + 1, dtype=np.float64)
    live_c0w = np.zeros(n + 1, dtype=np.float64)
    for name, p in graph.packets.items():
        w = graph.writer(name)
        l = graph.l_inf[name]
        mem[1 : min(l, n) + 1, max(w, 1) : n + 1] += float(p.nbytes)
        # Live at boundary b (between tasks b and b+1) iff w <= b < l —
        # exactly TaskGraph.live_packets(b), vectorized as a range add.
        lo, hi = max(w, 0), min(l - 1, n)
        if lo <= hi:
            live_bytes[lo : hi + 1] += float(p.nbytes)
            live_c0w[lo : hi + 1] += float(p.c0_weight)

    hop_tx = np.empty((L, n + 1), dtype=np.float64)
    hop_rx = np.empty((L, n + 1), dtype=np.float64)
    hop_latency = np.empty((L, n + 1), dtype=np.float64)
    for li, lk in enumerate(spec.links):
        tx = float(lk.init_energy) * live_c0w + lk.per_byte * live_bytes
        hop_tx[li] = tx
        hop_rx[li] = float(lk.rx_fraction) * tx
        hop_latency[li] = float(lk.init_s) + live_bytes * 8.0 / (
            float(lk.bandwidth_mbps) * 1e6
        )
    hop_total = hop_tx + hop_rx

    return PlacementInputs(
        graph=graph,
        spec=spec,
        cost=cost,
        node_costs=node_costs,
        energy=energy,
        q_thresh=q_thresh,
        mem=mem,
        mem_thresh=mem_thresh,
        live_bytes=live_bytes,
        live_c0w=live_c0w,
        hop_tx=hop_tx,
        hop_rx=hop_rx,
        hop_total=hop_total,
        hop_latency=hop_latency,
    )


# ---------------------------------------------------------------------------
# The numpy reference DPs
# ---------------------------------------------------------------------------


def _first_min(cand: np.ndarray, index: np.ndarray, big: int) -> np.ndarray:
    """First-min argmin along the last axis via the shared where/min idiom
    (identical in :mod:`.placement_torch`, so tie-breaks agree bitwise).
    Returns ``big`` only when ``index`` is empty; all-inf rows return the
    first index (inf == inf)."""
    mn = np.min(cand, axis=-1)
    return mn, np.min(
        np.where(cand == mn[..., None], index, big), axis=-1
    ).astype(np.int32)


def _inner_dp_numpy(
    energy_k: np.ndarray, thresh: float, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-node burst DP over *all* span starts at once.

    ``S[i, b]`` = minimum energy to burst-partition tasks ``i..b`` on this
    node under budget ``thresh`` (``S[i, i-1] = 0``, inf when infeasible);
    ``A[i, b]`` = start of the last burst (first-min). O(n³).
    """
    big = n + 2
    idx = np.arange(n + 2)
    S = np.full((n + 2, n + 2), np.inf, dtype=np.float64)
    S[idx[1:], idx[:-1]] = 0.0
    A = np.zeros((n + 2, n + 2), dtype=np.int32)
    ec = np.where(energy_k <= thresh, energy_k, np.inf)
    for b in range(1, n + 1):
        # cand[i, a] = S[i, a-1] + E_k⟨a,b⟩ for a = 1..b
        cand = S[:, 0:b] + ec[1 : b + 1, b][None, :]
        mn, first = _first_min(cand, np.arange(1, b + 1)[None, :], big)
        S[:, b] = np.where(idx <= b, mn, S[:, b])
        A[:, b] = np.where(idx <= b, first, 0)
    return S, A


def _outer_dp_numpy(
    S_nodes: np.ndarray,    # (N, n+2, n+2) inner DP values for one q scale
    hop: np.ndarray,        # (n+1,) hop_total for one link
    memok: np.ndarray,      # (N, n+2, n+2) bool memory feasibility
    n: int,
    N: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Chain DP over node count: ``dp[k-1, j]`` = minimum energy to run
    tasks ``1..j`` on exactly the first ``k`` nodes (each span non-empty);
    ``parent[k-1, j]`` = node ``k``'s span start (first-min)."""
    big = n + 2
    i_arr = np.arange(1, n + 1)
    j_arr = np.arange(n + 1)
    dp = np.empty((N, n + 1), dtype=np.float64)
    parent = np.empty((N, n + 1), dtype=np.int32)
    dp_prev = np.full(n + 1, np.inf)
    dp_prev[0] = 0.0
    zeros = np.zeros(n + 1)
    for k in range(1, N + 1):
        seg = np.where(memok[k - 1], S_nodes[k - 1], np.inf)
        # node 1 receives no hop; the accumulation order is ((dp + X) + S)
        base = dp_prev[0:n] + (hop[0:n] if k >= 2 else zeros[0:n])
        cand = base[None, :] + seg[1 : n + 1, 0 : n + 1].T
        cand = np.where(i_arr[None, :] <= j_arr[:, None], cand, np.inf)
        mn, first = _first_min(cand, i_arr[None, :], big)
        dp[k - 1] = mn
        parent[k - 1] = first
        dp_prev = mn
    return dp, parent


def solve_placement_numpy(
    graph: TaskGraph,
    cost: CostModel,
    spec: PlacementSpec,
    *,
    inputs: Optional[PlacementInputs] = None,
) -> "PlacementSweep":
    """The numpy oracle: every (link, memory, Q) grid point via the
    two-level DP. The torch grid solver is pinned bit-identical to this
    (values *and* parent arrays)."""
    if inputs is None:
        inputs = placement_inputs(graph, cost, spec)
    PLACEMENT_COUNT["numpy"] += 1
    n, N = inputs.n_tasks, inputs.n_nodes
    L, M, Z = inputs.grid_shape

    inner_S = np.empty((N, Z, n + 2, n + 2), dtype=np.float64)
    inner_A = np.empty((N, Z, n + 2, n + 2), dtype=np.int32)
    for k in range(N):
        for z in range(Z):
            inner_S[k, z], inner_A[k, z] = _inner_dp_numpy(
                inputs.energy[k], inputs.q_thresh[k, z], n
            )

    memok = np.empty((N, M, n + 2, n + 2), dtype=bool)
    for k in range(N):
        for m in range(M):
            memok[k, m] = inputs.mem <= inputs.mem_thresh[k, m]

    outer_dp = np.empty((L, M, Z, N, n + 1), dtype=np.float64)
    outer_parent = np.empty((L, M, Z, N, n + 1), dtype=np.int32)
    for li in range(L):
        for m in range(M):
            for z in range(Z):
                outer_dp[li, m, z], outer_parent[li, m, z] = _outer_dp_numpy(
                    inner_S[:, z], inputs.hop_total[li], memok[:, m], n, N
                )

    e_total, k_used = _finalize(outer_dp, n, N)
    return PlacementSweep(
        inputs=inputs,
        backend="numpy",
        e_total=e_total,
        k_used=k_used,
        outer_dp=outer_dp,
        outer_parent=outer_parent,
        inner_S=inner_S,
        inner_A=inner_A,
    )


def _finalize(outer_dp: np.ndarray, n: int, N: int):
    """min over node count (first-min → fewest nodes among optima).
    ``k_used == 0`` marks infeasible cells. Shared by both backends."""
    if n == 0:
        # the empty application runs on zero nodes at zero energy
        shape = outer_dp.shape[:-2]
        return np.zeros(shape), np.zeros(shape, dtype=np.int32)
    dpn = outer_dp[..., n]                              # (L, M, Z, N)
    mn = np.min(dpn, axis=-1)
    k_arr = np.arange(1, N + 1, dtype=np.int32)
    first = np.min(
        np.where(dpn == mn[..., None], k_arr, np.int32(N + 2)), axis=-1
    )
    k_used = np.where(np.isfinite(mn), first, 0).astype(np.int32)
    return mn, k_used


# ---------------------------------------------------------------------------
# Results: the grid sweep and materialized plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class PlacementSweep:
    """Everything the grid solve produced; :meth:`plan` materializes one
    cell. ``outer_dp``/``outer_parent``/``inner_S``/``inner_A`` are the raw
    DP tables — kept so the bit-identity gates can compare backends on the
    full solver state, not just the optima."""

    inputs: PlacementInputs
    backend: str
    e_total: np.ndarray       # (L, M, Z) f64, inf where infeasible
    k_used: np.ndarray        # (L, M, Z) i32, 0 where infeasible
    outer_dp: np.ndarray      # (L, M, Z, N, n+1) f64
    outer_parent: np.ndarray  # (L, M, Z, N, n+1) i32
    inner_S: np.ndarray       # (N, Z, n+2, n+2) f64
    inner_A: np.ndarray       # (N, Z, n+2, n+2) i32

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return tuple(self.e_total.shape)  # type: ignore[return-value]

    def feasible(
        self, link_index: int = 0, memory_index: int = 0, q_index: int = 0
    ) -> bool:
        return bool(np.isfinite(self.e_total[link_index, memory_index, q_index]))

    def plan(
        self, link_index: int = 0, memory_index: int = 0, q_index: int = 0
    ) -> "PlacementPlan":
        """Reconstruct one grid cell's placement (host-side walk of the
        parent arrays — identical plans from bit-identical arrays)."""
        li, m, z = int(link_index), int(memory_index), int(q_index)
        inp = self.inputs
        n = inp.n_tasks
        e = float(self.e_total[li, m, z])
        k = int(self.k_used[li, m, z])
        if not math.isfinite(e):
            raise PlacementError(
                f"grid cell (link={li}, memory={m}, q={z}) is infeasible: "
                f"no placement fits the node budgets"
            )
        spans: List[Tuple[int, int]] = []
        j = n
        for kk in range(k, 0, -1):
            i = int(self.outer_parent[li, m, z, kk - 1, j])
            spans.append((i, j))
            j = i - 1
        spans.reverse()
        node_bursts: List[Tuple[Tuple[int, int], ...]] = []
        node_energy: List[float] = []
        node_memory: List[float] = []
        for kk, (i, j) in enumerate(spans, start=1):
            bursts: List[Tuple[int, int]] = []
            b = j
            while b >= i:
                a = int(self.inner_A[kk - 1, z, i, b])
                bursts.append((a, b))
                b = a - 1
            bursts.reverse()
            node_bursts.append(tuple(bursts))
            node_energy.append(float(self.inner_S[kk - 1, z, i, j]))
            node_memory.append(float(inp.mem[i, j]))
        bounds = [i - 1 for (i, _) in spans[1:]]
        link = inp.spec.links[li]
        return PlacementPlan(
            link_index=li,
            memory_index=m,
            q_index=z,
            link=link,
            q_scale=float(inp.spec.q_scales[z]),
            memory_scale=float(inp.spec.memory_scales[m]),
            spans=tuple(spans),
            node_bursts=tuple(node_bursts),
            node_energy=tuple(node_energy),
            node_memory_bytes=tuple(node_memory),
            node_costs=inp.node_costs[:k],
            node_specs=inp.spec.nodes[:k],
            hop_boundaries=tuple(bounds),
            hop_bytes=tuple(float(inp.live_bytes[b]) for b in bounds),
            hop_tx=tuple(float(inp.hop_tx[li, b]) for b in bounds),
            hop_rx=tuple(float(inp.hop_rx[li, b]) for b in bounds),
            hop_latency_s=tuple(float(inp.hop_latency[li, b]) for b in bounds),
            e_total=e,
            graph=inp.graph,
        )

    def plans(self) -> List[Optional["PlacementPlan"]]:
        """Every grid cell's plan in (link, memory, q) C-order; ``None``
        where infeasible."""
        L, M, Z = self.grid_shape
        return [
            self.plan(li, m, z) if self.feasible(li, m, z) else None
            for li in range(L)
            for m in range(M)
            for z in range(Z)
        ]

    def summary(self) -> str:
        L, M, Z = self.grid_shape
        feas = int(np.isfinite(self.e_total).sum())
        return (
            f"PlacementSweep[{self.backend}] {self.inputs.n_nodes} nodes × "
            f"grid {L}×{M}×{Z} ({feas}/{L * M * Z} feasible)"
        )


@dataclasses.dataclass(frozen=True, eq=False)
class PlacementPlan:
    """One materialized placement: spans, per-node burst schedules and
    energy/memory accounting, plus per-hop transfer costs."""

    link_index: int
    memory_index: int
    q_index: int
    link: LinkModel
    q_scale: float
    memory_scale: float
    spans: Tuple[Tuple[int, int], ...]              # per used node, 1-based
    node_bursts: Tuple[Tuple[Tuple[int, int], ...], ...]
    node_energy: Tuple[float, ...]                  # span DP value per node
    node_memory_bytes: Tuple[float, ...]
    node_costs: Tuple[CostModel, ...]
    node_specs: Tuple[NodeSpec, ...]
    hop_boundaries: Tuple[int, ...]                 # cut after task b
    hop_bytes: Tuple[float, ...]
    hop_tx: Tuple[float, ...]
    hop_rx: Tuple[float, ...]
    hop_latency_s: Tuple[float, ...]
    e_total: float
    graph: TaskGraph

    @property
    def n_nodes_used(self) -> int:
        return len(self.spans)

    @property
    def n_bursts(self) -> int:
        return sum(len(bs) for bs in self.node_bursts)

    @property
    def transfer_energy(self) -> float:
        """Total inter-node transfer draw (TX + RX over every hop)."""
        return sum(self.hop_tx) + sum(self.hop_rx)

    @property
    def transfer_overhead(self) -> float:
        """Transfer energy as a fraction of the plan total (the swarm analog
        of the paper's activation-overhead figure)."""
        return self.transfer_energy / self.e_total if self.e_total else 0.0

    @property
    def transfer_bytes(self) -> float:
        return float(sum(self.hop_bytes))

    @property
    def total_hop_latency_s(self) -> float:
        return float(sum(self.hop_latency_s))

    def node_spent(self, node_index: int) -> float:
        """Node ``node_index``'s total draw: its span energy, plus TX of the
        hop it sends, plus RX of the hop it receives."""
        k = int(node_index)
        spent = self.node_energy[k]
        if k < len(self.hop_tx):
            spent += self.hop_tx[k]
        if k >= 1:
            spent += self.hop_rx[k - 1]
        return spent

    def validate(self) -> None:
        """Structural sanity: contiguous non-empty spans covering 1..n,
        bursts covering each span, hop boundaries at the span cuts."""
        expect = 1
        for (i, j), bursts in zip(self.spans, self.node_bursts):
            if i != expect or j < i:
                raise AssertionError(f"non-contiguous span ⟨{i},{j}⟩")
            b_expect = i
            for (a, b) in bursts:
                if a != b_expect or b < a:
                    raise AssertionError(
                        f"non-contiguous burst ⟨{a},{b}⟩ in span ⟨{i},{j}⟩"
                    )
                b_expect = b + 1
            if b_expect != j + 1:
                raise AssertionError(f"bursts do not cover span ⟨{i},{j}⟩")
            expect = j + 1
        if expect != self.graph.n_tasks + 1:
            raise AssertionError("placement does not cover all tasks")
        if tuple(j for (_, j) in self.spans[:-1]) != self.hop_boundaries:
            raise AssertionError("hop boundaries disagree with span cuts")

    def ledgers(self):
        """Per-node :class:`~repro_torch.obs.ledger.EnergyLedger` attribution.

        Each committed burst charges ``restore`` (the node's E_s),
        ``compute`` (scaled task energy) and ``commit`` (the remaining NVM
        traffic); hop TX is committed by the sender and RX by the receiver.
        Node ``k``'s ledger conserves against :meth:`node_spent`\\ (k) at
        solver tolerance — the swarm CLI and tests gate on that.
        """
        from ..obs.ledger import EnergyLedger

        out = []
        for k, ((i, j), bursts) in enumerate(zip(self.spans, self.node_bursts)):
            cm = self.node_costs[k]
            scale = float(self.node_specs[k].compute_scale)
            led = EnergyLedger()
            # Re-walk the burst costs in DP accumulation order so the sum of
            # charges reproduces node_energy[k] up to reordering rounding.
            for cycle, (a, b) in enumerate(bursts):
                total = float(self._burst_energy(k, a, b))
                restore = float(cm.e_startup)
                compute = float(
                    sum(self.graph.task(t).cost for t in range(a, b + 1)) * scale
                )
                led.charge(
                    k, cycle,
                    restore=restore,
                    compute=compute,
                    commit=total - restore - compute,
                )
            hop_cycle = len(bursts)
            if k < len(self.hop_tx):            # sends to node k+1
                led.charge(k, hop_cycle, commit=self.hop_tx[k])
            if k >= 1:                          # received from node k-1
                led.charge(k, hop_cycle + 1, commit=self.hop_rx[k - 1])
            out.append(led)
        return out

    def check_conservation(self) -> None:
        """Every node's ledger must conserve against its spent total, and
        the node totals must sum to the plan energy (solver tolerance)."""
        from ..obs.ledger import LedgerImbalance

        total = 0.0
        for k, led in enumerate(self.ledgers()):
            led.check_conservation(self.node_spent(k))
            total += self.node_spent(k)
        scale = max(abs(total), abs(self.e_total))
        if abs(total - self.e_total) > scale * BUDGET_REL + BUDGET_ABS:
            raise LedgerImbalance(
                f"node energies sum to {total!r} but the plan total is "
                f"{self.e_total!r}"
            )

    def _burst_energy(self, node_index: int, a: int, b: int) -> float:
        """E_k⟨a,b⟩ from the solved inputs is not retained on the plan;
        recompute from the node's (possibly scaled) burst detail."""
        from .burst import burst_cost

        cm = self.node_costs[node_index]
        scale = float(self.node_specs[node_index].compute_scale)
        g = _scaled_graph(self.graph, scale)
        return burst_cost(g, cm, a, b)

    def summary(self) -> str:
        spans = " | ".join(
            f"n{k}⟨{i},{j}⟩×{len(bs)}"
            for k, ((i, j), bs) in enumerate(zip(self.spans, self.node_bursts))
        )
        return (
            f"nodes={self.n_nodes_used} bursts={self.n_bursts} "
            f"E_total={self.e_total:.6g} "
            f"transfer={100 * self.transfer_overhead:.2f}% "
            f"({self.transfer_bytes:.0f} B over "
            f"{self.link.bandwidth_mbps:g} mbps) [{spans}]"
        )


# ---------------------------------------------------------------------------
# Exhaustive oracle (tests): full enumeration with the DP's exact
# accumulation order and tie-break key
# ---------------------------------------------------------------------------


def exhaustive_placement(
    inputs: PlacementInputs,
    link_index: int = 0,
    memory_index: int = 0,
    q_index: int = 0,
) -> Optional[Tuple[float, Tuple[Tuple[int, int], ...], Tuple[Tuple[Tuple[int, int], ...], ...]]]:
    """Enumerate every placement of one grid cell; ``None`` if none fits.

    Returns ``(e_total, spans, node_bursts)`` for the winner under the DP's
    exact tie-break key: (energy, node count, span starts compared from the
    last span backwards, then each span's burst starts compared the same
    way). Costs accumulate in the DP's order — ``((dp + hop) + seg)`` across
    spans, left-to-right across bursts within a span — so on ties *and*
    values this matches :func:`solve_placement_numpy` bitwise. O(2^n·…):
    test-only (n ≤ 8, N ≤ 3).
    """
    n, N = inputs.n_tasks, inputs.n_nodes
    if n > 12:
        raise PlacementError("exhaustive oracle limited to n <= 12")
    li, m, z = int(link_index), int(memory_index), int(q_index)
    hop = inputs.hop_total[li]
    if n == 0:
        return 0.0, (), ()

    def span_options(k: int, i: int, j: int):
        """All burst partitions of i..j on node k: (seg_energy, bursts),
        accumulated left-to-right like the inner DP."""
        thresh = inputs.q_thresh[k, z]
        opts = []
        for cuts in itertools.product([False, True], repeat=j - i):
            bounds = []
            a = i
            for t, cut in zip(range(i, j), cuts):
                if cut:
                    bounds.append((a, t))
                    a = t + 1
            bounds.append((a, j))
            seg = 0.0
            ok = True
            for (aa, bb) in bounds:
                e = inputs.energy[k, aa, bb]
                if not (e <= thresh):
                    ok = False
                    break
                seg = seg + e
            if ok:
                opts.append((seg, tuple(bounds)))
        return opts

    def burst_key(bursts: Tuple[Tuple[int, int], ...]):
        return tuple(a for (a, _) in reversed(bursts))

    best = None  # (energy, k, rev_span_starts, rev_burst_keys, spans, bursts)
    for k in range(1, min(N, n) + 1):
        for cut_pos in itertools.combinations(range(1, n), k - 1):
            starts = (1,) + tuple(c + 1 for c in cut_pos)
            ends = tuple(c for c in cut_pos) + (n,)
            spans = tuple(zip(starts, ends))
            # memory feasibility per node
            if not all(
                inputs.mem[i, j] <= inputs.mem_thresh[kk, m]
                for kk, (i, j) in enumerate(spans)
            ):
                continue
            # pick each span's canonical burst partition: min energy, then
            # smallest reversed burst starts (the inner DP's tie-break)
            chosen = []
            feasible = True
            for kk, (i, j) in enumerate(spans):
                opts = span_options(kk, i, j)
                if not opts:
                    feasible = False
                    break
                opts.sort(key=lambda sb: (sb[0], burst_key(sb[1])))
                chosen.append(opts[0])
            if not feasible:
                continue
            total = 0.0
            for kk, (seg, _) in enumerate(chosen):
                if kk >= 1:
                    total = total + hop[spans[kk][0] - 1]
                total = total + seg
            key = (
                total,
                k,
                tuple(i for (i, _) in reversed(spans)),
                tuple(burst_key(b) for (_, b) in reversed(chosen)),
            )
            if best is None or key < best[0]:
                best = (key, spans, tuple(b for (_, b) in chosen))
    if best is None:
        return None
    return best[0][0], best[1], best[2]


# ---------------------------------------------------------------------------
# Versioned placement tables (the DSE artifact)
# ---------------------------------------------------------------------------


class PlacementTable:
    """A solved placement grid as a versioned, fingerprinted JSON artifact —
    the swarm sibling of the single-node plan table (same discipline:
    content fingerprint over hex-encoded floats, typed tamper errors)."""

    def __init__(
        self,
        sweep: Optional[PlacementSweep] = None,
        *,
        payload: Optional[Mapping[str, Any]] = None,
        meta: Optional[Mapping[str, object]] = None,
    ) -> None:
        if (sweep is None) == (payload is None):
            raise PlacementError("give exactly one of sweep= or payload=")
        if sweep is not None:
            self._payload = _table_payload(sweep, dict(meta or {}))
        else:
            self._payload = _validate_table_payload(payload)

    # -- views --------------------------------------------------------------

    @property
    def meta(self) -> Dict[str, object]:
        return dict(self._payload["meta"])

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        g = self._payload["grid"]
        return (
            len(g["bandwidth_mbps"]),
            len(g["memory_scales"]),
            len(g["q_scales"]),
        )

    @property
    def bandwidths(self) -> Tuple[float, ...]:
        return tuple(self._payload["grid"]["bandwidth_mbps"])

    @property
    def e_total(self) -> np.ndarray:
        arr = np.asarray(self._payload["e_total"], dtype=np.float64)
        return np.where(np.isnan(arr), np.inf, arr)

    def cell(self, link_index: int, memory_index: int, q_index: int) -> Dict[str, Any]:
        return dict(
            self._payload["cells"][link_index][memory_index][q_index] or {}
        )

    def fingerprint(self) -> str:
        return _table_fingerprint(self._payload)

    def summary(self) -> str:
        L, M, Z = self.grid_shape
        feas = int(np.isfinite(self.e_total).sum())
        return (
            f"PlacementTable v{self._payload['version']} grid {L}×{M}×{Z} "
            f"({feas} feasible) fingerprint={self.fingerprint()[:12]}…"
        )

    # -- persistence --------------------------------------------------------

    def to_payload(self) -> Dict[str, Any]:
        out = dict(self._payload)
        out["fingerprint"] = self.fingerprint()
        return out

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_payload(), f, indent=2)
            f.write("\n")

    @classmethod
    def from_payload(cls, payload: Mapping[str, Any]) -> "PlacementTable":
        return cls(payload=payload)

    @classmethod
    def from_json(cls, path: str) -> "PlacementTable":
        with open(path) as f:
            return cls.from_payload(json.load(f))


def _table_payload(sweep: PlacementSweep, meta: Dict[str, object]) -> Dict[str, Any]:
    inp = sweep.inputs
    spec = inp.spec
    L, M, Z = sweep.grid_shape
    cells: List[List[List[Optional[Dict[str, Any]]]]] = []
    for li in range(L):
        mrow = []
        for m in range(M):
            zrow: List[Optional[Dict[str, Any]]] = []
            for z in range(Z):
                if not sweep.feasible(li, m, z):
                    zrow.append(None)
                    continue
                plan = sweep.plan(li, m, z)
                zrow.append(
                    {
                        "spans": [list(s) for s in plan.spans],
                        "bursts": [
                            [list(b) for b in bs] for bs in plan.node_bursts
                        ],
                        "node_energy": list(plan.node_energy),
                        "transfer_overhead": plan.transfer_overhead,
                        "transfer_bytes": plan.transfer_bytes,
                        "hop_latency_s": list(plan.hop_latency_s),
                    }
                )
            mrow.append(zrow)
        cells.append(mrow)
    e = np.where(np.isfinite(sweep.e_total), sweep.e_total, np.nan)
    return {
        "version": PLACEMENT_TABLE_VERSION,
        "backend": sweep.backend,
        "grid": {
            "bandwidth_mbps": [float(lk.bandwidth_mbps) for lk in spec.links],
            "memory_scales": list(spec.memory_scales),
            "q_scales": list(spec.q_scales),
        },
        "nodes": [
            {
                "q_max": nd.q_max,
                "memory_bytes": nd.memory_bytes,
                "compute_scale": nd.compute_scale,
                "cost": cm.name,
                "name": nd.name,
            }
            for nd, cm in zip(spec.nodes, inp.node_costs)
        ],
        "cost": {
            "name": inp.cost.name,
            "scalars": [float(x) for x in cost_scalars(inp.cost)],
        },
        "n_tasks": inp.n_tasks,
        "e_total": e.tolist(),
        "k_used": sweep.k_used.tolist(),
        "cells": cells,
        "meta": meta,
    }


def _table_fingerprint(payload: Mapping[str, Any]) -> str:
    """sha256 over the solved content — grid axes and energies hex-encoded
    so two tables agree iff their solved numbers agree bitwise."""
    h = hashlib.sha256()
    h.update(f"placement-v{payload['version']}\x00".encode())
    g = payload["grid"]
    for axis in ("bandwidth_mbps", "memory_scales", "q_scales"):
        h.update(" ".join(float(x).hex() for x in g[axis]).encode() + b"\x00")
    h.update(json.dumps(payload["nodes"], sort_keys=True).encode())
    h.update(" ".join(float(x).hex() for x in payload["cost"]["scalars"]).encode())
    flat: List[float] = []
    for mrow in payload["e_total"]:
        for zrow in mrow:
            flat.extend(zrow)
    h.update(
        " ".join("nan" if x is None or (isinstance(x, float) and math.isnan(x))
                 else float(x).hex() for x in flat).encode()
    )
    h.update(json.dumps(payload["cells"], sort_keys=True).encode())
    return h.hexdigest()


def _validate_table_payload(payload: Mapping[str, Any]) -> Dict[str, Any]:
    try:
        version = payload["version"]
    except (KeyError, TypeError) as exc:
        raise PlacementError("not a placement-table payload (no version)") from exc
    if version != PLACEMENT_TABLE_VERSION:
        raise PlacementError(
            f"placement-table version {version!r} != supported "
            f"{PLACEMENT_TABLE_VERSION}"
        )
    out = dict(payload)
    recorded = out.pop("fingerprint", None)
    if recorded is not None and recorded != _table_fingerprint(out):
        raise PlacementError(
            "placement-table fingerprint mismatch: file was edited or "
            "written by an incompatible build"
        )
    return out
