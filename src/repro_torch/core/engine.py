"""One Julienning façade: declarative :class:`PartitionSpec` → :class:`Engine`.

The port's copy of ``repro/core/engine.py``. Callers build one immutable
:class:`PartitionSpec` —

* **what** to partition: a :class:`~repro_torch.core.graph.TaskGraph` (or
  its dense or CSR export), a batch of graphs, or a model-zoo config plus
  (batch, seq) shapes to lower;
* **what to optimize**: ``objective="sum"`` (the paper's E_total DP over a
  Q_max grid), ``"minimax"`` (§4.4 storage minimization, Q_min) or
  ``"exact_k"`` (the fixed-burst-count DP);
* **where** to solve it: ``backend="numpy" | "torch" | "cuda" | "scan" |
  "scan-cpu" | "auto"``, and an optional :class:`QGridSharding` splitting
  the Q grid into chunks over torch devices;
* **at what price**: ``cost=`` a :class:`~.cost.CostModel`, or a
  :class:`~.calibration.MeasuredCostTable` priced at ``confidence=``;
* **across how many nodes**: ``placement=`` a
  :class:`~.placement.PlacementSpec` (a relay chain of harvesting nodes and
  its link × memory × Q grid)

— and :meth:`Engine.solve` resolves it through a backend *registry*.
``numpy`` is the oracle DP of :mod:`.partition`; ``cuda`` runs the CSR
sweep kernel on the card in the matching mode, ``torch`` its plain PyTorch
version on the CPU (tests, ``--device cpu``); ``scan`` runs the dense sweep
of :mod:`.partition_torch` on the card, one batched pass over a batch of
graphs, ``scan-cpu`` the same code on the CPU. ``auto`` never drops to the
CPU — without a card it raises, as ``device="cuda"`` does — and routes per
graph by layout: a ``GraphArrays`` export to ``scan``, a ``GraphCSRArrays``
export to ``cuda``, and a ``TaskGraph`` of any size to ``cuda`` (the
reference sends a graph under 32 MB of dense export to its ``lax.scan``
engine, one compiled executable on a TPU; the port's dense sweep is a host
loop over columns, so the kernel keeps every graph). A mixed batch is
solved group by group. Mismatches raise typed errors:
:class:`ExportMismatch` for a layout a backend cannot consume,
:class:`UnsupportedObjective` for an objective it does not implement.

Placement solves run on ``numpy`` (the oracle), ``scan`` (the torch grid
solver of :mod:`.placement_torch` on the card) and ``scan-cpu``; ``auto``
picks ``scan``. Q-grid sharding runs on ``cuda``, ``torch``, ``scan`` and
``scan-cpu``, bitwise equal to the unsharded solve. The reference's
``interpret=`` (the Pallas kernel's mode) has no counterpart: a spec that
sets it raises :class:`SpecError`.

Most callers go through :mod:`repro_torch.api`, which re-exports this
module's public names and the :func:`~repro_torch.api.solve` convenience.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs.trace import PID_SOLVER, TRACER
from . import partition_torch as pt
from .calibration import MeasuredCostTable, measured_default
from .cost import CostModel
from .graph import GraphArrays, GraphCSRArrays, TaskGraph
from .partition import Infeasible, Partition
from .placement import PlacementSpec, PlacementSweep

__all__ = [
    "EngineError",
    "SpecError",
    "UnsupportedObjective",
    "ExportMismatch",
    "BackendInfo",
    "register_backend",
    "backend_names",
    "backend_info",
    "export_kind",
    "resolve_auto_backend",
    "QGridSharding",
    "PartitionSpec",
    "Solution",
    "Engine",
    "default_engine",
    "OBJECTIVES",
]

AnyExport = Union[TaskGraph, GraphArrays, GraphCSRArrays]

OBJECTIVES = ("sum", "minimax", "exact_k")


# ---------------------------------------------------------------------------
# Typed errors
# ---------------------------------------------------------------------------


class EngineError(ValueError):
    """Base class for façade errors (spec validation, dispatch, capability)."""


class SpecError(EngineError):
    """Malformed or self-contradictory :class:`PartitionSpec`, or a field the
    port does not implement."""


class UnsupportedObjective(EngineError):
    """The selected backend does not implement the requested objective.

    Every built-in backend implements all of :data:`OBJECTIVES`, so this
    fires only for a backend registered with a restricted ``objectives``
    set."""


class ExportMismatch(EngineError, TypeError):
    """A graph export the selected backend cannot consume."""


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackendInfo:
    """Registry entry: a backend class plus its capability flags.

    ``objectives`` is the set of :data:`OBJECTIVES` the backend implements;
    ``supports_csr`` / ``supports_dense`` declare that it consumes
    :class:`GraphCSRArrays` / :class:`GraphArrays` exports (every backend
    accepts a :class:`TaskGraph`); ``supports_sharding`` gates
    :class:`QGridSharding`, ``supports_placement`` the multi-node placement
    axis; ``auto_eligible`` marks the backends ``backend="auto"`` may
    pick."""

    name: str
    factory: Any
    objectives: frozenset
    supports_sharding: bool = False
    supports_csr: bool = False
    supports_dense: bool = True
    supports_placement: bool = False
    auto_eligible: bool = True


_REGISTRY: Dict[str, BackendInfo] = {}


def register_backend(
    name: str,
    *,
    objectives: Sequence[str] = ("sum",),
    supports_sharding: bool = False,
    supports_csr: bool = False,
    supports_dense: bool = True,
    supports_placement: bool = False,
    auto_eligible: bool = True,
    registry: Optional[Dict[str, BackendInfo]] = None,
):
    """Class decorator: self-register a backend under ``name`` (in
    ``registry``, the process-global one by default)."""
    bad = set(objectives) - set(OBJECTIVES)
    if bad:
        raise SpecError(f"unknown objectives {sorted(bad)}; known: {OBJECTIVES}")

    def deco(cls):
        (_REGISTRY if registry is None else registry)[name] = BackendInfo(
            name=name,
            factory=cls,
            objectives=frozenset(objectives),
            supports_sharding=supports_sharding,
            supports_csr=supports_csr,
            supports_dense=supports_dense,
            supports_placement=supports_placement,
            auto_eligible=auto_eligible,
        )
        return cls

    return deco


def backend_names(registry: Optional[Dict[str, BackendInfo]] = None) -> List[str]:
    return sorted(_REGISTRY if registry is None else registry)


def backend_info(
    name: str, registry: Optional[Dict[str, BackendInfo]] = None
) -> BackendInfo:
    reg = _REGISTRY if registry is None else registry
    try:
        return reg[name]
    except KeyError:
        raise SpecError(
            f"unknown backend {name!r}; registered: {sorted(reg)}"
        ) from None


def export_kind(graph: AnyExport) -> str:
    """Classify a solver input: ``"graph"`` / ``"dense"`` / ``"csr"``."""
    if isinstance(graph, TaskGraph):
        return "graph"
    if isinstance(graph, GraphArrays):
        return "dense"
    if isinstance(graph, GraphCSRArrays):
        return "csr"
    raise ExportMismatch(
        f"cannot solve a {type(graph).__name__}: expected a TaskGraph or a "
        f"GraphArrays / GraphCSRArrays export"
    )


def _check_export(info: BackendInfo, graph: AnyExport,
                  registry: Dict[str, BackendInfo]) -> None:
    """The capability check guarding every dispatch: a TaskGraph goes to any
    backend, an export only to one that consumes its layout."""
    kind = export_kind(graph)
    for layout, flag, cls in (("dense", "supports_dense", "GraphArrays"),
                              ("csr", "supports_csr", "GraphCSRArrays")):
        if kind == layout and not getattr(info, flag):
            raise ExportMismatch(
                f"backend {info.name!r} does not consume {cls} exports; pass "
                f"the TaskGraph or pick a backend with {flag} (registered: "
                f"{[b.name for b in registry.values() if getattr(b, flag)]})"
            )


def resolve_auto_backend(
    graph: AnyExport,
    objective: str = "sum",
    registry: Optional[Dict[str, BackendInfo]] = None,
) -> str:
    """``backend="auto"`` for one graph: among the auto-eligible backends
    implementing ``objective``, a CSR export takes a ``supports_csr`` one, a
    dense export a ``supports_dense`` one, and a TaskGraph a CSR one first
    (the sweep kernel, whatever the graph's size; see the module
    docstring)."""
    reg = _REGISTRY if registry is None else registry
    cands = [b for b in reg.values() if b.auto_eligible and objective in b.objectives]
    if not cands:
        raise UnsupportedObjective(
            f"no registered auto-eligible backend implements objective "
            f"{objective!r} (registered: {sorted(reg)})"
        )
    dense_c = [b for b in cands if b.supports_dense]
    csr_c = [b for b in cands if b.supports_csr]
    kind = export_kind(graph)
    pool = {"csr": csr_c, "dense": dense_c}.get(kind, csr_c or dense_c)
    if not pool:
        raise ExportMismatch(
            f"no backend implementing objective {objective!r} consumes a "
            f"{kind!r} export ({sorted(b.name for b in cands)} take "
            f"{'dense' if dense_c else 'csr'} or the TaskGraph itself); pass "
            f"the TaskGraph or re-export in the matching layout"
        )
    return pool[0].name


# ---------------------------------------------------------------------------
# The declarative spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class QGridSharding:
    """Split the Q_max grid into ``n_shards`` contiguous chunks
    (:func:`~.partition_torch.shard_q_grid`), each solved on its own device.

    ``devices`` are torch devices (or their names); ``None`` solves every
    chunk on the backend's own device. With fewer devices than chunks the
    same chunks run one after another on the backend's device. Either way
    the gathered tables are bitwise equal to the unsharded solve, since
    every Q lane's DP is independent. Only ``objective="sum"`` has a Q grid
    to shard; :class:`PartitionSpec` rejects sharding with
    ``minimax``/``exact_k`` (:class:`SpecError`).
    """

    n_shards: int
    devices: Optional[Tuple[Any, ...]] = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise SpecError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.devices is not None:
            object.__setattr__(self, "devices",
                               tuple(torch.device(d) for d in self.devices))


class _Unset:
    """Sentinel distinguishing 'q_max not given' from 'q_max=None=unbounded'."""

    def __repr__(self):  # pragma: no cover - repr only
        return "<unset>"


_UNSET = _Unset()

# Fields of the reference's spec that the port does not implement, and why.
_NOT_PORTED = {
    "interpret": "interpret= is the Pallas kernel's mode; the port's kernels "
                 "are CUDA (pick backend='torch' for the plain version)",
}


def _is_nan(q) -> bool:
    return q is not None and q != q


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionSpec:
    """Immutable, declarative description of one partitioning problem.

    Exactly one input source::

        PartitionSpec(graph=g, ...)                  # one graph / CSR export
        PartitionSpec(graphs=(g1, g2), ...)          # a batch (one solve)
        PartitionSpec(config="qwen3-4b", shapes=((2, 24), (2, 48)),
                      kind="time", smoke=True, ...)  # model-zoo lowering

    and at most one Q axis: ``q_grid`` (a tuple of Q_max values, ``None`` =
    unbounded) or the single-point ``q_max``; a NaN in either is rejected.
    ``objective`` picks the DP: ``"sum"`` minimizes E_total over the grid,
    ``"minimax"`` computes Q_min (§4.4; no Q axis), ``"exact_k"`` solves the
    fixed-burst-count DP for ``n_bursts`` (``k_objective`` chooses the
    combine: ``"sum"`` for E_total, ``"max"`` for the bottleneck).

    ``cost`` is required for explicit graphs; config-lowered specs default
    it per ``kind`` as the plan-table builders do (an installed measured
    calibration first). ``cost`` also takes a
    :class:`~.calibration.MeasuredCostTable`, priced at ``confidence`` (a
    level in (0, 1)): every cut at measured mean + z·sigma;
    ``confidence=None`` prices at the plain mean, which is the analytical
    model itself when the measurements match it. ``backend`` names a
    registered backend or ``"auto"``; ``sharding`` splits the Q grid into
    chunks over torch devices. ``interpret`` exists so that a spec written
    for the reference fails loudly here: any value but ``None`` raises
    :class:`SpecError`.

    ``placement`` adds the multi-node axis: a
    :class:`~repro_torch.core.placement.PlacementSpec` describing a relay
    chain of harvesting nodes plus the link-bandwidth / memory / Q sweep
    grids. Placement solves carry their own budget axes, so ``q_grid=`` /
    ``q_max=`` / ``sharding=`` are rejected alongside it, the objective must
    stay ``"sum"``, and inputs must be :class:`TaskGraph` objects (the
    per-node column sweeps walk the graph structure).
    """

    graph: Optional[AnyExport] = None
    graphs: Optional[Tuple[AnyExport, ...]] = None
    config: Optional[Any] = None          # ModelConfig or registry arch name
    shapes: Tuple[Tuple[int, int], ...] = ((1, 128),)
    kind: str = "time"
    smoke: bool = False
    cost: Optional[Union[CostModel, MeasuredCostTable]] = None
    q_grid: Optional[Tuple[Optional[float], ...]] = None
    q_max: Any = _UNSET
    objective: str = "sum"
    n_bursts: Optional[int] = None
    k_objective: str = "sum"
    backend: str = "auto"
    sharding: Optional[QGridSharding] = None
    interpret: Any = None
    confidence: Any = None
    placement: Optional[PlacementSpec] = None

    def __post_init__(self):
        for name, why in _NOT_PORTED.items():
            if getattr(self, name) is not None:
                raise SpecError(f"{name}= is not supported by the port: {why}")
        sources = [
            s for s, v in (
                ("graph", self.graph),
                ("graphs", self.graphs),
                ("config", self.config),
            ) if v is not None
        ]
        if len(sources) != 1:
            raise SpecError(
                f"exactly one of graph= / graphs= / config= must be given "
                f"(got {sources or 'none'})"
            )
        if self.graphs is not None:
            object.__setattr__(self, "graphs", tuple(self.graphs))
            if not self.graphs:
                raise SpecError("graphs= is empty")
        object.__setattr__(
            self, "shapes", tuple((int(b), int(s)) for (b, s) in self.shapes)
        )
        if self.config is not None and not self.shapes:
            raise SpecError("config= specs need at least one (batch, seq) shape")
        if self.q_grid is not None:
            object.__setattr__(self, "q_grid", tuple(self.q_grid))
            if not self.q_grid:
                raise SpecError("q_grid= is empty")
            if any(_is_nan(q) for q in self.q_grid):
                raise SpecError(f"q_grid= holds a NaN: {self.q_grid}")
        if self.q_max is not _UNSET and _is_nan(self.q_max):
            raise SpecError("q_max= is NaN")
        if self.objective not in OBJECTIVES:
            raise SpecError(
                f"unknown objective {self.objective!r}; one of {OBJECTIVES}"
            )
        if self.q_grid is not None and self.q_max is not _UNSET:
            raise SpecError("give q_grid= or q_max=, not both")
        if self.objective == "minimax":
            if self.q_grid is not None or self.q_max is not _UNSET:
                raise SpecError(
                    "objective='minimax' computes Q_min and has no Q axis; "
                    "drop q_grid=/q_max="
                )
        if self.objective == "exact_k":
            if self.n_bursts is None or int(self.n_bursts) < 1:
                raise SpecError("objective='exact_k' needs n_bursts >= 1")
            if self.q_grid is not None:
                raise SpecError(
                    "objective='exact_k' takes a single q_max, not a q_grid"
                )
        elif self.n_bursts is not None:
            raise SpecError("n_bursts= only applies to objective='exact_k'")
        if self.k_objective not in ("sum", "max"):
            raise SpecError(
                f"k_objective must be 'sum' or 'max', got {self.k_objective!r}"
            )
        if self.sharding is not None:
            if not isinstance(self.sharding, QGridSharding):
                raise SpecError(
                    f"sharding= must be a QGridSharding, got "
                    f"{type(self.sharding).__name__}"
                )
            if self.objective != "sum":
                raise SpecError(
                    f"sharding shards the Q grid, which only objective='sum' "
                    f"has; objective={self.objective!r} solves per graph — "
                    f"drop sharding="
                )
        if not isinstance(self.backend, str):
            raise SpecError(f"backend= must be a name, got {self.backend!r}")
        if self.cost is not None and not isinstance(
                self.cost, (CostModel, MeasuredCostTable)):
            raise SpecError(
                f"cost= must be a CostModel or a MeasuredCostTable, got "
                f"{type(self.cost).__name__}"
            )
        if self.placement is not None:
            if not isinstance(self.placement, PlacementSpec):
                raise SpecError(
                    f"placement= must be a PlacementSpec, got "
                    f"{type(self.placement).__name__}"
                )
            if self.objective != "sum":
                raise SpecError(
                    f"placement= solves the multi-node E_total DP, which "
                    f"rides objective='sum'; objective={self.objective!r} has "
                    f"no placement form"
                )
            if self.q_grid is not None or self.q_max is not _UNSET:
                raise SpecError(
                    "placement= sweeps per-node budgets via "
                    "PlacementSpec.q_scales (each node's q_max × the scale "
                    "grid); drop q_grid=/q_max="
                )
            if self.sharding is not None:
                raise SpecError(
                    "placement= has no Q grid to shard (its grid axes are "
                    "links × memory_scales × q_scales); drop sharding="
                )
        if self.confidence is not None:
            try:
                c = float(self.confidence)
            except (TypeError, ValueError):
                raise SpecError(
                    f"confidence= must be a float in (0, 1), got {self.confidence!r}"
                ) from None
            if not 0.0 < c < 1.0 or c != c:
                raise SpecError(
                    f"confidence= must lie strictly in (0, 1), got {self.confidence!r}"
                )
            object.__setattr__(self, "confidence", c)

    @property
    def batched(self) -> bool:
        """True when the spec describes a batch (graphs= or config=)."""
        return self.graph is None

    @property
    def q_values(self) -> Tuple[Optional[float], ...]:
        """The normalized Q axis: ``()`` for minimax, one entry per grid
        point otherwise (a lone ``None`` = unbounded when nothing was given).
        """
        if self.objective == "minimax":
            return ()
        if self.q_grid is not None:
            return self.q_grid
        return (None if self.q_max is _UNSET else self.q_max,)


# ---------------------------------------------------------------------------
# Solutions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Solution:
    """What :meth:`Engine.solve` returns: one payload per objective.

    ``backend`` is the resolved backend name; ``graphs`` / ``cost`` /
    ``q_values`` are the resolved inputs (config-lowered graphs included),
    so downstream pricing needs nothing but the solution object. A ``sum``
    solve carries one :class:`~repro_torch.core.partition_torch.TorchSweep`
    per graph, where the reference's carries a ``JaxSweep``.
    """

    spec: PartitionSpec
    backend: str                 # the resolved name; "a+b" for a mixed auto batch
    graphs: Tuple[AnyExport, ...]
    cost: CostModel
    q_values: Tuple[Optional[float], ...]
    sweeps: Optional[Tuple[pt.TorchSweep, ...]] = None   # sum
    parts: Optional[Tuple[Tuple[Partition, ...], ...]] = None  # exact_k
    qmins: Optional[Tuple[float, ...]] = None           # minimax
    placements: Optional[Tuple[PlacementSweep, ...]] = None  # placement=

    @property
    def n_graphs(self) -> int:
        return len(self.graphs)

    def _one(self, what: Optional[tuple], label: str):
        if what is None:
            raise EngineError(
                f"this solution (objective={self.spec.objective!r}, "
                f"backend={self.backend!r}) carries no {label}"
            )
        return what

    @property
    def sweep(self) -> pt.TorchSweep:
        """The single :class:`TorchSweep` of a one-graph ``sum`` spec."""
        sweeps = self._one(self.sweeps, "TorchSweep results")
        if len(sweeps) != 1:
            raise EngineError(
                f"sweep is for single-graph specs; this one has "
                f"{len(sweeps)} — index .sweeps instead"
            )
        return sweeps[0]

    def partitions(self, graph_index: int = 0) -> List[Optional[Partition]]:
        """Per-Q :class:`Partition` objects for one graph (None where
        infeasible)."""
        if self.spec.objective == "minimax":
            raise EngineError(
                "objective='minimax' yields Q_min values; use .q_min()"
            )
        if self.parts is not None:
            return list(self.parts[graph_index])
        g = self.graphs[graph_index]
        if not isinstance(g, TaskGraph):
            raise EngineError(
                "materializing Partition objects needs the TaskGraph; this "
                "spec was built from a CSR export — call "
                ".sweeps[i].to_partitions(graph, cost) with the source graph"
            )
        return self._one(self.sweeps, "sweeps")[graph_index].to_partitions(
            g, self.cost
        )

    def partition(self, graph_index: int = 0, q_index: int = 0) -> Partition:
        """One feasible :class:`Partition`; raises
        :class:`~repro_torch.core.partition.Infeasible` where that
        (graph, Q) cell has none."""
        p = self.partitions(graph_index)[q_index]
        if p is None:
            raise Infeasible(
                f"Q_max={self.q_values[q_index]} admits no partition"
            )
        return p

    def placement_sweep(self, graph_index: int = 0) -> PlacementSweep:
        """The solved :class:`~repro_torch.core.placement.PlacementSweep`
        for one graph (specs with ``placement=``): the full links × memory ×
        Q grid plus the raw DP tables."""
        return self._one(self.placements, "placement sweeps")[graph_index]

    def placement_plan(
        self,
        graph_index: int = 0,
        link_index: int = 0,
        memory_index: int = 0,
        q_index: int = 0,
    ):
        """One grid cell materialized as a
        :class:`~repro_torch.core.placement.PlacementPlan`; raises
        :class:`~repro_torch.core.placement.PlacementError` where
        infeasible."""
        return self.placement_sweep(graph_index).plan(
            link_index, memory_index, q_index
        )

    def q_min(self, graph_index: int = 0) -> float:
        """The §4.4 storage minimum for one graph (objective='minimax')."""
        return self._one(self.qmins, "Q_min values")[graph_index]

    @property
    def q_mins(self) -> Tuple[float, ...]:
        return self._one(self.qmins, "Q_min values")

    def e_total(self, graph_index: int = 0) -> np.ndarray:
        """Optimal E_total per Q grid point (inf where infeasible)."""
        if self.sweeps is not None:
            return np.asarray(self.sweeps[graph_index].e_total)
        parts = self.partitions(graph_index)
        return np.array([np.inf if p is None else p.e_total for p in parts])

    def summary(self) -> str:
        return (
            f"Solution[{self.spec.objective}/{self.backend}] "
            f"{self.n_graphs} graph(s) × {max(len(self.q_values), 1)} Q"
        )


# ---------------------------------------------------------------------------
# Backends (self-registering)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _SolveRequest:
    """Engine-resolved inputs handed to a backend's ``solve``."""

    graphs: Tuple[AnyExport, ...]
    cost: CostModel
    q_values: Tuple[Optional[float], ...]
    objective: str
    n_bursts: Optional[int]
    k_objective: str
    sharding: Optional[QGridSharding] = None
    placement: Optional[PlacementSpec] = None


def _chunk_devices(sharding: QGridSharding, device: str):
    """The sharding's devices for a backend running on ``device``: they must
    be of its type (a CPU backend stays on the CPU)."""
    devices = sharding.devices
    if devices is not None and any(d.type != device for d in devices):
        raise SpecError(
            f"sharding devices {[str(d) for d in devices]} do not match the "
            f"backend's device type {device!r}"
        )
    return devices


@register_backend(
    "numpy",
    objectives=OBJECTIVES,
    supports_csr=False,          # the oracle DP walks the TaskGraph itself
    supports_dense=False,
    supports_placement=True,
    auto_eligible=False,
)
class NumpyBackend:
    """The numpy oracle DP (paper §4.3-§4.4) of :mod:`.partition`.

    Consumes :class:`TaskGraph` objects only; a CSR export raises
    :class:`ExportMismatch`. Its ``sum`` tables come back as a
    :class:`TorchSweep`, so plan tables build on it as on the kernel."""

    name = "numpy"

    def solve(self, req: _SolveRequest) -> dict:
        from .partition import _optimal_k, _optimal_multi, q_min

        if req.placement is not None:
            from .placement import solve_placement_numpy

            return {"placements": tuple(
                solve_placement_numpy(g, req.cost, req.placement) for g in req.graphs
            )}
        if req.objective == "sum":
            sweeps = []
            for g in req.graphs:
                dp, parent = _optimal_multi(g, req.cost, req.q_values)
                sweeps.append(pt.sweep_from_columns(
                    g.n_tasks, req.q_values, dp[:, 1:].T, parent[:, 1:].T))
            return {"sweeps": tuple(sweeps)}
        if req.objective == "minimax":
            return {"qmins": tuple(float(q_min(g, req.cost)) for g in req.graphs)}
        return {
            "parts": tuple(
                (_optimal_k(g, req.cost, req.n_bursts, req.q_values[0],
                            objective=req.k_objective),)
                for g in req.graphs
            )
        }


class _SweepBackend:
    """The CSR sweep in its three modes (:mod:`.partition_torch`), one
    launch per graph and mode, on ``device``."""

    device = "cpu"

    def solve(self, req: _SolveRequest) -> dict:
        dev = self.device
        if req.objective == "sum" and req.sharding is not None:
            return {"sweeps": tuple(pt.sweep_sharded(
                req.graphs, req.cost, req.q_values, n_shards=req.sharding.n_shards,
                devices=_chunk_devices(req.sharding, dev), device=dev))}
        if req.objective == "sum":
            return {"sweeps": tuple(
                pt.sweep(g, req.cost, req.q_values, device=dev) for g in req.graphs
            )}
        if req.objective == "minimax":
            return {"qmins": tuple(
                pt.q_min(g, req.cost, device=dev) for g in req.graphs
            )}
        return {
            "parts": tuple(
                (pt.exact_k_partition(g, req.cost, req.n_bursts, req.q_values[0],
                                      objective=req.k_objective, device=dev),)
                for g in req.graphs
            )
        }


@register_backend("torch", objectives=OBJECTIVES, supports_sharding=True,
                  supports_csr=True, supports_dense=False, auto_eligible=False)
class TorchBackend(_SweepBackend):
    """The sweep's plain PyTorch version on the CPU: bitwise equal to the
    kernel and to the numpy oracles (tests, ``--device cpu``)."""

    name = "torch"
    device = "cpu"


@register_backend("cuda", objectives=OBJECTIVES, supports_sharding=True,
                  supports_csr=True, supports_dense=False)
class CudaBackend(_SweepBackend):
    """The CSR sweep kernel (``kernels/partition_sweep/csrc``) on the card;
    raises without one."""

    name = "cuda"
    device = "cuda"


class _DenseBackend:
    """The dense sweep of :mod:`.partition_torch` on ``device``: a ``sum``
    batch in one padded pass (one per Q chunk when sharded), minimax and
    exact-K per graph; placement grids on :mod:`.placement_torch`."""

    device = "cpu"

    def solve(self, req: _SolveRequest) -> dict:
        from .placement_torch import solve_placement_torch

        dev = self.device
        if req.placement is not None:
            return {"placements": tuple(
                solve_placement_torch(g, req.cost, req.placement, device=dev)
                for g in req.graphs
            )}
        if req.objective == "sum" and req.sharding is not None:
            return {"sweeps": tuple(pt.sweep_sharded(
                req.graphs, req.cost, req.q_values, n_shards=req.sharding.n_shards,
                devices=_chunk_devices(req.sharding, dev), dense=True, device=dev))}
        if req.objective == "sum":
            return {"sweeps": tuple(pt.sweep_dense(req.graphs, req.cost, req.q_values,
                                                   device=dev))}
        if req.objective == "minimax":
            return {"qmins": tuple(pt.q_min_dense(g, req.cost, device=dev)
                                   for g in req.graphs)}
        return {
            "parts": tuple(
                (pt.exact_k_partition_dense(g, req.cost, req.n_bursts, req.q_values[0],
                                            objective=req.k_objective, device=dev),)
                for g in req.graphs
            )
        }


@register_backend("scan", objectives=OBJECTIVES, supports_sharding=True,
                  supports_dense=True, supports_placement=True)
class ScanBackend(_DenseBackend):
    """The dense sweep and the placement grid solver on the card (the
    reference's ``lax.scan`` engines); raises without one."""

    name = "scan"
    device = "cuda"


@register_backend("scan-cpu", objectives=OBJECTIVES, supports_sharding=True,
                  supports_dense=True, supports_placement=True, auto_eligible=False)
class ScanCpuBackend(_DenseBackend):
    """The dense sweep on the CPU (tests, ``--device cpu``): the same code
    as ``scan``."""

    name = "scan-cpu"
    device = "cpu"


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class Engine:
    """Resolve a :class:`PartitionSpec` and dispatch it to one backend.

    Stateless apart from its registry reference; :func:`default_engine` is
    what :func:`repro_torch.api.solve` uses."""

    def __init__(self, registry: Optional[Dict[str, BackendInfo]] = None):
        self._registry = _REGISTRY if registry is None else registry

    @staticmethod
    def _price_cost(spec: PartitionSpec, cost) -> CostModel:
        """The spec's priced CostModel: a :class:`MeasuredCostTable` at
        ``spec.confidence`` (each cut at measured mean + z·sigma); a plain
        CostModel as it is — with ``confidence=`` that is an error, since a
        data-sheet model has no variance to price and the flag would do
        nothing."""
        if isinstance(cost, MeasuredCostTable):
            return cost.cost_model(spec.confidence)
        if spec.confidence is not None:
            raise SpecError(
                f"confidence= prices measured uncertainty and needs cost= to be "
                f"a MeasuredCostTable (repro_torch.core.calibration); a plain "
                f"CostModel ({getattr(cost, 'name', cost)!r}) has no variance "
                f"to price"
            )
        return cost

    def _resolve_graphs(
        self, spec: PartitionSpec
    ) -> Tuple[Tuple[AnyExport, ...], CostModel]:
        if spec.config is not None:
            from ..configs import resolve_config
            from .layer_profile import default_cost_model, lower_config

            cfg = resolve_config(spec.config, smoke=spec.smoke)
            graphs = tuple(
                lower_config(cfg, batch=b, seq=s, kind=spec.kind)
                for (b, s) in spec.shapes
            )
            cost = spec.cost
            if cost is None:
                # an installed calibration is the default measured source, so
                # confidence= works on config-lowered specs without the table
                cost = measured_default(spec.kind) or default_cost_model(spec.kind)
            return graphs, self._price_cost(spec, cost)
        if spec.cost is None:
            raise SpecError(
                "cost= is required for explicit graph specs (config-lowered "
                "specs default it per kind)"
            )
        graphs = (spec.graph,) if spec.graph is not None else spec.graphs
        for g in graphs:
            export_kind(g)  # typed error for non-graph inputs
        return graphs, self._price_cost(spec, spec.cost)

    def resolve_backend(
        self, spec: PartitionSpec, graphs: Sequence[AnyExport]
    ) -> Tuple[str, List[str]]:
        """(label, one backend name per graph): the named backend for every
        graph, or for ``"auto"`` :func:`resolve_auto_backend` per graph — a
        placement spec the first auto-eligible backend with
        ``supports_placement`` (``scan``). ``label`` is the Solution's
        backend: one name, or ``"a+b"`` for a mixed batch."""
        if spec.backend != "auto":
            info = backend_info(spec.backend, self._registry)
            return info.name, [info.name] * len(graphs)
        if spec.placement is not None:
            cands = [b.name for b in self._registry.values()
                     if b.auto_eligible and b.supports_placement]
            if not cands:
                raise SpecError(
                    "no registered auto-eligible backend supports placement "
                    "solves; pass backend='numpy' or register one with "
                    "supports_placement"
                )
            return cands[0], [cands[0]] * len(graphs)
        per_graph = [resolve_auto_backend(g, spec.objective, self._registry)
                     for g in graphs]
        return "+".join(sorted(set(per_graph))), per_graph

    def solve(self, spec: PartitionSpec) -> Solution:
        """Validate, resolve, capability-check, dispatch, wrap."""
        if not isinstance(spec, PartitionSpec):
            raise SpecError(
                f"Engine.solve takes a PartitionSpec, got "
                f"{type(spec).__name__}"
            )
        graphs, cost = self._resolve_graphs(spec)
        label, per_graph = self.resolve_backend(spec, graphs)
        for name in sorted(set(per_graph)):
            info = backend_info(name, self._registry)
            if spec.objective not in info.objectives:
                raise UnsupportedObjective(
                    f"backend {info.name!r} does not implement objective "
                    f"{spec.objective!r} (supported: {sorted(info.objectives)}); "
                    f"backends implementing it: "
                    f"{sorted(b.name for b in self._registry.values() if spec.objective in b.objectives)}"
                )
            if spec.sharding is not None and not info.supports_sharding:
                raise SpecError(
                    f"backend {info.name!r} does not support Q-grid sharding; "
                    f"backends with supports_sharding: "
                    f"{sorted(b.name for b in self._registry.values() if b.supports_sharding)}"
                )
            if spec.placement is not None and not info.supports_placement:
                raise SpecError(
                    f"backend {info.name!r} does not implement placement "
                    f"solves; backends with supports_placement: "
                    f"{sorted(b.name for b in self._registry.values() if b.supports_placement)}"
                )
        for g, name in zip(graphs, per_graph):
            if spec.placement is not None and not isinstance(g, TaskGraph):
                raise ExportMismatch(
                    "placement= needs the TaskGraph (the per-node column "
                    "sweeps walk its structure); pass the graph rather than a "
                    "pre-exported layout"
                )
            if spec.objective == "exact_k" and not isinstance(g, TaskGraph):
                # reconstructed bursts are priced on the graph
                raise ExportMismatch(
                    "objective='exact_k' needs the TaskGraph to price the "
                    "reconstructed bursts; pass the graph rather than a "
                    "pre-exported layout"
                )
            _check_export(backend_info(name, self._registry), g, self._registry)
        with TRACER.span(
            "engine.solve",
            cat="engine",
            pid=PID_SOLVER,
            objective=spec.objective,
            backend=label,
            graphs=len(graphs),
            q_points=len(spec.q_values),
        ):
            payload = self._dispatch(spec, graphs, cost, per_graph)
        return Solution(
            spec=spec,
            backend=label,
            graphs=graphs,
            cost=cost,
            q_values=spec.q_values,
            **payload,
        )

    def _dispatch(self, spec, graphs, cost, per_graph) -> dict:
        """One solve per backend group (one group unless ``auto`` mixed
        layouts), the results put back in the graphs' order."""
        out: Dict[str, list] = {}
        for name in sorted(set(per_graph)):
            idx = [k for k, n in enumerate(per_graph) if n == name]
            req = _SolveRequest(
                graphs=tuple(graphs[k] for k in idx),
                cost=cost,
                q_values=spec.q_values,
                objective=spec.objective,
                n_bursts=spec.n_bursts,
                k_objective=spec.k_objective,
                sharding=spec.sharding,
                placement=spec.placement,
            )
            payload = backend_info(name, self._registry).factory().solve(req)
            for key, vals in payload.items():
                slots = out.setdefault(key, [None] * len(graphs))
                for k, v in zip(idx, vals):
                    slots[k] = v
        return {key: tuple(vals) for key, vals in out.items()}


_DEFAULT_ENGINE = Engine()


def default_engine() -> Engine:
    """The process-wide engine over the global backend registry."""
    return _DEFAULT_ENGINE
