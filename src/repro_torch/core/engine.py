"""One Julienning façade: declarative :class:`PartitionSpec` → :class:`Engine`.

The port's copy of ``repro/core/engine.py``. Callers build one immutable
:class:`PartitionSpec` —

* **what** to partition: a :class:`~repro_torch.core.graph.TaskGraph` (or
  its CSR export), a batch of graphs, or a model-zoo config plus
  (batch, seq) shapes to lower;
* **what to optimize**: ``objective="sum"`` (the paper's E_total DP over a
  Q_max grid), ``"minimax"`` (§4.4 storage minimization, Q_min) or
  ``"exact_k"`` (the fixed-burst-count DP);
* **where** to solve it: ``backend="numpy" | "torch" | "cuda" | "auto"``

— and :meth:`Engine.solve` resolves it through a backend *registry*.
``numpy`` is the oracle DP of :mod:`.partition`; ``torch`` runs the sweep's
plain PyTorch version on the CPU (tests, ``--device cpu``); ``cuda`` runs
the CSR sweep kernel on the card in the matching mode. ``auto`` resolves to
``cuda`` for every graph: the CSR kernel is the only engine the port has,
and ``auto`` never drops to the CPU — without a card it raises, as
``device="cuda"`` does. Mismatches raise typed errors:
:class:`ExportMismatch` for a layout a backend cannot consume,
:class:`UnsupportedObjective` for an objective it does not implement.

The reference's ``sharding=``, ``placement=``, ``confidence=`` (and a
measured cost table as ``cost=``) and ``interpret=`` have no counterpart in
the port yet; a spec that sets one raises :class:`SpecError` naming the
ROADMAP item that brings it.

Most callers go through :mod:`repro_torch.api`, which re-exports this
module's public names and the :func:`~repro_torch.api.solve` convenience.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..obs.trace import PID_SOLVER, TRACER
from . import partition_torch as pt
from .cost import CostModel
from .graph import GraphCSRArrays, TaskGraph
from .partition import Infeasible, Partition

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
    "PartitionSpec",
    "Solution",
    "Engine",
    "default_engine",
    "OBJECTIVES",
]

AnyExport = Union[TaskGraph, GraphCSRArrays]

OBJECTIVES = ("sum", "minimax", "exact_k")


# ---------------------------------------------------------------------------
# Typed errors
# ---------------------------------------------------------------------------


class EngineError(ValueError):
    """Base class for façade errors (spec validation, dispatch, capability)."""


class SpecError(EngineError):
    """Malformed or self-contradictory :class:`PartitionSpec`, or a field the
    port does not implement yet."""


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
    ``supports_csr`` declares that it consumes :class:`GraphCSRArrays`
    exports (every backend accepts a :class:`TaskGraph`); ``auto_eligible``
    marks the backends ``backend="auto"`` may pick."""

    name: str
    factory: Any
    objectives: frozenset
    supports_csr: bool = False
    auto_eligible: bool = True


_REGISTRY: Dict[str, BackendInfo] = {}


def register_backend(
    name: str,
    *,
    objectives: Sequence[str] = ("sum",),
    supports_csr: bool = False,
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
            supports_csr=supports_csr,
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
    """Classify a solver input: ``"graph"`` / ``"csr"``."""
    if isinstance(graph, TaskGraph):
        return "graph"
    if isinstance(graph, GraphCSRArrays):
        return "csr"
    raise ExportMismatch(
        f"cannot solve a {type(graph).__name__}: expected a TaskGraph or a "
        f"GraphCSRArrays export"
    )


# ---------------------------------------------------------------------------
# The declarative spec
# ---------------------------------------------------------------------------


class _Unset:
    """Sentinel distinguishing 'q_max not given' from 'q_max=None=unbounded'."""

    def __repr__(self):  # pragma: no cover - repr only
        return "<unset>"


_UNSET = _Unset()

# Fields of the reference's spec that the port does not implement yet, and
# the ROADMAP queue-1 item that brings each.
_NOT_PORTED = {
    "sharding": "Q-grid sharding is ROADMAP item 9 (sharded DSE)",
    "placement": "swarm placement is ROADMAP item 8",
    "confidence": "measured-cost confidence pricing is ROADMAP item 6 (calibration)",
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
    it per ``kind`` as the plan-table builders do. ``backend`` names a
    registered backend or ``"auto"``. ``sharding``, ``placement``,
    ``confidence`` and ``interpret`` exist so that a spec written for the
    reference fails loudly here: any value but ``None`` raises
    :class:`SpecError`.
    """

    graph: Optional[AnyExport] = None
    graphs: Optional[Tuple[AnyExport, ...]] = None
    config: Optional[Any] = None          # ModelConfig or registry arch name
    shapes: Tuple[Tuple[int, int], ...] = ((1, 128),)
    kind: str = "time"
    smoke: bool = False
    cost: Optional[CostModel] = None
    q_grid: Optional[Tuple[Optional[float], ...]] = None
    q_max: Any = _UNSET
    objective: str = "sum"
    n_bursts: Optional[int] = None
    k_objective: str = "sum"
    backend: str = "auto"
    sharding: Any = None
    interpret: Any = None
    confidence: Any = None
    placement: Any = None

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
        if not isinstance(self.backend, str):
            raise SpecError(f"backend= must be a name, got {self.backend!r}")
        if self.cost is not None and not isinstance(self.cost, CostModel):
            raise SpecError(
                f"cost= must be a CostModel, got {type(self.cost).__name__} "
                f"(a measured cost table is ROADMAP item 6, calibration)"
            )

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
    backend: str
    graphs: Tuple[AnyExport, ...]
    cost: CostModel
    q_values: Tuple[Optional[float], ...]
    sweeps: Optional[Tuple[pt.TorchSweep, ...]] = None   # sum
    parts: Optional[Tuple[Tuple[Partition, ...], ...]] = None  # exact_k
    qmins: Optional[Tuple[float, ...]] = None           # minimax

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


@register_backend(
    "numpy",
    objectives=OBJECTIVES,
    supports_csr=False,          # the oracle DP walks the TaskGraph itself
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


@register_backend("torch", objectives=OBJECTIVES, supports_csr=True,
                  auto_eligible=False)
class TorchBackend(_SweepBackend):
    """The sweep's plain PyTorch version on the CPU: bitwise equal to the
    kernel and to the numpy oracles (tests, ``--device cpu``)."""

    name = "torch"
    device = "cpu"


@register_backend("cuda", objectives=OBJECTIVES, supports_csr=True)
class CudaBackend(_SweepBackend):
    """The CSR sweep kernel (``kernels/partition_sweep/csrc``) on the card;
    raises without one."""

    name = "cuda"
    device = "cuda"


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class Engine:
    """Resolve a :class:`PartitionSpec` and dispatch it to one backend.

    Stateless apart from its registry reference; :func:`default_engine` is
    what :func:`repro_torch.api.solve` uses."""

    def __init__(self, registry: Optional[Dict[str, BackendInfo]] = None):
        self._registry = _REGISTRY if registry is None else registry

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
            cost = spec.cost if spec.cost is not None else default_cost_model(spec.kind)
            return graphs, cost
        if spec.cost is None:
            raise SpecError(
                "cost= is required for explicit graph specs (config-lowered "
                "specs default it per kind)"
            )
        graphs = (spec.graph,) if spec.graph is not None else spec.graphs
        for g in graphs:
            export_kind(g)  # typed error for non-graph inputs
        return graphs, spec.cost

    def resolve_backend(self, spec: PartitionSpec) -> BackendInfo:
        """The named backend, or for ``"auto"`` the first auto-eligible
        backend implementing the objective (``cuda`` in the default
        registry, whatever the graph)."""
        if spec.backend != "auto":
            return backend_info(spec.backend, self._registry)
        cands = [b for b in self._registry.values()
                 if b.auto_eligible and spec.objective in b.objectives]
        if not cands:
            raise UnsupportedObjective(
                f"no registered auto-eligible backend implements objective "
                f"{spec.objective!r} (registered: {sorted(self._registry)})"
            )
        return cands[0]

    def solve(self, spec: PartitionSpec) -> Solution:
        """Validate, resolve, capability-check, dispatch, wrap."""
        if not isinstance(spec, PartitionSpec):
            raise SpecError(
                f"Engine.solve takes a PartitionSpec, got "
                f"{type(spec).__name__}"
            )
        graphs, cost = self._resolve_graphs(spec)
        info = self.resolve_backend(spec)
        if spec.objective not in info.objectives:
            raise UnsupportedObjective(
                f"backend {info.name!r} does not implement objective "
                f"{spec.objective!r} (supported: {sorted(info.objectives)}); "
                f"backends implementing it: "
                f"{sorted(b.name for b in self._registry.values() if spec.objective in b.objectives)}"
            )
        for g in graphs:
            if spec.objective == "exact_k" and not isinstance(g, TaskGraph):
                # reconstructed bursts are priced on the graph
                raise ExportMismatch(
                    "objective='exact_k' needs the TaskGraph to price the "
                    "reconstructed bursts; pass the graph rather than a "
                    "pre-exported layout"
                )
            if export_kind(g) == "csr" and not info.supports_csr:
                raise ExportMismatch(
                    f"backend {info.name!r} does not consume GraphCSRArrays "
                    f"exports; pass the TaskGraph or pick a backend with "
                    f"supports_csr (registered: "
                    f"{[b.name for b in self._registry.values() if b.supports_csr]})"
                )
        req = _SolveRequest(
            graphs=graphs,
            cost=cost,
            q_values=spec.q_values,
            objective=spec.objective,
            n_bursts=spec.n_bursts,
            k_objective=spec.k_objective,
        )
        with TRACER.span(
            "engine.solve",
            cat="engine",
            pid=PID_SOLVER,
            objective=spec.objective,
            backend=info.name,
            graphs=len(graphs),
            q_points=len(spec.q_values),
        ):
            payload = info.factory().solve(req)
        return Solution(
            spec=spec,
            backend=info.name,
            graphs=graphs,
            cost=cost,
            q_values=spec.q_values,
            **payload,
        )


_DEFAULT_ENGINE = Engine()


def default_engine() -> Engine:
    """The process-wide engine over the global backend registry."""
    return _DEFAULT_ENGINE
