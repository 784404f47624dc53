"""The port's public Julienning API: declarative specs in, solutions out.

The counterpart of ``repro/api.py``: the energy-bounded partition DP, the
§4.4 storage minimax and the exact-K DP, on single graphs, batches or
model-zoo lowerings, through one call::

    from repro_torch.api import PartitionSpec, solve

    sol = solve(PartitionSpec(graph=g, cost=cm, q_max=132e-3))
    part = sol.partition()                 # a repro_torch.core.partition.Partition

    solve(PartitionSpec(graph=g, cost=cm, objective="minimax")).q_min()
    solve(PartitionSpec(graph=g, cost=cm, objective="exact_k",
                        n_bursts=4, k_objective="max")).partition()

``backend="auto"`` (the default) runs the CSR sweep kernel on the card and
raises without one; ``backend="torch"`` runs its plain version on the CPU,
``backend="numpy"`` the oracle DP. All three are bitwise equal.
"""

from __future__ import annotations

from .core.engine import (
    OBJECTIVES,
    BackendInfo,
    Engine,
    EngineError,
    ExportMismatch,
    PartitionSpec,
    Solution,
    SpecError,
    UnsupportedObjective,
    backend_info,
    backend_names,
    default_engine,
    export_kind,
    register_backend,
)
from .core.partition import Infeasible

__all__ = [
    "OBJECTIVES",
    "BackendInfo",
    "Engine",
    "EngineError",
    "ExportMismatch",
    "Infeasible",
    "PartitionSpec",
    "Solution",
    "SpecError",
    "UnsupportedObjective",
    "backend_info",
    "backend_names",
    "default_engine",
    "export_kind",
    "register_backend",
    "solve",
]


def solve(spec: PartitionSpec = None, **kwargs) -> Solution:
    """Solve a :class:`PartitionSpec` on the default engine.

    Accepts a prebuilt spec (positionally or as ``spec=``) or the spec's
    keyword arguments directly (``solve(graph=g, cost=cm, q_max=0.1)`` ≡
    ``solve(PartitionSpec(graph=g, cost=cm, q_max=0.1))``).
    """
    if spec is None:
        spec = PartitionSpec(**kwargs)
    elif kwargs:
        raise SpecError("pass a PartitionSpec or keywords, not both")
    return default_engine().solve(spec)
