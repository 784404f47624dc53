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

``backend="auto"`` (the default) runs the CSR sweep kernel on the card for
a graph or its CSR export, and the dense sweep (``"scan"``) for a dense
export; it raises without a card. ``backend="torch"`` runs the kernel's
plain version on the CPU, ``"scan-cpu"`` the dense sweep there,
``backend="numpy"`` the oracle DP. All are bitwise equal (the dense sweep
to ~ulp on graphs with more than eight reads in one task).

The Q grid splits into chunks over torch devices, and a placement spec cuts
the chain across N harvesting nodes, sweeping link bandwidth × node memory ×
node budget in one call (``auto`` is the torch grid solver on the card)::

    solve(PartitionSpec(graph=g, cost=cm, q_grid=(1e-3, 5e-3, None),
                        sharding=QGridSharding(n_shards=2)))
    sol = solve(PartitionSpec(graph=g, cost=cm, placement=PlacementSpec(
        nodes=3, links=tuple(LinkModel(bandwidth_mbps=b)
                             for b in range(900, 3400, 100)))))
    sol.placement_plan(link_index=0).summary()

A measured calibration prices the solve instead of the analytical model::

    table = MeasuredCostTable.from_ledger(report.ledger, kind="time")
    solve(PartitionSpec(graph=g, cost=table, confidence=0.9, q_max=q))
    with use_measured(table):              # the default for config specs
        solve(PartitionSpec(config="qwen3-4b", objective="minimax"))
"""

from __future__ import annotations

from .core.calibration import (
    CalibrationError,
    MeasuredCostTable,
    clear_measured_defaults,
    install_measured_default,
    use_measured,
)
from .core.engine import (
    OBJECTIVES,
    BackendInfo,
    Engine,
    EngineError,
    ExportMismatch,
    PartitionSpec,
    QGridSharding,
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
from .core.placement import (
    LinkModel,
    NodeSpec,
    PlacementError,
    PlacementPlan,
    PlacementSpec,
    PlacementSweep,
    PlacementTable,
)

__all__ = [
    "OBJECTIVES",
    "BackendInfo",
    "CalibrationError",
    "Engine",
    "EngineError",
    "ExportMismatch",
    "Infeasible",
    "LinkModel",
    "MeasuredCostTable",
    "NodeSpec",
    "PartitionSpec",
    "PlacementError",
    "PlacementPlan",
    "PlacementSpec",
    "PlacementSweep",
    "PlacementTable",
    "QGridSharding",
    "Solution",
    "SpecError",
    "UnsupportedObjective",
    "backend_info",
    "backend_names",
    "clear_measured_defaults",
    "default_engine",
    "export_kind",
    "install_measured_default",
    "register_backend",
    "solve",
    "use_measured",
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
