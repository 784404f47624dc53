"""Activation-offload pricing via Julienning: the pricing half of
``repro/core/offload.py``.

Volatile memory = HBM, NVM = pinned host memory over PCIe — the paper's
memory hierarchy, one level up. An activation graph partitioned under the
**memory cost model** (burst "energy" = activation working set in bytes,
Q_max = the HBM activation budget) is *priced* here under the H100's PCIe
time model (``c0 + bytes/bw``, the shape of the paper's FRAM model):
:func:`price_offload_bounds` prices *given* segment bounds (e.g. the cut
points stored in a :class:`repro_torch.core.plan_table.PlanTable`) without
any DP solve, and :func:`min_activation_budget` is Q_min (§4.4) under the
memory model. The solving half (``plan_offload``) is ROADMAP item 10.
Budget feasibility uses the global tolerance of :mod:`.partition`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from ..configs.base import ModelConfig
from .burst import burst_detail
from .cost import PEAK_FLOPS, h100_host_offload_model
from .graph import TaskGraph
from .layer_profile import (
    LayerProfile,
    build_activation_graph,
    memory_cost_model,
    profile_model,
)
from .partition import Infeasible, q_min, within_budget

__all__ = ["OffloadPlan", "price_offload_bounds", "min_activation_budget"]


@dataclasses.dataclass
class OffloadPlan:
    cfg_name: str
    hbm_budget_bytes: float
    bounds: List[Tuple[int, int]]
    segment_peak_bytes: List[float]      # working set per segment (≤ budget)
    offload_bytes: List[int]             # bytes pushed to host at each boundary
    pcie_seconds: float                  # total offload+reload time
    compute_seconds: float               # total compute time (for overlap check)

    @property
    def n_segments(self) -> int:
        return len(self.bounds)

    @property
    def overhead_fraction(self) -> float:
        """PCIe time / compute time — < 1 means fully overlappable."""
        return self.pcie_seconds / max(self.compute_seconds, 1e-30)

    def summary(self) -> str:
        return (f"{self.cfg_name}: {self.n_segments} segments under "
                f"{self.hbm_budget_bytes / 1e9:.2f} GB, offload "
                f"{sum(self.offload_bytes) / 1e9:.2f} GB, PCIe "
                f"{self.pcie_seconds * 1e3:.2f} ms "
                f"({100 * self.overhead_fraction:.1f}% of compute)")


def min_activation_budget(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Q_min (§4.4) under the memory model: the smallest HBM activation
    budget for which any offload segmentation exists (numpy DP)."""
    profiles, long_lived = profile_model(cfg, batch, seq)
    graph = build_activation_graph(profiles, long_lived, kind="memory")
    return q_min(graph, memory_cost_model())


def price_offload_bounds(
    cfg_name: str,
    profiles: List[LayerProfile],
    mem_graph: TaskGraph,
    bounds: Sequence[Tuple[int, int]],
    hbm_budget_bytes: float,
) -> OffloadPlan:
    """Price a given segmentation under the PCIe time model — no DP solve.

    Each segment's memory working set is validated against the budget with
    the shared solver tolerance, so a plan that a solver would accept
    prices here without spurious Infeasible flips.
    """
    mem = memory_cost_model()
    bursts = [burst_detail(mem_graph, mem, i, j) for (i, j) in bounds]
    for b in bursts:
        if not within_budget(b.total, hbm_budget_bytes):
            raise Infeasible(
                f"{cfg_name}: segment ⟨{b.i},{b.j}⟩ working set {b.total:.4g} B "
                f"exceeds the {hbm_budget_bytes:.4g} B HBM budget"
            )

    pcie = h100_host_offload_model()
    pcie_s = 0.0
    offload_bytes = []
    for b in bursts:
        w = sum(mem_graph.packets[n].nbytes for n in b.stores)
        r = sum(mem_graph.packets[n].nbytes for n in b.loads)
        pcie_s += (pcie.write.bytes_cost(w) if w else 0.0)
        pcie_s += (pcie.read.bytes_cost(r) if r else 0.0)
        offload_bytes.append(w)

    compute_s = sum(p.flops for p in profiles) / PEAK_FLOPS
    return OffloadPlan(
        cfg_name=cfg_name,
        hbm_budget_bytes=hbm_budget_bytes,
        bounds=list(bounds),
        segment_peak_bytes=[b.total for b in bursts],
        offload_bytes=offload_bytes,
        pcie_seconds=pcie_s,
        compute_seconds=compute_s,
    )
