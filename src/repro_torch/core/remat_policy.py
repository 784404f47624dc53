"""Memory-bounded remat pricing via Julienning: the pricing half of
``repro/core/remat_policy.py``.

Same activation graph, third cost interpretation: crossing a segment
boundary *saves* the boundary activation (HBM bytes) and the backward pass
*recomputes* the segment interior (FLOPs, priced at the H100's bf16 peak).
:func:`remat_from_bounds` prices *given* boundaries (e.g. the cut points
stored in a plan table) with no DP solve. The solving half (``plan_remat``,
``segments_for_scan``) is ROADMAP item 10. Budget feasibility uses the
global solver tolerance of :mod:`.partition`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .cost import PEAK_FLOPS
from .graph import TaskGraph
from .layer_profile import LayerProfile, memory_cost_model
from .partition import Infeasible, Partition, _partition_from_bounds, within_budget

__all__ = ["RematPlan", "remat_from_bounds"]


@dataclasses.dataclass
class RematPlan:
    cfg_name: str
    hbm_budget_bytes: float
    bounds: List[Tuple[int, int]]
    saved_bytes: int                 # boundary activations kept in HBM
    recompute_seconds: float         # extra forward time paid in backward
    compute_seconds: float           # one clean forward

    @property
    def n_segments(self) -> int:
        return len(self.bounds)

    @property
    def recompute_fraction(self) -> float:
        return self.recompute_seconds / max(self.compute_seconds, 1e-30)

    def summary(self) -> str:
        return (f"{self.cfg_name}: {self.n_segments} remat segments under "
                f"{self.hbm_budget_bytes / 1e9:.2f} GB, saved "
                f"{self.saved_bytes / 1e9:.2f} GB, recompute overhead "
                f"{100 * self.recompute_fraction:.1f}%")


def _saved_and_recompute(
    profiles: List[LayerProfile],
    mem_graph: TaskGraph,
    part: Partition,
) -> Tuple[int, float]:
    """(boundary bytes kept in HBM, recompute FLOPs) for a segmentation.

    The backward pass recomputes each segment's interior; layers whose
    outputs are saved boundaries need no recompute — so more (smaller)
    segments trade HBM for less recompute.
    """
    saved = sum(
        mem_graph.packets[n].nbytes for b in part.bursts for n in b.stores
    )
    boundary_layers = {j for (_, j) in part.bounds}
    recompute = sum(
        p.flops for idx, p in enumerate(profiles, start=1)
        if idx not in boundary_layers
    )
    return int(saved), recompute


def remat_from_bounds(
    cfg_name: str,
    profiles: List[LayerProfile],
    mem_graph: TaskGraph,
    bounds: Sequence[Tuple[int, int]],
    hbm_budget_bytes: float,
) -> RematPlan:
    """Price a given remat segmentation — no DP solve (plan-table path).

    Feasibility (saved boundaries + largest transient working set ≤ budget)
    uses the shared solver tolerance.
    """
    mem = memory_cost_model()
    part = _partition_from_bounds(mem_graph, mem, list(bounds), None)
    saved, rec_flops = _saved_and_recompute(profiles, mem_graph, part)
    if not within_budget(saved + part.max_burst, hbm_budget_bytes):
        raise Infeasible(
            f"{cfg_name}: saved boundaries ({saved / 1e9:.2f} GB) + transient "
            f"peak ({part.max_burst / 1e9:.2f} GB) exceed the "
            f"{hbm_budget_bytes / 1e9:.2f} GB budget"
        )
    compute = sum(p.flops for p in profiles) / PEAK_FLOPS
    return RematPlan(
        cfg_name=cfg_name,
        hbm_budget_bytes=hbm_budget_bytes,
        bounds=list(bounds),
        saved_bytes=saved,
        recompute_seconds=rec_flops / PEAK_FLOPS,
        compute_seconds=compute,
    )
