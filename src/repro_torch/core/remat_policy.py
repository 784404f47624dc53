"""Memory-bounded remat segmentation via Julienning
(``repro/core/remat_policy.py``).

Same activation graph, third cost interpretation: crossing a segment
boundary *saves* the boundary activation (HBM bytes) and the backward pass
*recomputes* the segment interior (FLOPs, priced at the H100's bf16 peak).
:func:`plan_remat` sweeps Q and keeps the feasible segmentation with the
least recompute; :func:`remat_from_bounds` prices *given* boundaries (e.g.
the cut points stored in a plan table) with no DP solve;
:func:`segments_for_scan` turns a plan into the (n_segments, seg_len) of a
uniform segmentation of a homogeneous stack. Budget feasibility uses the
global solver tolerance of :mod:`.partition`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ModelConfig
from .cost import PEAK_FLOPS
from .engine import PartitionSpec, default_engine
from .graph import TaskGraph
from .layer_profile import LayerProfile, build_activation_graph, memory_cost_model, profile_model
from .partition import Infeasible, Partition, _partition_from_bounds, q_min, within_budget

__all__ = ["RematPlan", "plan_remat", "remat_from_bounds", "segments_for_scan"]

Q_POINTS = 24  # the per-segment bounds plan_remat sweeps


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


def plan_remat(cfg: ModelConfig, batch: int, seq: int,
               hbm_budget_bytes: float) -> RematPlan:
    """The least recompute subject to (saved boundaries + the largest
    segment's transient working set) ≤ ``hbm_budget_bytes``.

    Saved boundaries occupy HBM until the backward pass, so the budget binds
    their sum plus one segment's working set. The per-segment bound Q is
    swept over ``Q_POINTS`` geometric points from Q_min to the budget, one
    numpy solve over the grid; the first candidate with strictly less
    recompute than those before it wins. Raises ``Infeasible`` when none
    fits."""
    profiles, long_lived = profile_model(cfg, batch, seq)
    mem_graph = build_activation_graph(profiles, long_lived, kind="memory")
    mem = memory_cost_model()
    qmn = q_min(mem_graph, mem)
    qs = tuple(np.geomspace(qmn, max(hbm_budget_bytes, qmn * 1.0001), Q_POINTS))
    cands = default_engine().solve(PartitionSpec(
        graph=mem_graph, cost=mem, q_grid=qs, backend="numpy")).partitions()
    part: Optional[Partition] = None
    best = None
    for cand in cands:
        if cand is None:
            continue
        saved, rec = _saved_and_recompute(profiles, mem_graph, cand)
        if not within_budget(saved + cand.max_burst, hbm_budget_bytes):
            continue
        if best is None or rec < best:
            best, part = rec, cand
    if part is None:
        raise Infeasible(
            f"no remat segmentation fits {hbm_budget_bytes / 1e9:.2f} GB "
            f"(transient Q_min alone is {qmn / 1e9:.2f} GB)")
    return remat_from_bounds(cfg.name, profiles, mem_graph, part.bounds, hbm_budget_bytes)


def segments_for_scan(n_layers: int, plan: RematPlan) -> Tuple[int, int]:
    """(n_segments, seg_len) for a double-loop lowering: the divisor of
    ``n_layers`` closest to the plan's segment count (the smaller on a tie)."""
    want = max(plan.n_segments, 1)
    best = min((s for s in range(1, n_layers + 1) if n_layers % s == 0),
               key=lambda s: abs(s - want))
    return best, n_layers // best
