"""Pipeline-stage partitioning via Julienning (``repro/core/pipeline.py``).

A K-stage pipeline of a layer stack is the paper's problem: tasks =
layers, packets = boundary activations, burst = stage, E_r = the hop that
moves the boundary activation to the next stage's card, and the *minimax*
objective (§4.4) with exactly K bursts minimizes the bottleneck stage, the
quantity that sets pipeline throughput. The port prices hops with
:func:`~.cost.h100_pipeline_model` (H100 cards joined by NVLink), where
``repro`` prices them on TPU ICI. Dependency awareness pays on
heterogeneous stacks: cutting zamba2 after a Mamba2 block moves only the
[B, S, d] activation, while a stage holding a shared-attention block also
loads the embedding that block reads, once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..configs.base import ModelConfig
from .cost import h100_pipeline_model
from .engine import PartitionSpec, default_engine
from .layer_profile import build_activation_graph, profile_model

__all__ = ["PipelinePlan", "plan_pipeline"]


@dataclasses.dataclass
class PipelinePlan:
    cfg_name: str
    n_stages: int
    bounds: List[Tuple[int, int]]        # layer index ranges per stage (1-based)
    stage_seconds: List[float]           # compute+comm per stage
    stage_weight_bytes: List[int]
    comm_bytes: List[int]                # bytes entering each stage
    bottleneck_seconds: float
    total_seconds: float

    @property
    def balance(self) -> float:
        """bottleneck / mean — 1.0 is a perfectly balanced pipeline."""
        mean = self.total_seconds / max(self.n_stages, 1)
        return self.bottleneck_seconds / mean if mean else 1.0

    def summary(self) -> str:
        return (f"{self.cfg_name}: {self.n_stages} stages, bottleneck "
                f"{self.bottleneck_seconds * 1e3:.3f} ms, balance "
                f"{self.balance:.3f}, max stage weights "
                f"{max(self.stage_weight_bytes) / 1e9:.2f} GB")


def plan_pipeline(cfg: ModelConfig, batch: int, seq: int, n_stages: int,
                  objective: str = "max") -> PipelinePlan:
    """``n_stages`` stages of ``cfg``'s time-kind activation graph at
    (``batch``, ``seq``): the exact-K DP on numpy, combining stages by
    ``objective`` ("max": the bottleneck; "sum": the total)."""
    profiles, long_lived = profile_model(cfg, batch, seq)
    graph = build_activation_graph(profiles, long_lived, kind="time")
    part = default_engine().solve(PartitionSpec(
        graph=graph, cost=h100_pipeline_model(), objective="exact_k", n_bursts=n_stages,
        k_objective=objective, backend="numpy",
    )).partition()
    return PipelinePlan(
        cfg_name=cfg.name,
        n_stages=n_stages,
        bounds=part.bounds,
        stage_seconds=[b.total for b in part.bursts],
        stage_weight_bytes=[sum(p.weight_bytes for p in profiles[i - 1:j])
                            for (i, j) in part.bounds],
        comm_bytes=[b.read_bytes for b in part.bursts],
        bottleneck_seconds=part.max_burst,
        total_seconds=part.e_total,
    )
