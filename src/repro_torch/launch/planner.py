"""Online plan consumption + offline table building (CLI).

The port's copy of ``repro/launch/planner.py``. :class:`ServePlanner` is
the request-path face of a :class:`repro_torch.core.plan_table.PlanTable`:
every query is an O(1) lookup — no DP solve, no graph lowering — and the
planner keeps hit/miss counters.

Besides the serving plan itself, the stored cut points feed the other three
julienne consumers *without re-solving*:

* :meth:`ServePlanner.offload_plan` — price the tabulated bounds as an
  activation-offload schedule (:func:`repro_torch.core.offload.price_offload_bounds`);
* :meth:`ServePlanner.remat_plan` — price them as remat segment boundaries
  (:func:`repro_torch.core.remat_policy.remat_from_bounds`);
* :meth:`ServePlanner.pipeline_cuts` — the interior segment ends as
  pipeline-stage cuts.

:func:`request_cycles` maps a looked-up plan onto a request's token steps:
each step (prefill or one decode) is one traversal of the activation graph
and costs the plan's ``e_total``; consecutive steps are greedily grouped so
each cycle (E_s + steps) fits the energy budget. This is O(n) bookkeeping,
not a partitioner solve.

CLI (offline build)::

    python -m repro_torch.launch.planner --arch qwen3-4b --full \
        --buckets 1x128,4x512 --q-points 16 --out plan_qwen.npz [--device cuda]

builds the Q grid from the buckets' own Q_min .. E_total(whole-app) range
(plus an unbounded entry), solves the whole grid through the façade — the
sweep kernel on the card, or with ``--device cpu`` its plain version — and
writes the versioned table; ``--probe K`` re-validates K random cells
against the live engine after the build. ``--shards`` and ``--extend``
(the reference's sharded DSE) are ROADMAP item 9.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..api import PartitionSpec, solve
from ..configs import resolve_config as _resolve_config
from ..configs.base import ModelConfig
from ..core.layer_profile import (
    build_activation_graph,
    default_cost_model,
    lower_config,
    profile_model,
)
from ..core.offload import OffloadPlan, price_offload_bounds
from ..core.partition import Infeasible, whole_app_partition, within_budget
from ..core.plan_table import (
    PlanTable,
    PlanTableError,
    SegmentPlan,
    build_plan_table,
    probe_plan_table,
)
from ..core.remat_policy import RematPlan, remat_from_bounds

__all__ = [
    "ADMISSION_OUTCOMES",
    "ServePlanner",
    "as_planner",
    "request_cycles",
    "build_table_for_arch",
    "derive_q_grid",
    "lower_buckets",
]


def resolve_config(arch: str, smoke: bool = True) -> ModelConfig:
    """Smoke-first view of :func:`repro_torch.configs.resolve_config` (the
    planner CLI defaults to the smoke registry; ``--full`` takes the
    published widths)."""
    return _resolve_config(arch, smoke=smoke)


#: Admission-control outcomes the traffic harness reports per request.
ADMISSION_OUTCOMES = ("admitted", "deferred", "rejected")


def _fresh_planner_stats() -> Dict[str, object]:
    return {
        "lookups": 0,
        "hits": 0,       # lookups answered from the table
        "misses": 0,     # UnknownBucketError / Infeasible budget
        "admitted": 0,   # admission-control outcomes (see record_admission)
        "deferred": 0,
        "rejected": 0,
        "by_bucket": {},  # "BATCHxSEQ" -> hit count
    }


class ServePlanner:
    """O(1) plan lookups for the serving loop, with observability counters.

    ``stats`` carries per-bucket hit/miss counters (every :meth:`plan_for`
    call) plus the admission counters a traffic harness reports through
    :meth:`record_admission`. Counters are process-lifetime for the planner
    instance; consumers that compare across runs must snapshot-and-diff (or
    call :meth:`reset_stats` for a fresh baseline).
    """

    def __init__(self, table: PlanTable) -> None:
        self.table = table
        self.stats: Dict[str, object] = _fresh_planner_stats()

    def reset_stats(self) -> None:
        """Zero all counters (test isolation / per-run baselines)."""
        self.stats = _fresh_planner_stats()

    @classmethod
    def from_file(
        cls,
        path: str,
        *,
        probe: Optional[Union[ModelConfig, str]] = None,
        probe_k: Optional[int] = 4,
        probe_seed: int = 0,
        probe_cost=None,
        probe_backend: str = "auto",
    ) -> "ServePlanner":
        """Load a table; with ``probe`` (a ModelConfig or registry arch name),
        re-validate ``probe_k`` random cells against the live engine first
        (``probe_backend``; the card by default) — the load-time staleness
        check (raises :class:`repro_torch.core.plan_table.StaleTableError` on
        any bit drift). ``probe_cost`` must name the table's cost model when
        it was built with a non-default one (defaults per table kind)."""
        table = PlanTable.load(path)
        if probe is not None:
            probe_plan_table(table, probe, k=probe_k, seed=probe_seed,
                             cost=probe_cost, backend=probe_backend)
        return cls(table)

    @property
    def e_startup(self) -> float:
        return self.table.e_startup

    def plan_for(
        self, batch: int, seq: int, energy_budget: Optional[float] = None
    ) -> SegmentPlan:
        """Bucket the request shape and return the precomputed plan.

        A successful lookup counts as a *hit* (per-bucket, under the
        ``"BATCHxSEQ"`` key of the covering bucket); an untabulated shape or
        a budget below the Q grid counts as a *miss* and re-raises.
        """
        self.stats["lookups"] += 1
        try:
            plan = self.table.lookup(batch, seq, energy_budget)
        except (PlanTableError, Infeasible):
            self.stats["misses"] += 1
            raise
        self.stats["hits"] += 1
        key = f"{plan.batch}x{plan.seq_bucket}"
        by = self.stats["by_bucket"]
        by[key] = by.get(key, 0) + 1
        return plan

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups answered from the table (0.0 before any)."""
        n = self.stats["lookups"]
        return self.stats["hits"] / n if n else 0.0

    def record_admission(self, outcome: str) -> None:
        """Admission observability: a traffic harness reports each request's
        outcome ('admitted' | 'deferred' | 'rejected') here so the admission
        counters live beside the lookup counters they gate on."""
        if outcome not in ADMISSION_OUTCOMES:
            raise ValueError(
                f"unknown admission outcome {outcome!r}; "
                f"expected one of {ADMISSION_OUTCOMES}"
            )
        self.stats[outcome] += 1

    # -- derived consumers (no DP solve; bounds come from the table) --------

    def _memory_plan(
        self, cfg: ModelConfig, batch: int, seq: int, hbm_budget: float
    ) -> Tuple[SegmentPlan, list, object]:
        if self.table.kind != "memory":
            raise PlanTableError(
                f"offload/remat derivation needs a kind='memory' table, "
                f"this one is kind={self.table.kind!r}"
            )
        if cfg.name != self.table.arch:
            raise PlanTableError(
                f"table was built for {self.table.arch!r}, not {cfg.name!r}"
            )
        plan = self.plan_for(batch, seq, hbm_budget)
        profiles, long_lived = profile_model(cfg, plan.batch, plan.seq_bucket)
        mem_graph = build_activation_graph(profiles, long_lived, kind="memory")
        return plan, profiles, mem_graph

    def offload_plan(
        self, cfg: ModelConfig, batch: int, seq: int, hbm_budget: float
    ) -> OffloadPlan:
        """Tabulated bounds priced as a PCIe offload schedule."""
        plan, profiles, mem_graph = self._memory_plan(cfg, batch, seq, hbm_budget)
        return price_offload_bounds(
            cfg.name, profiles, mem_graph, list(plan.bounds), hbm_budget
        )

    def remat_plan(
        self, cfg: ModelConfig, batch: int, seq: int, hbm_budget: float
    ) -> RematPlan:
        """Tabulated bounds priced as remat segment boundaries."""
        plan, profiles, mem_graph = self._memory_plan(cfg, batch, seq, hbm_budget)
        return remat_from_bounds(
            cfg.name, profiles, mem_graph, list(plan.bounds), hbm_budget
        )

    def pipeline_cuts(
        self, batch: int, seq: int, energy_budget: Optional[float] = None
    ) -> Tuple[int, ...]:
        """Interior segment ends of the looked-up plan — stage cut points."""
        return self.plan_for(batch, seq, energy_budget).cut_points


def as_planner(obj: Union[str, PlanTable, ServePlanner]) -> ServePlanner:
    """Coerce a path / table / planner into a ServePlanner."""
    if isinstance(obj, ServePlanner):
        return obj
    if isinstance(obj, PlanTable):
        return ServePlanner(obj)
    if isinstance(obj, str):
        return ServePlanner.from_file(obj)
    raise TypeError(f"cannot make a ServePlanner from {type(obj).__name__}")


def request_cycles(
    n_steps: int,
    step_energy: float,
    energy_budget: Optional[float] = None,
    e_startup: float = 0.0,
) -> List[Tuple[int, int]]:
    """Greedy grouping of token steps into energy-bounded cycles (1-based).

    Uses the shared solver tolerance (:func:`within_budget`) so a request
    whose steps exactly fill the budget is not split by float noise. With no
    budget the whole request is one cycle; a single step that alone exceeds
    the budget still forms its own cycle (its interior segmentation fits Q by
    table construction).
    """
    if n_steps <= 0:
        return []
    if energy_budget is None:
        return [(1, n_steps)]
    bounds: List[Tuple[int, int]] = []
    start = 1
    acc = e_startup + step_energy  # step `start` is always admitted
    for k in range(2, n_steps + 1):
        if within_budget(acc + step_energy, energy_budget):
            acc += step_energy
        else:
            bounds.append((start, k - 1))
            start = k
            acc = e_startup + step_energy
    bounds.append((start, n_steps))
    return bounds


def lower_buckets(
    cfg: ModelConfig, shape_buckets: List[Tuple[int, int]], kind: str = "time"
):
    """One lowered activation graph per (batch, seq) bucket."""
    return [lower_config(cfg, batch=b, seq=s, kind=kind)
            for (b, s) in shape_buckets]


def derive_q_grid(graphs, cm, n_q: int = 16, backend: str = "auto") -> List[Optional[float]]:
    """The standard offline Q grid for a bucket set: geometric from
    [min over buckets of Q_min, max whole-app E_total × 1.05] plus one
    unbounded entry, so every bucket has both fully-julienned and
    single-cycle plans tabulated.

    Q_min goes through the façade's minimax objective on ``backend`` (the
    sweep kernel's minimax mode on the card by default), the engine the
    rest of the table build uses.
    """
    lo = min(
        solve(PartitionSpec(graph=g, cost=cm, objective="minimax",
                            backend=backend)).q_min()
        for g in graphs
    )
    hi = max(whole_app_partition(g, cm).e_total * 1.05 for g in graphs)
    qs: List[Optional[float]] = list(np.geomspace(lo, max(hi, lo * 1.0001), n_q))
    qs.append(None)
    return qs


def build_table_for_arch(
    arch: str,
    shape_buckets: List[Tuple[int, int]],
    n_q: int = 16,
    *,
    smoke: bool = True,
    kind: str = "time",
    cache_dir: Optional[str] = None,
    backend: str = "auto",
) -> PlanTable:
    """Convenience offline build: derive the Q grid from the buckets
    (:func:`derive_q_grid`) and solve the whole grid in one batched façade
    call on ``backend`` (the sweep kernel on the card by default)."""
    cfg = resolve_config(arch, smoke)
    cm = default_cost_model(kind)
    graphs = lower_buckets(cfg, shape_buckets, kind)
    qs = derive_q_grid(graphs, cm, n_q, backend=backend)
    return build_plan_table(
        cfg, shape_buckets, qs, kind=kind, cost=cm, cache_dir=cache_dir,
        graphs=graphs, backend=backend,
    )


def _parse_buckets(text: str) -> List[Tuple[int, int]]:
    """Parse comma-separated ``BATCHxSEQ`` bucket tokens (e.g. ``2x24,4x48``).

    Each token must be two positive integers joined by an ``x`` (case
    insensitive). Malformed tokens raise a ValueError naming the offending
    entry — previously ``"2x"`` or ``"2x24,48"`` died with an opaque
    "not enough values to unpack".
    """
    out = []
    for part in text.split(","):
        token = part.strip().lower()
        batch_s, sep, seq_s = token.partition("x")
        try:
            if not sep or not batch_s or not seq_s:
                raise ValueError
            bucket = (int(batch_s), int(seq_s))
            if bucket[0] <= 0 or bucket[1] <= 0:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"malformed bucket {part.strip()!r} in {text!r}: expected "
                f"BATCHxSEQ with positive integers (e.g. 2x24)"
            ) from None
        out.append(bucket)
    return out


# --device → the façade backend the build and the probe run on
_BACKEND_OF_DEVICE = {"cuda": "cuda", "cpu": "torch"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--buckets", default="2x24,2x48",
                    help="comma-separated BATCHxSEQ buckets, e.g. 2x24,4x48")
    ap.add_argument("--q-points", type=int, default=16,
                    help="geometric Q grid size (an unbounded point is added)")
    ap.add_argument("--kind", choices=("time", "memory"), default="time",
                    help="cost interpretation")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--full", action="store_true",
                    help="use the full config instead of the smoke config")
    ap.add_argument("--device", choices=sorted(_BACKEND_OF_DEVICE), default="cuda",
                    help="cuda: the sweep kernel on the card; cpu: its plain "
                    "version on the host")
    ap.add_argument("--shards", type=int, default=None,
                    help="not supported by the port (ROADMAP item 9)")
    ap.add_argument("--extend", action="store_true",
                    help="not supported by the port (ROADMAP item 9)")
    ap.add_argument("--probe", type=int, default=0,
                    help="re-validate this many random cells against the "
                    "live engine after the build")
    args = ap.parse_args(argv)
    if args.shards is not None or args.extend:
        ap.error("--shards and --extend need the sharded DSE (launch/dse.py), "
                 "which is ROADMAP item 9 and not ported yet")

    backend = _BACKEND_OF_DEVICE[args.device]
    buckets = _parse_buckets(args.buckets)
    t0 = time.time()
    table = build_table_for_arch(
        args.arch, buckets, args.q_points, smoke=not args.full,
        kind=args.kind, backend=backend,
    )
    table.save(args.out)
    print(f"[planner] built {table.summary()} in {time.time() - t0:.2f}s "
          f"on {args.device} → {args.out}")
    if args.probe:
        n = probe_plan_table(
            table, resolve_config(args.arch, smoke=not args.full), k=args.probe,
            backend=backend,
        )
        print(f"[planner]   probe: {n} cells re-validated — clean")
    for b, (batch, seq) in enumerate(table.buckets()):
        plan = table.plan_at(b, table.q_index(None))
        print(f"[planner]   {plan.summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
