"""Precomputed Q-grid segment-plan tables (the serving-path integration).

The port's copy of ``repro/core/plan_table.py``. The paper's claim is that
energy-bounded execution cycles are planned *ahead of time* and replayed
cheaply at runtime. An **offline** builder solves the whole (shape-bucket ×
Q_max) design space through the façade (:func:`repro_torch.api.solve`, one
sweep-kernel launch per bucket on the card), and the **online** side
(:mod:`repro_torch.launch.planner`) answers every request with an O(1)
table lookup — no DP solve on the request path.

Table contents, per (bucket b, Q index k): the reconstructed segment bounds
(the julienne cut points, which double as offload, remat and pipeline cuts
for the planners), the per-cycle energy of every segment, and ``e_total`` /
``feasible`` for the whole request shape.

Serialization is one ``.npz`` whose ``header`` entry is a JSON document
carrying the format version, the architecture, the cost-model scalars and a
config fingerprint — the reference's format byte for byte, so a table
either package writes loads in the other. :func:`PlanTable.load` refuses
other versions (:class:`StaleTableError`) and :func:`build_plan_table`
keys its on-disk cache by the fingerprint, so a table built for one
(config, buckets, Q grid, cost model) can never silently serve another.

:func:`extend_plan_table` appends buckets / Q points without re-solving any
existing cell (the header's ``lineage`` records each step);
:func:`probe_plan_table` re-solves K random cells against the live engine
and raises :class:`StaleTableError` on any bit mismatch. Tables are
**canonical**: buckets sort by (batch, seq) and the Q grid ascending
(unbounded last), so the same design-space set gives the same bytes however
it was built. ``build_plan_table(..., sharding=QGridSharding(...))`` and
``extend_plan_table(..., n_shards=)`` split the Q grid into chunks over torch
devices (one after another on one card); the gathered table's content is
byte-identical to the unsharded build's.

Bit-exactness: a lookup returns bounds and ``e_total`` bit-identical to a
direct façade solve of the same (graph, cost, Q) on any backend.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..configs.base import ModelConfig
from ..obs.metrics import METRICS
from ..obs.trace import PID_SOLVER, TRACER
from .burst import burst_cost
from .cost import CostModel, cost_scalars
from .engine import QGridSharding, SpecError
from .graph import TaskGraph
from .layer_profile import default_cost_model, lower_config
from .partition import BUDGET_ABS, BUDGET_REL, Infeasible

__all__ = [
    "PLAN_TABLE_VERSION",
    "PlanTableError",
    "StaleTableError",
    "UnknownBucketError",
    "SegmentPlan",
    "PlanTable",
    "build_plan_table",
    "extend_plan_table",
    "probe_plan_table",
    "config_fingerprint",
    "BUILD_STATS",
]

# v2: canonical bucket/Q ordering + the `lineage` fingerprint chain in the
# header (incremental-extension provenance). v1 tables must be rebuilt.
PLAN_TABLE_VERSION = 2

# Offline-build observability (the fingerprint cache short-circuits the
# solve; extensions never rebuild existing cells). Registry-backed
# (repro_torch.obs.metrics) but still a plain dict to consumers.
BUILD_STATS = METRICS.counter_dict(
    "plan_table.build_stats", ("built", "cache_hits", "extended")
)


class PlanTableError(ValueError):
    """Malformed, mismatched, or misused plan table."""


class StaleTableError(PlanTableError):
    """On-disk table is from an incompatible format version, or the staleness
    probe found a cell that no longer matches the live engine."""


class UnknownBucketError(PlanTableError, KeyError):
    """Request shape maps to no tabulated (batch, seq) bucket."""


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """One looked-up plan: the energy-bounded cycles for a request shape.

    ``bounds`` are 1-based inclusive task ranges over the lowered activation
    graph (the julienne cut points); ``cycle_energy[c]`` is the modeled energy
    of cycle ``c`` (E_s + loads + execution + stores — what one system
    activation must deliver); ``e_total`` is the whole request.
    """

    arch: str
    batch: int
    seq_bucket: int
    q_max: Optional[float]
    n_tasks: int
    bounds: Tuple[Tuple[int, int], ...]
    cycle_energy: Tuple[float, ...]
    e_total: float

    @property
    def n_cycles(self) -> int:
        return len(self.bounds)

    @property
    def max_cycle_energy(self) -> float:
        return max(self.cycle_energy, default=0.0)

    @property
    def cut_points(self) -> Tuple[int, ...]:
        """Interior segment ends — the pipeline/offload/remat cut points."""
        return tuple(j for (_, j) in self.bounds[:-1])

    def summary(self) -> str:
        q = "inf" if self.q_max is None else f"{self.q_max:.6g}"
        return (
            f"{self.arch} b{self.batch}/s{self.seq_bucket}: "
            f"{self.n_cycles} cycles @ Q≤{q}, "
            f"max cycle {self.max_cycle_energy:.6g}, "
            f"E_total {self.e_total:.6g}"
        )


def _q_list(q_values: Sequence[Optional[float]]) -> List[Optional[float]]:
    out: List[Optional[float]] = []
    for q in q_values:
        if q is None or (isinstance(q, float) and np.isinf(q)):
            out.append(None)
        else:
            out.append(float(q))
    return out


def _q_key(q: Optional[float]) -> float:
    return np.inf if q is None else float(q)


def _canonical_grid(
    shape_buckets: Sequence[Tuple[int, int]],
    q_values: Sequence[Optional[float]],
    graphs: Optional[Sequence[TaskGraph]] = None,
) -> Tuple[List[Tuple[int, int]], List[Optional[float]],
           Optional[List[TaskGraph]]]:
    """Validate and canonically order the design-space grid.

    Buckets sort by (batch, seq); Q values sort ascending with the unbounded
    entry last. Pre-lowered ``graphs`` (one per bucket, caller order) are
    permuted alongside their buckets. The canonical order is what makes the
    table content a pure function of the design-space *set* — shuffled
    incremental extensions land on identical bytes.
    """
    buckets = [(int(b), int(s)) for (b, s) in shape_buckets]
    if not buckets:
        raise PlanTableError("shape_buckets is empty")
    if len(set(buckets)) != len(buckets):
        raise PlanTableError(f"duplicate shape buckets in {buckets}")
    qs = _q_list(q_values)
    if not qs:
        raise PlanTableError("q_values is empty")
    keys = [_q_key(q) for q in qs]
    if len(set(keys)) != len(keys):
        raise PlanTableError(f"duplicate Q values in {q_values}")
    if graphs is not None and len(graphs) != len(buckets):
        raise PlanTableError(
            f"{len(graphs)} pre-lowered graphs for {len(buckets)} buckets"
        )
    order = sorted(range(len(buckets)), key=lambda i: buckets[i])
    buckets = [buckets[i] for i in order]
    if graphs is not None:
        graphs = [graphs[i] for i in order]
    qs = [qs[i] for i in np.argsort(np.asarray(keys), kind="stable")]
    return buckets, qs, graphs


def config_fingerprint(
    cfg: ModelConfig,
    shape_buckets: Sequence[Tuple[int, int]],
    q_values: Sequence[Optional[float]],
    kind: str,
    cost: CostModel,
) -> str:
    """Content hash keying the build cache and pinning table identity.

    Covers everything the solved plans depend on: the full ModelConfig, the
    bucket set, the Q grid (exact float reprs), the cost interpretation
    (``kind``) and the cost-model scalars, plus the table format version.
    Buckets and Q values are hashed in canonical (sorted) order, so the
    fingerprint is a function of the design-space *set*, not the call order.
    """
    qs = sorted(_q_key(q) for q in _q_list(q_values))
    payload = {
        "version": PLAN_TABLE_VERSION,
        "cfg": dataclasses.asdict(cfg),
        "buckets": sorted([int(b), int(s)] for (b, s) in shape_buckets),
        "q_grid": [None if np.isinf(q) else q.hex() for q in qs],
        "kind": kind,
        "cost": {"name": cost.name, "scalars": [c.hex() for c in cost_scalars(cost)]},
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class PlanTable:
    """Immutable (bucket × Q) grid of precomputed segment plans.

    Construct via :func:`build_plan_table` / :func:`extend_plan_table` or
    :meth:`load`; query via :meth:`lookup`.
    Storage is flat-ragged: entry ``(b, k)`` owns segment rows
    ``seg_ptr[b*nq+k] : seg_ptr[b*nq+k+1]`` of ``seg_start``/``seg_end``/
    ``cycle_energy`` (the CSR idiom the engine already uses for graphs).
    """

    def __init__(
        self,
        header: Dict,
        bucket_batch: np.ndarray,
        bucket_seq: np.ndarray,
        n_tasks: np.ndarray,
        q_grid: np.ndarray,
        feasible: np.ndarray,
        e_total: np.ndarray,
        seg_ptr: np.ndarray,
        seg_start: np.ndarray,
        seg_end: np.ndarray,
        cycle_energy: np.ndarray,
    ) -> None:
        self.header = dict(header)
        self.bucket_batch = np.asarray(bucket_batch, dtype=np.int64)
        self.bucket_seq = np.asarray(bucket_seq, dtype=np.int64)
        self.n_tasks = np.asarray(n_tasks, dtype=np.int64)
        self.q_grid = np.asarray(q_grid, dtype=np.float64)
        self.feasible = np.asarray(feasible, dtype=bool)
        self.e_total = np.asarray(e_total, dtype=np.float64)
        self.seg_ptr = np.asarray(seg_ptr, dtype=np.int64)
        self.seg_start = np.asarray(seg_start, dtype=np.int32)
        self.seg_end = np.asarray(seg_end, dtype=np.int32)
        self.cycle_energy = np.asarray(cycle_energy, dtype=np.float64)
        nb, nq = self.feasible.shape
        if self.seg_ptr.shape[0] != nb * nq + 1:
            raise PlanTableError(
                f"seg_ptr length {self.seg_ptr.shape[0]} != {nb}*{nq}+1"
            )

    # -- identity ----------------------------------------------------------

    @property
    def arch(self) -> str:
        return self.header["arch"]

    @property
    def kind(self) -> str:
        return self.header["kind"]

    @property
    def fingerprint(self) -> str:
        return self.header["fingerprint"]

    @property
    def lineage(self) -> List[str]:
        """Fingerprint chain: the fresh-build fingerprint followed by one
        entry per :func:`extend_plan_table` step (extension provenance)."""
        return list(self.header.get("lineage", [self.fingerprint]))

    @property
    def e_startup(self) -> float:
        """E_s of the cost model the table was priced under."""
        return float(self.header["cost_scalars"][0])

    @property
    def n_buckets(self) -> int:
        return int(self.bucket_batch.shape[0])

    @property
    def n_q(self) -> int:
        return int(self.q_grid.shape[0])

    def buckets(self) -> List[Tuple[int, int]]:
        return [
            (int(b), int(s)) for b, s in zip(self.bucket_batch, self.bucket_seq)
        ]

    def q_values(self) -> List[Optional[float]]:
        return [None if np.isinf(q) else float(q) for q in self.q_grid]

    _PAYLOAD = (
        "bucket_batch", "bucket_seq", "n_tasks", "q_grid", "feasible",
        "e_total", "seg_ptr", "seg_start", "seg_end", "cycle_energy",
    )

    def content_digest(self) -> str:
        """sha256 over the table *content*: the identity header fields plus
        every payload array's dtype, shape, and raw bytes.

        Two tables with equal digests store bit-identical plans for the same
        design space under the same engine config. Build-provenance header
        fields (``lineage``, ``backend``) are excluded: a design space built
        on any backend, or grown through any order of incremental
        extensions, is *content-identical*, and this digest shows it.
        """
        ident = {
            k: self.header[k]
            for k in ("version", "arch", "kind", "cost_name", "cost_scalars",
                      "fingerprint")
        }
        h = hashlib.sha256(
            json.dumps(ident, sort_keys=True, separators=(",", ":")).encode()
        )
        for name in self._PAYLOAD:
            a = getattr(self, name)
            h.update(f"{name}:{a.dtype.str}:{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    # -- lookup ------------------------------------------------------------

    def bucket_index(self, batch: int, seq: int) -> int:
        """Smallest tabulated seq-bucket covering ``seq`` at exactly ``batch``."""
        ok = (self.bucket_batch == int(batch)) & (self.bucket_seq >= int(seq))
        idx = np.flatnonzero(ok)
        if idx.size == 0:
            raise UnknownBucketError(
                f"no bucket covers (batch={batch}, seq={seq}); "
                f"tabulated: {self.buckets()}"
            )
        return int(idx[np.argmin(self.bucket_seq[idx])])

    def q_index(self, energy_budget: Optional[float]) -> int:
        """Largest tabulated Q_max that fits under ``energy_budget``.

        Any plan solved for Q' ≤ budget is feasible for the budget (every
        cycle ≤ Q' ≤ budget), and e_total is non-increasing in Q, so the
        largest fitting grid point is the best tabulated plan. ``None`` means
        unbounded and selects the largest grid entry.
        """
        if energy_budget is None:
            return int(np.argmax(self.q_grid))
        # vectorized within_budget(q, budget) over the grid (request path)
        cap = float(energy_budget) * (1 + BUDGET_REL) + BUDGET_ABS
        fits = np.flatnonzero(self.q_grid <= cap)
        if fits.size == 0:
            raise Infeasible(
                f"energy budget {energy_budget} is below the smallest "
                f"tabulated Q_max {self.q_grid.min():.6g}"
            )
        return int(fits[np.argmax(self.q_grid[fits])])

    def plan_at(self, b: int, k: int) -> SegmentPlan:
        """The stored plan for bucket index ``b`` at Q index ``k``."""
        if not self.feasible[b, k]:
            q = self.q_grid[k]
            raise Infeasible(
                f"bucket {self.buckets()[b]} infeasible at Q_max={q:.6g}"
            )
        e = b * self.n_q + k
        lo, hi = int(self.seg_ptr[e]), int(self.seg_ptr[e + 1])
        q = self.q_grid[k]
        return SegmentPlan(
            arch=self.arch,
            batch=int(self.bucket_batch[b]),
            seq_bucket=int(self.bucket_seq[b]),
            q_max=None if np.isinf(q) else float(q),
            n_tasks=int(self.n_tasks[b]),
            bounds=tuple(
                (int(i), int(j))
                for i, j in zip(self.seg_start[lo:hi], self.seg_end[lo:hi])
            ),
            cycle_energy=tuple(float(c) for c in self.cycle_energy[lo:hi]),
            e_total=float(self.e_total[b, k]),
        )

    def lookup(
        self, batch: int, seq: int, energy_budget: Optional[float] = None
    ) -> SegmentPlan:
        """O(1) request-path query: bucket the shape, pick the Q, return the
        precomputed plan. Raises :class:`UnknownBucketError` for untabulated
        shapes and :class:`Infeasible` for budgets below the grid."""
        if TRACER.enabled:  # guarded: keep the disabled hot path span-free
            with TRACER.span(
                "plan_table.lookup", cat="plan_table", pid=PID_SOLVER,
                batch=batch, seq=seq,
            ):
                return self.plan_at(
                    self.bucket_index(batch, seq), self.q_index(energy_budget)
                )
        return self.plan_at(
            self.bucket_index(batch, seq), self.q_index(energy_budget)
        )

    # -- serialization -----------------------------------------------------

    def save(self, path: str) -> str:
        """Write the table as one ``.npz`` with an embedded JSON header
        (atomic: write-to-temp + rename, same protocol as DirNVM)."""
        directory = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(
                    fh,
                    header=np.array(json.dumps(self.header, sort_keys=True)),
                    **{name: getattr(self, name) for name in self._PAYLOAD},
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    @classmethod
    def load(cls, path: str) -> "PlanTable":
        with np.load(path, allow_pickle=False) as z:
            try:
                header = json.loads(str(z["header"]))
            except (KeyError, json.JSONDecodeError) as e:
                raise PlanTableError(f"{path}: missing/corrupt header") from e
            version = header.get("version")
            if version != PLAN_TABLE_VERSION:
                raise StaleTableError(
                    f"{path}: table version {version} != supported "
                    f"{PLAN_TABLE_VERSION}; rebuild with build_plan_table()"
                )
            return cls(header=header, **{name: z[name] for name in cls._PAYLOAD})

    def nbytes(self) -> int:
        return int(sum(getattr(self, name).nbytes for name in self._PAYLOAD))

    def summary(self) -> str:
        feas = int(self.feasible.sum())
        return (
            f"PlanTable[{self.arch}/{self.kind}] {self.n_buckets} buckets × "
            f"{self.n_q} Q points, {feas}/{self.feasible.size} feasible, "
            f"{self.nbytes() / 1e3:.1f} kB"
        )


# ---------------------------------------------------------------------------
# Cell blocks: vectorized (bucket × Q) assembly shared by build/extend
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _CellBlock:
    """Flat-ragged per-cell data: cell ``c`` owns segment rows
    ``ptr[c]:ptr[c+1]``. Cells are bucket-major, Q-minor."""

    feasible: np.ndarray
    e_total: np.ndarray
    ptr: np.ndarray
    start: np.ndarray
    end: np.ndarray
    energy: np.ndarray


def _segments_for_sweep(graph: TaskGraph, cm: CostModel, res) -> _CellBlock:
    """Vectorized extraction of one graph's (nq) cells from a TorchSweep:
    array ops over the ``starts`` matrix, segment rows in (Q-major,
    start-ascending) order, each distinct burst (i, j) priced once."""
    n = int(res.n_tasks)
    nq = len(res.q_values)
    feas = np.asarray(res.feasible, dtype=bool).copy()
    e_tot = np.where(feas, np.asarray(res.e_total, dtype=np.float64), np.inf)
    if n == 0:
        # An empty graph is trivially feasible everywhere with zero segments.
        return _CellBlock(
            feasible=feas,
            e_total=np.where(feas, 0.0, np.inf),
            ptr=np.zeros(nq + 1, dtype=np.int64),
            start=np.zeros(0, dtype=np.int32),
            end=np.zeros(0, dtype=np.int32),
            energy=np.zeros(0, dtype=np.float64),
        )
    sub = np.asarray(res.starts[:, 1 : n + 1], dtype=bool) & feas[:, None]
    q_idx, i0 = np.nonzero(sub)  # row-major: Q-major, start-ascending
    starts = (i0 + 1).astype(np.int32)
    nseg = starts.shape[0]
    # end of segment s = next start in the same Q row - 1, else n_tasks
    same_row = np.zeros(nseg, dtype=bool)
    if nseg:
        same_row[:-1] = q_idx[1:] == q_idx[:-1]
    nxt = np.empty(nseg, dtype=np.int32)
    if nseg:
        nxt[:-1] = starts[1:] - 1
        nxt[-1] = 0
    ends = np.where(same_row, nxt, np.int32(n))
    counts = sub.sum(axis=1).astype(np.int64)
    ptr = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    if nseg:
        pairs = starts.astype(np.int64) * (n + 2) + ends.astype(np.int64)
        uniq, inv = np.unique(pairs, return_inverse=True)
        priced = np.array(
            [burst_cost(graph, cm, int(p // (n + 2)), int(p % (n + 2)))
             for p in uniq],
            dtype=np.float64,
        )
        energy = priced[inv]
    else:
        energy = np.zeros(0, dtype=np.float64)
    return _CellBlock(
        feasible=feas, e_total=e_tot, ptr=ptr,
        start=starts, end=ends, energy=energy,
    )


def _block_from_sweeps(
    graphs: Sequence[TaskGraph], cm: CostModel, sweeps: Sequence
) -> _CellBlock:
    return _block_concat(
        [_segments_for_sweep(g, cm, res) for g, res in zip(graphs, sweeps)]
    )


def _block_from_table(table: PlanTable) -> _CellBlock:
    return _CellBlock(
        feasible=table.feasible.reshape(-1),
        e_total=table.e_total.reshape(-1),
        ptr=table.seg_ptr,
        start=table.seg_start,
        end=table.seg_end,
        energy=table.cycle_energy,
    )


def _block_concat(blocks: Sequence[_CellBlock]) -> _CellBlock:
    ptr = np.zeros(sum(b.ptr.shape[0] - 1 for b in blocks) + 1, dtype=np.int64)
    pos, off = 1, 0
    for b in blocks:
        nc = b.ptr.shape[0] - 1
        ptr[pos : pos + nc] = b.ptr[1:] + off
        pos += nc
        off += int(b.ptr[-1])
    return _CellBlock(
        feasible=np.concatenate([b.feasible for b in blocks]),
        e_total=np.concatenate([b.e_total for b in blocks]),
        ptr=ptr,
        start=np.concatenate([b.start for b in blocks]),
        end=np.concatenate([b.end for b in blocks]),
        energy=np.concatenate([b.energy for b in blocks]),
    )


def _block_gather(block: _CellBlock, order: np.ndarray) -> _CellBlock:
    """Reorder ragged cells: cell ``c`` of the result is cell ``order[c]``
    of ``block`` (the standard CSR row-gather, fully vectorized)."""
    counts = np.diff(block.ptr)[order]
    ptr = np.zeros(order.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    total = int(ptr[-1])
    idx = (
        np.repeat(block.ptr[:-1][order], counts)
        + np.arange(total, dtype=np.int64)
        - np.repeat(ptr[:-1], counts)
    )
    return _CellBlock(
        feasible=block.feasible[order],
        e_total=block.e_total[order],
        ptr=ptr,
        start=block.start[idx],
        end=block.end[idx],
        energy=block.energy[idx],
    )


def _finish_table(
    cfg: ModelConfig,
    kind: str,
    cm: CostModel,
    fp: str,
    backend: str,
    buckets: Sequence[Tuple[int, int]],
    qs: Sequence[Optional[float]],
    n_tasks: Sequence[int],
    block: _CellBlock,
    lineage: Sequence[str],
) -> PlanTable:
    nb, nq = len(buckets), len(qs)
    header = {
        "version": PLAN_TABLE_VERSION,
        "arch": cfg.name,
        "kind": kind,
        "cost_name": cm.name,
        "cost_scalars": cost_scalars(cm).tolist(),
        "fingerprint": fp,
        "backend": backend,
        "lineage": list(lineage),
    }
    return PlanTable(
        header=header,
        bucket_batch=np.array([b for (b, _) in buckets], dtype=np.int64),
        bucket_seq=np.array([s for (_, s) in buckets], dtype=np.int64),
        n_tasks=np.asarray(n_tasks, dtype=np.int64),
        q_grid=np.array([_q_key(q) for q in qs], dtype=np.float64),
        feasible=block.feasible.reshape(nb, nq),
        e_total=block.e_total.reshape(nb, nq),
        seg_ptr=block.ptr,
        seg_start=block.start,
        seg_end=block.end,
        cycle_energy=block.energy,
    )


def _cache_lookup(cache_dir: Optional[str], fp: str, lineage: Sequence[str]):
    """(cache_path, hit-or-None) for a fingerprint-keyed on-disk cache.

    A hit must match the caller's expected ``lineage`` too: content is a
    pure function of the fingerprint, but provenance is not — a fresh build
    must not serve a cached extension's multi-link chain (or vice versa), so
    a lineage mismatch is treated as a miss and rebuilt in place.
    """
    if cache_dir is None:
        return None, None
    cache_path = os.path.join(cache_dir, f"plan_{fp[:16]}.npz")
    if os.path.exists(cache_path):
        try:
            table = PlanTable.load(cache_path)
            if table.fingerprint == fp and table.lineage == list(lineage):
                return cache_path, table
        except PlanTableError:
            pass  # stale/corrupt cache entry: rebuild
    return cache_path, None


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _facade_sweeps(graphs, cm, qs, backend, sharding=None):
    """One batched (optionally Q-sharded) façade solve returning a
    TorchSweep per graph."""
    from ..api import PartitionSpec, solve  # lazy: the façade imports this package

    sol = solve(PartitionSpec(
        graphs=tuple(graphs), cost=cm, q_grid=tuple(qs), backend=backend,
        sharding=sharding,
    ))
    if sol.sweeps is None:
        raise PlanTableError(
            f"plan tables need sweep tables; backend={backend!r} returned none"
        )
    return sol.sweeps


def build_plan_table(
    cfg: Union[ModelConfig, str],
    shape_buckets: Sequence[Tuple[int, int]],
    q_values: Sequence[Optional[float]],
    *,
    kind: str = "time",
    cost: Optional[CostModel] = None,
    backend: str = "auto",
    cache_dir: Optional[str] = None,
    graphs: Optional[Sequence[TaskGraph]] = None,
    sharding: Optional[QGridSharding] = None,
) -> PlanTable:
    """Offline build: lower every (batch, seq) bucket via
    :func:`lower_config` and solve the whole bucket × Q grid in one
    batched façade call (:func:`repro_torch.api.solve`; ``backend="auto"``
    is the sweep kernel on the card).

    ``kind`` picks the activation-graph cost interpretation ("time" seconds /
    "memory" working bytes — see :mod:`.layer_profile`); ``cost`` prices
    transfers and defaults per kind. With ``cache_dir``, the build is keyed by
    :func:`config_fingerprint` — a prior table for the identical inputs is
    loaded instead of re-solved, and stale or mismatched files are rebuilt in
    place. ``graphs``, if given, must be the buckets' own
    ``lower_config(cfg, b, s, kind=kind)`` results (one per bucket, in the
    caller's bucket order) — callers that already lowered them (e.g. to
    derive the Q grid) skip the second lowering; identity is still pinned by
    the fingerprint over (cfg, buckets, kind). Buckets and Q values are
    stored in canonical sorted order regardless of call order.
    ``sharding`` (a :class:`~.engine.QGridSharding`) splits the Q grid into
    chunks over torch devices; the table is **byte-identical** to the
    unsharded build of the same inputs, with the same fingerprint, and with
    fewer devices than shards the chunks run one after another.
    """
    from ..configs import resolve_config

    if sharding is not None and not isinstance(sharding, QGridSharding):
        raise SpecError(
            f"sharding= must be a QGridSharding, got {type(sharding).__name__}"
        )
    cfg = resolve_config(cfg)
    buckets, qs, graphs = _canonical_grid(shape_buckets, q_values, graphs)
    cm = cost if cost is not None else default_cost_model(kind)
    fp = config_fingerprint(cfg, buckets, qs, kind, cm)

    cache_path, cached = _cache_lookup(cache_dir, fp, [fp])
    if cached is not None:
        BUILD_STATS["cache_hits"] += 1
        return cached

    with TRACER.span(
        "plan_table.build", cat="plan_table", pid=PID_SOLVER,
        cfg=cfg.name, buckets=len(buckets), q_points=len(qs),
    ):
        if graphs is None:
            graphs = [
                lower_config(cfg, batch=b, seq=s, kind=kind) for (b, s) in buckets
            ]
        sweeps = _facade_sweeps(graphs, cm, qs, backend, sharding)
        table = _finish_table(
            cfg, kind, cm, fp, backend, buckets, qs,
            [g.n_tasks for g in graphs], _block_from_sweeps(graphs, cm, sweeps),
            lineage=[fp],
        )
    BUILD_STATS["built"] += 1
    if cache_path is not None:
        table.save(cache_path)
    return table


def extend_plan_table(
    base: Union[PlanTable, str],
    cfg: Union[ModelConfig, str],
    *,
    add_buckets: Sequence[Tuple[int, int]] = (),
    add_q_values: Sequence[Optional[float]] = (),
    cost: Optional[CostModel] = None,
    backend: str = "auto",
    cache_dir: Optional[str] = None,
    n_shards: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> PlanTable:
    """Incrementally extend a table with new buckets and/or Q points.

    Existing cells are **never re-solved**: their rows are byte-moved from
    ``base``, and only the new (bucket, Q) cells hit the engine — one
    batched solve (Q-sharded over ``devices`` when ``n_shards`` is given)
    for new buckets over the final Q grid plus one for old buckets over the
    new Q points. Additions already tabulated are
    ignored, so re-extending an untouched base returns it unchanged with
    zero engine calls.

    The result is canonical: **bit-identical content** to a fresh
    :func:`build_plan_table` of the final (bucket, Q) set, regardless of how
    the set was split into extension steps or in what order they were applied
    (the property tier shuffles them). The header's ``lineage`` chain gains
    the final fingerprint, recording the extension provenance.
    """
    from ..configs import resolve_config

    if isinstance(base, str):
        base = PlanTable.load(base)
    cfg = resolve_config(cfg)
    kind = base.kind
    cm = cost if cost is not None else default_cost_model(kind)
    base_buckets = base.buckets()
    base_qs = base.q_values()
    fp_base = config_fingerprint(cfg, base_buckets, base_qs, kind, cm)
    if fp_base != base.fingerprint:
        raise PlanTableError(
            f"base table fingerprint {base.fingerprint[:16]}… does not match "
            f"this engine config (cfg={cfg.name!r}, kind={kind!r}, "
            f"cost={cm.name!r} → {fp_base[:16]}…); refusing to extend"
        )

    old_b_index = {b: i for i, b in enumerate(base_buckets)}
    old_q_index = {_q_key(q): i for i, q in enumerate(base_qs)}
    new_buckets = []
    for b in [(int(x), int(s)) for (x, s) in add_buckets]:
        if b not in old_b_index and b not in new_buckets:
            new_buckets.append(b)
    new_qs = []
    for q in _q_list(add_q_values):
        if _q_key(q) not in old_q_index and _q_key(q) not in map(_q_key, new_qs):
            new_qs.append(q)
    if not new_buckets and not new_qs:
        return base  # untouched: zero engine calls, zero re-solves

    final_buckets, final_qs, _ = _canonical_grid(
        base_buckets + new_buckets, base_qs + new_qs
    )
    new_qs = sorted(new_qs, key=_q_key)
    fp = config_fingerprint(cfg, final_buckets, final_qs, kind, cm)
    lineage = base.lineage + [fp]
    cache_path, cached = _cache_lookup(cache_dir, fp, lineage)
    if cached is not None:
        BUILD_STATS["cache_hits"] += 1
        return cached
    sharding = None if n_shards is None else QGridSharding(int(n_shards), devices)

    def _solve(graphs, qs):
        # One span per engine call the extension actually makes (new-bucket
        # block and/or new-Q block); an untouched extend emits none.
        with TRACER.span(
            "plan_table.extend", cat="plan_table", pid=PID_SOLVER,
            graphs=len(graphs), q_points=len(qs),
        ):
            return _facade_sweeps(graphs, cm, qs, backend, sharding)

    new_buckets = sorted(new_buckets)
    new_b_index = {b: i for i, b in enumerate(new_buckets)}
    new_q_index = {_q_key(q): i for i, q in enumerate(new_qs)}
    nq_f, nq_old, nq_new = len(final_qs), len(base_qs), len(new_qs)
    nb_old = len(base_buckets)

    # Pool: [base cells | new-bucket × final-Q cells | old-bucket × new-Q
    # cells]; the gather below reorders it into canonical (bucket-major,
    # Q-minor) cell order without touching any copied bytes.
    blocks = [_block_from_table(base)]
    off_newb = nb_old * nq_old
    if new_buckets:
        new_graphs = [
            lower_config(cfg, batch=b, seq=s, kind=kind) for (b, s) in new_buckets
        ]
        blocks.append(_block_from_sweeps(new_graphs, cm, _solve(new_graphs, final_qs)))
    off_oldq = off_newb + len(new_buckets) * nq_f
    if new_qs:
        old_graphs = [
            lower_config(cfg, batch=b, seq=s, kind=kind) for (b, s) in base_buckets
        ]
        blocks.append(_block_from_sweeps(old_graphs, cm, _solve(old_graphs, new_qs)))
    pool = _block_concat(blocks)

    # Per-Q source row (same for every old bucket): base column or new-solve
    # column — vectorized so the merge stays O(cells) in numpy, not Python.
    q_keys = np.array([_q_key(q) for q in final_qs])
    q_is_old = np.array([k in old_q_index for k in q_keys])
    q_old_col = np.array([old_q_index.get(k, 0) for k in q_keys], dtype=np.int64)
    q_new_col = np.array([new_q_index.get(k, 0) for k in q_keys], dtype=np.int64)
    order = np.empty(len(final_buckets) * nq_f, dtype=np.int64)
    for bf, bucket in enumerate(final_buckets):
        row = slice(bf * nq_f, (bf + 1) * nq_f)
        if bucket in old_b_index:
            ob = old_b_index[bucket]
            order[row] = np.where(
                q_is_old,
                ob * nq_old + q_old_col,
                off_oldq + ob * nq_new + q_new_col,
            )
        else:
            jb = new_b_index[bucket]
            order[row] = off_newb + jb * nq_f + np.arange(nq_f)

    n_tasks = [
        int(base.n_tasks[old_b_index[b]]) if b in old_b_index
        else new_graphs[new_b_index[b]].n_tasks
        for b in final_buckets
    ]
    table = _finish_table(
        cfg, kind, cm, fp, backend, final_buckets, final_qs, n_tasks,
        _block_gather(pool, order), lineage=lineage,
    )
    BUILD_STATS["extended"] += 1
    if cache_path is not None:
        table.save(cache_path)
    return table


# ---------------------------------------------------------------------------
# Load-time staleness probe
# ---------------------------------------------------------------------------


def probe_plan_table(
    table: PlanTable,
    cfg: Union[ModelConfig, str],
    *,
    k: Optional[int] = 4,
    seed: int = 0,
    cost: Optional[CostModel] = None,
    backend: str = "auto",
    measured=None,
    drift_tol: float = 0.05,
) -> int:
    """Re-validate ``k`` random cells against the live engine (``k=None``
    probes every cell). Returns the number of probed cells.

    Raises :class:`StaleTableError` when the table's fingerprint does not
    match the given engine config (cfg / kind / cost-model scalars), or when
    any probed cell's feasibility, e_total, bounds, or cycle energies differ
    by even one bit from a fresh solve — the load-time guard for tables that
    outlived an engine or cost-model change the version field can't see.

    ``measured`` (a :class:`~.calibration.MeasuredCostTable`, e.g. built
    from a traffic run's ledger) additionally reprices every probed feasible
    cell's cycles under the measured mean model and rejects the table when
    any cycle's measured draw is further than ``drift_tol`` (relative) from
    the tabulated one — the staleness check against a refreshed profile. A
    clean calibration materializes the tabulated model itself and always
    passes.
    """
    from ..api import PartitionSpec, solve  # lazy: the façade imports this package
    from ..configs import resolve_config

    cfg = resolve_config(cfg)
    cm = cost if cost is not None else default_cost_model(table.kind)
    fp = config_fingerprint(cfg, table.buckets(), table.q_values(), table.kind, cm)
    if fp != table.fingerprint:
        raise StaleTableError(
            f"table fingerprint {table.fingerprint[:16]}… does not match the "
            f"live engine config (cfg={cfg.name!r}, kind={table.kind!r}, "
            f"cost={cm.name!r} → {fp[:16]}…)"
        )
    m_cm = None
    if measured is not None:
        m_kind = getattr(measured, "kind", table.kind)
        if m_kind != table.kind:
            raise StaleTableError(
                f"calibration profile is kind={m_kind!r} but the table is "
                f"kind={table.kind!r}"
            )
        if drift_tol < 0:
            raise PlanTableError(f"drift_tol must be >= 0, got {drift_tol}")
        m_cm = measured.cost_model()
    nb, nq = table.n_buckets, table.n_q
    total = nb * nq
    if k is None or k >= total:
        cells = np.arange(total)
    else:
        if k < 1:
            raise PlanTableError(f"probe needs k >= 1 cells, got {k}")
        rng = np.random.default_rng(seed)
        cells = np.sort(rng.choice(total, size=k, replace=False))

    buckets = table.buckets()
    qs = table.q_values()
    for b in np.unique(cells // nq):
        q_sel = [int(c % nq) for c in cells if c // nq == b]
        batch, seq_b = buckets[int(b)]
        graph = lower_config(cfg, batch=batch, seq=seq_b, kind=table.kind)
        res = solve(PartitionSpec(
            graph=graph, cost=cm, q_grid=tuple(qs[j] for j in q_sel),
            backend=backend,
        )).sweep
        for qi, j in enumerate(q_sel):
            where = f"cell (bucket {buckets[int(b)]}, Q={qs[j]})"
            if graph.n_tasks != int(table.n_tasks[b]):
                raise StaleTableError(
                    f"stale {where}: n_tasks {table.n_tasks[b]} != "
                    f"{graph.n_tasks} from the live lowering"
                )
            if bool(res.feasible[qi]) != bool(table.feasible[b, j]):
                raise StaleTableError(
                    f"stale {where}: feasibility flag differs from live solve"
                )
            if not res.feasible[qi]:
                continue
            plan = table.plan_at(int(b), j)
            if float(res.e_total[qi]) != plan.e_total:
                raise StaleTableError(
                    f"stale {where}: e_total {plan.e_total!r} != live "
                    f"{float(res.e_total[qi])!r}"
                )
            bounds = res.bounds(qi)
            if list(plan.bounds) != bounds:
                raise StaleTableError(
                    f"stale {where}: bounds {list(plan.bounds)} != live {bounds}"
                )
            live_energy = tuple(
                burst_cost(graph, cm, i, jj) for (i, jj) in bounds
            )
            if plan.cycle_energy != live_energy:
                raise StaleTableError(
                    f"stale {where}: cycle energies differ from live pricing"
                )
            if m_cm is not None:
                for ci, ((i, jj), tab_e) in enumerate(zip(bounds, live_energy)):
                    meas_e = burst_cost(graph, m_cm, i, jj)
                    err = abs(meas_e - tab_e)
                    scale = max(abs(meas_e), abs(tab_e))
                    if err > drift_tol * scale + BUDGET_ABS:
                        raise StaleTableError(
                            f"stale {where}: cycle {ci} measured draw "
                            f"{meas_e!r} drifted {err / scale:.1%} from the "
                            f"tabulated {tab_e!r} (tolerance "
                            f"{drift_tol:.1%}) — recalibrate and rebuild"
                        )
    return int(len(cells))
