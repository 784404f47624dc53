"""Measured cost calibration: close the loop from captured energy ledgers
back into the solver's cost model.

The port's copy of ``repro/core/calibration.py``. The analytical
:class:`~repro_torch.core.cost.CostModel` of ``core/cost.py`` is the H100's
(data-sheet rates, and constants measured once on the card). The traffic
harness's :class:`repro_torch.obs.ledger.EnergyLedger` records what each
committed cycle drew, split into ``restore`` / ``compute`` / ``commit``
(and crashed attempts as ``replay`` overhead). This module ingests those
rows into a versioned, fingerprinted :class:`MeasuredCostTable` — per
category the mean and variance of the draw, with sample counts — and
materializes it back into a plain ``CostModel`` that goes wherever one is
accepted (the façade's ``PartitionSpec.cost``,
``layer_profile.default_cost_model`` through
:func:`install_measured_default`, plan-table builds and probes).

Uncertainty propagation ("price each cut at mean + z·sigma"):

- ``restore`` samples re-estimate the activation cost E_s:
  ``e_startup' = mean + z·std``.
- ``commit`` samples re-scale the NVM transfer curves: the coefficient of
  variation ``cv = std/mean`` multiplies both ``read`` and ``write`` as
  ``c' = c · (1 + z·cv)``.
- ``compute`` and ``replay`` stats are kept (summary, staleness checks) but
  not folded into the CostModel: task energies live on the graph nodes.

``z`` comes from the confidence level through the stdlib normal quantile
(``statistics.NormalDist().inv_cdf``); ``confidence=None`` (or exactly 0.5)
prices at the plain mean with ``z = 0``.

Bit-identity contract: the accumulator is Welford's algorithm, whose mean
stays *bitwise* equal to ``x`` over any number of identical samples ``x``
and whose m2 stays exactly ``0.0``. A ledger captured from a run that
matched the analytical model therefore rebuilds the analytical scalars
exactly, and :meth:`MeasuredCostTable.cost_model` returns the *base
CostModel object itself* whenever the materialized scalars are unchanged —
so a sigma=0 solve is the analytical solve, on every backend.

Stdlib + numpy only at import (``cost_scalars`` needs numpy); the
analytical default is looked up lazily in :mod:`.layer_profile`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from contextlib import contextmanager
from statistics import NormalDist
from typing import Dict, Iterable, Mapping, Optional

from .cost import CostModel, LinearTransfer, cost_scalars

__all__ = [
    "CALIBRATION_VERSION",
    "CalibrationError",
    "KernelStats",
    "MeasuredCostTable",
    "clear_measured_defaults",
    "install_measured_default",
    "measured_default",
    "use_measured",
    "z_score",
]

CALIBRATION_VERSION = 1

# Mirrors repro_torch.obs.ledger.CATEGORIES without importing obs (keeps
# core importable on its own); tests/test_torch_calibration.py checks that
# the two agree.
CATEGORIES = ("restore", "compute", "commit", "replay")


class CalibrationError(ValueError):
    """Malformed ledger rows, calibration files, or confidence levels."""


def z_score(confidence: Optional[float]) -> float:
    """Normal quantile for a one-sided confidence level in (0, 1).

    ``None`` and exactly ``0.5`` (the median) return ``0.0`` exactly — the
    sigma=0 path must not pick up an ``inv_cdf`` rounding residue.
    """
    if confidence is None:
        return 0.0
    c = float(confidence)
    if not 0.0 < c < 1.0 or math.isnan(c):
        raise CalibrationError(
            f"confidence must lie strictly in (0, 1), got {confidence!r}"
        )
    if c == 0.5:
        return 0.0
    return NormalDist().inv_cdf(c)


@dataclasses.dataclass
class KernelStats:
    """Welford running (count, mean, m2) for one energy category.

    Population variance (``m2 / count``): the ledger rows *are* the
    population of observed draws being replayed, not a sample from a larger
    experiment we never ran.
    """

    count: int = 0
    mean: float = 0.0
    m2: float = 0.0

    def add(self, x: float) -> None:
        x = float(x)
        if math.isnan(x) or math.isinf(x):
            raise CalibrationError(f"non-finite energy sample {x!r}")
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self.m2 += delta * (x - self.mean)

    @property
    def variance(self) -> float:
        return self.m2 / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(self.variance)

    @property
    def cv(self) -> float:
        """Coefficient of variation; 0.0 when unsampled or mean-free."""
        return self.std / abs(self.mean) if self.count and self.mean else 0.0

    def merge(self, other: "KernelStats") -> "KernelStats":
        """Chan's parallel Welford combine of two (count, mean, m2) triples.

        Exact contract: counts add exactly; an empty side returns the other
        side's moments bitwise; and merging accumulators whose means agree
        bitwise keeps that mean bitwise (``delta == 0.0``) — so fleets of
        devices that measured identical draws merge to the identical table,
        fingerprint included. For differing means the result equals
        sequential ingestion of the concatenated samples mathematically
        (pinned to ~ulp by the differential test), not bitwise — summation
        order is part of Welford's rounding.
        """
        if not isinstance(other, KernelStats):
            raise CalibrationError(
                f"merge takes a KernelStats, got {type(other).__name__}"
            )
        na, nb = self.count, other.count
        if nb == 0:
            return KernelStats(count=na, mean=self.mean, m2=self.m2)
        if na == 0:
            return KernelStats(count=nb, mean=other.mean, m2=other.m2)
        n = na + nb
        delta = other.mean - self.mean
        mean = self.mean + delta * (nb / n)
        m2 = self.m2 + other.m2 + delta * delta * (na * (nb / n))
        return KernelStats(count=n, mean=mean, m2=m2)

    def to_dict(self) -> Dict[str, object]:
        # float64 repr round-trips bitwise through json in Python 3
        return {"count": self.count, "mean": self.mean, "m2": self.m2}

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "KernelStats":
        """Load one stats entry, validating every field.

        The Welford invariants are enforced here — not left to the
        fingerprint check, which is skipped for legitimately fingerprint-free
        payloads and recomputable by anyone editing the file — so a NaN mean
        or negative count can never survive into confidence pricing. Raises
        the typed tamper error (:class:`CalibrationError`).
        """
        try:
            count = int(d["count"])
            mean = float(d["mean"])
            m2 = float(d["m2"])
        except (KeyError, TypeError, ValueError) as exc:
            raise CalibrationError(f"malformed stats entry {d!r}") from exc
        if count < 0:
            raise CalibrationError(
                f"stats entry has negative count {count}: the file was "
                f"edited or produced by an incompatible build"
            )
        if not math.isfinite(mean) or not math.isfinite(m2):
            raise CalibrationError(
                f"stats entry has non-finite mean/m2 ({mean!r}, {m2!r}): "
                f"the file was edited or produced by an incompatible build"
            )
        if m2 < 0.0:
            raise CalibrationError(
                f"stats entry has negative m2 {m2!r} (variance cannot be "
                f"negative): the file was edited or produced by an "
                f"incompatible build"
            )
        if count == 0 and (mean != 0.0 or m2 != 0.0):
            raise CalibrationError(
                f"stats entry claims zero samples but non-zero moments "
                f"(mean={mean!r}, m2={m2!r}): the file was edited or "
                f"produced by an incompatible build"
            )
        return cls(count=count, mean=mean, m2=m2)


class MeasuredCostTable:
    """Versioned, fingerprinted per-category measured energy statistics.

    Built from :class:`~repro_torch.obs.ledger.EnergyLedger` rows (or a
    ``dump_json`` payload), carries the analytical ``base`` CostModel it
    calibrates, and materializes confidence-priced CostModels via
    :meth:`cost_model` — see the module docstring for the pricing rules and
    the bit-identity contract.
    """

    def __init__(
        self,
        base: CostModel,
        kind: str = "time",
        *,
        meta: Optional[Mapping[str, object]] = None,
    ) -> None:
        if not isinstance(base, CostModel):
            raise CalibrationError(
                f"base must be a CostModel, got {type(base).__name__}"
            )
        self.base = base
        self.kind = str(kind)
        self.stats: Dict[str, KernelStats] = {c: KernelStats() for c in CATEGORIES}
        self.meta: Dict[str, object] = dict(meta or {})

    # -- ingestion ---------------------------------------------------------

    def add(self, category: str, energy: float) -> None:
        if category not in self.stats:
            raise CalibrationError(
                f"unknown ledger category {category!r}; expected one of "
                f"{CATEGORIES}"
            )
        self.stats[category].add(energy)

    def ingest_rows(self, rows: Iterable[Mapping[str, object]]) -> int:
        """Ingest ``EnergyLedger.to_rows()``-shaped dicts; returns the count."""
        n = 0
        for row in rows:
            try:
                category, energy = row["category"], row["energy"]
            except (KeyError, TypeError) as exc:
                raise CalibrationError(
                    f"ledger row needs 'category' and 'energy' fields: {row!r}"
                ) from exc
            self.add(str(category), float(energy))
            n += 1
        return n

    def ingest_ledger(self, ledger) -> int:
        return self.ingest_rows(ledger.to_rows())

    @classmethod
    def from_ledger(
        cls, ledger, *, base: Optional[CostModel] = None, kind: str = "time"
    ) -> "MeasuredCostTable":
        table = cls(base if base is not None else _analytical_default(kind), kind)
        table.ingest_ledger(ledger)
        return table

    @classmethod
    def from_ledger_json(
        cls,
        path: str,
        *,
        base: Optional[CostModel] = None,
        kind: Optional[str] = None,
    ) -> "MeasuredCostTable":
        """Ingest an ``EnergyLedger.dump_json`` file (e.g. the traffic
        harness's ``--ledger-out``). Ledger meta keys (minus the bulky
        ``entries``/``summary``) carry over as provenance."""
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict) or "entries" not in payload:
            raise CalibrationError(
                f"{path}: not an EnergyLedger dump_json payload "
                "(no 'entries' list)"
            )
        k = str(kind if kind is not None else payload.get("kind", "time"))
        meta = {
            key: val
            for key, val in payload.items()
            if key not in ("entries", "summary")
        }
        table = cls(
            base if base is not None else _analytical_default(k), k, meta=meta
        )
        table.ingest_rows(payload["entries"])
        return table

    # -- multi-host aggregation --------------------------------------------

    @classmethod
    def merge(
        cls,
        *tables: "MeasuredCostTable",
        meta: Optional[Mapping[str, object]] = None,
    ) -> "MeasuredCostTable":
        """Merge per-device tables into one fleet table: weighted Welford
        combine of every category's
        (count, mean, m2) via :meth:`KernelStats.merge`, left to right in
        argument order.

        All tables must share the ``kind`` and the exact base CostModel
        scalars — merging profiles calibrated against different analytical
        models is a typed error, not an average. Per-device provenance is
        recorded in the result's meta under ``"merged_from"`` (each source's
        fingerprint, sample count, and meta — device identity rides in the
        meta each ledger dump carried) and therefore lands in
        :meth:`to_payload`. A single-table merge reproduces that table's
        statistics bitwise.
        """
        if not tables:
            raise CalibrationError("merge needs at least one table")
        for t in tables:
            if not isinstance(t, MeasuredCostTable):
                raise CalibrationError(
                    f"merge takes MeasuredCostTable arguments, got "
                    f"{type(t).__name__}"
                )
        head = tables[0]
        ref = [float(x) for x in cost_scalars(head.base)]
        for t in tables[1:]:
            if t.kind != head.kind:
                raise CalibrationError(
                    f"cannot merge kind={t.kind!r} into kind={head.kind!r}: "
                    f"profiles of different graph kinds measure different "
                    f"quantities"
                )
            if (
                [float(x) for x in cost_scalars(t.base)] != ref
                or t.base.name != head.base.name
            ):
                raise CalibrationError(
                    f"cannot merge tables calibrated against different base "
                    f"models ({t.base.name!r} vs {head.base.name!r}): the "
                    f"merged statistics would price against neither"
                )
        out = cls(head.base, head.kind, meta=meta)
        for category in CATEGORIES:
            s = KernelStats()
            for t in tables:
                s = s.merge(t.stats[category])
            out.stats[category] = s
        out.meta.setdefault(
            "merged_from",
            [
                {
                    "fingerprint": t.fingerprint(),
                    "n_samples": t.n_samples,
                    "meta": dict(t.meta),
                }
                for t in tables
            ],
        )
        return out

    # -- identity ----------------------------------------------------------

    @property
    def n_samples(self) -> int:
        return sum(s.count for s in self.stats.values())

    def fingerprint(self) -> str:
        """sha256 over version, kind, base scalars, and the exact (count,
        mean, m2) per category — hex float encoding, so two tables agree iff
        their statistics agree bitwise."""
        h = hashlib.sha256()
        h.update(f"calibration-v{CALIBRATION_VERSION}\x00{self.kind}\x00".encode())
        h.update(self.base.name.encode() + b"\x00")
        h.update(" ".join(x.hex() for x in map(float, cost_scalars(self.base))).encode())
        for category in CATEGORIES:
            s = self.stats[category]
            h.update(
                f"\x00{category}:{s.count}:{float(s.mean).hex()}:"
                f"{float(s.m2).hex()}".encode()
            )
        return h.hexdigest()

    # -- pricing -----------------------------------------------------------

    def e_startup(self, confidence: Optional[float] = None) -> float:
        """Measured activation cost at the given confidence (base value when
        no restore samples were captured)."""
        r = self.stats["restore"]
        if not r.count:
            return float(self.base.e_startup)
        z = z_score(confidence)
        return r.mean + z * r.std if z else r.mean

    def transfer_scale(self, confidence: Optional[float] = None) -> float:
        """Multiplier applied to both transfer curves: ``1 + z·cv(commit)``."""
        z = z_score(confidence)
        cv = self.stats["commit"].cv
        return 1.0 + z * cv if z and cv else 1.0

    def cost_model(self, confidence: Optional[float] = None) -> CostModel:
        """Materialize the measured statistics as a plain CostModel.

        Returns ``self.base`` — the very same object — whenever the
        materialized scalars equal the base scalars bitwise, so a clean
        calibration loop (measurements match the model) keeps names,
        fingerprints, and solver outputs identical by construction.
        """
        e_s = self.e_startup(confidence)
        s = self.transfer_scale(confidence)
        base = self.base
        if e_s == float(base.e_startup) and s == 1.0:
            return base
        suffix = "+measured"
        z = z_score(confidence)
        if z:
            suffix += f"@{float(confidence):g}"
        return CostModel(
            e_startup=e_s,
            read=LinearTransfer(base.read.c0 * s, base.read.c1 * s),
            write=LinearTransfer(base.write.c0 * s, base.write.c1 * s),
            name=base.name + suffix,
        )

    # -- persistence -------------------------------------------------------

    def to_payload(self, **meta) -> Dict[str, object]:
        return {
            "version": CALIBRATION_VERSION,
            "kind": self.kind,
            "fingerprint": self.fingerprint(),
            "base": {
                "name": self.base.name,
                "e_startup": float(self.base.e_startup),
                "read": [float(self.base.read.c0), float(self.base.read.c1)],
                "write": [float(self.base.write.c0), float(self.base.write.c1)],
            },
            "stats": {c: self.stats[c].to_dict() for c in CATEGORIES},
            "meta": {**self.meta, **meta},
        }

    def to_json(self, path: str, **meta) -> None:
        with open(path, "w") as f:
            json.dump(self.to_payload(**meta), f, indent=2)
            f.write("\n")

    @classmethod
    def from_payload(cls, payload: Mapping[str, object]) -> "MeasuredCostTable":
        try:
            version = payload["version"]
        except (KeyError, TypeError) as exc:
            raise CalibrationError("not a calibration payload (no version)") from exc
        if version != CALIBRATION_VERSION:
            raise CalibrationError(
                f"calibration version {version!r} != supported "
                f"{CALIBRATION_VERSION}"
            )
        b = payload["base"]
        base = CostModel(
            e_startup=float(b["e_startup"]),
            read=LinearTransfer(*map(float, b["read"])),
            write=LinearTransfer(*map(float, b["write"])),
            name=str(b["name"]),
        )
        table = cls(base, str(payload["kind"]), meta=payload.get("meta"))
        for category, d in dict(payload["stats"]).items():
            if category not in table.stats:
                raise CalibrationError(f"unknown stats category {category!r}")
            table.stats[category] = KernelStats.from_dict(d)
        recorded = payload.get("fingerprint")
        if recorded is not None and recorded != table.fingerprint():
            raise CalibrationError(
                "calibration fingerprint mismatch: file was edited or "
                "written by an incompatible build"
            )
        return table

    @classmethod
    def from_json(cls, path: str) -> "MeasuredCostTable":
        with open(path) as f:
            return cls.from_payload(json.load(f))

    # -- reporting ---------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "kind": self.kind,
            "base": self.base.name,
            "n_samples": self.n_samples,
            "fingerprint": self.fingerprint(),
        }
        for category in CATEGORIES:
            s = self.stats[category]
            out[category] = {"count": s.count, "mean": s.mean, "std": s.std}
        return out

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"MeasuredCostTable(kind={self.kind!r}, base={self.base.name!r}, "
            f"n_samples={self.n_samples}, "
            f"fingerprint={self.fingerprint()[:12]}…)"
        )


# ---------------------------------------------------------------------------
# Measured-default registry: slot a calibration in wherever the analytical
# default_cost_model would be consulted (plan builds, config-lowered specs).
# ---------------------------------------------------------------------------

_MEASURED_DEFAULTS: Dict[str, MeasuredCostTable] = {}


def _analytical_default(kind: str) -> CostModel:
    """The pre-calibration default — bypasses the measured registry so a
    table's ``base`` never recursively points at another calibration."""
    from .layer_profile import analytical_cost_model

    return analytical_cost_model(kind)


def install_measured_default(
    table: MeasuredCostTable, kind: Optional[str] = None
) -> None:
    """Register ``table`` as the default cost source for its graph kind:
    subsequent ``default_cost_model(kind)`` calls return
    ``table.cost_model()`` instead of the analytical model."""
    if not isinstance(table, MeasuredCostTable):
        raise CalibrationError(
            f"expected a MeasuredCostTable, got {type(table).__name__}"
        )
    _MEASURED_DEFAULTS[str(kind if kind is not None else table.kind)] = table


def measured_default(kind: str) -> Optional[MeasuredCostTable]:
    return _MEASURED_DEFAULTS.get(kind)


def clear_measured_defaults(kind: Optional[str] = None) -> None:
    if kind is None:
        _MEASURED_DEFAULTS.clear()
    else:
        _MEASURED_DEFAULTS.pop(str(kind), None)


@contextmanager
def use_measured(table: MeasuredCostTable, kind: Optional[str] = None):
    """Scoped :func:`install_measured_default` (restores the previous
    registration on exit) — what the traffic harness's ``--replan`` and the
    tests use."""
    key = str(kind if kind is not None else table.kind)
    previous = _MEASURED_DEFAULTS.get(key)
    install_measured_default(table, key)
    try:
        yield table
    finally:
        if previous is None:
            _MEASURED_DEFAULTS.pop(key, None)
        else:
            _MEASURED_DEFAULTS[key] = previous
