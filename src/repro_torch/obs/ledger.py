"""Energy ledger: per-request / per-cycle attribution of tabulated draw.

Every successful energy cycle charges three categories, read straight off
the cycle's :class:`repro_torch.core.burst.BurstDetail`:

- ``restore`` — the fixed activation cost E_s (``e_startup``) paid on every
  wake-from-power-loss,
- ``compute`` — the task energy executed in the cycle (``e_task``),
- ``commit`` — NVM transfer traffic (``e_read + e_write``) for loading and
  committing the burst's live set.

Crashed cycle attempts are recorded under the separate ``replay`` overhead
category: the admission controller reserved energy for each cycle *once*
(the tabulated draw), so energy burned by an attempt that failed to commit
is overhead on top of the reservation, not part of it. That split is exactly
what makes the conservation check work: for a drained run, the sum of the
three charged categories must equal the ``HarvestModel`` pool delta
(``energy_spent``) to within solver tolerance, while ``replay`` quantifies
the paper's activation-overhead figure per run.

The port's copy of ``repro/obs/ledger.py``. Stdlib only; the solver
tolerance constants are imported lazily so :mod:`repro_torch.obs` stays
importable without numpy.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

__all__ = [
    "CATEGORIES",
    "CHARGED_CATEGORIES",
    "EnergyLedger",
    "LedgerEntry",
    "LedgerImbalance",
]

CHARGED_CATEGORIES = ("restore", "compute", "commit")
CATEGORIES = CHARGED_CATEGORIES + ("replay",)


class LedgerImbalance(AssertionError):
    """Ledger charged total disagrees with the harvest pool delta."""


@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    rid: int
    cycle: int
    category: str
    energy: float
    vt: Optional[float] = None  # virtual-clock time, when the caller has one


def _tolerance() -> Tuple[float, float]:
    from ..core.partition import BUDGET_ABS, BUDGET_REL

    return BUDGET_REL, BUDGET_ABS


class EnergyLedger:
    """Append-only energy attribution with conservation checking."""

    def __init__(self):
        self.entries: List[LedgerEntry] = []

    # -- recording ---------------------------------------------------------

    def charge(
        self,
        rid: int,
        cycle: int,
        *,
        restore: float = 0.0,
        compute: float = 0.0,
        commit: float = 0.0,
        vt: Optional[float] = None,
    ) -> None:
        """Attribute one committed cycle's draw across the three categories."""
        for category, energy in (
            ("restore", restore),
            ("compute", compute),
            ("commit", commit),
        ):
            if energy:
                self.entries.append(LedgerEntry(rid, cycle, category, float(energy), vt))

    def overhead(self, rid: int, cycle: int, energy: float, vt: Optional[float] = None) -> None:
        """Record a crashed attempt's energy as replay overhead (outside the
        admission reservation — see module docstring)."""
        self.entries.append(LedgerEntry(rid, cycle, "replay", float(energy), vt))

    # -- aggregation -------------------------------------------------------

    def by_category(self) -> Dict[str, float]:
        out = {c: 0.0 for c in CATEGORIES}
        for e in self.entries:
            out[e.category] = out.get(e.category, 0.0) + e.energy
        return out

    def by_request(self, rid: int) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.entries:
            if e.rid == rid:
                out[e.category] = out.get(e.category, 0.0) + e.energy
        return out

    def charged_total(self) -> float:
        return sum(e.energy for e in self.entries if e.category != "replay")

    def overhead_total(self) -> float:
        return sum(e.energy for e in self.entries if e.category == "replay")

    def overhead_fraction(self) -> float:
        """Replay energy as a fraction of charged energy — the per-run analog
        of the paper's 0.12% activation-overhead figure. 0.0 on empty runs."""
        charged = self.charged_total()
        return self.overhead_total() / charged if charged else 0.0

    # -- conservation ------------------------------------------------------

    def conservation_error(self, pool_spent: float) -> float:
        """Absolute disagreement between charged total and the pool delta."""
        return abs(self.charged_total() - pool_spent)

    def conserves(self, pool_spent: float) -> bool:
        """True iff charged total equals ``pool_spent`` at solver tolerance
        (the same BUDGET_REL/BUDGET_ABS every feasibility check uses)."""
        rel, abs_tol = _tolerance()
        scale = max(abs(self.charged_total()), abs(pool_spent))
        return self.conservation_error(pool_spent) <= scale * rel + abs_tol

    def check_conservation(self, pool_spent: float) -> None:
        """Raise :class:`LedgerImbalance` unless the ledger conserves."""
        if not self.conserves(pool_spent):
            raise LedgerImbalance(
                f"energy ledger charged {self.charged_total()!r} but the "
                f"harvest pool spent {pool_spent!r} "
                f"(err={self.conservation_error(pool_spent):.3e})"
            )

    # -- export ------------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        out = self.by_category()
        out["charged_total"] = self.charged_total()
        out["overhead_fraction"] = self.overhead_fraction()
        out["entries"] = len(self.entries)
        return out

    def to_rows(self) -> List[Dict[str, object]]:
        return [dataclasses.asdict(e) for e in self.entries]

    def sorted_rows(self) -> List[Dict[str, object]]:
        """:meth:`to_rows` in deterministic (rid, cycle) order. Append order
        depends on interleaving (the traffic harness commits many requests'
        cycles through one batched executor), so exports sort: the stable
        sort keeps each (rid, cycle)'s category rows in charge order while
        making the file — and any calibration fingerprint built from it —
        reproducible across schedules that charged the same work."""
        return [
            dataclasses.asdict(e)
            for e in sorted(self.entries, key=lambda e: (e.rid, e.cycle))
        ]

    def dump_json(self, path: str, **meta) -> None:
        payload = dict(meta)
        payload["summary"] = self.summary()
        payload["entries"] = self.sorted_rows()
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
