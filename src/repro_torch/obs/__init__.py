"""Telemetry of the port: the port's own copy of ``repro/obs``.

Stdlib only (importing it pulls in neither torch nor numpy):

- :mod:`repro_torch.obs.metrics` — a process-global registry of named
  counters, gauges and histograms with one ``snapshot()``/``reset()``/
  ``diff()`` API; ``COMMIT_STATS`` and ``BUILD_STATS`` are registry-backed
  dicts.
- :mod:`repro_torch.obs.trace` — a span tracer emitting Chrome
  ``trace_event`` JSON (Perfetto). Disabled by default; hot paths guard on
  ``TRACER.enabled``, so tracing that is off costs one attribute check.
- :mod:`repro_torch.obs.ledger` — per-request / per-cycle attribution of
  tabulated energy into restore, compute, commit and replay, with a
  conservation check at the solver's tolerance.
- :mod:`repro_torch.obs.log` — the launchers' ``[<tag>] ...`` progress lines
  through :mod:`logging`.
"""

from . import ledger, log, metrics, trace  # noqa: F401
from .ledger import EnergyLedger
from .metrics import METRICS, reset_all
from .trace import TRACER

__all__ = [
    "METRICS",
    "TRACER",
    "EnergyLedger",
    "ledger",
    "log",
    "metrics",
    "reset_all",
    "trace",
]
