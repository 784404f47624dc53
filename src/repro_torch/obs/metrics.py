"""Process-global metrics registry: counters, gauges, histograms, and the
registry-backed counter dicts behind module globals such as the runtime's
``COMMIT_STATS`` and the plan-table builder's ``BUILD_STATS``.

The port's copy of ``repro/obs/metrics.py``, stdlib only. Consumers use the
*snapshot-and-diff* pattern — absolute values are meaningless in a process
that has run other work — and :func:`reset_all` gives a clean baseline.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "Counter",
    "CounterDict",
    "Gauge",
    "Histogram",
    "METRICS",
    "MetricsRegistry",
    "diff_snapshots",
    "reset_all",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Mapping[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Base class: a named instrument owned by one registry."""

    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def reset(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def snapshot(self):  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic counter, optionally split by labels.

    ``inc()`` with no labels accumulates under the empty label set; with
    labels (``c.inc(1, backend="numpy")``) each distinct label combination
    gets its own cell. ``snapshot()`` returns a plain dict keyed by a
    ``"k=v,k2=v2"`` string (``""`` for the unlabeled cell) so it JSON-dumps
    cleanly.
    """

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._cells: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1, **labels: str) -> None:
        key = _label_key(labels)
        self._cells[key] = self._cells.get(key, 0) + value

    def value(self, **labels: str) -> float:
        return self._cells.get(_label_key(labels), 0)

    def reset(self) -> None:
        self._cells.clear()

    def snapshot(self) -> Dict[str, float]:
        return {
            ",".join(f"{k}={v}" for k, v in key): val
            for key, val in sorted(self._cells.items())
        }


class Gauge(_Metric):
    """Last-write-wins value, optionally split by labels."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._cells: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        self._cells[_label_key(labels)] = value

    def value(self, **labels: str) -> Optional[float]:
        return self._cells.get(_label_key(labels))

    def reset(self) -> None:
        self._cells.clear()

    def snapshot(self) -> Dict[str, float]:
        return {
            ",".join(f"{k}={v}" for k, v in key): val
            for key, val in sorted(self._cells.items())
        }


class Histogram(_Metric):
    """Streaming count/sum/min/max summary (no stored samples, no buckets —
    enough for overhead accounting without unbounded memory)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self.reset()

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
            "mean": self.mean,
        }


class CounterDict(dict, _Metric):
    """A plain ``dict`` that is also a registered metric.

    Module-global counter dicts (``runtime.COMMIT_STATS``,
    ``plan_table.BUILD_STATS``) are updated as dicts
    (``COMMIT_STATS["commits"] += 1``) and compared as dicts, while
    :func:`reset_all` reaches them through the registry.
    """

    kind = "counter_dict"

    def __init__(self, name: str, keys: Iterable[str], help: str = ""):
        _Metric.__init__(self, name, help)
        self._initial_keys = tuple(keys)
        dict.__init__(self, {k: 0 for k in self._initial_keys})

    def reset(self) -> None:
        # Re-zero the *initial* schema and drop any ad-hoc keys added since,
        # matching the semantics of the old reset_* helpers which rebuilt the
        # dict contents in place.
        for k in [k for k in self if k not in self._initial_keys]:
            del self[k]
        for k in self._initial_keys:
            self[k] = 0

    def snapshot(self) -> Dict[str, float]:
        return dict(self)


class MetricsRegistry:
    """Owns every instrument; one ``snapshot()``/``reset()``/``diff()``."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and type(existing) is type(metric):
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter(name, help))  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge(name, help))  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._register(Histogram(name, help))  # type: ignore[return-value]

    def counter_dict(
        self, name: str, keys: Iterable[str], help: str = ""
    ) -> CounterDict:
        return self._register(CounterDict(name, keys, help))  # type: ignore[return-value]

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Plain-dict view of every registered instrument (JSON-safe)."""
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    def diff(
        self, before: Mapping[str, Mapping[str, float]]
    ) -> Dict[str, Dict[str, float]]:
        """Delta of the current snapshot against an earlier one; cells that
        did not change are omitted, so the result reads as "what this span
        of work did"."""
        return diff_snapshots(before, self.snapshot())

    def dump_json(self, path: str, **meta) -> None:
        payload = dict(meta)
        payload["metrics"] = self.snapshot()
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")


def diff_snapshots(
    before: Mapping[str, Mapping[str, float]],
    after: Mapping[str, Mapping[str, float]],
) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for name, cells in after.items():
        prev = before.get(name, {})
        if not isinstance(cells, Mapping):  # pragma: no cover - defensive
            continue
        delta = {}
        for key, val in cells.items():
            p = prev.get(key, 0)
            if isinstance(val, (int, float)) and isinstance(p, (int, float)):
                if val != p:
                    delta[key] = val - p
            elif val != p:
                delta[key] = val
        if delta:
            out[name] = delta
    return out


#: The process-global registry. Module-level counter dicts across the repo
#: register themselves here at import time.
METRICS = MetricsRegistry()


def reset_all() -> None:
    """Zero every registered instrument (``reset_commit_stats`` and every
    other counter's reset)."""
    METRICS.reset()
