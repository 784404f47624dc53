"""Span tracer emitting Chrome ``trace_event`` JSON (Perfetto-loadable).

The port's copy of ``repro/obs/trace.py``: the same events, tracks and
default category (``"repro"``), so a trace of either package loads in the
same Perfetto views. Design points:

- **Disabled by default, near-zero cost when off.** ``TRACER.span(...)``
  returns a shared no-op context manager when disabled; hot paths (plan-table
  lookup, ``BurstRuntime`` bursts) additionally guard on ``TRACER.enabled``
  so the disabled cost is one attribute check.
- **Two clocks.** The trace timeline (``ts``/``dur``) is wall-clock
  microseconds from ``time.perf_counter()`` relative to the moment tracing
  was enabled — that is what Perfetto renders. Callers that live on the
  traffic harness's virtual clock pass ``vt=...`` and the virtual timestamp
  rides along in the event ``args`` so both timelines are recoverable.
- **Tracks.** ``pid``/``tid`` pairs map to Perfetto tracks; ``set_process``
  / ``set_thread`` emit the ``ph:"M"`` metadata events that name them.
  Solver/plan-table spans live on their own pid, the runtime's bursts on
  another; the traffic-harness tracks are laid out as in the reference.

Event phases used: ``X`` (complete span, ``ts``+``dur``), ``i`` (instant),
``C`` (counter series, e.g. the harvest pool charge), ``M`` (metadata).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List

__all__ = [
    "TRACER",
    "Tracer",
    "PID_TRAFFIC",
    "PID_SOLVER",
    "PID_RUNTIME",
    "PID_SWARM",
    "TID_SCHEDULER",
    "TID_HARVEST",
    "request_tid",
    "node_tid",
]

# Track layout shared by all instrumented call sites. Request tracks are
# allocated as TID_REQUEST_BASE + rid (see request_tid); swarm node tracks
# as TID_NODE_BASE + node index (see node_tid) on the swarm pid.
PID_TRAFFIC = 1
PID_SOLVER = 2
PID_RUNTIME = 3
PID_SWARM = 4
TID_SCHEDULER = 0
TID_HARVEST = 1
TID_REQUEST_BASE = 100
TID_NODE_BASE = 200


def request_tid(rid: int) -> int:
    """Perfetto thread id for request ``rid``'s per-request track."""
    return TID_REQUEST_BASE + int(rid)


def node_tid(node: int) -> int:
    """Perfetto thread id for swarm node ``node``'s per-node track
    (one track per harvesting device on the :data:`PID_SWARM` process)."""
    return TID_NODE_BASE + int(node)


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **args: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """An open ``ph:"X"`` complete event; closing the context records it."""

    __slots__ = ("_tracer", "name", "cat", "pid", "tid", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, pid: int, tid: int, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.pid = pid
        self.tid = tid
        self.args = args

    def set(self, **args: Any) -> None:
        """Attach additional args to the span before it closes."""
        self.args.update(args)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        tracer = self._tracer
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        ev: Dict[str, Any] = {
            "name": self.name,
            "cat": self.cat or "repro",
            "ph": "X",
            "ts": (self._t0 - tracer._t0) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "pid": self.pid,
            "tid": self.tid,
        }
        if self.args:
            ev["args"] = self.args
        tracer._events.append(ev)
        return False


class Tracer:
    """Process-global event collector; see module docstring for the model."""

    def __init__(self):
        self.enabled = False
        self._events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._tracks: Dict[Any, str] = {}

    # -- lifecycle ---------------------------------------------------------

    def configure(self, enabled: bool = True, clear: bool = True) -> None:
        """Turn tracing on/off. ``clear`` drops buffered events and re-zeroes
        the wall-clock origin so a fresh capture starts at ts=0."""
        if clear:
            self._events = []
            self._tracks = {}
            self._t0 = time.perf_counter()
        self.enabled = enabled

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self.configure(enabled=False, clear=True)

    # -- track naming ------------------------------------------------------

    def set_process(self, pid: int, name: str) -> None:
        if not self.enabled or ("p", pid) in self._tracks:
            return
        self._tracks[("p", pid)] = name
        self._events.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "args": {"name": name}}
        )

    def set_thread(self, pid: int, tid: int, name: str) -> None:
        if not self.enabled or ("t", pid, tid) in self._tracks:
            return
        self._tracks[("t", pid, tid)] = name
        self._events.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": name}}
        )

    # -- event emission ----------------------------------------------------

    def span(self, name: str, cat: str = "", pid: int = PID_TRAFFIC, tid: int = TID_SCHEDULER, **args: Any):
        """Context manager timing a nested span. No-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, pid, tid, args)

    def instant(self, name: str, cat: str = "", pid: int = PID_TRAFFIC, tid: int = TID_SCHEDULER, **args: Any) -> None:
        """Point-in-time event (admit/defer/reject, NVM commit, crash...)."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat or "repro",
            "ph": "i",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": pid,
            "tid": tid,
            "s": "t",  # thread-scoped instant
        }
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, values: Dict[str, float], pid: int = PID_TRAFFIC, tid: int = TID_HARVEST) -> None:
        """Counter-series sample (rendered as a filled chart in Perfetto)."""
        if not self.enabled:
            return
        self._events.append(
            {
                "name": name,
                "cat": "repro",
                "ph": "C",
                "ts": (time.perf_counter() - self._t0) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": dict(values),
            }
        )

    # -- export ------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def chrome_trace(self) -> Dict[str, Any]:
        """The JSON object Perfetto / chrome://tracing loads directly."""
        return {"traceEvents": list(self._events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the number of events."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")
        return len(self._events)


#: Process-global tracer shared by every instrumented call site.
TRACER = Tracer()
