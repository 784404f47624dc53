"""Continuous-traffic serving harness: async request queue, energy-budget
admission control, and continuation batching over the plan table.

The port's copy of ``repro/launch/traffic.py``, over the port's runtime,
planner and ``obs/``. It is the fleet-scale face of the serving path: the
planned path serves one energy-bounded request; this module sustains a
stream:

* **Arrival processes** — deterministic fixed-interval, Poisson-like
  (seeded-PRNG exponential gaps), or replay-from-trace (JSON records) —
  produce :class:`Request` objects with virtual arrival timestamps that feed
  an ``asyncio.Queue`` (the request queue) through a virtual-clock-driven
  producer coroutine.

* **Admission control** checks each request's *tabulated* energy (looked up
  O(1) from the :class:`~repro_torch.launch.planner.ServePlanner` plan table — no
  DP solve on the admission path) against the remaining harvest budget
  (:class:`HarvestModel`): requests that can never fit are **rejected**,
  requests that outstrip the current charge are **deferred** to a FIFO queue
  and retried as the budget replenishes, and admitted requests *reserve*
  their whole tabulated draw up front. The harvest pool models energy
  *income over time*; the per-cycle buffer Q (``cycle_budget``) that bounds
  any single burst is a separate, smaller quantity — exactly the paper's
  E_burst — used to split each request into committed cycles.

* **Continuation batching**: an admitted request opens as a
  :class:`Continuation` — a steppable :class:`~repro_torch.core.runtime.BurstRuntime`
  whose cycles commit one at a time. The scheduler drains one shape bucket's
  continuations at a time (round-robin *within* the bucket, FIFO *across*
  buckets), so consecutive cycles — even from different requests — hit the
  same cached prefill and decode graph
  (:func:`repro_torch.launch.serve._step_fns`): zero captures after warmup,
  pinned by the ``TRACE_COUNT`` snapshot the report carries. A mid-cycle
  :class:`~repro_torch.core.runtime.PowerFailure` leaves the continuation queued
  with its committed index intact; the next visit replays the cycle.

Time is two-track: the *virtual* clock drives arrivals and energy
replenishment (deterministic under a fixed seed — the tests pin admission /
deferral ordering exactly), while wall-clock timestamps feed the serving
metrics (sustained requests/sec, p50/p95/p99 latency) reported by
:class:`TrafficReport` and the ``serving_traffic`` benchmark section.

CLI (smoke-checkable, used by CI)::

    python -m repro_torch.launch.planner --arch qwen3-4b --buckets 2x16 \\
        --out plan.npz --device cpu
    python -m repro_torch.launch.traffic --arch qwen3-4b --plan-table plan.npz \\
        --device cpu --arrivals poisson --rate 2.0 --n 12 --shapes 2x8x8 \\
        --capacity-requests 1.5 --rate-requests 0.4 \\
        --expect-admitted 1 --expect-deferred 1 --expect-zero-retrace

``--build`` builds the table in-process instead (on the sweep kernel with
``--device cuda``, its plain version with ``--device cpu``). ``--full``
serves the architecture at its published width. The calibration loop
(``--replan``, ``--drift-tol``, ``--expect-replan-identical``,
``--calibration``) is ROADMAP.md queue 1, item 6.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import heapq
import json
import random
import sys
import time
from collections import deque
from typing import (
    Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple,
)

import numpy as np

from ..core.partition import BUDGET_ABS, BUDGET_REL, within_budget
from ..core.runtime import COMMIT_STATS, PowerFailure
from ..obs.ledger import EnergyLedger
from ..obs.log import enable_cli_output, get_emitter
from ..obs.metrics import METRICS
from ..obs.trace import (
    PID_RUNTIME,
    PID_SOLVER,
    PID_TRAFFIC,
    TID_HARVEST,
    TID_SCHEDULER,
    TRACER,
    request_tid,
)

# Structured progress reporting: silent under pytest / library use (no
# handler), "[traffic] ..." on stdout under the CLI (enable_cli_output).
_LOG = get_emitter("repro_torch.traffic")

__all__ = [
    "Request",
    "Continuation",
    "HarvestModel",
    "TrafficReport",
    "TrafficHarness",
    "deterministic_arrivals",
    "poisson_arrivals",
    "trace_arrivals",
    "load_trace",
    "main",
]


# ---------------------------------------------------------------------------
# Requests and arrival processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a shape plus its virtual arrival time."""

    rid: int
    batch: int
    prompt_len: int
    gen: int
    time: float = 0.0
    seed: int = 0

    @property
    def max_seq(self) -> int:
        return self.prompt_len + self.gen

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.batch, self.prompt_len, self.gen)


def deterministic_arrivals(
    n: int,
    interval: float,
    shape: Tuple[int, int, int],
    *,
    start: float = 0.0,
    seed: int = 0,
) -> List[Request]:
    """``n`` identical-shape requests, one every ``interval`` virtual time
    units. All requests share ``seed`` (one model, one prompt set) so the
    whole stream reuses a single cached executable + params entry."""
    batch, prompt_len, gen = shape
    return [
        Request(rid=i, batch=batch, prompt_len=prompt_len, gen=gen,
                time=start + i * interval, seed=seed)
        for i in range(n)
    ]


def poisson_arrivals(
    n: int,
    rate: float,
    shapes: Sequence[Tuple[int, int, int]],
    *,
    seed: int = 0,
    start: float = 0.0,
    request_seed: int = 0,
) -> List[Request]:
    """Poisson-like arrivals: exponential inter-arrival gaps at ``rate``
    requests per unit virtual time from a seeded PRNG, shapes drawn
    uniformly from ``shapes``. Deterministic for a fixed ``seed``."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    rng = random.Random(seed)
    t = start
    out = []
    for i in range(n):
        t += rng.expovariate(rate)
        batch, prompt_len, gen = shapes[rng.randrange(len(shapes))]
        out.append(Request(rid=i, batch=batch, prompt_len=prompt_len,
                           gen=gen, time=t, seed=request_seed))
    return out


def trace_arrivals(records: Iterable) -> List[Request]:
    """Replay-from-trace: records are dicts with ``time``/``batch``/
    ``prompt_len``/``gen`` (optional ``rid``/``seed``), tuples
    ``(time, batch, prompt_len, gen[, seed])``, or ready Requests."""
    out: List[Request] = []
    for i, rec in enumerate(records):
        if isinstance(rec, Request):
            out.append(rec)
        elif isinstance(rec, dict):
            out.append(Request(
                rid=int(rec.get("rid", i)), batch=int(rec["batch"]),
                prompt_len=int(rec["prompt_len"]), gen=int(rec["gen"]),
                time=float(rec.get("time", i)), seed=int(rec.get("seed", 0)),
            ))
        else:
            t, batch, prompt_len, gen = rec[:4]
            seed = int(rec[4]) if len(rec) > 4 else 0
            out.append(Request(rid=i, batch=int(batch),
                               prompt_len=int(prompt_len), gen=int(gen),
                               time=float(t), seed=seed))
    return sorted(out, key=lambda r: (r.time, r.rid))


def load_trace(path: str) -> List[Request]:
    """Load a JSON arrival trace (a list of record dicts / tuples)."""
    with open(path) as fh:
        return trace_arrivals(json.load(fh))


# ---------------------------------------------------------------------------
# Continuations: the schedulable unit
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Continuation:
    """An admitted request opened as a steppable BurstRuntime.

    ``scope`` (a context-manager factory) wraps every step where an
    executor needs one; the port has no mesh, so its executors leave it
    None.
    """

    request: Request
    plan: Any  # SegmentPlan
    cycles: List[Tuple[int, int]]
    runtime: Any  # BurstRuntime
    e_startup: float
    output: str = "sequence"
    scope: Optional[Callable[[], Any]] = None

    @property
    def bucket_key(self) -> Tuple[int, int]:
        return (self.plan.batch, self.plan.seq_bucket)

    @property
    def n_cycles(self) -> int:
        return len(self.cycles)

    @property
    def cycles_done(self) -> int:
        return int(self.runtime.nvm.read_index())

    @property
    def done(self) -> bool:
        return self.cycles_done >= self.n_cycles

    def cycle_cost(self, c: int) -> float:
        """Modeled energy of cycle ``c``: E_s + its token steps."""
        i, j = self.cycles[c]
        return self.e_startup + (j - i + 1) * self.plan.e_total

    @property
    def total_cost(self) -> float:
        """The whole request's tabulated draw (what admission reserves)."""
        return sum(self.cycle_cost(c) for c in range(self.n_cycles))

    def step(self) -> bool:
        """Commit one cycle; True when the request is complete. May raise
        PowerFailure (the committed index survives — re-step to replay)."""
        if self.scope is None:
            return self.runtime.step()
        with self.scope():
            return self.runtime.step()

    def run_to_completion(self, max_activations: int = 10 ** 6):
        """Drive :meth:`step` to completion, riding through injected power
        failures (the single-request path `_serve_planned` uses)."""
        for _ in range(max_activations):
            try:
                while not self.step():
                    pass
                return self.tokens()
            except PowerFailure:
                continue
        raise RuntimeError("did not complete within max_activations")

    def tokens(self):
        return self.runtime.outputs()[self.output]


def request_energy(
    plan, gen: int, cycle_budget: Optional[float], e_startup: float
) -> Tuple[List[Tuple[int, int]], float]:
    """Tabulated cycles + total draw for a request, without opening it.

    This is the admission-path counterpart of opening a Continuation: an
    O(gen) grouping over the looked-up plan — no solver, no graph lowering —
    so rejected/deferred requests never pay params/graph setup.
    """
    from .planner import request_cycles  # lazy: avoid import cycle at load

    cycles = request_cycles(gen, plan.e_total, cycle_budget,
                            e_startup=e_startup)
    total = sum(e_startup + (j - i + 1) * plan.e_total for (i, j) in cycles)
    return cycles, total


# ---------------------------------------------------------------------------
# Harvest budget
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HarvestModel:
    """Energy-harvesting admission budget: a storage pool replenished at
    ``rate`` (energy per unit *virtual* time), capped at ``capacity``.

    Admission *reserves* a request's whole tabulated energy up front
    (``draw``); deferral waits for replenishment; rejection is for requests
    that can never fit — ``e_req > capacity``, or ``rate == 0`` with
    ``e_req`` above the current charge. ``capacity=float('inf')`` disables
    admission control (everything fits immediately).

    Distinct from the per-cycle buffer Q: the pool bounds how much total
    work is admitted per unit time (income), Q bounds any single burst.
    """

    capacity: float
    rate: float = 0.0
    charge: Optional[float] = None

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError(f"capacity must be positive, got {self.capacity}")
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")
        if self.charge is None:
            self.charge = self.capacity
        self.charge = min(float(self.charge), float(self.capacity))
        self.harvested = 0.0
        self.spent = 0.0

    def replenish(self, dt: float) -> None:
        """Advance virtual time by ``dt``: harvest ``rate * dt``, capped."""
        if dt <= 0 or self.rate == 0 or not np.isfinite(self.capacity):
            return
        add = min(self.rate * dt, self.capacity - self.charge)
        if add > 0:
            self.charge += add
            self.harvested += add

    def fits(self, energy: float) -> bool:
        """Does ``energy`` fit the *current* charge (solver tolerance)?"""
        return within_budget(energy, self.charge)

    def can_ever_fit(self, energy: float) -> bool:
        """Could ``energy`` ever fit, given replenishment?"""
        if not within_budget(energy, self.capacity):
            return False
        return self.rate > 0 or self.fits(energy)

    def draw(self, energy: float) -> None:
        """Reserve an admitted request's tabulated draw."""
        self.charge -= energy
        self.spent += energy

    def time_until(self, energy: float) -> float:
        """Virtual time until ``energy`` fits (0 if it already does)."""
        if self.fits(energy):
            return 0.0
        if self.rate <= 0 or not within_budget(energy, self.capacity):
            return float("inf")
        return (energy - self.charge) / self.rate



# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrafficReport:
    """What one harness run observed (all counters are per-run deltas)."""

    arrived: int = 0
    admitted: int = 0
    deferred: int = 0    # requests deferred at least once
    rejected: int = 0
    completed: int = 0
    cycles_run: int = 0
    power_failures: int = 0
    executable_switches: int = 0  # bucket-key changes between cycles
    reject_reasons: Dict[str, int] = dataclasses.field(default_factory=dict)
    events: List[Tuple[float, str, int]] = dataclasses.field(
        default_factory=list)  # (virtual time, event, rid)
    latency_wall_s: List[float] = dataclasses.field(default_factory=list)
    latency_virtual: List[float] = dataclasses.field(default_factory=list)
    wall_seconds: float = 0.0
    virtual_makespan: float = 0.0
    trace_delta: Dict[str, int] = dataclasses.field(default_factory=dict)
    commit_delta: Dict[str, int] = dataclasses.field(default_factory=dict)
    planner_delta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    hit_rate: float = 0.0
    energy_spent: float = 0.0
    energy_harvested: float = 0.0
    final_charge: float = 0.0
    tokens: Dict[int, Any] = dataclasses.field(default_factory=dict)
    # Energy-ledger attribution (repro_torch.obs.ledger): restore/compute/commit
    # charged against the admission reservation, replay as overhead on top.
    energy_ledger: Dict[str, float] = dataclasses.field(default_factory=dict)
    ledger_conserved: Optional[bool] = None
    ledger_conservation_error: float = 0.0
    ledger_overhead_fraction: float = 0.0
    ledger: Optional[Any] = dataclasses.field(default=None, repr=False)

    @property
    def requests_per_s(self) -> float:
        return self.completed / self.wall_seconds if self.wall_seconds else 0.0

    def latency_percentiles_ms(self) -> Dict[str, float]:
        if not self.latency_wall_s:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        lat = np.asarray(self.latency_wall_s) * 1e3
        return {
            "p50": float(np.percentile(lat, 50)),
            "p95": float(np.percentile(lat, 95)),
            "p99": float(np.percentile(lat, 99)),
        }

    @property
    def retraces(self) -> int:
        return sum(self.trace_delta.values())

    def summary(self) -> str:
        pct = self.latency_percentiles_ms()
        return (
            f"{self.completed}/{self.arrived} completed "
            f"({self.admitted} admitted, {self.deferred} deferred, "
            f"{self.rejected} rejected) | "
            f"{self.requests_per_s:.1f} req/s, "
            f"p50/p95/p99 {pct['p50']:.1f}/{pct['p95']:.1f}/"
            f"{pct['p99']:.1f} ms | "
            f"{self.cycles_run} cycles ({self.power_failures} power "
            f"failures, {self.commit_delta.get('replays', 0)} replays) | "
            f"plan-cache hit rate {self.hit_rate:.3f} | "
            f"retraces {self.retraces} | "
            f"energy {self.energy_spent:.4g} spent "
            f"(replay overhead {self.ledger_overhead_fraction:.2%}, "
            f"ledger {'conserved' if self.ledger_conserved else 'IMBALANCED'})"
        )


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


class _VirtualClock:
    """Deterministic virtual time shared by the producer (arrivals) and the
    scheduler: coroutines ``wait_until`` a timestamp, the scheduler
    ``advance_to`` the next event and yields so due waiters run."""

    def __init__(self) -> None:
        self.now = 0.0
        self._waiters: List[Tuple[float, int, asyncio.Future]] = []
        self._n = 0

    async def wait_until(self, t: float) -> None:
        if t <= self.now:
            return
        fut = asyncio.get_running_loop().create_future()
        self._n += 1
        heapq.heappush(self._waiters, (t, self._n, fut))
        await fut

    def next_wakeup(self) -> Optional[float]:
        return self._waiters[0][0] if self._waiters else None

    def advance_to(self, t: float) -> None:
        self.now = max(self.now, t)
        while self._waiters and self._waiters[0][0] <= self.now:
            _, _, fut = heapq.heappop(self._waiters)
            if not fut.done():
                fut.set_result(None)


@dataclasses.dataclass
class _Pending:
    """A request between lookup and admission (possibly deferred)."""

    request: Request
    plan: Any
    cycles: List[Tuple[int, int]]
    energy: float
    arrive_wall: float


class TrafficHarness:
    """Drives an executor (``repro_torch.launch.serve.PlannedExecutor`` in
    production, synthetic ones in the fast tests) under continuous traffic.

    The executor contract: ``.planner`` (a ServePlanner), and
    ``.open(batch, prompt_len, gen, *, seed, cycle_budget, plan, nvm,
    crash_hook) -> Continuation``. Optionally ``.warmup(shapes)`` to
    pre-compile executables outside the measured run.
    """

    def __init__(
        self,
        executor,
        *,
        harvest: Optional[HarvestModel] = None,
        cycle_budget: Optional[float] = None,
        service_time: float = 1.0,
        max_wait: Optional[float] = None,
        keep_tokens: bool = False,
        crash_hook_factory: Optional[Callable[[Request], Any]] = None,
        nvm_factory: Optional[Callable[[Request], Any]] = None,
    ) -> None:
        self.executor = executor
        self.planner = executor.planner
        self.harvest = harvest if harvest is not None else HarvestModel(
            capacity=float("inf"))
        self.cycle_budget = cycle_budget
        if service_time <= 0:
            raise ValueError("service_time must be positive")
        self.service_time = service_time
        self.max_wait = max_wait
        self.keep_tokens = keep_tokens
        self.crash_hook_factory = crash_hook_factory
        self.nvm_factory = nvm_factory

    # -- warmup ------------------------------------------------------------

    def warmup(self, requests: Sequence[Request]) -> int:
        """Run one throwaway request per distinct shape so compiles happen
        outside the measured window; returns the number of shapes warmed.
        Uses each shape's first-seen seed so the warmed params entry is the
        one the run will reuse."""
        warm = getattr(self.executor, "warmup", None)
        shapes: Dict[Tuple[int, int, int], int] = {}
        for r in sorted(requests, key=lambda r: (r.time, r.rid)):
            shapes.setdefault(r.shape, r.seed)
        if warm is None:
            return 0
        warm([(b, p, g, s) for (b, p, g), s in shapes.items()],
             cycle_budget=self.cycle_budget)
        return len(shapes)

    # -- the run -----------------------------------------------------------

    def run(self, requests: Sequence[Request]) -> TrafficReport:
        """Serve an arrival schedule to drain; returns the run's report."""
        return asyncio.run(self._run_async(list(requests)))

    async def _feed(self, requests: List[Request], clock: _VirtualClock,
                    queue: "asyncio.Queue[Request]") -> None:
        # The producer side of the async request queue: park until the
        # virtual clock reaches each arrival, then enqueue.
        for r in sorted(requests, key=lambda r: (r.time, r.rid)):
            await clock.wait_until(r.time)
            queue.put_nowait(r)
        self._feed_done = True

    async def _run_async(self, requests: List[Request]) -> TrafficReport:
        report = TrafficReport()
        ledger = EnergyLedger()
        report.ledger = ledger
        self._feed_done = not requests
        clock = _VirtualClock()
        if TRACER.enabled:
            TRACER.set_process(PID_TRAFFIC, "traffic")
            TRACER.set_thread(PID_TRAFFIC, TID_SCHEDULER, "scheduler")
            TRACER.set_thread(PID_TRAFFIC, TID_HARVEST, "harvest")
            TRACER.set_process(PID_SOLVER, "solver/plan-table")
            TRACER.set_process(PID_RUNTIME, "burst runtime")
        queue: "asyncio.Queue[Request]" = asyncio.Queue()
        deferred: deque[_Pending] = deque()
        ever_deferred: set = set()
        groups: Dict[Tuple[int, int], deque] = {}
        group_order: List[Tuple[int, int]] = []
        open_meta: Dict[int, _Pending] = {}
        last_key: Optional[Tuple[int, int]] = None

        trace0 = self._trace_snapshot()
        commit0 = dict(COMMIT_STATS)
        planner0 = self._planner_snapshot()
        harvested0, spent0 = self.harvest.harvested, self.harvest.spent
        wall0 = time.perf_counter()

        def event(kind: str, rid: int) -> None:
            report.events.append((clock.now, kind, rid))
            if TRACER.enabled:
                # each request gets its own Perfetto track; lifecycle events
                # land on it as instants carrying the virtual timestamp
                TRACER.set_thread(PID_TRAFFIC, request_tid(rid), f"request {rid}")
                TRACER.instant(
                    kind, cat="traffic", tid=request_tid(rid), rid=rid, vt=clock.now
                )

        def sample_harvest() -> None:
            if TRACER.enabled and np.isfinite(self.harvest.charge):
                TRACER.counter(
                    "harvest_charge", {"charge": self.harvest.charge},
                    tid=TID_HARVEST,
                )

        def reject(pend: _Pending, reason: str) -> None:
            report.rejected += 1
            report.reject_reasons[reason] = (
                report.reject_reasons.get(reason, 0) + 1)
            self._record_admission("rejected")
            event(f"reject:{reason}", pend.request.rid)

        def open_admitted(pend: _Pending) -> None:
            r = pend.request
            self.harvest.draw(pend.energy)
            sample_harvest()
            cont = self.executor.open(
                r.batch, r.prompt_len, r.gen, seed=r.seed,
                cycle_budget=self.cycle_budget, plan=pend.plan,
                nvm=self.nvm_factory(r) if self.nvm_factory else None,
                crash_hook=(self.crash_hook_factory(r)
                            if self.crash_hook_factory else None),
            )
            # the harness's request (rid, arrival time) is authoritative —
            # executors mint their own rids for standalone use
            cont.request = r
            key = cont.bucket_key
            if key not in groups:
                groups[key] = deque()
                group_order.append(key)
            groups[key].append(cont)
            open_meta[r.rid] = pend
            report.admitted += 1
            self._record_admission("admitted")
            event("admit", r.rid)

        def try_admit(pend: _Pending, *, arriving: bool) -> bool:
            """Admit/defer/reject one pending request; True if consumed
            (admitted or rejected), False if it should stay deferred."""
            r = pend.request
            if not self.harvest.can_ever_fit(pend.energy):
                reason = ("over_capacity"
                          if not within_budget(pend.energy,
                                               self.harvest.capacity)
                          else "no_replenishment")
                reject(pend, reason)
                return True
            if (self.max_wait is not None
                    and clock.now - r.time > self.max_wait + 1e-12):
                reject(pend, "max_wait")
                return True
            if self.harvest.fits(pend.energy):
                open_admitted(pend)
                return True
            if arriving:
                deferred.append(pend)
                if r.rid not in ever_deferred:
                    ever_deferred.add(r.rid)
                    report.deferred += 1
                    self._record_admission("deferred")
                event("defer", r.rid)
            return False

        def on_arrival(r: Request) -> None:
            report.arrived += 1
            event("arrive", r.rid)
            try:
                plan = self.planner.plan_for(r.batch, r.max_seq,
                                             self.cycle_budget)
            except Exception as e:  # UnknownBucketError / Infeasible
                pend = _Pending(r, None, [], 0.0, time.perf_counter())
                reject(pend, type(e).__name__)
                return
            cycles, energy = request_energy(
                plan, r.gen, self.cycle_budget, self.planner.e_startup)
            pend = _Pending(r, plan, cycles, energy, time.perf_counter())
            # FIFO fairness: while older requests wait for energy, newcomers
            # join the back of the deferral queue only if they don't fit the
            # *remaining* charge — cheap requests may overtake (documented,
            # pinned by the ordering tests).
            try_admit(pend, arriving=True)

        def retry_deferred() -> None:
            # deferred requests get first claim on replenished energy, FIFO
            while deferred:
                pend = deferred[0]
                consumed = try_admit(pend, arriving=False)
                if consumed:
                    deferred.popleft()
                    continue
                break  # head still waiting: preserve FIFO order

        def next_cycle() -> Optional[Continuation]:
            # continuation batching: drain the oldest bucket group before
            # switching executables; round-robin inside the group
            while group_order:
                key = group_order[0]
                grp = groups[key]
                if grp:
                    return grp[0]
                del groups[key]
                group_order.pop(0)
            return None

        def execute(cont: Continuation) -> None:
            nonlocal last_key
            rid = cont.request.rid
            c = cont.cycles_done  # index of the cycle this visit will run
            if last_key is not None and cont.bucket_key != last_key:
                report.executable_switches += 1
                if TRACER.enabled:
                    TRACER.instant(
                        "executable_switch", cat="traffic", tid=TID_SCHEDULER,
                        bucket=str(cont.bucket_key), vt=clock.now,
                    )
            last_key = cont.bucket_key
            grp = groups[cont.bucket_key]
            try:
                if TRACER.enabled:
                    with TRACER.span(
                        "cycle", cat="traffic", tid=request_tid(rid),
                        rid=rid, cycle=c, vt=clock.now,
                    ):
                        done = cont.step()
                else:
                    done = cont.step()
            except PowerFailure:
                report.power_failures += 1
                # the crashed attempt's energy was never reserved by
                # admission: book it as replay overhead, not a charge
                ledger.overhead(rid, c, cont.cycle_cost(c), vt=clock.now)
                event("power_failure", rid)
                return  # committed index intact; replay on the next visit
            report.cycles_run += 1
            restore, compute, commit = self._attribute_cycle(cont, c)
            ledger.charge(
                rid, c, restore=restore, compute=compute, commit=commit,
                vt=clock.now,
            )
            if done:
                grp.popleft()
                pend = open_meta.pop(cont.request.rid)
                report.completed += 1
                report.latency_wall_s.append(
                    time.perf_counter() - pend.arrive_wall)
                report.latency_virtual.append(
                    clock.now + self.service_time - cont.request.time)
                if self.keep_tokens:
                    report.tokens[cont.request.rid] = np.asarray(
                        cont.tokens())
                event("complete", cont.request.rid)
            else:
                grp.rotate(-1)  # round-robin within the bucket

        feeder = asyncio.ensure_future(self._feed(requests, clock, queue))
        try:
            while True:
                await asyncio.sleep(0)  # let the feeder flush due arrivals
                while not queue.empty():
                    on_arrival(queue.get_nowait())
                retry_deferred()
                cont = next_cycle()
                if cont is not None:
                    execute(cont)
                    dt = self.service_time
                    self.harvest.replenish(dt)
                    sample_harvest()
                    clock.advance_to(clock.now + dt)
                    continue
                # idle: jump to the next event (arrival / deferred-ready /
                # max-wait expiry), harvesting along the way
                horizons: List[float] = []
                nxt = clock.next_wakeup()
                if nxt is not None:
                    horizons.append(nxt)
                for pend in deferred:
                    wait = self.harvest.time_until(pend.energy)
                    if np.isfinite(wait):
                        horizons.append(clock.now + max(wait, 0.0))
                    if self.max_wait is not None:
                        horizons.append(pend.request.time + self.max_wait
                                        + 2e-12)
                if not horizons:
                    if (self._feed_done and queue.empty() and not deferred
                            and not any(groups.values())):
                        break
                    # feeder has items not yet due but no waiter registered
                    # yet: yield and re-check
                    continue
                t = min(horizons)
                self.harvest.replenish(t - clock.now)
                sample_harvest()
                clock.advance_to(t)
        finally:
            feeder.cancel()

        report.wall_seconds = time.perf_counter() - wall0
        report.virtual_makespan = clock.now
        report.trace_delta = self._trace_delta(trace0)
        report.commit_delta = {
            k: COMMIT_STATS[k] - commit0[k] for k in commit0}
        report.planner_delta = self._planner_delta(planner0)
        lk = report.planner_delta.get("lookups", 0)
        report.hit_rate = (
            report.planner_delta.get("hits", 0) / lk if lk else 0.0)
        report.energy_spent = self.harvest.spent - spent0
        report.energy_harvested = self.harvest.harvested - harvested0
        report.final_charge = self.harvest.charge
        if not np.isfinite(report.final_charge):
            report.final_charge = float("inf")
        # Energy-ledger closure: every admitted request drained, so the
        # charged categories must reproduce the pool delta exactly (at
        # solver tolerance); replay overhead sits outside the reservation.
        report.energy_ledger = ledger.by_category()
        report.ledger_overhead_fraction = ledger.overhead_fraction()
        report.ledger_conservation_error = ledger.conservation_error(
            report.energy_spent)
        report.ledger_conserved = ledger.conserves(report.energy_spent)
        return report

    @staticmethod
    def _attribute_cycle(cont: Continuation, c: int) -> Tuple[float, float, float]:
        """Split cycle ``c``'s tabulated cost into (restore, compute, commit).

        Preferred source is the runtime partition's own
        :class:`~repro_torch.core.burst.BurstDetail` — it separates E_s, task
        energy, and NVM transfer traffic — but only when its total agrees
        with the admission-path :meth:`Continuation.cycle_cost` (the quantity
        the harvest pool actually drew), so ledger conservation holds by
        construction. Executors whose runtime prices cycles differently fall
        back to the admission decomposition with commit folded into zero.
        """
        total = cont.cycle_cost(c)
        try:
            d = cont.runtime.partition.bursts[c]
        except Exception:
            d = None
        if d is not None:
            dt = float(d.total)
            if abs(dt - total) <= max(abs(dt), abs(total)) * BUDGET_REL + BUDGET_ABS:
                return float(d.e_startup), float(d.e_task), float(d.e_read + d.e_write)
        return float(cont.e_startup), float(total - cont.e_startup), 0.0

    # -- snapshots (diffs, never absolutes) --------------------------------

    @staticmethod
    def _trace_snapshot() -> Dict[str, int]:
        serve = sys.modules.get("repro_torch.launch.serve")
        return dict(serve.TRACE_COUNT) if serve is not None else {}

    @classmethod
    def _trace_delta(cls, before: Dict[str, int]) -> Dict[str, int]:
        now = cls._trace_snapshot()
        return {k: now.get(k, 0) - before.get(k, 0)
                for k in set(before) | set(now)}

    def _planner_snapshot(self) -> Dict[str, Any]:
        stats = getattr(self.planner, "stats", {})
        out = {k: v for k, v in stats.items() if isinstance(v, int)}
        out["by_bucket"] = dict(stats.get("by_bucket", {}))
        return out

    def _planner_delta(self, before: Dict[str, Any]) -> Dict[str, Any]:
        now = self._planner_snapshot()
        delta = {k: now.get(k, 0) - before.get(k, 0)
                 for k in now if k != "by_bucket"}
        by0 = before.get("by_bucket", {})
        delta["by_bucket"] = {
            k: v - by0.get(k, 0)
            for k, v in now.get("by_bucket", {}).items()
            if v - by0.get(k, 0)
        }
        return delta

    def _record_admission(self, outcome: str) -> None:
        rec = getattr(self.planner, "record_admission", None)
        if rec is not None:
            rec(outcome)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_shapes(text: str) -> List[Tuple[int, int, int]]:
    """Comma-separated BATCHxPROMPTxGEN request shapes (e.g. 2x8x8)."""
    out = []
    for part in text.split(","):
        bits = part.strip().lower().split("x")
        try:
            if len(bits) != 3:
                raise ValueError
            shape = tuple(int(b) for b in bits)
            if any(v <= 0 for v in shape):
                raise ValueError
        except ValueError:
            raise ValueError(
                f"malformed shape {part.strip()!r} in {text!r}: expected "
                f"BATCHxPROMPTxGEN with positive integers (e.g. 2x8x8)"
            ) from None
        out.append(shape)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--plan-table", default=None,
                    help="precomputed PlanTable (.npz); omit with --build")
    ap.add_argument("--build", action="store_true",
                    help="build a plan table in-process from --shapes "
                         "instead of loading --plan-table")
    ap.add_argument("--full", action="store_true",
                    help="the architecture's published width instead of its "
                         "smoke config")
    ap.add_argument("--device", default="cuda",
                    help="cuda: serve on the card, build on the sweep kernel; "
                         "cpu: the plain versions on the host")
    ap.add_argument("--arrivals", choices=("deterministic", "poisson",
                                           "trace"), default="deterministic")
    ap.add_argument("--n", type=int, default=8, help="number of requests")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="deterministic: virtual gap between arrivals")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="poisson: arrivals per unit virtual time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default="2x8x8",
                    help="comma-separated BATCHxPROMPTxGEN request shapes")
    ap.add_argument("--trace", default=None,
                    help="JSON arrival trace (--arrivals trace)")
    ap.add_argument("--cycle-budget", type=float, default=None,
                    help="per-cycle energy buffer Q (table units)")
    ap.add_argument("--capacity", type=float, default=None,
                    help="harvest pool capacity (energy units)")
    ap.add_argument("--harvest-rate", type=float, default=0.0,
                    help="harvest income (energy per unit virtual time)")
    ap.add_argument("--capacity-requests", type=float, default=None,
                    help="capacity in units of one first-shape request's "
                         "tabulated energy (portable across tables)")
    ap.add_argument("--rate-requests", type=float, default=None,
                    help="harvest rate in request-energies per unit time")
    ap.add_argument("--service-time", type=float, default=1.0,
                    help="virtual time one committed cycle takes")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the pre-run build and capture warmup")
    ap.add_argument("--expect-admitted", type=int, default=None,
                    help="exit nonzero unless >= this many admitted")
    ap.add_argument("--expect-deferred", type=int, default=None,
                    help="exit nonzero unless >= this many deferred")
    ap.add_argument("--expect-zero-retrace", action="store_true",
                    help="exit nonzero on any post-warmup build or capture")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace_event JSON (Perfetto-loadable) "
                         "of the run; also gates on ledger conservation")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry snapshot as JSON")
    ap.add_argument("--ledger-out", default=None,
                    help="write the run's energy ledger as JSON "
                         "(deterministic (rid, cycle) row order)")
    ap.add_argument("--table-out", default=None,
                    help="with --build: save the in-process plan table (.npz)")
    for flag in ("--replan", "--expect-replan-identical"):
        ap.add_argument(flag, action="store_true",
                        help="not supported by the port (ROADMAP.md queue 1, item 6)")
    ap.add_argument("--drift-tol", type=float, default=None,
                    help="not supported by the port (ROADMAP.md queue 1, item 6)")
    ap.add_argument("--calibration", default=None,
                    help="not supported by the port (ROADMAP.md queue 1, item 6)")
    args = ap.parse_args(argv)
    if (args.replan or args.expect_replan_identical or args.drift_tol is not None
            or args.calibration is not None):
        ap.error("--replan, --drift-tol, --expect-replan-identical and --calibration "
                 "need the measured-cost calibration (core/calibration.py), which is "
                 "ROADMAP.md queue 1, item 6 and not ported yet")
    if args.table_out and not (args.build or args.plan_table is None):
        ap.error("--table-out needs the in-process --build path")

    # CLI runs report through the structured emitter on stdout; library and
    # pytest use stay silent (no handler attached).
    enable_cli_output("repro_torch.traffic", tag="traffic")
    if args.trace_out:
        TRACER.configure(enabled=True)

    # torch-heavy imports stay here so `--help` and the pure-python pieces
    # (arrival processes, HarvestModel) never pay for them
    import torch

    from .planner import _BACKEND_OF_DEVICE, ServePlanner, build_table_for_arch
    from .serve import PlannedExecutor

    shapes = _parse_shapes(args.shapes)
    if args.build or args.plan_table is None:
        buckets = sorted({(b, p + g) for (b, p, g) in shapes})
        table = build_table_for_arch(
            args.arch, buckets, n_q=8, smoke=not args.full,
            backend=_BACKEND_OF_DEVICE[torch.device(args.device).type])
        planner = ServePlanner(table)
        _LOG.emit(f"built {table.summary()}")
        if args.table_out:
            table.save(args.table_out)
            _LOG.emit(f"saved plan table to {args.table_out}",
                      path=args.table_out)
    else:
        planner = ServePlanner.from_file(args.plan_table)
    executor = PlannedExecutor(args.arch, planner, smoke=not args.full,
                               device=args.device)

    if args.arrivals == "trace":
        if args.trace is None:
            ap.error("--arrivals trace requires --trace FILE")
        requests = load_trace(args.trace)
    elif args.arrivals == "poisson":
        requests = poisson_arrivals(args.n, args.rate, shapes,
                                    seed=args.seed)
    else:
        requests = deterministic_arrivals(args.n, args.interval, shapes[0],
                                          seed=args.seed)

    capacity, rate = args.capacity, args.harvest_rate
    if args.capacity_requests is not None or args.rate_requests is not None:
        b, p, g = shapes[0]
        plan = planner.plan_for(b, p + g, args.cycle_budget)
        _, e_req = request_energy(plan, g, args.cycle_budget,
                                  planner.e_startup)
        if args.capacity_requests is not None:
            capacity = args.capacity_requests * e_req
        if args.rate_requests is not None:
            rate = args.rate_requests * e_req
        _LOG.emit(f"one {b}x{p}x{g} request draws {e_req:.6g}; "
                  f"capacity={capacity:.6g} rate={rate:.6g}",
                  e_req=e_req, capacity=capacity, rate=rate)
    harvest = (HarvestModel(capacity=capacity, rate=rate)
               if capacity is not None else None)

    harness = TrafficHarness(executor, harvest=harvest,
                             cycle_budget=args.cycle_budget,
                             service_time=args.service_time)
    if not args.no_warmup:
        n_warm = harness.warmup(requests)
        _LOG.emit(f"warmed {n_warm} shape(s)", warmed=n_warm)
    report = harness.run(requests)
    _LOG.emit(report.summary())
    _LOG.emit(
        "energy ledger: " + ", ".join(
            f"{k}={v:.6g}" for k, v in report.energy_ledger.items()),
        **report.energy_ledger,
    )

    if args.trace_out:
        n_events = TRACER.write(args.trace_out)
        _LOG.emit(f"wrote {n_events} trace events to {args.trace_out}",
                  events=n_events, path=args.trace_out)
    if args.metrics_out:
        METRICS.dump_json(args.metrics_out, tool="traffic", arch=args.arch)
        _LOG.emit(f"wrote metrics snapshot to {args.metrics_out}",
                  path=args.metrics_out)
    if args.ledger_out:
        report.ledger.dump_json(args.ledger_out, tool="traffic",
                                arch=args.arch, kind="time", seed=args.seed)
        _LOG.emit(f"wrote {len(report.ledger.entries)} ledger entries to "
                  f"{args.ledger_out}", path=args.ledger_out)

    failures = []
    if report.ledger_conserved is False:
        failures.append(
            f"energy ledger imbalance {report.ledger_conservation_error:.3e} "
            f"vs pool delta {report.energy_spent:.6g}")
    if (args.expect_admitted is not None
            and report.admitted < args.expect_admitted):
        failures.append(f"admitted {report.admitted} < "
                        f"{args.expect_admitted}")
    if (args.expect_deferred is not None
            and report.deferred < args.expect_deferred):
        failures.append(f"deferred {report.deferred} < "
                        f"{args.expect_deferred}")
    if args.expect_zero_retrace and report.retraces:
        failures.append(f"retraces {report.trace_delta} != 0 after warmup")
    if failures:
        _LOG.emit(f"FAILED: {'; '.join(failures)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
