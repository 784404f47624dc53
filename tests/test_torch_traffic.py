"""The port's continuous-traffic harness (``repro_torch.launch.traffic``).

* The port's copies of ``tests/test_traffic.py``'s fast tier: a FakeTable
  and a SyntheticExecutor drive the port's ServePlanner, request_cycles,
  BurstRuntime (on the CPU) and TrafficHarness through tiny numpy chain
  graphs, pinning admission, deferral, rejection, continuation batching,
  power failures and the energy ledger exactly, with the reference's
  expected values.
* Against ``repro``: the arrival processes give the same requests under the
  same seed, and both harnesses, each over its own package's runtime and
  the same numpy-only synthetic executor, give the same events,
  admission counts, commit deltas, energy and tokens.
* A smoke qwen3-4b run of the real model under the harness (on the CPU)
  has zero builds or captures after warm-up and the tokens of unplanned
  ``serve``; the CLI runs with ``--build --device cpu``.
"""

import dataclasses
import functools
import json
import types

import numpy as np
import pytest


# -- shared synthetic fixtures (no jax) --------------------------------------

E_TOTAL = 0.25    # one token step (one graph traversal)
E_STARTUP = 0.1
GEN = 3           # default request: 0.1 + 3*0.25 = 0.85 energy units
REQ_E = E_STARTUP + GEN * E_TOTAL


@dataclasses.dataclass(frozen=True)
class FakePlan:
    batch: int
    seq_bucket: int
    e_total: float


class FakeTable:
    """Duck-typed PlanTable: exact-batch, smallest-covering-seq lookup. It
    raises the errors of ``ns``'s package, so that package's planner counts
    them as misses."""

    def __init__(self, buckets, e_total=E_TOTAL, e_startup=E_STARTUP,
                 arch="fake", q_floor=None, ns=None):
        self.arch = arch
        self.e_startup = e_startup
        self.e_total = e_total
        self.q_floor = q_floor
        self.ns = ns or port_ns()
        self._buckets = sorted(buckets)

    def lookup(self, batch, seq, energy_budget=None):
        if (self.q_floor is not None and energy_budget is not None
                and energy_budget < self.q_floor):
            raise self.ns.Infeasible(f"budget {energy_budget} below Q grid")
        for (b, s) in self._buckets:
            if b == batch and s >= seq:
                return FakePlan(batch=b, seq_bucket=s, e_total=self.e_total)
        raise self.ns.UnknownBucketError(f"no bucket covers {batch}x{seq}")


def port_ns():
    """The port's pieces a synthetic executor and a harness run on."""
    from repro_torch.core import runtime
    from repro_torch.core.burst import burst_detail
    from repro_torch.core.cost import CostModel, LinearTransfer
    from repro_torch.core.graph import GraphBuilder
    from repro_torch.core.partition import Infeasible, Partition
    from repro_torch.core.plan_table import UnknownBucketError
    from repro_torch.launch import planner, traffic

    return types.SimpleNamespace(
        BurstRuntime=functools.partial(runtime.BurstRuntime, device="cpu"),
        CostModel=CostModel, LinearTransfer=LinearTransfer, GraphBuilder=GraphBuilder,
        Partition=Partition, burst_detail=burst_detail, Infeasible=Infeasible,
        UnknownBucketError=UnknownBucketError, planner=planner, traffic=traffic,
        runtime=runtime)


def ref_ns():
    """``repro``'s same pieces (numpy task bodies: nothing is compiled)."""
    import repro.core as core
    from repro.core import runtime
    from repro.core.burst import burst_detail
    from repro.core.partition import Infeasible
    from repro.core.plan_table import UnknownBucketError
    from repro.launch import planner, traffic

    return types.SimpleNamespace(
        BurstRuntime=core.BurstRuntime, CostModel=core.CostModel,
        LinearTransfer=core.LinearTransfer, GraphBuilder=core.GraphBuilder,
        Partition=core.Partition, burst_detail=burst_detail, Infeasible=Infeasible,
        UnknownBucketError=UnknownBucketError, planner=planner, traffic=traffic,
        runtime=runtime)


class SyntheticExecutor:
    """Executor contract implementation over tiny numpy chain graphs.

    Each request is ``gen`` +1 steps through the real BurstRuntime (the
    port's on the CPU, or ``repro``'s with ``ns=ref_ns()``): the final
    sequence equals ``seed + gen``, so token correctness (including across
    crash replays) is a one-line assert.
    """

    def __init__(self, planner, ns=None):
        self.planner = planner
        self.ns = ns or port_ns()
        self.opened = []

    def open(self, batch, prompt_len, gen, *, seed=0, cycle_budget=None,
             prompts=None, plan=None, nvm=None, crash_hook=None):
        ns = self.ns
        if plan is None:
            plan = self.planner.plan_for(batch, prompt_len + gen,
                                         cycle_budget)
        b = ns.GraphBuilder()
        b.packet("prompts", 8, external=True)
        for k in range(gen - 1):
            b.packet(f"state{k}", 8)
        b.packet("sequence", 8, keep=True)

        def mk(k):
            def fn(inp):
                src = inp["prompts"] if k == 0 else inp[f"state{k - 1}"]
                name = "sequence" if k == gen - 1 else f"state{k}"
                return {name: np.asarray(src) + 1}
            return fn

        for k in range(gen):
            b.task(f"step{k}",
                   reads=("prompts",) if k == 0 else (f"state{k - 1}",),
                   writes=("sequence",) if k == gen - 1 else (f"state{k}",),
                   cost=plan.e_total, fn=mk(k))
        graph = b.build()
        cycles = ns.planner.request_cycles(gen, plan.e_total, cycle_budget,
                                           e_startup=self.planner.e_startup)
        cost = ns.CostModel(e_startup=self.planner.e_startup,
                            read=ns.LinearTransfer(0.0, 0.0),
                            write=ns.LinearTransfer(0.0, 0.0), name="synthetic")
        part = ns.Partition(
            cycles, [ns.burst_detail(graph, cost, i, j) for (i, j) in cycles],
            None,
        )
        rt = ns.BurstRuntime(graph, part, nvm=nvm, cost=cost,
                             crash_hook=crash_hook)
        if rt.nvm.read_index() == 0:
            rt.seed_inputs(
                {"prompts": np.full((batch,), seed, dtype=np.int64)})
        self.opened.append((batch, prompt_len, gen, seed))
        return ns.traffic.Continuation(
            request=ns.traffic.Request(rid=len(self.opened) - 1, batch=batch,
                                       prompt_len=prompt_len, gen=gen, seed=seed),
            plan=plan, cycles=list(cycles), runtime=rt,
            e_startup=self.planner.e_startup)


@pytest.fixture()
def synthetic():
    """(planner, executor) over a two-bucket fake table."""
    from repro_torch.launch.planner import ServePlanner

    planner = ServePlanner(FakeTable([(1, 8), (2, 8)]))
    return planner, SyntheticExecutor(planner)


def _req(rid, t=0.0, gen=GEN, batch=1, seed=0):
    from repro_torch.launch.traffic import Request

    return Request(rid=rid, batch=batch, prompt_len=2, gen=gen, time=t,
                   seed=seed)


def _events(report, kind):
    return [rid for (_, k, rid) in report.events if k.split(":")[0] == kind]


# -- shapes --------------------------------------------------------------------


def test_parse_shapes_validation():
    from repro_torch.launch.traffic import _parse_shapes

    assert _parse_shapes("2x8x8,1x4x2") == [(2, 8, 8), (1, 4, 2)]
    with pytest.raises(ValueError, match="BATCHxPROMPTxGEN"):
        _parse_shapes("2x8")
    with pytest.raises(ValueError, match="'0x8x8'"):
        _parse_shapes("0x8x8")


# -- request_cycles edge cases (satellite) -----------------------------------


def test_request_cycles_gen_one():
    from repro_torch.launch.planner import request_cycles

    # a single step is always one cycle, however small the budget
    assert request_cycles(1, 0.25, None, e_startup=0.1) == [(1, 1)]
    assert request_cycles(1, 0.25, 1e-6, e_startup=0.1) == [(1, 1)]
    assert request_cycles(0, 0.25, None) == []


def test_request_cycles_budget_below_single_step():
    from repro_torch.launch.planner import request_cycles

    # budget < e_startup + step_energy: documented behavior is single-step
    # cycles (the step's *interior* segmentation fits Q by table
    # construction; grouping just can't merge steps)
    assert request_cycles(4, 0.25, 0.3, e_startup=0.1) == [
        (1, 1), (2, 2), (3, 3), (4, 4)]


def test_request_cycles_exact_fill_tolerance():
    from repro_torch.launch.planner import request_cycles

    # 0.1 + 3*0.25 = 0.85 exactly fills the budget → groups of 3
    assert request_cycles(7, 0.25, 0.85, e_startup=0.1) == [
        (1, 3), (4, 6), (7, 7)]
    # within the shared solver tolerance (rel 1e-9): still not split
    assert request_cycles(7, 0.25, 0.85 - 8.5e-13, e_startup=0.1) == [
        (1, 3), (4, 6), (7, 7)]
    # clearly below: groups of 2
    assert request_cycles(7, 0.25, 0.85 - 1e-6, e_startup=0.1) == [
        (1, 2), (3, 4), (5, 6), (7, 7)]


# -- arrival processes -------------------------------------------------------


def test_deterministic_arrivals():
    from repro_torch.launch.traffic import deterministic_arrivals

    reqs = deterministic_arrivals(3, 0.5, (2, 8, 4), start=1.0)
    assert [r.time for r in reqs] == [1.0, 1.5, 2.0]
    assert all(r.shape == (2, 8, 4) and r.max_seq == 12 for r in reqs)


def test_poisson_arrivals_deterministic_under_seed():
    from repro_torch.launch.traffic import poisson_arrivals

    shapes = [(1, 4, 2), (2, 8, 4)]
    a = poisson_arrivals(16, 2.0, shapes, seed=7)
    b = poisson_arrivals(16, 2.0, shapes, seed=7)
    assert [(r.time, r.shape) for r in a] == [(r.time, r.shape) for r in b]
    c = poisson_arrivals(16, 2.0, shapes, seed=8)
    assert [r.time for r in a] != [r.time for r in c]
    times = [r.time for r in a]
    assert times == sorted(times) and times[0] > 0
    with pytest.raises(ValueError, match="rate"):
        poisson_arrivals(4, 0.0, shapes)


def test_trace_arrivals_and_load(tmp_path):
    from repro_torch.launch.traffic import load_trace, trace_arrivals

    recs = [
        {"time": 2.0, "batch": 1, "prompt_len": 4, "gen": 2},
        (0.5, 2, 8, 4, 3),  # tuple form with seed
    ]
    reqs = trace_arrivals(recs)
    assert [r.time for r in reqs] == [0.5, 2.0]  # sorted by arrival
    assert reqs[0].seed == 3 and reqs[1].shape == (1, 4, 2)

    p = tmp_path / "trace.json"
    p.write_text(json.dumps([
        {"time": 0.0, "batch": 1, "prompt_len": 2, "gen": 3},
        {"time": 1.0, "batch": 2, "prompt_len": 2, "gen": 3},
    ]))
    loaded = load_trace(str(p))
    assert [r.batch for r in loaded] == [1, 2]


# -- HarvestModel ------------------------------------------------------------


def test_harvest_model_replenish_and_cap():
    from repro_torch.launch.traffic import HarvestModel

    h = HarvestModel(capacity=1.0, rate=0.5, charge=0.2)
    h.replenish(1.0)
    assert h.charge == pytest.approx(0.7)
    h.replenish(10.0)  # caps at capacity
    assert h.charge == pytest.approx(1.0)
    assert h.harvested == pytest.approx(0.8)
    h.draw(0.85)
    assert h.charge == pytest.approx(0.15)
    assert h.spent == pytest.approx(0.85)


def test_harvest_model_fits_and_time_until():
    from repro_torch.launch.traffic import HarvestModel

    h = HarvestModel(capacity=1.0, rate=0.5, charge=0.5)
    assert h.fits(0.5)          # exact fill, solver tolerance
    assert not h.fits(0.6)
    assert h.time_until(0.5) == 0.0
    assert h.time_until(0.8) == pytest.approx(0.6)
    assert h.time_until(2.0) == float("inf")  # over capacity: never
    assert h.can_ever_fit(0.9) and not h.can_ever_fit(1.5)

    static = HarvestModel(capacity=1.0, rate=0.0, charge=0.3)
    assert not static.can_ever_fit(0.5)  # no income: current charge is it
    assert static.can_ever_fit(0.3)


def test_harvest_model_validation():
    from repro_torch.launch.traffic import HarvestModel

    with pytest.raises(ValueError, match="capacity"):
        HarvestModel(capacity=0.0)
    with pytest.raises(ValueError, match="rate"):
        HarvestModel(capacity=1.0, rate=-1.0)
    unbounded = HarvestModel(capacity=float("inf"))
    assert unbounded.fits(1e12)
    unbounded.replenish(5.0)  # no-op, no overflow


# -- admission control through the harness -----------------------------------


def test_admit_then_defer_then_replenish(synthetic):
    from repro_torch.launch.traffic import HarvestModel, TrafficHarness

    planner, ex = synthetic
    harness = TrafficHarness(
        ex, harvest=HarvestModel(capacity=1.0, rate=0.5), keep_tokens=True)
    report = harness.run([_req(0), _req(1)])

    assert (report.arrived, report.admitted, report.deferred,
            report.rejected, report.completed) == (2, 2, 1, 0, 2)
    # r0 fits the initial charge; r1 waits for harvest income
    assert _events(report, "admit") == [0, 1]
    assert _events(report, "defer") == [1]
    assert _events(report, "complete") == [0, 1]
    # the planner carries the admission counters (satellite: observability)
    assert report.planner_delta["admitted"] == 2
    assert report.planner_delta["deferred"] == 1
    assert report.planner_delta["lookups"] == 2
    assert report.hit_rate == 1.0
    # energy ledger: both requests drawn, income credited
    assert report.energy_spent == pytest.approx(2 * REQ_E)
    # synthetic chain: sequence == seed + gen, replay-safe
    for rid in (0, 1):
        np.testing.assert_array_equal(report.tokens[rid],
                                      np.full((1,), GEN, dtype=np.int64))


def test_reject_over_capacity_and_no_replenishment(synthetic):
    from repro_torch.launch.traffic import HarvestModel, TrafficHarness

    planner, ex = synthetic
    # capacity below one request's tabulated draw: can never fit
    r = TrafficHarness(ex, harvest=HarvestModel(capacity=0.5, rate=1.0)).run(
        [_req(0)])
    assert r.rejected == 1 and r.admitted == 0
    assert r.reject_reasons == {"over_capacity": 1}

    # fits capacity but rate=0 and charge too low: deferral would hang
    h = HarvestModel(capacity=2.0, rate=0.0, charge=0.5)
    r = TrafficHarness(ex, harvest=h).run([_req(0)])
    assert r.reject_reasons == {"no_replenishment": 1}
    assert r.planner_delta["rejected"] == 1


def test_reject_unknown_bucket_counts_miss(synthetic):
    from repro_torch.launch.traffic import TrafficHarness

    planner, ex = synthetic
    report = TrafficHarness(ex, keep_tokens=True).run([
        _req(0), _req(1, batch=7), _req(2)])  # batch 7: no bucket
    assert report.completed == 2 and report.rejected == 1
    assert report.reject_reasons == {"UnknownBucketError": 1}
    assert report.planner_delta["lookups"] == 3
    assert report.planner_delta["misses"] == 1
    assert report.hit_rate == pytest.approx(2 / 3)


def test_deferral_queue_is_fifo(synthetic):
    from repro_torch.launch.traffic import HarvestModel, TrafficHarness

    planner, ex = synthetic
    harness = TrafficHarness(
        ex, harvest=HarvestModel(capacity=0.9, rate=REQ_E))
    report = harness.run([_req(0), _req(1), _req(2)])
    assert report.admitted == 3 and report.deferred == 2
    assert _events(report, "admit") == [0, 1, 2]
    assert _events(report, "complete") == [0, 1, 2]


def test_cheap_request_may_overtake_deferred_head(synthetic):
    from repro_torch.launch.traffic import HarvestModel, TrafficHarness

    planner, ex = synthetic
    # r0/r1 cost 0.85; r2 (gen=1) costs 0.35 and arrives later, when the
    # charge covers it but not the deferred head — documented overtake
    harness = TrafficHarness(
        ex, harvest=HarvestModel(capacity=0.9, rate=0.3))
    report = harness.run([_req(0), _req(1), _req(2, t=0.5, gen=1)])
    assert report.completed == 3
    assert _events(report, "admit") == [0, 2, 1]


def test_max_wait_rejects_stale_deferrals(synthetic):
    from repro_torch.launch.traffic import HarvestModel, TrafficHarness

    planner, ex = synthetic
    harness = TrafficHarness(
        ex, harvest=HarvestModel(capacity=0.9, rate=0.01), max_wait=2.0)
    report = harness.run([_req(0), _req(1)])
    assert report.completed == 1 and report.rejected == 1
    assert report.reject_reasons == {"max_wait": 1}
    assert report.deferred == 1  # deferred first, then expired


def test_unlimited_harvest_admits_everything(synthetic):
    from repro_torch.launch.traffic import TrafficHarness

    planner, ex = synthetic
    report = TrafficHarness(ex).run([_req(i) for i in range(5)])
    assert report.admitted == 5 and report.deferred == 0
    assert report.completed == 5
    assert report.final_charge == float("inf")


# -- continuation batching ---------------------------------------------------


def test_same_bucket_requests_drain_before_switching():
    from repro_torch.launch.planner import ServePlanner
    from repro_torch.launch.traffic import TrafficHarness

    planner = ServePlanner(FakeTable([(1, 8), (2, 8)]))
    ex = SyntheticExecutor(planner)
    # interleaved arrival of two buckets; 3 cycles per request via Q=0.4
    reqs = [_req(0, batch=1), _req(1, batch=2), _req(2, batch=1),
            _req(3, batch=2)]
    harness = TrafficHarness(ex, cycle_budget=0.4)
    report = harness.run(reqs)
    assert report.completed == 4
    assert report.cycles_run == 4 * 3
    # bucket 1x8 (r0, r2) fully drains, then one switch to 2x8 (r1, r3)
    assert report.executable_switches == 1
    # round-robin within a bucket: r0 and r2 finish adjacently
    assert _events(report, "complete") == [0, 2, 1, 3]


def test_round_robin_interleaves_cycles_within_bucket(synthetic):
    from repro_torch.launch.traffic import TrafficHarness

    planner, ex = synthetic
    report = TrafficHarness(ex, cycle_budget=0.4).run(
        [_req(0), _req(1)])
    # 3 cycles each, interleaved: both complete at the end, in order
    assert report.cycles_run == 6
    assert _events(report, "complete") == [0, 1]
    assert report.commit_delta == {"commits": 6, "replays": 0}


# -- crash-mid-queue fault injection ----------------------------------------


def test_power_failure_mid_queue_replays_and_completes(synthetic):
    from repro_torch.launch.traffic import HarvestModel, TrafficHarness

    planner, ex = synthetic

    class CrashOnce:
        def __init__(self):
            self.fired = False

        def __call__(self, b, phase):
            from repro_torch.core.runtime import PowerFailure

            if not self.fired and b == 1 and phase == "executed":
                self.fired = True
                raise PowerFailure(f"injected at burst {b} ({phase})")

    hooks = {}

    def hook_for(request):
        if request.rid == 1:
            hooks[request.rid] = CrashOnce()
            return hooks[request.rid]
        return None

    harness = TrafficHarness(
        ex, cycle_budget=0.4, keep_tokens=True,
        harvest=HarvestModel(capacity=2.5, rate=1.0),
        crash_hook_factory=hook_for)
    report = harness.run([_req(0), _req(1)])

    assert hooks[1].fired
    assert report.power_failures == 1
    assert report.completed == 2
    # 6 cycles commit; the crashed one replays exactly once
    assert report.cycles_run == 6
    assert report.commit_delta == {"commits": 6, "replays": 1}
    # idempotent replay: tokens identical to the unfailed request
    np.testing.assert_array_equal(report.tokens[1], report.tokens[0])


def test_continuation_step_contract(synthetic):
    from repro_torch.core.runtime import MemoryNVM, PowerFailure

    planner, ex = synthetic
    boom = {"armed": True}

    def hook(b, phase):
        if boom["armed"] and b == 1 and phase == "stored":
            boom["armed"] = False
            raise PowerFailure("injected")

    cont = ex.open(1, 2, GEN, cycle_budget=0.4, nvm=MemoryNVM(),
                   crash_hook=hook)
    assert cont.n_cycles == 3 and not cont.done
    assert cont.step() is False
    assert cont.cycles_done == 1
    with pytest.raises(PowerFailure):
        cont.step()
    assert cont.cycles_done == 1          # commit index survived the crash
    assert cont.step() is False           # replay of cycle 1
    assert cont.runtime.stats.replays == 1
    assert cont.step() is True
    assert cont.done and cont.step() is True  # idempotent once complete
    np.testing.assert_array_equal(cont.tokens(),
                                  np.full((1,), GEN, dtype=np.int64))
    # per-cycle cost: E_s + one step each under Q=0.4
    assert cont.cycle_cost(0) == pytest.approx(E_STARTUP + E_TOTAL)
    assert cont.total_cost == pytest.approx(3 * (E_STARTUP + E_TOTAL))


def test_crash_on_deferred_requests_first_cycle(synthetic):
    """Fault matrix × admission control: a request that was deferred by the
    harvest pool crashes on its very first cycle after finally being
    admitted. The replay books as overhead outside the admission
    reservation, the request still completes, and the ledger conserves."""
    from repro_torch.launch.traffic import HarvestModel, TrafficHarness

    planner, ex = synthetic
    fired = {}

    class CrashFirstCycle:
        def __init__(self, rid):
            self.rid = rid

        def __call__(self, b, phase):
            from repro_torch.core.runtime import PowerFailure

            if self.rid not in fired and b == 0 and phase == "executed":
                fired[self.rid] = True
                raise PowerFailure("injected on the deferred head's cycle 0")

    def hook_for(request):
        return CrashFirstCycle(request.rid) if request.rid == 1 else None

    # e_req = 3 * (E_STARTUP + E_TOTAL) = 1.05: rid 0 drains the pool, rid 1
    # must wait for harvest before admission
    harness = TrafficHarness(
        ex, cycle_budget=0.4, keep_tokens=True,
        harvest=HarvestModel(capacity=1.2, rate=0.5),
        crash_hook_factory=hook_for)
    report = harness.run([_req(0), _req(1, t=0.5)])

    assert fired == {1: True}
    assert report.deferred == 1 and report.admitted == 2
    assert report.completed == 2
    assert report.power_failures == 1
    assert report.commit_delta == {"commits": 6, "replays": 1}
    # the crashed attempt is booked as replay overhead on (rid=1, cycle=0),
    # at the full cycle draw, outside the reservation
    replays = [e for e in report.ledger.entries if e.category == "replay"]
    assert [(e.rid, e.cycle) for e in replays] == [(1, 0)]
    assert replays[0].energy == pytest.approx(E_STARTUP + E_TOTAL)
    assert report.ledger_conserved
    assert report.ledger.overhead_total() == pytest.approx(
        E_STARTUP + E_TOTAL)
    # idempotent replay: deferred-then-crashed output matches the clean one
    np.testing.assert_array_equal(report.tokens[1], report.tokens[0])


def test_crash_between_reservation_and_first_commit(synthetic):
    """Fault matrix × admission control: power failure after the admission
    reservation drew from the pool but before the first cycle ever
    committed ('loaded' phase — nothing durable yet). The reservation is
    not refunded, the replay books at the full cycle cost, and the request
    completes with conservation intact."""
    from repro_torch.launch.traffic import HarvestModel, TrafficHarness

    planner, ex = synthetic
    state = {"fired": False}

    def hook(b, phase):
        from repro_torch.core.runtime import PowerFailure

        if not state["fired"] and b == 0 and phase == "loaded":
            state["fired"] = True
            raise PowerFailure("injected before the first commit")

    harness = TrafficHarness(
        ex, cycle_budget=0.4, keep_tokens=True,
        harvest=HarvestModel(capacity=2.0, rate=1.0),
        crash_hook_factory=lambda r: hook)
    report = harness.run([_req(0)])

    assert state["fired"]
    assert report.power_failures == 1
    assert report.completed == 1
    # no cycle had committed, so the replay re-runs cycle 0 from scratch
    assert report.commit_delta == {"commits": 3, "replays": 1}
    replays = [(e.rid, e.cycle) for e in report.ledger.entries
               if e.category == "replay"]
    assert replays == [(0, 0)]
    assert report.ledger_conserved
    # charged total is the clean 3-cycle energy; the crashed attempt rides
    # on top as overhead
    assert report.ledger.charged_total() == pytest.approx(
        3 * (E_STARTUP + E_TOTAL))
    assert report.ledger.overhead_total() == pytest.approx(
        E_STARTUP + E_TOTAL)


# -- reset hooks + global counters (satellite) -------------------------------


def test_commit_stats_reset_and_diff(synthetic):
    from repro_torch.core.runtime import COMMIT_STATS, reset_commit_stats
    from repro_torch.launch.traffic import TrafficHarness

    planner, ex = synthetic
    reset_commit_stats()
    assert COMMIT_STATS == {"commits": 0, "replays": 0}
    TrafficHarness(ex).run([_req(0)])
    assert COMMIT_STATS["commits"] == 1  # gen=3, one unbounded cycle
    reset_commit_stats()
    assert COMMIT_STATS == {"commits": 0, "replays": 0}


def test_serve_planner_reset_stats_and_admission_validation():
    from repro_torch.launch.planner import ServePlanner

    planner = ServePlanner(FakeTable([(1, 8)]))
    planner.plan_for(1, 5)
    planner.record_admission("admitted")
    assert planner.stats["lookups"] == 1 and planner.stats["admitted"] == 1
    assert planner.stats["by_bucket"] == {"1x8": 1}
    assert planner.hit_rate == 1.0
    planner.reset_stats()
    assert planner.stats["lookups"] == 0 and planner.stats["by_bucket"] == {}
    assert planner.hit_rate == 0.0
    with pytest.raises(ValueError, match="unknown admission outcome"):
        planner.record_admission("dropped")


def test_request_energy_matches_cycle_ledger(synthetic):
    from repro_torch.launch.traffic import request_energy

    planner, ex = synthetic
    plan = planner.plan_for(1, 5)
    cycles, total = request_energy(plan, GEN, 0.4, planner.e_startup)
    assert cycles == [(1, 1), (2, 2), (3, 3)]
    assert total == pytest.approx(3 * (E_STARTUP + E_TOTAL))
    cycles, total = request_energy(plan, GEN, None, planner.e_startup)
    assert cycles == [(1, GEN)]
    assert total == pytest.approx(REQ_E)


def test_warmup_dedupes_shapes(synthetic):
    from repro_torch.launch.traffic import TrafficHarness

    planner, ex = synthetic

    class WarmExec(SyntheticExecutor):
        def __init__(self, planner):
            super().__init__(planner)
            self.warmed = None

        def warmup(self, shapes, cycle_budget=None):
            self.warmed = list(shapes)

    wex = WarmExec(planner)
    harness = TrafficHarness(wex)
    n = harness.warmup([_req(0, seed=5), _req(1, t=1.0, seed=9),
                        _req(2, t=2.0, gen=1)])
    assert n == 2  # two distinct shapes
    # first-seen seed per shape, so the warmed params entry is reused
    assert sorted(wex.warmed) == [(1, 2, 1, 0), (1, 2, GEN, 5)]


def test_report_summary_and_percentiles(synthetic):
    from repro_torch.launch.traffic import TrafficHarness

    planner, ex = synthetic
    report = TrafficHarness(ex).run([_req(i, t=0.25 * i) for i in range(4)])
    pct = report.latency_percentiles_ms()
    assert set(pct) == {"p50", "p95", "p99"}
    assert pct["p50"] <= pct["p95"] <= pct["p99"]
    assert report.requests_per_s > 0
    s = report.summary()
    assert "4/4 completed" in s and "retraces 0" in s
    assert report.trace_delta == {} or not any(report.trace_delta.values())


# -- against repro -----------------------------------------------------------------


def _astuples(reqs):
    return [dataclasses.astuple(r) for r in reqs]


@pytest.mark.parametrize("seed", range(4))
def test_arrivals_equal_reference(seed, tmp_path):
    port, ref = port_ns().traffic, ref_ns().traffic
    shapes = [(1, 4, 2), (2, 8, 4), (4, 16, 8)]
    assert _astuples(port.poisson_arrivals(20, 1.7, shapes, seed=seed, start=0.5,
                                           request_seed=3)) == \
        _astuples(ref.poisson_arrivals(20, 1.7, shapes, seed=seed, start=0.5,
                                       request_seed=3))
    assert _astuples(port.deterministic_arrivals(5, 0.25 * seed, (2, 8, 4), start=1.0,
                                                 seed=seed)) == \
        _astuples(ref.deterministic_arrivals(5, 0.25 * seed, (2, 8, 4), start=1.0,
                                             seed=seed))
    records = [{"time": 3.0 - seed, "batch": 1, "prompt_len": 4, "gen": 2, "seed": seed},
               (0.5, 2, 8, 4, 3), (0.5, 1, 2, 3)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(records))
    assert _astuples(port.load_trace(str(path))) == _astuples(ref.load_trace(str(path)))
    assert _astuples(port.trace_arrivals(records)) == _astuples(ref.trace_arrivals(records))


def _crash_rid(rid, cycle, phase, ns):
    fired = set()

    def factory(request):
        if request.rid != rid:
            return None

        def hook(b, ph):
            if (b, ph) == (cycle, phase) and rid not in fired:
                fired.add(rid)
                raise ns.runtime.PowerFailure("injected")
        return hook
    return factory


SCENARIOS = {
    "defer_crash_reject": dict(
        buckets=[(1, 8), (2, 8)],
        requests=[(0, 0.0, GEN, 1), (1, 0.0, GEN, 1), (2, 0.5, 1, 1), (3, 0.5, GEN, 7),
                  (4, 1.0, GEN, 2), (5, 1.5, 2, 2)],
        harness=dict(cycle_budget=0.4, capacity=1.2, rate=0.5), crash=(1, 1, "executed")),
    "max_wait": dict(
        buckets=[(1, 8)], requests=[(0, 0.0, GEN, 1), (1, 0.0, GEN, 1), (2, 3.0, 1, 1)],
        harness=dict(capacity=0.9, rate=0.01, max_wait=2.0), crash=None),
    "poisson_two_buckets": dict(
        buckets=[(1, 8), (2, 8)], requests="poisson",
        harness=dict(cycle_budget=0.6, capacity=2.0, rate=0.6),
        crash=(4, 0, "loaded")),
}


def _run(ns, scenario):
    sc = SCENARIOS[scenario]
    planner = ns.planner.ServePlanner(FakeTable(sc["buckets"], ns=ns))
    ex = SyntheticExecutor(planner, ns=ns)
    if sc["requests"] == "poisson":
        reqs = ns.traffic.poisson_arrivals(10, 1.3, [(1, 2, 3), (2, 2, 2), (1, 2, 1)],
                                           seed=11)
    else:
        reqs = [ns.traffic.Request(rid=rid, batch=b, prompt_len=2, gen=g, time=t)
                for rid, t, g, b in sc["requests"]]
    h = dict(sc["harness"])
    harvest = ns.traffic.HarvestModel(capacity=h.pop("capacity"), rate=h.pop("rate"))
    crash = sc["crash"]
    harness = ns.traffic.TrafficHarness(
        ex, harvest=harvest, keep_tokens=True,
        crash_hook_factory=_crash_rid(*crash, ns) if crash else None, **h)
    return harness.run(reqs)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_harness_equals_reference_on_synthetic_executors(scenario):
    got, want = _run(port_ns(), scenario), _run(ref_ns(), scenario)
    fields = ("arrived", "admitted", "deferred", "rejected", "completed", "cycles_run",
              "power_failures", "executable_switches", "reject_reasons", "events",
              "latency_virtual", "virtual_makespan", "commit_delta", "planner_delta",
              "hit_rate", "energy_spent", "energy_harvested", "final_charge",
              "energy_ledger", "ledger_conserved", "ledger_overhead_fraction")
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f
    assert got.events and got.completed
    assert sorted(got.tokens) == sorted(want.tokens)
    for rid in want.tokens:
        np.testing.assert_array_equal(np.asarray(got.tokens[rid]), want.tokens[rid])
    assert [dataclasses.astuple(e) for e in got.ledger.entries] == \
        [dataclasses.astuple(e) for e in want.ledger.entries]


# -- the real model (smoke qwen3-4b on the CPU) and the CLI --------------------------


def test_traffic_harness_real_model_zero_retrace_and_token_equality():
    from conftest import SERVE_BATCH, SERVE_GEN, SERVE_PROMPT

    import repro_torch.launch.serve as serve_mod
    from repro_torch.launch.planner import build_table_for_arch
    from repro_torch.launch.serve import PlannedExecutor
    from repro_torch.launch.traffic import (
        HarvestModel, TrafficHarness, deterministic_arrivals, request_energy,
    )

    arch = "qwen3-4b"
    max_seq = SERVE_PROMPT + SERVE_GEN
    table = build_table_for_arch(arch, [(SERVE_BATCH, max_seq), (SERVE_BATCH, 2 * max_seq)],
                                 n_q=8, smoke=True, backend="torch")
    ex = PlannedExecutor(arch, table, smoke=True, device="cpu")
    shape = (SERVE_BATCH, SERVE_PROMPT, SERVE_GEN)
    plan = ex.planner.plan_for(SERVE_BATCH, max_seq, None)
    _, e_req = request_energy(plan, SERVE_GEN, None, ex.planner.e_startup)

    # capacity holds ~1.5 requests, income ~0.9/unit-time: with three
    # arrivals the second defers
    harness = TrafficHarness(
        ex, harvest=HarvestModel(capacity=1.5 * e_req, rate=0.9 * e_req),
        keep_tokens=True)
    reqs = deterministic_arrivals(3, 0.0, shape)
    harness.warmup(reqs)

    report = harness.run(reqs)
    assert report.completed == 3 and report.admitted == 3
    assert report.deferred >= 1
    assert set(report.trace_delta) == {"prefill", "decode"}
    assert not any(report.trace_delta.values()), report.trace_delta
    assert report.hit_rate == 1.0
    assert report.commit_delta["commits"] == 3  # one unbounded cycle each
    assert report.ledger_conserved

    unplanned = serve_mod.serve(arch, *shape, smoke=True, device="cpu")
    for rid in range(3):
        np.testing.assert_array_equal(report.tokens[rid], unplanned.numpy())


def test_traffic_cli_builds_and_serves_on_cpu(tmp_path, capsys):
    from repro_torch.launch.traffic import main

    ledger, table, trace = tmp_path / "ledger.json", tmp_path / "t.npz", tmp_path / "tr.json"
    rc = main([
        "--arch", "qwen3-4b", "--build", "--device", "cpu", "--arrivals", "deterministic",
        "--n", "3", "--interval", "0.0", "--shapes", "2x8x6",
        "--capacity-requests", "1.5", "--rate-requests", "0.9",
        "--expect-admitted", "3", "--expect-deferred", "1",
        "--expect-zero-retrace", "--ledger-out", str(ledger), "--table-out", str(table),
        "--trace-out", str(trace),
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "3/3 completed" in out and "retraces 0" in out
    assert ledger.exists() and table.exists() and trace.exists()


@pytest.mark.parametrize("flag", [["--replan"], ["--expect-replan-identical"],
                                  ["--drift-tol", "0.1"], ["--calibration", "c.json"]])
def test_traffic_cli_calibration_names_its_roadmap_item(flag, capsys):
    from repro_torch.launch.traffic import main

    with pytest.raises(SystemExit) as e:
        main(["--build", "--device", "cpu", *flag])
    assert e.value.code == 2
    assert "queue 1, item 6" in capsys.readouterr().err
