"""The port's telemetry and traced runtime against the reference's.

* The metrics registry, the tracer, the energy ledger and the CLI emitter
  of ``repro_torch.obs`` give the reference's snapshots, diffs, events and
  files for the same calls.
* Both ``BurstRuntime``s run the same lowered smoke graph (``with_fns``)
  under the same partition and crash schedule: outputs, ``COMMIT_STATS``,
  the ``on_commit`` calls and the traced (name, cat, args) sequence agree.
"""

import io
import json

import numpy as np
import pytest

from helpers_torch import port_cost
from repro.api import PartitionSpec as RefSpec
from repro.api import solve as ref_solve
from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.core import layer_profile as ref_lp
from repro.core import runtime as ref_rt
from repro.core.cost import PAPER_FRAM_MODEL as REF_FRAM
from repro.obs import ledger as ref_ledger
from repro.obs import log as ref_log
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace

from repro_torch.configs import SMOKE_CONFIGS
from repro_torch.core import layer_profile as lp
from repro_torch.core import runtime as rt
from repro_torch.core.partition import _partition_from_bounds
from repro_torch.obs import ledger, log, metrics, trace

CPU = "cpu"


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    yield
    metrics.reset_all()
    trace.TRACER.reset()


def _drive_metrics(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("solves", help="solves")
    c.inc()
    c.inc(2, backend="numpy")
    g = reg.gauge("pool")
    g.set(0.25)
    g.set(3.5, node="a")
    h = reg.histogram("cycle_s")
    d = reg.counter_dict("stats", ("commits", "replays"))
    before = reg.snapshot()
    for v in (0.5, 0.125, 2.0):
        h.observe(v)
    c.inc(3, backend="cuda")
    d["commits"] += 4
    d["extra"] = 1
    assert reg.counter("solves") is c  # re-registration returns the instrument
    return reg, before, d


def test_metrics_snapshots_diffs_and_dump_match(tmp_path):
    mine, mine_before, mine_d = _drive_metrics(metrics)
    ref, ref_before, ref_d = _drive_metrics(ref_metrics)
    assert mine.snapshot() == ref.snapshot()
    assert mine.diff(mine_before) == ref.diff(ref_before)
    assert mine.names() == ref.names()
    mine.dump_json(str(tmp_path / "a.json"), run="x")
    ref.dump_json(str(tmp_path / "b.json"), run="x")
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    mine.reset()
    ref.reset()
    assert mine.snapshot() == ref.snapshot()
    assert dict(mine_d) == dict(ref_d) == {"commits": 0, "replays": 0}


def _drive_tracer(mod):
    tr = mod.Tracer()
    tr.span("off").__enter__()  # disabled: a no-op
    tr.instant("off")
    tr.configure(enabled=True)
    tr.set_process(mod.PID_RUNTIME, "runtime")
    tr.set_process(mod.PID_RUNTIME, "runtime")  # named once
    tr.set_thread(mod.PID_TRAFFIC, mod.request_tid(3), "req 3")
    with tr.span("outer", cat="solver", pid=mod.PID_SOLVER, q=2) as sp:
        sp.set(extra=1)
        tr.instant("mark", pid=mod.PID_SOLVER, index=7)
        tr.counter("pool", {"charge": 0.5})
    with pytest.raises(KeyError):
        with tr.span("failing"):
            raise KeyError("x")
    return tr


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


def test_tracer_events_match(tmp_path):
    mine, ref = _drive_tracer(trace), _drive_tracer(ref_trace)
    assert _untimed(mine.events()) == _untimed(ref.events())
    assert mine.chrome_trace().keys() == ref.chrome_trace().keys()
    assert mine.write(str(tmp_path / "t.json")) == len(ref.events())
    assert json.loads((tmp_path / "t.json").read_text())["displayTimeUnit"] == "ms"
    assert trace.node_tid(2) == ref_trace.node_tid(2)


def _drive_ledger(mod):
    led = mod.EnergyLedger()
    led.charge(1, 0, restore=9e-6, compute=0.125, commit=3e-6, vt=0.5)
    led.charge(0, 1, restore=9e-6, compute=0.25)
    led.overhead(1, 0, 0.0625, vt=0.75)
    led.charge(0, 0, compute=0.5, commit=1e-6)
    return led


def test_ledger_summary_conservation_and_dump_match(tmp_path):
    mine, ref = _drive_ledger(ledger), _drive_ledger(ref_ledger)
    assert mine.summary() == ref.summary()
    assert mine.by_request(0) == ref.by_request(0)
    assert mine.sorted_rows() == ref.sorted_rows()
    spent = ref.charged_total()
    assert mine.conserves(spent) and ref.conserves(spent)
    mine.check_conservation(spent)
    with pytest.raises(ledger.LedgerImbalance):
        mine.check_conservation(spent * 1.001)
    mine.dump_json(str(tmp_path / "a.json"), run="x")
    ref.dump_json(str(tmp_path / "b.json"), run="x")
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()


def test_cli_emitter_lines_match():
    outs = []
    for mod, name in ((log, "repro_torch.test_obs"), (ref_log, "repro.test_obs")):
        stream = io.StringIO()
        mod.enable_cli_output(name, tag="planner", stream=stream)
        mod.get_emitter(name).emit("built 3 buckets", buckets=3)
        mod.disable_cli_output(name)
        mod.get_emitter(name).emit("silent")
        outs.append(stream.getvalue())
    assert outs[0] == outs[1] == "[planner] built 3 buckets\n"


class CrashAt:
    """PowerFailure once at each (burst, phase) site of ``sites``."""

    def __init__(self, power_failure, sites):
        self.power_failure, self.sites = power_failure, set(sites)

    def __call__(self, b, phase):
        if (b, phase) in self.sites:
            self.sites.discard((b, phase))
            raise self.power_failure(f"injected at burst {b} @ {phase}")


def _run_traced(mod, tracer, stats, graph, part, inputs, device):
    commits = []
    kw = {} if device is None else {"device": device}
    runtime = mod.BurstRuntime(
        graph, part, mod.MemoryNVM(), cost=None,
        crash_hook=CrashAt(mod.PowerFailure, [(1, "executed"), (0, "stored"), (1, "loaded")]),
        on_commit=commits.append, **kw,
    )
    stats.reset()
    tracer.configure(enabled=True)
    try:
        out = runtime.run_to_completion(inputs)
    finally:
        tracer.disable()
    events = [(e["name"], e.get("cat"), e.get("args")) for e in tracer.events()]
    return out, dict(stats), commits, events, runtime.stats


@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-1.3b"])
def test_runtime_outputs_commits_and_trace_match(arch):
    ref_g = ref_lp.lower_config(REF_SMOKE[arch], 2, 16, with_fns=True, seed=5)
    g = lp.lower_config(SMOKE_CONFIGS[arch], 2, 16, with_fns=True, seed=5)
    cm = REF_FRAM
    n = g.n_tasks
    ref_part = ref_solve(RefSpec(graph=ref_g, cost=cm, objective="exact_k",
                                 n_bursts=n, backend="numpy")).partition()
    part = _partition_from_bounds(g, port_cost(cm), ref_part.bounds, None)
    inputs = lp.external_inputs(g, seed=5)
    assert inputs.keys() == ref_lp.external_inputs(ref_g, seed=5).keys()

    mine = _run_traced(rt, trace.TRACER, rt.COMMIT_STATS, g, part, inputs, CPU)
    ref = _run_traced(ref_rt, ref_trace.TRACER, ref_rt.COMMIT_STATS, ref_g, ref_part,
                      inputs, None)
    out, ref_out = mine[0], ref[0]
    assert out.keys() == ref_out.keys()
    for k in out:
        assert out[k].dtype == ref_out[k].dtype
        assert np.array_equal(out[k], ref_out[k]), k
    assert mine[1] == ref[1] == {"commits": n, "replays": 3}
    assert mine[2] == ref[2] == list(range(n))
    assert mine[3] == ref[3]
    names = [e[0] for e in mine[3]]
    assert names.count("burst") == n + 3 and names.count("power_failure") == 3
    assert names.count("replay") == 3 and names.count("nvm_commit") == n
    assert (mine[4].replays, mine[4].bursts_run) == (ref[4].replays, ref[4].bursts_run)
    atomic = rt.execute_atomic(g, inputs, device=CPU)
    assert all(np.array_equal(atomic[k], out[k]) for k in out)


def test_tracer_off_adds_no_events_and_nvm_has(tmp_path):
    g = lp.lower_config(SMOKE_CONFIGS["qwen3-4b"], 1, 8, with_fns=True)
    part = _partition_from_bounds(g, port_cost(REF_FRAM), [(1, g.n_tasks)], None)
    for nvm in (rt.MemoryNVM(), rt.DirNVM(str(tmp_path / "nvm"))):
        assert not nvm.has("act0")
        rt.BurstRuntime(g, part, nvm, device=CPU).run({})
        assert nvm.has(f"act{g.n_tasks - 1}") and not nvm.has("act0")
    assert trace.TRACER.events() == []
    assert rt.COMMIT_STATS["commits"] == 2
    rt.reset_commit_stats()
    assert rt.COMMIT_STATS == {"commits": 0, "replays": 0}
