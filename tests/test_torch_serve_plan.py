"""The port's planned serving path changes scheduling, never results.

On the CPU, at smoke size, with the plain kernel versions:

* ``serve()`` with and without ``plan_table`` gives identical tokens on both
  smoke archs (dense and xLSTM);
* repeated planned and unplanned requests add no build or capture
  (``TRACE_COUNT``) and no partitioner solve;
* an energy budget splits the request into committed cycles, and a power
  failure mid-request resumes from the last committed cycle with identical
  tokens and one replay, on ``MemoryNVM`` and ``DirNVM``;
* against ``repro``: ``_request_graph`` has the same tasks, packets, bytes
  and costs as ``repro.launch.serve._request_graph`` (dummy step functions,
  nothing compiled), the cycles and burst energies of an opened request
  equal ``repro``'s, and a table the port builds, loaded by ``repro``'s
  ``ServePlanner``, gives the port's ``plan_for``. The tables are built on
  the port's plain sweep (``backend="torch"``): ``repro``'s own builds hit
  the ``enable_x64`` break (ROADMAP.md §3).
"""

import json

import pytest
import torch

from conftest import SERVE_ARCHS, SERVE_BATCH, SERVE_GEN, SERVE_MAX_SEQ, SERVE_PROMPT

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.core.burst import burst_detail as ref_burst_detail
from repro.core.cost import CostModel as RefCostModel
from repro.core.cost import LinearTransfer as RefLinearTransfer
from repro.launch import planner as ref_planner
from repro.launch import serve as ref_serve

from repro_torch.configs import SMOKE_CONFIGS
from repro_torch.core import engine, partition, partition_torch
from repro_torch.core.plan_table import PlanTableError
from repro_torch.core.runtime import DirNVM, MemoryNVM, PowerFailure
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.planner import ServePlanner, build_table_for_arch
from repro_torch.launch.serve import serve

ARCHS = SERVE_ARCHS
BATCH, PROMPT, GEN, MAX_SEQ = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_MAX_SEQ
BUCKETS = [(BATCH, MAX_SEQ), (BATCH, 2 * MAX_SEQ)]


@pytest.fixture(scope="module")
def tables():
    return {arch: build_table_for_arch(arch, BUCKETS, n_q=8, smoke=True, backend="torch")
            for arch in ARCHS}


@pytest.fixture(scope="module")
def plain_tokens():
    return {arch: serve(arch, BATCH, PROMPT, GEN, smoke=True, device="cpu")
            for arch in ARCHS}


def _serve(arch, **kw):
    return serve(arch, BATCH, PROMPT, GEN, smoke=True, device="cpu", **kw)


@pytest.fixture()
def solves(monkeypatch):
    """Calls of every partitioner entry point the port has."""
    calls = []

    def counting(owner, name):
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(owner, name, wrapper)

    counting(engine.Engine, "solve")
    for name in ("sweep", "sweep_from_columns", "q_min", "exact_k_partition"):
        counting(partition_torch, name)
    for name in ("_optimal_multi", "_optimal_k", "q_min"):
        counting(partition, name)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_tokens_identical_to_unplanned(arch, tables, plain_tokens):
    rep = {}
    planned = _serve(arch, plan_table=tables[arch], report=rep)
    assert planned.dtype == torch.int64 and planned.shape == (BATCH, GEN)
    assert torch.equal(planned, plain_tokens[arch])
    assert rep["cycles"] == [(1, GEN)]  # unbounded budget: one cycle
    assert rep["runtime_stats"].bursts_run == 1
    assert rep["planner_stats"]["lookups"] == 1


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_solve_counter_sees_a_table_build(backend, solves):
    build_table_for_arch("qwen3-4b", [(1, 8)], n_q=2, smoke=True, backend=backend)
    assert "solve" in solves and len(solves) > 1


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_lookup_adds_zero_retraces_and_zero_solves(arch, tables, plain_tokens, solves):
    planner = ServePlanner(tables[arch])
    first = _serve(arch, plan_table=planner)
    traces = dict(serve_mod.TRACE_COUNT)
    for _ in range(2):
        assert torch.equal(_serve(arch, plan_table=planner), first)
        assert torch.equal(_serve(arch), first)
    assert dict(serve_mod.TRACE_COUNT) == traces, "request path rebuilt its step functions"
    assert solves == [], "request path solved"
    assert planner.stats["lookups"] == 3
    assert torch.equal(first, plain_tokens[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_unplanned_requests_add_zero_retraces(arch, plain_tokens):
    first = _serve(arch)
    traces = dict(serve_mod.TRACE_COUNT)
    for _ in range(2):
        assert torch.equal(_serve(arch), first)
    assert dict(serve_mod.TRACE_COUNT) == traces
    assert torch.equal(first, plain_tokens[arch])


def test_step_fns_count_builds_not_calls():
    serve_mod.reset_trace_counts()
    key = ("qwen3-4b", True, 3, 11, torch.device("cpu"))
    prefill, decode = serve_mod._step_fns(*key, donate=False)
    assert serve_mod._step_fns(*key, donate=False) == (prefill, decode)
    assert dict(serve_mod.TRACE_COUNT) == {"prefill": 1, "decode": 1}  # one build each
    cfg = SMOKE_CONFIGS["qwen3-4b"]
    model = serve_mod.api.init_params(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab, (3, 9), generator=torch.Generator().manual_seed(0))
    logits, cache = prefill(model, {"tokens": toks})
    snapshot = {k: v.clone() for k, v in cache.items()}
    tok = logits[:, -1].argmax(-1, keepdim=True)
    _, new = decode(model, cache, tok, 9)
    # the planned path's decode never donates: its input cache is untouched
    assert all(torch.equal(cache[k], snapshot[k]) for k in cache)
    assert not torch.equal(new["k"], cache["k"])
    before = dict(serve_mod.TRACE_COUNT)
    for _ in range(3):
        decode(model, cache, tok, 9)
    assert dict(serve_mod.TRACE_COUNT) == before


def test_energy_budget_splits_into_committed_cycles(tables, plain_tokens):
    arch = ARCHS[0]
    table = tables[arch]
    plan = table.lookup(BATCH, MAX_SEQ, None)
    budget = plan.e_total * 2.2 + table.e_startup  # ~2 steps per cycle
    rep = {}
    planned = _serve(arch, plan_table=table, energy_budget=budget, report=rep)
    assert torch.equal(planned, plain_tokens[arch])
    assert len(rep["cycles"]) == 3
    assert rep["runtime_stats"].bursts_run == 3
    assert rep["nvm"].read_index() == 3
    expect = 3 * table.e_startup + GEN * plan.e_total
    assert rep["runtime_stats"].energy == pytest.approx(expect, rel=1e-12)


class CrashOnce:
    def __init__(self):
        self.fired = 0
        self.sites = []

    def __call__(self, b, phase):
        self.sites.append((b, phase))
        if b == 1 and phase == "executed" and not self.fired:
            self.fired += 1
            raise PowerFailure("injected mid-request")


@pytest.mark.parametrize("nvm_kind", ["memory", "dir"])
@pytest.mark.parametrize("arch", ARCHS)
def test_crash_mid_request_resumes_from_committed_cycle(arch, nvm_kind, tables, plain_tokens,
                                                        tmp_path):
    table = tables[arch]
    plan = table.lookup(BATCH, MAX_SEQ, None)
    budget = plan.e_total * 2.2 + table.e_startup
    nvm = MemoryNVM() if nvm_kind == "memory" else DirNVM(str(tmp_path / "nvm"))
    hook = CrashOnce()
    rep = {}
    planned = _serve(arch, plan_table=table, energy_budget=budget, nvm=nvm, crash_hook=hook,
                     report=rep)
    assert hook.fired == 1
    assert torch.equal(planned, plain_tokens[arch])
    st = rep["runtime_stats"]
    assert st.bursts_run == 3 and st.replays == 1
    assert st.tasks_run == GEN + 2           # cycle 1 (2 steps) ran twice
    assert hook.sites.count((0, "loaded")) == 1  # cycle 0's commit survived


def test_table_arch_mismatch_raises(tables):
    with pytest.raises(PlanTableError):
        _serve(ARCHS[1], plan_table=tables[ARCHS[0]])


@pytest.mark.parametrize("kw", [{"energy_budget": 1.0}, {"nvm": MemoryNVM()},
                                {"crash_hook": CrashOnce()}],
                         ids=["energy_budget", "nvm", "crash_hook"])
def test_planned_only_arguments_without_a_table_raise(kw):
    with pytest.raises(ValueError, match="require plan_table"):
        _serve("qwen3-4b", **kw)


def test_reset_trace_counts_zeroes_counters():
    serve_mod.TRACE_COUNT["prefill"] += 1  # simulate leaked state
    serve_mod.reset_trace_counts()
    assert serve_mod.TRACE_COUNT == {"prefill": 0, "decode": 0}


# -- against repro -----------------------------------------------------------------


def _dummy_step(*args):
    raise AssertionError("a dummy step function ran")


def _graph_record(g):
    packets = [(p.name, p.nbytes, p.c0_weight, p.keep, p.external) for p in g.packets.values()]
    tasks = [(t.name, tuple(t.reads), tuple(t.writes), t.cost) for t in g.tasks]
    return packets, tasks


@pytest.mark.parametrize("gen", [1, 2, GEN])
@pytest.mark.parametrize("arch", ARCHS)
def test_request_graph_matches_reference(arch, gen):
    step_energy = 0.125 + 0.01 * gen
    got = serve_mod._request_graph(SMOKE_CONFIGS[arch], None, BATCH, PROMPT, gen,
                                   PROMPT + gen, _dummy_step, _dummy_step, step_energy)
    want = ref_serve._request_graph(REF_SMOKE[arch], None, BATCH, PROMPT, gen, PROMPT + gen,
                                    _dummy_step, _dummy_step, step_energy)
    assert _graph_record(got) == _graph_record(want)
    assert serve_mod._cache_nbytes(SMOKE_CONFIGS[arch], BATCH, MAX_SEQ) == \
        ref_serve._cache_nbytes(REF_SMOKE[arch], BATCH, MAX_SEQ)


@pytest.mark.parametrize("steps_per_cycle", [None, 1, 2.2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_cycles_and_bursts_match_reference(arch, steps_per_cycle, tables):
    table = tables[arch]
    ex = serve_mod.PlannedExecutor(arch, table, smoke=True, device="cpu")
    plan = ex.planner.plan_for(BATCH, MAX_SEQ, None)
    budget = (None if steps_per_cycle is None
              else table.e_startup + steps_per_cycle * plan.e_total)
    cont = ex.open(BATCH, PROMPT, GEN, cycle_budget=budget)
    want_cycles = ref_planner.request_cycles(GEN, plan.e_total, budget,
                                             e_startup=table.e_startup)
    assert cont.cycles == want_cycles
    assert cont.runtime.partition.bounds == want_cycles
    ref_graph = ref_serve._request_graph(REF_SMOKE[arch], None, BATCH, PROMPT, GEN, MAX_SEQ,
                                         _dummy_step, _dummy_step, plan.e_total)
    cost = RefCostModel(e_startup=table.e_startup, read=RefLinearTransfer(0.0, 0.0),
                        write=RefLinearTransfer(0.0, 0.0), name="request-cycles")
    for (i, j), got in zip(want_cycles, cont.runtime.partition.bursts):
        want = ref_burst_detail(ref_graph, cost, i, j)
        assert (got.total, got.loads, got.stores, got.read_bytes, got.write_bytes) == \
            (want.total, want.loads, want.stores, want.read_bytes, want.write_bytes)
        assert cont.cycle_cost([c for c in want_cycles].index((i, j))) == \
            pytest.approx(want.total, rel=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_table_read_by_reference_planner_gives_the_same_plans(arch, tables, tmp_path):
    table = tables[arch]
    path = str(tmp_path / "plan.npz")
    table.save(path)
    ours, theirs = ServePlanner(table), ref_planner.ServePlanner.from_file(path)
    budgets = [None] + sorted(q for q in table.q_values() if q is not None)[-4:]
    for batch, seq in [(BATCH, 5), (BATCH, MAX_SEQ), (BATCH, MAX_SEQ + 1)]:
        for q in budgets:
            a, b = ours.plan_for(batch, seq, q), theirs.plan_for(batch, seq, q)
            assert (a.batch, a.seq_bucket, tuple(a.bounds), a.e_total, a.n_cycles) == \
                (b.batch, b.seq_bucket, tuple(b.bounds), b.e_total, b.n_cycles)
    assert ours.stats["hits"] == theirs.stats["hits"] == 15


# -- the CLI -----------------------------------------------------------------------


def test_serve_cli_planned_on_cpu(tables, tmp_path, capsys):
    path = str(tmp_path / "plan.npz")
    tables["qwen3-4b"].save(path)
    plan = tables["qwen3-4b"].lookup(BATCH, MAX_SEQ, None)
    budget = tables["qwen3-4b"].e_startup + 2.5 * plan.e_total
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    rc = serve_mod.main(["--smoke", "--device", "cpu", "--batch", str(BATCH),
                         "--prompt-len", str(PROMPT), "--gen", str(GEN), "--plan-table", path,
                         "--energy-budget", repr(budget), "--trace-out", str(trace),
                         "--metrics-out", str(metrics)])
    out = capsys.readouterr().out
    assert rc == 0 and "planned batch=2" in out and "in 3 energy cycles" in out
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e.get("name") == "nvm_commit" for e in events) == 3
    assert "serve.trace_count" in json.loads(metrics.read_text())["metrics"]


@pytest.mark.parametrize("flag", [["--calibration", "c.json"], ["--drift-tol", "0.1"]])
def test_serve_cli_calibration_names_its_roadmap_item(flag, capsys):
    with pytest.raises(SystemExit) as e:
        serve_mod.main(["--smoke", "--device", "cpu", *flag])
    assert e.value.code == 2
    assert "queue 1, item 6" in capsys.readouterr().err


def test_planned_path_on_cuda_without_a_card_raises(tables):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        serve("qwen3-4b", BATCH, PROMPT, GEN, smoke=True, plan_table=tables["qwen3-4b"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mod.PlannedExecutor("qwen3-4b", tables["qwen3-4b"], smoke=True)
