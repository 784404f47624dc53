"""The port's measured-cost calibration against the reference.

``repro.core.calibration`` is jax-free, so its statistics, tables and
payloads meet the port's as numpy meets numpy: the same seeded samples and
ledger rows go to both, on the same base scalars (the reference's, carried
across by ``port_cost``; the port's own default base is the H100's). Held
here: ``z_score`` and the Welford statistics bit for bit, table JSON bytes
and fingerprints, the sigma = 0 contract (the base object itself), every
tamper rejection of ``from_payload``, the registry and ``use_measured``,
``confidence=`` on the façade against ``repro``'s numpy backend, and the
drift probe against the drift ``repro``'s numpy pieces compute for the same
cycles (``repro``'s own probe cannot run here: it needs the ``enable_x64``
build of its engine). Then the calibration loop through the traffic and
serve CLIs on the CPU.
"""

import json
import math
import random

import numpy as np
import pytest

from helpers_torch import port_cost, port_of
from repro.api import PartitionSpec as RefSpec
from repro.api import solve as ref_solve
from repro.core import burst as ref_burst
from repro.core import calibration as rc
from repro.core import graph as ref_graph
from repro.core.cost import tpu_host_offload_model
from repro.core.partition import BUDGET_ABS as REF_BUDGET_ABS

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.core import calibration as pc
from repro_torch.core import layer_profile as lp
from repro_torch.core.plan_table import (
    PlanTableError,
    StaleTableError,
    build_plan_table,
    probe_plan_table,
)
from repro_torch.launch import planner as planner_mod
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import traffic as traffic_mod
from repro_torch.obs.ledger import CATEGORIES, EnergyLedger

REF_BASE = tpu_host_offload_model()
BASE = port_cost(REF_BASE)
PROBE_BUCKETS = ((1, 128), (4, 512))


def _bits(x: float) -> str:
    return float(x).hex()


def _rows(seed, n=24, restore=None, noise=0.0):
    """Seeded ledger rows: ``n`` cycles charging restore (``restore`` each,
    scaled by 1 + noise·N(0,1)), compute and commit; one replay."""
    rs = np.random.default_rng(seed)
    e_s = BASE.e_startup if restore is None else restore
    rows = []
    for c in range(n):
        rows.append({"rid": c // 4, "cycle": c % 4, "category": "restore",
                     "energy": float(e_s * (1.0 + noise * rs.standard_normal()))})
        rows.append({"rid": c // 4, "cycle": c % 4, "category": "compute",
                     "energy": float(rs.uniform(1e-3, 5e-2))})
        rows.append({"rid": c // 4, "cycle": c % 4, "category": "commit",
                     "energy": float(rs.uniform(1e-5, 1e-3))})
    rows.append({"rid": 0, "cycle": 1, "category": "replay", "energy": 2.5e-3})
    return rows


def _tables(rows, kind="time"):
    """(port table on BASE, reference table on REF_BASE) from ``rows``."""
    p, r = pc.MeasuredCostTable(BASE, kind), rc.MeasuredCostTable(REF_BASE, kind)
    p.ingest_rows(rows)
    r.ingest_rows(rows)
    return p, r


def _ref_graph_of(g):
    """The port's graph as the reference's (plain data across)."""
    packets = [ref_graph.Packet(p.name, p.nbytes, p.c0_weight, keep=p.keep,
                                external=p.external) for p in g.packets.values()]
    tasks = [ref_graph.Task(t.name, t.reads, t.writes, t.cost) for t in g.tasks]
    return ref_graph.TaskGraph(tasks, packets)


# -- statistics -----------------------------------------------------------------


@pytest.mark.parametrize("c", [None, 0.5, 0.9, 0.1, 0.999, 1e-9])
def test_z_score_bitwise(c):
    assert _bits(pc.z_score(c)) == _bits(rc.z_score(c))


@pytest.mark.parametrize("c", [0.0, 1.0, 1.5, -0.2, float("nan")])
def test_z_score_rejects_what_the_reference_rejects(c):
    with pytest.raises(rc.CalibrationError):
        rc.z_score(c)
    with pytest.raises(pc.CalibrationError):
        pc.z_score(c)


@pytest.mark.parametrize("seed", range(4))
def test_kernel_stats_and_merge_bitwise(seed):
    rs = np.random.default_rng(seed)
    xs = rs.lognormal(-7, 1.5, size=40).tolist()
    cut = int(rs.integers(1, 39))
    parts = []
    for lo, hi in ((0, cut), (cut, 40), (0, 40)):
        a, b = pc.KernelStats(), rc.KernelStats()
        for x in xs[lo:hi]:
            a.add(x)
            b.add(x)
        assert (a.count, _bits(a.mean), _bits(a.m2)) == (b.count, _bits(b.mean), _bits(b.m2))
        assert _bits(a.std) == _bits(b.std) and _bits(a.cv) == _bits(b.cv)
        parts.append((a, b))
    (pa, ra), (pb, rb), (pall, _) = parts
    pm, rm = pa.merge(pb), ra.merge(rb)
    assert (pm.count, _bits(pm.mean), _bits(pm.m2)) == (rm.count, _bits(rm.mean), _bits(rm.m2))
    assert math.isclose(pm.mean, pall.mean, rel_tol=1e-12)
    assert math.isclose(pm.m2, pall.m2, rel_tol=1e-9)
    empty = pc.KernelStats()
    assert empty.merge(pa).to_dict() == pa.to_dict() == pa.merge(empty).to_dict()
    same = pc.KernelStats()
    for _ in range(17):
        same.add(xs[0])
    assert _bits(same.mean) == _bits(xs[0]) and same.m2 == 0.0
    with pytest.raises(pc.CalibrationError):
        pa.merge(rb)
    with pytest.raises(pc.CalibrationError):
        pc.KernelStats().add(float("inf"))


def test_categories_agree_with_the_ledger_and_the_reference():
    assert pc.CATEGORIES == CATEGORIES == rc.CATEGORIES
    assert pc.CALIBRATION_VERSION == rc.CALIBRATION_VERSION


# -- tables -----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_table_json_and_fingerprint_equal_the_reference(seed, tmp_path):
    rows = _rows(seed, noise=0.02)
    p, r = _tables(rows)
    assert p.fingerprint() == r.fingerprint()
    assert json.dumps(p.to_payload(run=seed)) == json.dumps(r.to_payload(run=seed))
    p.to_json(str(tmp_path / "p.json"), run=seed)
    r.to_json(str(tmp_path / "r.json"), run=seed)
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "r.json").read_bytes()
    back = pc.MeasuredCostTable.from_json(str(tmp_path / "r.json"))
    assert back.fingerprint() == p.fingerprint()
    for conf in (None, 0.9, 0.3):
        a, b = p.cost_model(conf), r.cost_model(conf)
        assert a.name == b.name
        assert [_bits(x) for x in (a.e_startup, a.read.c0, a.read.c1, a.write.c0, a.write.c1)] \
            == [_bits(x) for x in (b.e_startup, b.read.c0, b.read.c1, b.write.c0, b.write.c1)]
    p2, r2 = _tables(_rows(seed + 10, noise=0.02))
    merged, rmerged = pc.MeasuredCostTable.merge(p, p2), rc.MeasuredCostTable.merge(r, r2)
    assert merged.fingerprint() == rmerged.fingerprint()
    assert json.dumps(merged.to_payload()) == json.dumps(rmerged.to_payload())


def test_ledger_dump_ingests_as_in_the_reference(tmp_path):
    ledger = EnergyLedger()
    for row in _rows(5, n=8, noise=0.01):
        if row["category"] == "replay":
            ledger.overhead(row["rid"], row["cycle"], row["energy"])
        else:
            ledger.charge(row["rid"], row["cycle"], **{row["category"]: row["energy"]})
    path = str(tmp_path / "ledger.json")
    ledger.dump_json(path, tool="traffic", kind="time", seed=5)
    p = pc.MeasuredCostTable.from_ledger_json(path, base=BASE)
    r = rc.MeasuredCostTable.from_ledger_json(path, base=REF_BASE)
    assert p.n_samples == r.n_samples == len(ledger.entries)
    assert json.dumps(p.to_payload()) == json.dumps(r.to_payload())
    own = pc.MeasuredCostTable.from_ledger(ledger)
    assert own.base == lp.analytical_cost_model("time")   # the H100's model
    assert own.base.name == "h100-host-offload"
    with pytest.raises(pc.CalibrationError):
        (tmp_path / "bad.json").write_text(json.dumps({"kind": "time"}))
        pc.MeasuredCostTable.from_ledger_json(str(tmp_path / "bad.json"))


def test_sigma_zero_is_the_base_object_and_solves_bitwise():
    g_ref = random.Random(3)
    from helpers_random import random_cost_model, random_task_graph

    g = random_task_graph(g_ref, max_tasks=12)
    cm = random_cost_model(g_ref)
    pg, pcm = port_of(g, cm)
    table = pc.MeasuredCostTable(pcm)
    table.ingest_rows([{"category": "restore", "energy": pcm.e_startup}] * 9
                      + [{"category": "commit", "energy": 4e-4}] * 5)
    for conf in (None, 0.5, 0.9, 0.01):
        assert table.cost_model(conf) is pcm
    qs = (None, 2.0 * table.e_startup())
    got = api.solve(graph=pg, cost=table, confidence=0.9, q_grid=qs, backend="torch")
    want = api.solve(graph=pg, cost=pcm, q_grid=qs, backend="torch")
    assert got.cost is pcm
    for f in ("dp", "parent", "e_total", "starts"):
        assert np.array_equal(getattr(got.sweep, f), getattr(want.sweep, f))
    empty = pc.MeasuredCostTable(pcm)
    assert empty.cost_model(0.9) is pcm and empty.e_startup(0.9) == pcm.e_startup


def _payload():
    p, _ = _tables(_rows(1, n=6, noise=0.01))
    return p.to_payload()


def _tamper(kind):
    d = json.loads(json.dumps(_payload()))
    if kind == "version":
        d["version"] = 2
    elif kind == "no_version":
        del d["version"]
    elif kind == "fingerprint":
        d["fingerprint"] = "0" * 64
    elif kind == "nan_mean":
        d["stats"]["restore"]["mean"] = float("nan")
        d.pop("fingerprint")
    elif kind == "negative_count":
        d["stats"]["commit"]["count"] = -1
        d.pop("fingerprint")
    elif kind == "negative_m2":
        d["stats"]["commit"]["m2"] = -1.0
        d.pop("fingerprint")
    elif kind == "empty_with_moments":
        d["stats"]["replay"] = {"count": 0, "mean": 1.0, "m2": 0.0}
        d.pop("fingerprint")
    elif kind == "missing_field":
        del d["stats"]["compute"]["m2"]
    elif kind == "unknown_category":
        d["stats"]["sleep"] = {"count": 0, "mean": 0.0, "m2": 0.0}
    elif kind == "edited_stats":
        d["stats"]["restore"]["mean"] *= 2.0
    return d


@pytest.mark.parametrize("kind", ["version", "no_version", "fingerprint", "nan_mean",
                                  "negative_count", "negative_m2", "empty_with_moments",
                                  "missing_field", "unknown_category", "edited_stats"])
def test_from_payload_rejects_what_the_reference_rejects(kind):
    bad = _tamper(kind)
    with pytest.raises(rc.CalibrationError):
        rc.MeasuredCostTable.from_payload(json.loads(json.dumps(bad)))
    with pytest.raises(pc.CalibrationError):
        pc.MeasuredCostTable.from_payload(bad)


def test_from_payload_without_fingerprint_loads():
    d = _payload()
    fp = d.pop("fingerprint")
    assert pc.MeasuredCostTable.from_payload(d).fingerprint() == fp


# -- the registry -----------------------------------------------------------------


def test_registry_and_use_measured_scoping():
    pc.clear_measured_defaults()
    clean = pc.MeasuredCostTable.from_ledger(EnergyLedger())
    hot, _ = _tables(_rows(2, restore=3 * BASE.e_startup))
    assert pc.measured_default("time") is None
    assert lp.default_cost_model("time") == lp.analytical_cost_model("time")
    with pc.use_measured(hot):
        assert pc.measured_default("time") is hot
        assert lp.default_cost_model("time").e_startup == hot.e_startup()
        with pc.use_measured(clean):
            assert lp.default_cost_model("time") is clean.base
        assert pc.measured_default("time") is hot
        sol = api.solve(config="qwen3-4b", smoke=True, shapes=((2, 16),), kind="time",
                        objective="minimax", backend="numpy")
        assert sol.cost.e_startup == hot.e_startup()
        assert lp.default_cost_model("memory") == lp.memory_cost_model()
    assert pc.measured_default("time") is None
    api.install_measured_default(hot)
    api.install_measured_default(clean, kind="memory")
    assert pc.measured_default("memory") is clean
    api.clear_measured_defaults("memory")
    assert pc.measured_default("memory") is None and pc.measured_default("time") is hot
    api.clear_measured_defaults()
    assert pc.measured_default("time") is None
    with pytest.raises(pc.CalibrationError):
        pc.install_measured_default(BASE)


# -- the façade -------------------------------------------------------------------


@pytest.mark.parametrize("bad", [0.0, 1.0, -0.1, 1.5, float("nan"), "high"])
def test_confidence_is_validated(bad):
    with pytest.raises(api.SpecError):
        api.PartitionSpec(graph=lp.lower_config(get_config("qwen3-4b"), 1, 128),
                          cost=BASE, confidence=bad)


def test_confidence_with_a_plain_cost_model_fails_at_solve_time():
    g = lp.lower_config(get_config("qwen3-4b"), 1, 128)
    spec = api.PartitionSpec(graph=g, cost=BASE, confidence=0.9, backend="torch")
    assert spec.confidence == 0.9
    with pytest.raises(api.SpecError, match="MeasuredCostTable"):
        api.solve(spec)
    with pytest.raises(api.SpecError):
        api.PartitionSpec(graph=g, cost=object())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("objective", ["sum", "minimax", "exact_k"])
def test_confidence_solves_equal_the_reference_numpy_backend(seed, objective):
    from helpers_random import random_task_graph

    rng = random.Random(900 + seed)
    g = random_task_graph(rng, max_tasks=12)
    pg, _ = port_of(g, REF_BASE)
    p, r = _tables(_rows(seed, noise=0.3))
    priced = p.cost_model(0.9)
    assert priced.e_startup > p.stats["restore"].mean and priced is not p.base
    qmin = ref_solve(RefSpec(graph=g, cost=r, confidence=0.9, objective="minimax",
                             backend="numpy")).q_min()
    got_qmin = api.solve(graph=pg, cost=p, confidence=0.9, objective="minimax",
                         backend="torch").q_min()
    assert _bits(got_qmin) == _bits(qmin)
    if objective == "minimax":
        return
    if objective == "sum":
        kw = dict(q_grid=(qmin, 1.7 * qmin, None))
    else:
        kw = dict(objective="exact_k", n_bursts=max(1, g.n_tasks // 2), q_max=2 * qmin)
    want = ref_solve(RefSpec(graph=g, cost=r, confidence=0.9, backend="numpy", **kw))
    got = api.solve(graph=pg, cost=p, confidence=0.9, backend="torch", **kw)
    for a, b in zip(got.partitions(), want.partitions()):
        assert (a is None) == (b is None)
        if b is not None:
            assert a.bounds == b.bounds
            assert [_bits(x.total) for x in a.bursts] == [_bits(x.total) for x in b.bursts]


# -- the drift probe ----------------------------------------------------------------


@pytest.fixture(scope="module")
def probe_table():
    cfg = get_config("qwen3-4b")
    graphs = planner_mod.lower_buckets(cfg, PROBE_BUCKETS, "time")
    qs = planner_mod.derive_q_grid(graphs, BASE, 6, backend="torch")
    table = build_plan_table(cfg, PROBE_BUCKETS, qs, kind="time", cost=BASE, graphs=graphs,
                             backend="torch")
    ref_graphs = {b: _ref_graph_of(g) for b, g in zip(PROBE_BUCKETS, graphs)}
    return cfg, table, ref_graphs


def _ref_verdict(table, ref_graphs, ref_measured, tol) -> bool:
    """Whether ``repro``'s numpy pieces find every tabulated cycle within
    ``tol`` of its draw under the measured mean model (the probe's rule)."""
    m_cm = ref_measured.cost_model()
    for b, bucket in enumerate(table.buckets()):
        g = ref_graphs[bucket]
        for qi in range(table.n_q):
            if not table.feasible[b, qi]:
                continue
            plan = table.plan_at(b, qi)
            for (i, j), tab in zip(plan.bounds, plan.cycle_energy):
                assert ref_burst.burst_cost(g, REF_BASE, i, j) == tab
                meas = ref_burst.burst_cost(g, m_cm, i, j)
                if abs(meas - tab) > tol * max(abs(meas), abs(tab)) + REF_BUDGET_ABS:
                    return False
    return True


@pytest.mark.parametrize("factor,tol", [(1.0, 0.05), (1.2, 0.05), (60.0, 0.05),
                                        (60.0, 0.9), (4000.0, 0.05), (4000.0, 0.5)])
def test_probe_against_the_reference_drift(probe_table, factor, tol):
    """Clean (factor 1), within tolerance, refused, and the same profile
    accepted under a looser tolerance — each as ``repro``'s pieces judge."""
    cfg, table, ref_graphs = probe_table
    p, r = _tables(_rows(7, restore=factor * BASE.e_startup))
    want = _ref_verdict(table, ref_graphs, r, tol)
    if want:
        assert probe_plan_table(table, cfg, k=None, cost=BASE, backend="torch",
                                measured=p, drift_tol=tol) == table.feasible.size
    else:
        with pytest.raises(StaleTableError, match="drifted"):
            probe_plan_table(table, cfg, k=None, cost=BASE, backend="torch", measured=p,
                             drift_tol=tol)


def test_probe_cases_cover_accept_and_refuse(probe_table):
    _, table, ref_graphs = probe_table
    verdicts = {f: _ref_verdict(table, ref_graphs, _tables(_rows(7, restore=f * BASE.e_startup))[1],
                                0.05)
                for f in (1.0, 1.2, 60.0, 4000.0)}
    assert verdicts[1.0] and verdicts[1.2] and not verdicts[4000.0]


def test_probe_rejects_a_kind_mismatch_and_a_negative_tolerance(probe_table):
    cfg, table, _ = probe_table
    mem, _ = _tables(_rows(1), kind="memory")
    with pytest.raises(StaleTableError, match="kind"):
        probe_plan_table(table, cfg, k=2, cost=BASE, backend="torch", measured=mem)
    clean, _ = _tables(_rows(1))
    with pytest.raises(PlanTableError, match="drift_tol"):
        probe_plan_table(table, cfg, k=2, cost=BASE, backend="torch", measured=clean,
                         drift_tol=-0.01)
    assert probe_plan_table(table, cfg, k=3, cost=BASE, backend="torch",
                            measured=clean, drift_tol=0.0) == 3


# -- the loop through the CLIs --------------------------------------------------------


def test_traffic_replan_round_trip_and_serve_calibration(tmp_path, capsys):
    ledger = tmp_path / "ledger.json"
    rc_ = traffic_mod.main(["--build", "--device", "cpu", "--replan", "--expect-replan-identical",
                            "--n", "3", "--interval", "0", "--shapes", "2x8x6",
                            "--cycle-budget", "1e-3", "--ledger-out", str(ledger)])
    out = capsys.readouterr().out
    assert rc_ == 0, out
    assert "identical to the original" in out and "replan probe: 4 cells within 5.0%" in out
    # the run's ledger as a calibration, in both packages on the same base
    p = pc.MeasuredCostTable.from_ledger_json(str(ledger), base=BASE)
    r = rc.MeasuredCostTable.from_ledger_json(str(ledger), base=REF_BASE)
    assert p.n_samples > 0 and json.dumps(p.to_payload()) == json.dumps(r.to_payload())

    table = tmp_path / "t.npz"
    assert planner_mod.main(["--device", "cpu", "--out", str(table)]) == 0
    cal = tmp_path / "cal.json"
    pc.MeasuredCostTable.from_ledger_json(str(ledger)).to_json(str(cal))
    capsys.readouterr()
    assert serve_mod.main(["--device", "cpu", "--plan-table", str(table),
                           "--calibration", str(cal)]) == 0
    out = capsys.readouterr().out
    assert "calibration probe: 4 cells" in out and "planned batch=4" in out
    hot = pc.MeasuredCostTable.from_ledger_json(str(ledger))
    hot.stats["restore"] = pc.KernelStats(count=3, mean=1e3 * hot.base.e_startup, m2=0.0)
    hot.to_json(str(cal))
    with pytest.raises(StaleTableError, match="drifted"):
        serve_mod.main(["--device", "cpu", "--plan-table", str(table),
                        "--calibration", str(cal)])
    assert serve_mod.main(["--device", "cpu", "--plan-table", str(table), "--calibration",
                           str(cal), "--drift-tol", "2000"]) == 0
