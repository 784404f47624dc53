"""The port's plan tables against the reference's, at full width.

``repro``'s own ``build_plan_table`` cannot run here (its ``auto``/``scan``/
``pallas`` backends need ``enable_x64``, and ``numpy`` returns no sweep
tables), so the expected table is assembled from ``repro``'s numpy pieces:
the CSR oracle's DP tables for each bucket, ``repro``'s cell assembly and
header, and ``repro.api.solve(backend="numpy")`` for every cell's plan.

* ``config_fingerprint`` equals ``repro``'s for the same inputs;
* a table the port writes loads in ``repro``'s ``PlanTable.load`` with an
  equal ``content_digest()`` and equal lookups, and that digest is the one
  of the table assembled from ``repro``'s pieces;
* every cell equals ``repro``'s numpy façade solve bit for bit, for
  qwen3-4b (time and memory) and xlstm-1.3b at the buckets ``chip_smoke.py``
  builds on the card;
* extension byte-identity and lineage, the probe's detection of an altered
  cell, the fingerprint cache, version and lookup errors.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest

from helpers_torch import load_ref_oracle, port_cost
from repro.api import PartitionSpec as RefSpec
from repro.api import solve as ref_solve
from repro.configs import get_config as ref_get_config
from repro.core import cost as ref_cost
from repro.core import layer_profile as ref_lp
from repro.core import plan_table as ref_pt
from repro.core import q_min as ref_q_min
from repro.core import whole_app_partition as ref_whole_app

from repro_torch.api import SpecError
from repro_torch.configs import get_config
from repro_torch.core import layer_profile as lp
from repro_torch.core import plan_table as pt
from repro_torch.core.partition import Infeasible
from repro_torch.obs.metrics import reset_all
from repro_torch.obs.trace import TRACER

REF = load_ref_oracle()

QWEN_BUCKETS = [(1, 128), (1, 512), (1, 1000), (1, 2048), (4, 512), (4, 1024),
                (8, 512), (8, 2048)]
XLSTM_BUCKETS = [(1, 128), (1, 512), (1, 1024), (4, 512), (4, 1024), (8, 2048)]
TABLES = [("qwen3-4b", "time", QWEN_BUCKETS), ("qwen3-4b", "memory", QWEN_BUCKETS),
          ("xlstm-1.3b", "time", XLSTM_BUCKETS)]


@pytest.fixture(autouse=True)
def _reference_peak_and_clean_counters(monkeypatch):
    # time-kind graphs price E_task at PEAK_FLOPS: the reference's, here only
    monkeypatch.setattr(lp, "PEAK_FLOPS", ref_cost.PEAK_FLOPS)
    yield
    reset_all()
    TRACER.reset()


def ref_cost_of(kind):
    return ref_lp.analytical_cost_model(kind)


def ref_q_grid(ref_graphs, cm, n_q=16):
    """derive_q_grid's rule from the reference's numpy pieces."""
    lo = min(ref_q_min(g, cm) for g in ref_graphs)
    hi = max(ref_whole_app(g, cm).e_total * 1.05 for g in ref_graphs)
    return list(np.geomspace(lo, max(hi, lo * 1.0001), n_q)) + [None]


def oracle_sweep(g, cm, qs):
    """The reference CSR oracle's DP tables as the fields cell assembly reads."""
    n = g.n_tasks
    mns, bests = REF.sweep_columns_ref(g.to_csr_arrays(), cm, qs)
    e_total = mns[n - 1].copy()
    starts = np.zeros((len(qs), n + 1), dtype=bool)
    for qi in range(len(qs)):
        j = n
        while np.isfinite(e_total[qi]) and j > 0:
            i = int(bests[j - 1, qi])
            starts[qi, i] = True
            j = i - 1
    return SimpleNamespace(n_tasks=n, q_values=list(qs), e_total=e_total,
                           feasible=np.isfinite(e_total), starts=starts)


def ref_table(ref_cfg, buckets, qs, kind, cm):
    """The table ``repro`` would build, from its numpy pieces."""
    buckets, qs, _ = ref_pt._canonical_grid(buckets, qs)
    fp = ref_pt.config_fingerprint(ref_cfg, buckets, qs, kind, cm)
    graphs = [ref_lp.lower_config(ref_cfg, b, s, kind=kind) for (b, s) in buckets]
    block = ref_pt._block_from_sweeps(graphs, cm, [oracle_sweep(g, cm, qs) for g in graphs])
    return ref_pt._finish_table(ref_cfg, kind, cm, fp, "numpy", buckets, qs,
                                [g.n_tasks for g in graphs], block, lineage=[fp])


def _setup(arch, kind, buckets):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    cm = ref_cost_of(kind)
    ref_graphs = [ref_lp.lower_config(ref_cfg, b, s, kind=kind) for (b, s) in buckets]
    return ref_cfg, cfg, cm, port_cost(cm), ref_q_grid(ref_graphs, cm)


@pytest.mark.parametrize("arch,kind,buckets", TABLES, ids=[f"{a}-{k}" for a, k, _ in TABLES])
def test_full_width_table_equals_reference(arch, kind, buckets, tmp_path):
    ref_cfg, cfg, cm, pc, qs = _setup(arch, kind, buckets)
    from repro_torch.launch.planner import derive_q_grid, lower_buckets

    assert derive_q_grid(lower_buckets(cfg, buckets, kind), pc, 16, backend="torch") == qs
    assert pt.config_fingerprint(cfg, buckets, qs, kind, pc) == \
        ref_pt.config_fingerprint(ref_cfg, buckets, qs, kind, cm)

    table = pt.build_plan_table(cfg, buckets, qs, kind=kind, cost=pc, backend="torch")
    numpy_built = pt.build_plan_table(cfg, buckets, qs, kind=kind, cost=pc, backend="numpy")
    want = ref_table(ref_cfg, buckets, qs, kind, cm)
    assert table.content_digest() == numpy_built.content_digest() == want.content_digest()

    path = table.save(str(tmp_path / "port.npz"))
    loaded = ref_pt.PlanTable.load(path)
    assert loaded.content_digest() == table.content_digest()
    assert loaded.header == table.header

    # every cell against the reference's numpy façade solve
    for b, (batch, seq) in enumerate(table.buckets()):
        g = ref_lp.lower_config(ref_cfg, batch, seq, kind=kind)
        parts = ref_solve(RefSpec(graph=g, cost=cm, q_grid=tuple(table.q_values()),
                                  backend="numpy")).partitions()
        e_dp = oracle_sweep(g, cm, table.q_values()).e_total
        for k, (q, part) in enumerate(zip(table.q_values(), parts)):
            assert bool(table.feasible[b, k]) == (part is not None)
            if part is None:
                with pytest.raises(Infeasible):
                    table.plan_at(b, k)
                continue
            plan = table.plan_at(b, k)
            assert list(plan.bounds) == part.bounds
            assert plan.cycle_energy == tuple(x.total for x in part.bursts)
            assert plan.e_total == e_dp[k]
            assert plan.n_tasks == g.n_tasks
            got, ref_plan = table.lookup(batch, seq, q), loaded.lookup(batch, seq, q)
            assert (got.bounds, got.cycle_energy, got.e_total) == \
                (ref_plan.bounds, ref_plan.cycle_energy, ref_plan.e_total)


def _qwen_grid(kind="time"):
    ref_cfg, cfg, cm, pc, qs = _setup("qwen3-4b", kind, QWEN_BUCKETS[:4])
    return cfg, pc, qs


def test_extension_is_byte_identical_and_records_lineage():
    cfg, pc, qs = _qwen_grid()
    full = pt.build_plan_table(cfg, QWEN_BUCKETS, qs, cost=pc, backend="torch")
    rng = random.Random(7)
    buckets = list(QWEN_BUCKETS)
    rng.shuffle(buckets)
    base = pt.build_plan_table(cfg, buckets[:3], qs[::2], cost=pc, backend="numpy")
    step = pt.extend_plan_table(base, cfg, add_buckets=buckets[3:6],
                                add_q_values=qs[1::4], cost=pc, backend="torch")
    final = pt.extend_plan_table(step, cfg, add_buckets=buckets[6:] + buckets[:1],
                                 add_q_values=qs[1::2], cost=pc, backend="numpy")
    assert final.content_digest() == full.content_digest()
    assert final.lineage == [base.fingerprint, step.fingerprint, full.fingerprint]
    assert pt.BUILD_STATS["extended"] == 2
    assert pt.extend_plan_table(final, cfg, add_buckets=QWEN_BUCKETS[:2],
                                cost=pc, backend="numpy") is final
    with pytest.raises(pt.PlanTableError):
        pt.extend_plan_table(base, cfg, add_buckets=[(2, 64)], backend="numpy")  # other cost


def _altered(table, field, index, value):
    arrays = {name: getattr(table, name).copy() for name in pt.PlanTable._PAYLOAD}
    arrays[field].reshape(-1)[index] = value
    return pt.PlanTable(table.header, **arrays)


def test_probe_passes_clean_and_sees_an_altered_cell():
    cfg, pc, qs = _qwen_grid()
    table = pt.build_plan_table(cfg, QWEN_BUCKETS[:4], qs, cost=pc, backend="torch")
    assert pt.probe_plan_table(table, cfg, k=8, cost=pc, backend="torch") == 8
    assert pt.probe_plan_table(table, cfg, k=None, cost=pc, backend="numpy") == table.feasible.size
    cell = int(np.flatnonzero(table.feasible.reshape(-1))[3])
    seg = int(table.seg_ptr[cell])
    for field, index, value in (
        ("cycle_energy", seg, np.nextafter(table.cycle_energy[seg], np.inf)),
        ("e_total", cell, np.nextafter(table.e_total.reshape(-1)[cell], 0)),
        ("seg_end", seg, table.seg_end[seg] + 1),
        ("feasible", cell, False),
    ):
        with pytest.raises(pt.StaleTableError):
            pt.probe_plan_table(_altered(table, field, index, value), cfg, k=None,
                                cost=pc, backend="torch")
    with pytest.raises(pt.StaleTableError):  # another cost model: fingerprint
        pt.probe_plan_table(table, cfg, k=2, backend="torch")
    with pytest.raises(pt.PlanTableError):
        pt.probe_plan_table(table, cfg, k=0, cost=pc, backend="torch")


def test_fingerprint_cache_short_circuits_the_build(tmp_path):
    cfg, pc, qs = _qwen_grid()
    a = pt.build_plan_table(cfg, QWEN_BUCKETS[:4], qs, cost=pc, backend="torch",
                            cache_dir=str(tmp_path))
    b = pt.build_plan_table(cfg, QWEN_BUCKETS[3::-1], qs[::-1], cost=pc, backend="torch",
                            cache_dir=str(tmp_path))
    assert pt.BUILD_STATS == {"built": 1, "cache_hits": 1, "extended": 0}
    assert a.content_digest() == b.content_digest()
    assert len(list(tmp_path.glob("plan_*.npz"))) == 1


def test_version_lookup_and_builder_errors(tmp_path):
    cfg, pc, qs = _qwen_grid()
    table = pt.build_plan_table(cfg, QWEN_BUCKETS[:4], qs, cost=pc, backend="torch")
    stale = pt.PlanTable({**table.header, "version": 1},
                         **{n: getattr(table, n) for n in pt.PlanTable._PAYLOAD})
    path = stale.save(str(tmp_path / "v1.npz"))
    with pytest.raises(pt.StaleTableError):
        pt.PlanTable.load(path)
    with pytest.raises(ref_pt.StaleTableError):
        ref_pt.PlanTable.load(path)
    with pytest.raises(pt.UnknownBucketError):
        table.lookup(4, 128)
    with pytest.raises(Infeasible):
        table.lookup(1, 128, energy_budget=min(q for q in qs if q) * 0.5)
    assert table.lookup(1, 100).seq_bucket == 128
    assert table.lookup(1, 128, None).q_max is None
    for bad in (dict(shape_buckets=[]), dict(shape_buckets=[(1, 128), (1, 128)]),
                dict(q_values=[]), dict(q_values=[1.0, 1.0])):
        kw = dict(shape_buckets=[(1, 128)], q_values=qs) | bad
        with pytest.raises(pt.PlanTableError):
            pt.build_plan_table(cfg, kw["shape_buckets"], kw["q_values"], cost=pc,
                                backend="torch")
    with pytest.raises(SpecError, match="item 9"):
        pt.build_plan_table(cfg, [(1, 128)], qs, cost=pc, sharding=object())


def test_lookup_span_when_traced():
    cfg, pc, qs = _qwen_grid()
    table = pt.build_plan_table(cfg, QWEN_BUCKETS[:2], qs, cost=pc, backend="numpy")
    TRACER.configure(enabled=True)
    table.lookup(1, 128)
    assert [e["name"] for e in TRACER.events()] == ["plan_table.lookup"]
