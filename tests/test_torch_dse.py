"""Q-grid sharding, sharded and extended plan tables, and the ``dse`` CLI.

``repro``'s sharded sweep lives in ``core/partition_jax.py``, which cannot
be imported here (``enable_x64`` is gone from jax 0.9.0), so:

* ``shard_q_grid`` is held to the documented cases of
  ``tests/test_dse_shard.py``;
* a sharded sweep (1-5 chunks, chunks of one Q point and of sizes that are
  no multiple of anything) is bitwise equal to the unsharded one on the
  ``torch`` (CSR) and ``scan-cpu`` (dense) backends, through the façade and
  directly, with the chunks on devices of their own or one after another;
* sharded builds and extensions have the ``content_digest`` of the
  unsharded build, at full width;
* ``python -m repro_torch.launch.dse --device cpu`` runs every mode; its
  ``--placement`` table is byte-equal to what ``repro``'s CLI writes with
  ``--backend numpy`` (the port's analytical model set to the reference's).
"""

import json
import random

import pytest
import torch

from helpers_random import random_cost_model, random_q_grid, random_task_graph
from helpers_torch import port_cost, port_of

from repro.core import cost as ref_cost
from repro.core import layer_profile as ref_lp
from repro.core.partition import q_min as ref_q_min
from repro.core.partition import whole_app_partition as ref_whole_app
from repro.launch import dse as ref_dse

import repro_torch.api as api
from repro_torch.configs import get_config
from repro_torch.core import layer_profile as lp
from repro_torch.core import partition_torch as pt
from repro_torch.core.plan_table import (BUILD_STATS, PlanTable, build_plan_table,
                                         extend_plan_table)
from repro_torch.launch import dse, mesh
from repro_torch.launch.planner import derive_q_grid, lower_buckets
from repro_torch.obs.ledger import EnergyLedger
from repro_torch.obs.metrics import reset_all
from repro_torch.obs.trace import TRACER

FIELDS = ("dp", "parent", "e_total", "feasible", "starts")
QWEN = [(1, 128), (1, 512), (4, 512), (8, 2048)]


@pytest.fixture(autouse=True)
def _clean():
    yield
    reset_all()
    TRACER.reset()
    TRACER.disable()


def same_sweeps(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.n_tasks == y.n_tasks and list(x.q_values) == list(y.q_values)
        for f in FIELDS:
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype and u.shape == v.shape and u.tobytes() == v.tobytes(), f


def test_shard_q_grid_documented_cases():
    assert pt.shard_q_grid(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert pt.shard_q_grid(3, 8) == [(0, 1), (1, 2), (2, 3)]  # clamped
    assert pt.shard_q_grid(5, 1) == [(0, 5)]
    for nq, ns in [(1, 1), (7, 3), (100, 8)]:
        chunks = pt.shard_q_grid(nq, ns)
        assert chunks[0][0] == 0 and chunks[-1][1] == nq
        assert all(lo < hi for lo, hi in chunks)
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert max(hi - lo for lo, hi in chunks) - min(hi - lo for lo, hi in chunks) <= 1
    with pytest.raises(ValueError, match="at least one Q point"):
        pt.shard_q_grid(0, 2)
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        pt.shard_q_grid(4, 0)


def _random_batch(seed):
    rng = random.Random(seed)
    ref_graphs = [random_task_graph(rng, max_tasks=14) for _ in range(3)]
    ref_cm = random_cost_model(rng)
    qs = random_q_grid(rng, ref_q_min(ref_graphs[0], ref_cm),
                       ref_whole_app(ref_graphs[0], ref_cm).e_total)
    graphs = [port_of(g, ref_cm)[0] for g in ref_graphs]
    return graphs, port_cost(ref_cm), qs


@pytest.mark.parametrize("backend", ["torch", "scan-cpu"])
@pytest.mark.parametrize("seed", range(3))
def test_sharded_sweep_equals_unsharded(backend, seed):
    graphs, cm, qs = _random_batch(seed)
    whole = api.solve(graphs=tuple(graphs), cost=cm, q_grid=tuple(qs), backend=backend).sweeps
    for n_shards in (1, 2, 3, len(qs), len(qs) + 3):  # one-point chunks, clamped
        sol = api.solve(graphs=tuple(graphs), cost=cm, q_grid=tuple(qs), backend=backend,
                        sharding=api.QGridSharding(n_shards))
        same_sweeps(sol.sweeps, whole)
    # chunks on devices of their own (CPU devices here), as many as chunks
    sol = api.solve(graphs=tuple(graphs), cost=cm, q_grid=tuple(qs), backend=backend,
                    sharding=api.QGridSharding(3, ["cpu"] * 3))
    same_sweeps(sol.sweeps, whole)


def test_sharded_sweep_directly_and_with_empty_graphs():
    graphs, cm, qs = _random_batch(7)
    from repro_torch.core.graph import GraphBuilder

    empty = GraphBuilder().build()
    batch = [graphs[0], empty, graphs[1]]
    for dense in (False, True):
        want = (pt.sweep_dense(batch, cm, qs, device="cpu") if dense
                else [pt.sweep(g, cm, qs, device="cpu") for g in batch])
        for n_shards in (2, 5):
            got = pt.sweep_sharded(batch, cm, qs, n_shards=n_shards, dense=dense, device="cpu")
            same_sweeps(got, want)
    assert pt.sweep_sharded([], cm, qs, n_shards=2, device="cpu") == []


def test_sharding_devices_and_backends():
    graphs, cm, qs = _random_batch(1)
    sh = api.QGridSharding(2, ["cpu", torch.device("cpu")])
    assert sh.devices == (torch.device("cpu"),) * 2
    with pytest.raises(api.SpecError, match="n_shards"):
        api.QGridSharding(0)
    with pytest.raises(api.SpecError, match="device type"):
        api.solve(graph=graphs[0], cost=cm, q_grid=tuple(qs), backend="torch",
                  sharding=api.QGridSharding(2, ["cuda:0", "cuda:1"]))
    with pytest.raises(api.SpecError, match="does not support Q-grid sharding"):
        api.solve(graph=graphs[0], cost=cm, q_grid=tuple(qs), backend="numpy",
                  sharding=api.QGridSharding(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            api.solve(graph=graphs[0], cost=cm, q_grid=tuple(qs),
                      sharding=api.QGridSharding(2))


def test_shard_devices():
    from repro_torch.launch.planner import shard_devices_for

    assert shard_devices_for("torch", 1) is None and shard_devices_for("scan-cpu", 1) is None
    assert shard_devices_for("cuda", 1) == mesh.shard_devices(1)
    with pytest.raises(ValueError):
        mesh.shard_devices(0)
    n = torch.cuda.device_count()
    assert mesh.shard_devices(n + 1) is None
    if n:
        assert mesh.shard_devices(n) == [torch.device("cuda", i) for i in range(n)]


# ---------------------------------------------------------------------------
# Plan tables at full width
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen_grid():
    cfg = get_config("qwen3-4b")
    cm = lp.default_cost_model("time")
    graphs = lower_buckets(cfg, QWEN, "time")
    return cfg, cm, graphs, derive_q_grid(graphs, cm, 8, backend="torch")


@pytest.mark.parametrize("backend", ["torch", "scan-cpu"])
def test_sharded_and_extended_tables_equal_the_unsharded_build(backend, qwen_grid):
    cfg, cm, graphs, qs = qwen_grid
    whole = build_plan_table(cfg, QWEN, qs, cost=cm, graphs=graphs, backend=backend)
    for n_shards in (1, 2, 3):
        sharded = build_plan_table(cfg, QWEN, qs, cost=cm, graphs=graphs, backend=backend,
                                   sharding=api.QGridSharding(n_shards))
        assert sharded.content_digest() == whole.content_digest()
        assert sharded.fingerprint == whole.fingerprint
        for name in PlanTable._PAYLOAD:
            assert getattr(sharded, name).tobytes() == getattr(whole, name).tobytes()
    base = build_plan_table(cfg, QWEN[:2], qs[:5] + [None], cost=cm, backend=backend)
    solved = BUILD_STATS["extended"]
    TRACER.configure(enabled=True)
    grown = extend_plan_table(base, cfg, add_buckets=QWEN[2:], add_q_values=qs[5:-1],
                              cost=cm, backend=backend, n_shards=2)
    blocks = [(e["args"]["graphs"], e["args"]["q_points"]) for e in TRACER.events()
              if e.get("name") == "plan_table.extend"]
    assert blocks == [(2, len(qs)), (2, len(qs) - 6)]  # only the new cells
    assert BUILD_STATS["extended"] == solved + 1
    assert grown.content_digest() == whole.content_digest()
    assert grown.lineage == [base.fingerprint, whole.fingerprint]


# ---------------------------------------------------------------------------
# The dse CLI on the CPU
# ---------------------------------------------------------------------------


def test_dse_cli_modes(tmp_path, capsys):
    arch = ["--arch", "qwen3-4b", "--full", "--device", "cpu"]
    every = ",".join(f"{b}x{s}" for b, s in QWEN)
    digests = set()
    for k in (1, 2, 3):
        out = str(tmp_path / f"s{k}.npz")
        assert dse.main(arch + ["--buckets", every, "--q-points", "6", "--shards", str(k),
                                "--out", out, "--probe", "3"]) == 0
        digests.add(PlanTable.load(out).content_digest())
        assert f"({k} shards, 1 cpu devices)" in capsys.readouterr().out
    assert len(digests) == 1
    s1 = PlanTable.load(str(tmp_path / "s1.npz"))

    ext = str(tmp_path / "ext.npz")
    assert dse.main(arch + ["--buckets", ",".join(f"{b}x{s}" for b, s in QWEN[:2]),
                            "--q-points", "6", "--out", ext]) == 0
    add = [3e-4, 7e-4]
    trace = str(tmp_path / "trace.json")
    assert dse.main(arch + ["--buckets", every, "--extend", "--add-q",
                            ",".join(map(repr, add)), "--shards", "2", "--out", ext,
                            "--trace-out", trace]) == 0
    grown = PlanTable.load(ext)
    fresh = build_plan_table(get_config("qwen3-4b"), QWEN, grown.q_values(), backend="torch")
    assert grown.content_digest() == fresh.content_digest()
    assert len(grown.lineage) == 2 and grown.n_buckets == 4
    events = json.load(open(trace))["traceEvents"]
    assert [(e["args"]["graphs"], e["args"]["q_points"]) for e in events
            if e.get("name") == "plan_table.extend"] == [(2, grown.n_q), (2, 2)]
    assert "extended" in capsys.readouterr().out

    assert dse.main(arch + ["--probe-only", "--probe", "5", "--out", str(tmp_path / "s2.npz")]) == 0
    assert "5 cells" in capsys.readouterr().out

    cm = lp.default_cost_model("time")
    led = EnergyLedger()
    for c in range(3):
        led.charge(c, 0, restore=float(cm.e_startup), compute=1e-4)
    clean, drifted = str(tmp_path / "clean.json"), str(tmp_path / "drift.json")
    led.dump_json(clean, kind="time")
    payload = json.load(open(clean))
    for e in payload["entries"]:
        e["energy"] *= 1.8
    json.dump(payload, open(drifted, "w"))
    assert dse.main(arch[:3] + ["--calibrate", clean, "--out", str(tmp_path / "s1.npz"),
                                "--device", "cpu"]) == 0
    assert "accepted" in capsys.readouterr().out
    assert dse.main(arch + ["--calibrate", drifted, "--out", str(tmp_path / "s1.npz")]) == 1
    assert "STALE" in capsys.readouterr().err
    assert s1.n_q == 7


@pytest.mark.parametrize("argv", [["--extend", "--kind", "time"], ["--probe-only", "--q-points", "4"],
                                  ["--calibrate", "x.json", "--extend"],
                                  ["--placement", "--probe-only"], ["--add-q", "1e-3"]],
                         ids=["extend_kind", "probe_q_points", "calibrate_extend",
                              "placement_probe", "add_q_without_extend"])
def test_dse_usage_errors_match_reference(argv, tmp_path):
    out = ["--out", str(tmp_path / "t.npz")]
    with pytest.raises(SystemExit) as want:
        ref_dse.main(argv + out)
    with pytest.raises(SystemExit) as got:
        dse.main(argv + out + ["--device", "cpu"])
    assert got.value.code == want.value.code == 2


def test_dse_placement_table_equals_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(lp, "PEAK_FLOPS", ref_cost.PEAK_FLOPS)
    monkeypatch.setattr(lp, "analytical_cost_model",
                        lambda kind: port_cost(ref_lp.analytical_cost_model(kind)))
    ref_g = ref_lp.lower_config(__import__("repro.configs", fromlist=["x"]).resolve_config(
        "qwen3-4b", smoke=True), batch=2, seq=16, kind="time")
    q = ref_q_min(ref_g, ref_lp.analytical_cost_model("time")) * 1.25
    argv = ["--arch", "qwen3-4b", "--placement", "--buckets", "2x16", "--nodes", "3",
            "--bandwidths", "900:1500:200", "--node-q", repr(q), "--q-scales", "0.8,1.25",
            "--memory-scales", "1,0.5", "--node-memory", "4000", "--backend", "numpy"]
    ref_path, port_path = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    assert ref_dse.main(argv + ["--out", ref_path]) == 0
    assert dse.main(argv + ["--out", port_path, "--device", "cpu"]) == 0
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    # the default budget: Q_min × 1.25 on the sweep's plain version, and the
    # torch grid solver on the CPU — the same solved content
    auto = str(tmp_path / "auto.json")
    assert dse.main([a for a in argv if a not in ("--node-q", repr(q), "--backend", "numpy")]
                    + ["--out", auto, "--device", "cpu"]) == 0
    got = json.load(open(auto))
    assert got["meta"]["node_q"] == q and got["backend"] == "scan-cpu"
    assert got["fingerprint"] == json.load(open(ref_path))["fingerprint"]
    assert "grid: 3 links × 2 memory × 2 Q" in capsys.readouterr().out


def test_dse_and_planner_parse_and_refuse_cuda_without_a_card(tmp_path):
    assert dse.parse_bandwidths("900:3400:100") == ref_dse.parse_bandwidths("900:3400:100")
    assert len(dse.parse_bandwidths("900:3400:100")) == 25
    assert dse.parse_bandwidths("900,1800") == [900.0, 1800.0]
    for bad in ("900:800", "1:2:3:4", ",", "900:1000:0"):
        with pytest.raises(ValueError):
            dse.parse_bandwidths(bad)
        with pytest.raises(ValueError):
            ref_dse.parse_bandwidths(bad)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    for argv in (["--shards", "2"], ["--placement"], ["--placement", "--node-q", "1.0"]):
        with pytest.raises(RuntimeError, match="cuda"):
            dse.main(argv + ["--out", str(tmp_path / "t.npz")])
