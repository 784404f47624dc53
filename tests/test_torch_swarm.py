"""The port's swarm CLI end to end on the CPU, against ``repro``'s.

``python -m repro_torch.launch.swarm --device cpu`` runs the whole CLI on
the host: the NS Optimizer fixture and the zoo configs, the bandwidth
report, the conservation gate and its exit codes (0 feasible, 1 a plan
that does not conserve, 2 nothing feasible at the base scales),
``--table-out``, ``--ledger-out``, ``--trace-out`` (one track per node) and
``--metrics-out``. ``repro``'s CLI avoids its ``enable_x64`` break only
with ``--node-q`` given and ``--backend numpy``; there both write the same
table bytes and the same report, with the port's analytical cost model set
to the reference's.
"""

import json
import re

import pytest
import torch

from helpers_torch import port_cost

from repro.core import cost as ref_cost
from repro.core import layer_profile as ref_lp
from repro.launch import swarm as ref_swarm

from repro_torch.core import layer_profile as lp
from repro_torch.core import placement as P
from repro_torch.launch import swarm
from repro_torch.obs.ledger import LedgerImbalance
from repro_torch.obs.metrics import reset_all
from repro_torch.obs.trace import PID_SWARM, TRACER, node_tid

NS = ["--prof", "tests/fixtures/ns_mini/prof.csv", "--dep", "tests/fixtures/ns_mini/dep.csv"]
GRID = ["--nodes", "3", "--bandwidths", "900,1800,3300", "--q-scales", "0.8,1,1.25",
        "--memory-scales", "1,0.5", "--compute-scales", "1,1.5,2"]
MODES = {"ns_mini": NS + ["--node-memory", "1654000"],
         "qwen3-4b-smoke": ["--arch", "qwen3-4b", "--buckets", "2x16"],
         "xlstm-1.3b-full": ["--arch", "xlstm-1.3b", "--full", "--buckets", "1x128"]}


@pytest.fixture(autouse=True)
def _reference_cost_model(monkeypatch):
    """The port's analytical model and peak set to the reference's, so both
    CLIs price the same graphs alike; counters and tracer cleared after."""
    monkeypatch.setattr(lp, "PEAK_FLOPS", ref_cost.PEAK_FLOPS)
    monkeypatch.setattr(lp, "analytical_cost_model",
                        lambda kind: port_cost(ref_lp.analytical_cost_model(kind)))
    yield
    reset_all()
    TRACER.reset()
    TRACER.disable()


def node_q_of(mode):
    """Q_min × 1.25, the CLI's default budget, from the reference's numpy DP."""
    from repro.core.partition import q_min

    import argparse

    ns = argparse.Namespace(prof=None, dep=None, arch=None, buckets="2x16", full=False,
                            kind=None)
    argv = iter(MODES[mode])
    for flag in argv:
        key = flag.lstrip("-").replace("-", "_")
        setattr(ns, key, True if key == "full" else next(argv))
    g, cm, _ = ref_swarm.load_graph(ns)
    return q_min(g, cm) * 1.25


def report(text):
    """The CLI's report without the solve's wall time and backend."""
    return [re.sub(r"on backend \S+ in [0-9.]+s", "", ln) for ln in text.splitlines()
            if "wrote" not in ln]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tables_and_report_equal_reference(mode, tmp_path, capsys):
    q = repr(node_q_of(mode))
    argv = MODES[mode] + GRID + ["--node-q", q, "--backend", "numpy"]
    ref_path, np_path, cpu_path = (str(tmp_path / f"{k}.json") for k in ("ref", "np", "cpu"))
    assert ref_swarm.main(argv + ["--table-out", ref_path]) == 0
    want = capsys.readouterr().out
    assert swarm.main(argv + ["--device", "cpu", "--table-out", np_path]) == 0
    got = capsys.readouterr().out
    assert report(got) == report(want)
    assert open(np_path, "rb").read() == open(ref_path, "rb").read()
    # the torch grid solver on the CPU: the same solved content
    argv_cpu = [a for a in argv if a not in ("--backend", "numpy")]
    assert swarm.main(argv_cpu + ["--device", "cpu", "--table-out", cpu_path]) == 0
    out = capsys.readouterr().out
    assert "on backend scan-cpu" in out and "conserve node-by-node" in out
    cpu, ref = P.PlacementTable.from_json(cpu_path), P.PlacementTable.from_json(ref_path)
    assert cpu.fingerprint() == ref.fingerprint()
    assert cpu.meta["backend"] == "scan-cpu"


def test_default_budget_ledger_trace_and_metrics(tmp_path, capsys):
    paths = {k: str(tmp_path / f"{k}.json") for k in ("table", "ledger", "trace", "metrics")}
    rc = swarm.main(MODES["qwen3-4b-smoke"] + GRID + [
        "--device", "cpu", "--table-out", paths["table"], "--ledger-out", paths["ledger"],
        "--trace-out", paths["trace"], "--metrics-out", paths["metrics"]])
    assert rc == 0
    out = capsys.readouterr().out
    table = P.PlacementTable.from_json(paths["table"])
    # the default budget is Q_min × 1.25 on the sweep's plain version
    assert table.meta["node_q"] == pytest.approx(node_q_of("qwen3-4b-smoke"), rel=0, abs=0)
    assert table.meta["backend"] == "scan-cpu" and table.grid_shape == (3, 2, 3)
    led = json.load(open(paths["ledger"]))
    assert led["tool"] == "swarm" and led["entries"]
    events = json.load(open(paths["trace"]))["traceEvents"]
    best_nodes = led["nodes"]
    threads = {ev["args"]["name"] for ev in events
               if ev.get("ph") == "M" and ev.get("pid") == PID_SWARM
               and ev.get("name") == "thread_name"}
    assert threads == {f"node{k}" for k in range(best_nodes)}
    spans = [ev for ev in events if ev.get("ph") == "X" and ev["name"].startswith("span<")]
    assert [ev["tid"] for ev in spans] == [node_tid(k) for k in range(best_nodes)]
    assert any(ev["name"] == "swarm.solve" for ev in events)
    metrics = json.load(open(paths["metrics"]))
    assert "placement_solves" in json.dumps(metrics)
    assert f"wrote metrics snapshot to {paths['metrics']}" in out


def test_gate_exit_codes_match_reference(monkeypatch, capsys):
    tiny = MODES["ns_mini"] + GRID + ["--node-q", "1e-9", "--backend", "numpy"]
    assert ref_swarm.main(tiny) == 2
    assert swarm.main(tiny + ["--device", "cpu"]) == 2
    assert "no feasible placement anywhere" in capsys.readouterr().err

    def imbalance(self):
        raise LedgerImbalance("forced")

    monkeypatch.setattr(P.PlacementPlan, "check_conservation", imbalance)
    assert swarm.main(MODES["ns_mini"] + GRID + ["--device", "cpu"]) == 1
    assert "CONSERVATION FAILURE: forced" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], NS[:2], NS + ["--arch", "qwen3-4b"],
                                  MODES["ns_mini"] + ["--compute-scales", "1,2"]],
                         ids=["no_mode", "prof_without_dep", "two_modes", "scales_per_node"])
def test_usage_errors_match_reference(argv):
    with pytest.raises(SystemExit) as want:
        ref_swarm.main(argv + ["--node-q", "1.0"])
    with pytest.raises(SystemExit) as got:
        swarm.main(argv + ["--node-q", "1.0", "--device", "cpu"])
    assert str(got.value.code) == str(want.value.code)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        swarm.main(MODES["ns_mini"])  # --device cuda is the default
    with pytest.raises(RuntimeError, match="cuda"):
        swarm.main(MODES["ns_mini"] + ["--node-q", "1.0"])
