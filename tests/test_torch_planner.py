"""The port's planner (``repro_torch.launch.planner``) against the reference's.

* ``request_cycles`` gives ``repro``'s cycles on random inputs, and
  ``_parse_buckets`` the same buckets and errors;
* ``ServePlanner`` counts hits and misses, and its offload, remat and
  pipeline plans priced from a memory table equal ``repro``'s pricing of the
  same bounds (with the reference's constants patched in for the comparison
  only);
* ``build_table_for_arch`` on the plain version equals the numpy build, and
  the CLI builds, probes and saves a full-width table with ``--device cpu``,
  refuses ``--shards`` / ``--extend`` naming ROADMAP item 9, and without a
  card does not drop to the CPU.
"""

import random

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import cost as ref_cost
from repro.core import layer_profile as ref_lp
from repro.core.offload import price_offload_bounds as ref_price_offload
from repro.core.remat_policy import remat_from_bounds as ref_remat
from repro.launch import planner as ref_planner

from repro_torch.configs import get_config
from repro_torch.core import offload, remat_policy
from repro_torch.core.cost import cost_from_scalars
from repro_torch.core.partition import Infeasible
from repro_torch.core.plan_table import PlanTable, PlanTableError, UnknownBucketError
from repro_torch.launch import planner

BUCKETS = [(1, 128), (4, 512), (8, 2048)]


@pytest.mark.parametrize("seed", range(6))
def test_request_cycles_match_reference(seed):
    rng = random.Random(500 + seed)
    for _ in range(40):
        n = rng.randint(0, 30)
        step = rng.choice([rng.uniform(0.01, 2.0), 0.1, 0.25])
        budget = rng.choice([None, rng.uniform(0.0, 5.0), 3 * step + 0.01])
        e_s = rng.choice([0.0, rng.uniform(0.0, 0.5)])
        assert planner.request_cycles(n, step, budget, e_s) == \
            ref_planner.request_cycles(n, step, budget, e_s)


@pytest.mark.parametrize("text", ["2x24,4x48", " 2X24 ", "2x24,48", "2x", "x24",
                                  "2x24x3", "0x24", "2xfoo", ""])
def test_parse_buckets_matches_reference(text):
    try:
        want = ref_planner._parse_buckets(text)
    except ValueError as e:
        with pytest.raises(ValueError, match="BATCHxSEQ") as got:
            planner._parse_buckets(text)
        assert str(got.value) == str(e)
        return
    assert planner._parse_buckets(text) == want


@pytest.fixture(scope="module")
def memory_table():
    return planner.build_table_for_arch("qwen3-4b", BUCKETS, 16, smoke=False,
                                        kind="memory", backend="torch")


def test_planner_counts_and_pipeline_cuts(memory_table, tmp_path):
    p = planner.ServePlanner(memory_table)
    budget = sorted(q for q in memory_table.q_values() if q is not None)[-3]
    plan = p.plan_for(4, 300, budget)
    assert (plan.batch, plan.seq_bucket) == (4, 512)
    assert p.pipeline_cuts(4, 300, budget) == plan.cut_points
    with pytest.raises(UnknownBucketError):
        p.plan_for(2, 128)
    with pytest.raises(Infeasible):
        p.plan_for(1, 128, memory_table.q_grid.min() * 0.5)
    assert (p.stats["lookups"], p.stats["hits"], p.stats["misses"]) == (4, 2, 2)
    assert p.stats["by_bucket"] == {"4x512": 2}
    assert p.hit_rate == 0.5
    p.record_admission("admitted")
    with pytest.raises(ValueError):
        p.record_admission("lost")
    p.reset_stats()
    assert p.stats["lookups"] == 0
    path = memory_table.save(str(tmp_path / "t.npz"))
    assert planner.as_planner(path).table.content_digest() == memory_table.content_digest()
    assert planner.as_planner(p) is p
    with pytest.raises(TypeError):
        planner.as_planner(3)
    probed = planner.ServePlanner.from_file(path, probe=get_config("qwen3-4b"),
                                            probe_k=3, probe_backend="torch")
    assert probed.table.fingerprint == memory_table.fingerprint


def test_offload_and_remat_pricing_match_reference(memory_table, monkeypatch):
    cfg, ref_cfg = get_config("qwen3-4b"), ref_get_config("qwen3-4b")
    tpu = ref_cost.tpu_host_offload_model()
    monkeypatch.setattr(offload, "PEAK_FLOPS", ref_cost.PEAK_FLOPS)
    monkeypatch.setattr(remat_policy, "PEAK_FLOPS", ref_cost.PEAK_FLOPS)
    monkeypatch.setattr(offload, "h100_host_offload_model",
                        lambda: cost_from_scalars(ref_cost.cost_scalars(tpu), tpu.name))
    p = planner.ServePlanner(memory_table)
    budget = sorted(q for q in memory_table.q_values() if q is not None)[-1]
    for b, s in BUCKETS:
        plan = p.plan_for(b, s, budget)
        profiles, long_lived = ref_lp.profile_model(ref_cfg, b, s)
        mem_graph = ref_lp.build_activation_graph(profiles, long_lived, kind="memory")
        got, want = p.offload_plan(cfg, b, s, budget), ref_price_offload(
            ref_cfg.name, profiles, mem_graph, list(plan.bounds), budget)
        assert (got.bounds, got.offload_bytes, got.segment_peak_bytes, got.pcie_seconds,
                got.compute_seconds) == (want.bounds, want.offload_bytes,
                                         want.segment_peak_bytes, want.pcie_seconds,
                                         want.compute_seconds)
        got, want = p.remat_plan(cfg, b, s, budget), ref_remat(
            ref_cfg.name, profiles, mem_graph, list(plan.bounds), budget)
        assert (got.bounds, got.saved_bytes, got.recompute_seconds, got.compute_seconds) == \
            (want.bounds, want.saved_bytes, want.recompute_seconds, want.compute_seconds)
    with pytest.raises(Infeasible):
        remat_policy.remat_from_bounds(cfg.name, *_mem(cfg, 8, 2048),
                                       [(1, cfg.n_layers)], 1.0)
    assert offload.min_activation_budget(cfg, 1, 128) > 0


def _mem(cfg, b, s):
    from repro_torch.core.layer_profile import build_activation_graph, profile_model

    profiles, long_lived = profile_model(cfg, b, s)
    return profiles, build_activation_graph(profiles, long_lived, kind="memory")


def test_time_table_refuses_memory_pricing():
    table = planner.build_table_for_arch("qwen3-4b", BUCKETS[:1], 4, smoke=False,
                                         backend="numpy")
    with pytest.raises(PlanTableError):
        planner.ServePlanner(table).offload_plan(get_config("qwen3-4b"), 1, 128, 1.0)
    with pytest.raises(PlanTableError):
        planner.ServePlanner(table).remat_plan(get_config("xlstm-1.3b"), 1, 128, 1.0)


@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-1.3b"])
def test_build_for_arch_plain_equals_numpy(arch):
    a = planner.build_table_for_arch(arch, BUCKETS, 16, smoke=False, backend="torch")
    b = planner.build_table_for_arch(arch, BUCKETS, 16, smoke=False, backend="numpy")
    assert a.content_digest() == b.content_digest()
    assert a.header["cost_name"] == "h100-host-offload"
    assert a.n_q == 17 and np.isinf(a.q_grid[-1])


def test_cli_builds_probes_and_saves_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "plan.npz")
    assert planner.main(["--arch", "xlstm-1.3b", "--full", "--buckets", "1x128,4x512",
                         "--device", "cpu", "--probe", "4", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "probe: 4 cells re-validated" in text and "on cpu" in text
    table = PlanTable.load(out)
    assert table.arch == "xlstm-1.3b" and table.buckets() == [(1, 128), (4, 512)]


@pytest.mark.parametrize("flag", [["--shards", "2"], ["--extend"]])
def test_cli_refuses_sharded_dse(flag, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        planner.main(["--out", str(tmp_path / "t.npz"), "--device", "cpu", *flag])
    assert e.value.code == 2
    assert "ROADMAP item 9" in capsys.readouterr().err


def test_cli_without_a_card_does_not_drop_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        planner.main(["--out", str(tmp_path / "t.npz")])
    with pytest.raises(RuntimeError, match="cuda"):
        planner.build_table_for_arch("qwen3-4b", BUCKETS[:1])
