"""The port's swarm placement against the reference's numpy pieces.

``repro``'s ``lax.scan`` grid solver cannot run here (``enable_x64`` is gone
from jax 0.9.0), so the referee is ``repro.core.placement``'s numpy oracle,
its exhaustive enumeration and its ``PlacementTable``:

* **the six DP arrays** — the port's ``solve_placement_numpy`` and its torch
  grid solver on the CPU (``scan-cpu``) equal ``repro``'s
  ``solve_placement_numpy`` bitwise in ``inner_S``, ``inner_A``,
  ``outer_dp``, ``outer_parent``, ``e_total`` and ``k_used`` (dtypes
  included), on both registered configs (smoke and full-width lowerings),
  tie-heavy dyadic random specs, the ns_mini fixture, and heterogeneous and
  memory-bound specs;
* **small graphs** — the port's ``exhaustive_placement`` equals
  ``repro``'s and the DP's winner;
* **plans** — spans, bursts, hops and ledgers equal ``repro``'s and
  conserve;
* **tables** — ``PlacementTable`` JSON byte-equal to ``repro``'s under the
  reference's scalars, with the same tamper and version errors;
* **spec validation and dispatch** — the façade's rejections match
  ``repro``'s, and ``auto`` resolves a placement spec to ``scan``.
"""

import dataclasses
import json
import math
import random

import numpy as np
import pytest
import torch

from helpers_random import (
    adversarial_tie_graph,
    random_cost_model,
    random_task_graph,
    tie_cost_model,
)
from helpers_torch import port_cost, port_of, port_placement_spec

import repro.api as ref_api
from repro.configs import resolve_config as ref_get_config
from repro.core import placement as RP
from repro.core.layer_profile import default_cost_model as ref_default_cost
from repro.core.layer_profile import lower_config as ref_lower
from repro.data.ns_optimizer import load_ns_model as ref_load_ns

import repro_torch.api as api
from repro_torch.core import placement as P
from repro_torch.core.placement_torch import solve_placement_torch
from repro_torch.obs.ledger import LedgerImbalance
from repro_torch.obs.metrics import reset_all

ARRAYS = ("inner_S", "inner_A", "outer_dp", "outer_parent", "e_total", "k_used")
NS_MINI = "tests/fixtures/ns_mini"


@pytest.fixture(autouse=True)
def _clean_counters():
    yield
    reset_all()


def assert_same_arrays(got, want):
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f"{f} differs"


def both_ways(ref_g, ref_cm, ref_spec):
    """(repro's numpy sweep, the port's numpy sweep, the port's scan-cpu
    sweep) of the same problem."""
    g, cm = port_of(ref_g, ref_cm)
    spec = port_placement_spec(ref_spec)
    want = RP.solve_placement_numpy(ref_g, ref_cm, ref_spec)
    return (want, P.solve_placement_numpy(g, cm, spec),
            solve_placement_torch(g, cm, spec, device="cpu"))


def grid_spec(graph, cm, *, nodes=3, scales=(1.0, 1.5, 2.0), memory_share=1.0,
              links=(900.0, 1800.0, 3300.0), q_scales=(0.8, 1.25),
              memory_scales=(1.0, 0.5)):
    """A reference spec in the swarm CLI's shape: each node's budget Q_min ×
    1.25 and its NVM a share of the whole graph's span footprint."""
    from repro.core.partition import q_min

    foot = RP.placement_inputs(graph, cm, RP.PlacementSpec(
        nodes=1, link=RP.LinkModel(900.0))).mem[1, graph.n_tasks]
    q = q_min(graph, cm) * 1.25
    return RP.PlacementSpec(
        nodes=tuple(RP.NodeSpec(q_max=q, memory_bytes=memory_share * foot,
                                compute_scale=scales[k % len(scales)], name=f"node{k}")
                    for k in range(nodes)),
        links=tuple(RP.LinkModel(bandwidth_mbps=b) for b in links),
        q_scales=q_scales, memory_scales=memory_scales)


def random_spec(rng, max_nodes=3):
    """A small random reference PlacementSpec mixing every swept axis."""
    nodes = tuple(
        RP.NodeSpec(q_max=rng.choice([None, rng.uniform(0.5, 6.0)]),
                    memory_bytes=rng.choice([None, rng.uniform(50, 4000)]),
                    compute_scale=rng.choice([1.0, 1.0, 0.5, 2.0]))
        for _ in range(rng.randint(1, max_nodes)))
    links = tuple(
        RP.LinkModel(bandwidth_mbps=rng.choice([900.0, 2000.0, 3300.0]),
                     energy_per_byte=rng.choice([None, 0.0, 1e-3]),
                     init_energy=rng.choice([0.0, 0.1]),
                     rx_fraction=rng.choice([1.0, 0.5]))
        for _ in range(rng.randint(1, 2)))
    return RP.PlacementSpec(nodes=nodes, links=links,
                            q_scales=rng.choice([(1.0,), (0.75, 1.5)]),
                            memory_scales=rng.choice([(1.0,), (0.5, 2.0)]))


# ---------------------------------------------------------------------------
# The six DP arrays
# ---------------------------------------------------------------------------

CONFIG_CASES = [(arch, smoke, bucket)
                for arch in ("qwen3-4b", "xlstm-1.3b")
                for smoke, bucket in ((True, (2, 16)), (False, (1, 128)))]


@pytest.mark.parametrize("arch,smoke,bucket", CONFIG_CASES,
                         ids=[f"{a}-{'smoke' if s else 'full'}" for a, s, _ in CONFIG_CASES])
@pytest.mark.parametrize("kind", ["time", "memory"])
def test_arrays_equal_reference_on_configs(arch, smoke, bucket, kind):
    ref_g = ref_lower(ref_get_config(arch, smoke=smoke), batch=bucket[0], seq=bucket[1],
                      kind=kind)
    ref_cm = ref_default_cost(kind)
    want, got_np, got_t = both_ways(ref_g, ref_cm, grid_spec(ref_g, ref_cm))
    assert_same_arrays(got_np, want)
    assert_same_arrays(got_t, want)
    assert got_t.backend == "scan-cpu" and got_np.backend == "numpy"
    # the memory axis's 0.5 refuses cells, and some plan spans several nodes
    feasible = np.isfinite(want.e_total)
    assert 0 < feasible.sum() < feasible.size


@pytest.mark.parametrize("seed", range(6))
def test_arrays_equal_reference_on_tie_heavy_specs(seed):
    rng = random.Random(1000 + seed)
    ref_g = adversarial_tie_graph(rng, max_tasks=14)
    ref_cm = tie_cost_model(rng)
    spec = random_spec(rng)
    want, got_np, got_t = both_ways(ref_g, ref_cm, spec)
    assert_same_arrays(got_np, want)
    assert_same_arrays(got_t, want)


@pytest.mark.parametrize("seed", range(6))
def test_arrays_equal_reference_on_random_specs(seed):
    rng = random.Random(2000 + seed)
    ref_g = random_task_graph(rng, max_tasks=12)
    ref_cm = random_cost_model(rng)
    want, got_np, got_t = both_ways(ref_g, ref_cm, random_spec(rng))
    assert_same_arrays(got_np, want)
    assert_same_arrays(got_t, want)


def test_arrays_equal_reference_on_ns_mini():
    model = ref_load_ns(f"{NS_MINI}/prof.csv", f"{NS_MINI}/dep.csv")
    ref_cm = ref_default_cost("time")
    spec = grid_spec(model.graph, ref_cm, links=tuple(range(900, 3400, 100)),
                     q_scales=(0.8, 1.0, 1.25), memory_scales=(1.0, 0.5, 2.0))
    want, got_np, got_t = both_ways(model.graph, ref_cm, spec)
    assert_same_arrays(got_np, want)
    assert_same_arrays(got_t, want)
    assert want.e_total.shape == (25, 3, 3)


def test_arrays_equal_reference_on_heterogeneous_memory_bound_specs():
    """Per-node cost models, compute scales and memory caps that bind."""
    rng = random.Random(3)
    for _ in range(4):
        ref_g = random_task_graph(rng, max_tasks=10, min_tasks=4)
        slow = random_cost_model(rng)
        base = random_cost_model(rng)
        foot = RP.placement_inputs(ref_g, base, RP.PlacementSpec(
            nodes=1, link=RP.LinkModel(900.0))).mem[1, ref_g.n_tasks]
        nodes = (RP.NodeSpec(q_max=None, memory_bytes=0.5 * foot),
                 RP.NodeSpec(q_max=rng.uniform(2, 12), memory_bytes=0.6 * foot, cost=slow,
                             compute_scale=1.5),
                 RP.NodeSpec(memory_bytes=0.7 * foot, cost=slow, compute_scale=0.5))
        spec = RP.PlacementSpec(nodes=nodes,
                                links=(RP.LinkModel(900.0, init_energy=0.05, rx_fraction=0.5),
                                       RP.LinkModel(3000.0, energy_per_byte=1e-4)),
                                q_scales=(0.5, 1.0, 2.0), memory_scales=(0.75, 1.0, 1.5))
        want, got_np, got_t = both_ways(ref_g, base, spec)
        assert_same_arrays(got_np, want)
        assert_same_arrays(got_t, want)


def test_inputs_equal_reference():
    rng = random.Random(11)
    for _ in range(8):
        ref_g = random_task_graph(rng, max_tasks=8)
        ref_cm = random_cost_model(rng)
        ref_spec = random_spec(rng)
        g, cm = port_of(ref_g, ref_cm)
        want = RP.placement_inputs(ref_g, ref_cm, ref_spec)
        got = P.placement_inputs(g, cm, port_placement_spec(ref_spec))
        for f in ("energy", "q_thresh", "mem", "mem_thresh", "live_bytes", "live_c0w",
                  "hop_tx", "hop_rx", "hop_total", "hop_latency"):
            assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f


# ---------------------------------------------------------------------------
# Small graphs, plans, ledgers
# ---------------------------------------------------------------------------


def test_exhaustive_equals_reference_and_the_dp():
    rng = random.Random(5)
    checked = 0
    for _ in range(12):
        ref_g = (adversarial_tie_graph(rng, max_tasks=7, min_tasks=2) if rng.random() < 0.5
                 else random_task_graph(rng, max_tasks=7))
        ref_cm = tie_cost_model(rng)
        ref_spec = random_spec(rng)
        g, cm = port_of(ref_g, ref_cm)
        spec = port_placement_spec(ref_spec)
        inp, ref_inp = P.placement_inputs(g, cm, spec), RP.placement_inputs(ref_g, ref_cm,
                                                                            ref_spec)
        sweep = solve_placement_torch(g, cm, spec, inputs=inp, device="cpu")
        L, M, Z = spec.grid_shape
        for li in range(L):
            for m in range(M):
                for z in range(Z):
                    got = P.exhaustive_placement(inp, li, m, z)
                    assert got == RP.exhaustive_placement(ref_inp, li, m, z)
                    if got is None:
                        assert not sweep.feasible(li, m, z)
                        continue
                    plan = sweep.plan(li, m, z)
                    assert (plan.e_total, plan.spans, plan.node_bursts) == got
                    checked += 1
    assert checked > 15


def test_plans_and_ledgers_equal_reference_and_conserve():
    ref_g = ref_lower(ref_get_config("qwen3-4b", smoke=False), batch=1, seq=128, kind="time")
    ref_cm = ref_default_cost("time")
    # homogeneous nodes: at memory ×0.5 the chain splits across nodes
    want, _, got = both_ways(ref_g, ref_cm, grid_spec(ref_g, ref_cm, scales=(1.0,)))
    ref_plans, plans = want.plans(), got.plans()
    assert [p is None for p in plans] == [p is None for p in ref_plans]
    multi = 0
    for p, r in zip(plans, ref_plans):
        if p is None:
            continue
        for f in ("spans", "node_bursts", "node_energy", "node_memory_bytes",
                  "hop_boundaries", "hop_bytes", "hop_tx", "hop_rx", "hop_latency_s",
                  "e_total", "q_scale", "memory_scale"):
            assert getattr(p, f) == getattr(r, f), f
        assert p.summary() == r.summary()
        assert [led.to_rows() for led in p.ledgers()] == [led.to_rows() for led in r.ledgers()]
        p.validate()
        p.check_conservation()
        multi += p.n_nodes_used > 1
    assert multi > 0


def test_imbalanced_plan_is_caught_and_infeasible_cell_raises():
    ref_g = ref_lower(ref_get_config("xlstm-1.3b", smoke=True), batch=2, seq=16, kind="time")
    ref_cm = ref_default_cost("time")
    _, _, sweep = both_ways(ref_g, ref_cm, grid_spec(ref_g, ref_cm))
    li, m, z = map(int, np.argwhere(np.isfinite(sweep.e_total))[0])
    plan = sweep.plan(li, m, z)
    bad = dataclasses.replace(plan, e_total=plan.e_total * 1.5)
    with pytest.raises(LedgerImbalance):
        bad.check_conservation()
    li, m, z = map(int, np.argwhere(~np.isfinite(sweep.e_total))[0])
    with pytest.raises(P.PlacementError, match="infeasible"):
        sweep.plan(li, m, z)


# ---------------------------------------------------------------------------
# Placement tables
# ---------------------------------------------------------------------------


def test_table_json_byte_equal_reference(tmp_path):
    model = ref_load_ns(f"{NS_MINI}/prof.csv", f"{NS_MINI}/dep.csv")
    ref_cm = ref_default_cost("time")
    spec = grid_spec(model.graph, ref_cm, q_scales=(0.8, 1.0, 1.25),
                     memory_scales=(1.0, 0.5, 2.0))
    want, got_np, got_t = both_ways(model.graph, ref_cm, spec)
    meta = {"tool": "test", "node_q": 0.5}
    ref_path, np_path = tmp_path / "ref.json", tmp_path / "port.json"
    RP.PlacementTable(want, meta=meta).to_json(str(ref_path))
    P.PlacementTable(got_np, meta=meta).to_json(str(np_path))
    assert np_path.read_bytes() == ref_path.read_bytes()
    scan = P.PlacementTable(got_t, meta=meta)
    assert scan.fingerprint() == RP.PlacementTable(want, meta=meta).fingerprint()
    # round trip, and the reference reads the port's file
    back = P.PlacementTable.from_json(str(np_path))
    assert back.fingerprint() == scan.fingerprint()
    assert np.array_equal(back.e_total, want.e_total)
    assert RP.PlacementTable.from_json(str(np_path)).fingerprint() == back.fingerprint()
    assert back.cell(0, 0, 0) == RP.PlacementTable.from_json(str(ref_path)).cell(0, 0, 0)
    assert back.summary() == RP.PlacementTable.from_json(str(ref_path)).summary()


def test_table_tamper_and_version_errors(tmp_path):
    ref_g = ref_lower(ref_get_config("qwen3-4b", smoke=True), batch=2, seq=16, kind="time")
    ref_cm = ref_default_cost("time")
    _, got, _ = both_ways(ref_g, ref_cm, grid_spec(ref_g, ref_cm))
    payload = P.PlacementTable(got).to_payload()
    for mutate, match in ((lambda p: p["e_total"][0][0].__setitem__(0, 123.0), "fingerprint"),
                          (lambda p: p.__setitem__("version", 99), "version"),
                          (lambda p: p.pop("version"), "no version")):
        bad = json.loads(json.dumps(payload))
        mutate(bad)
        with pytest.raises(P.PlacementError, match=match):
            P.PlacementTable.from_payload(bad)
        with pytest.raises(RP.PlacementError, match=match):
            RP.PlacementTable.from_payload(bad)
    with pytest.raises(P.PlacementError):
        P.PlacementTable()


# ---------------------------------------------------------------------------
# Validation and dispatch
# ---------------------------------------------------------------------------


def _raises(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - the class is what is compared
        return type(exc).__name__
    return None


MODEL_CASES = [
    ("link", dict(bandwidth_mbps=0.0)), ("link", dict(bandwidth_mbps=math.inf)),
    ("link", dict(bandwidth_mbps=math.nan)), ("link", dict(bandwidth_mbps=9e2, rx_fraction=-1)),
    ("link", dict(bandwidth_mbps=9e2, energy_per_byte=math.inf)),
    ("node", dict(q_max=0.0)), ("node", dict(memory_bytes=-1.0)),
    ("node", dict(compute_scale=0.0)), ("node", dict(compute_scale=math.nan)),
    ("node", dict(cost="not-a-model")),
    ("spec", dict(nodes=0)), ("spec", dict(nodes=())), ("spec", dict(nodes=("x",))),
    ("spec", dict(nodes=2, link=None)), ("spec", dict(nodes=2, links=())),
    ("spec", dict(nodes=2, q_scales=())), ("spec", dict(nodes=2, memory_scales=(0.0,))),
    ("spec", dict(nodes=2, q_scales=(math.inf,))),
]


@pytest.mark.parametrize("what,kw", MODEL_CASES)
def test_model_validation_matches_reference(what, kw):
    def make(mod):
        if what == "link":
            return mod.LinkModel(**kw)
        if what == "node":
            return mod.NodeSpec(**kw)
        kw2 = dict(kw)
        kw2.setdefault("link", mod.LinkModel(900.0))
        return mod.PlacementSpec(**kw2)

    assert _raises(lambda: make(P)) == _raises(lambda: make(RP)) == "PlacementError"


def test_models_match_reference():
    for kw in (dict(bandwidth_mbps=1000.0), dict(bandwidth_mbps=900.0, energy_per_byte=2e-9),
               dict(bandwidth_mbps=900.0, rx_fraction=0.5, init_energy=0.3, init_s=1e-3)):
        a, b = P.LinkModel(**kw), RP.LinkModel(**kw)
        assert (a.name, a.per_byte, a.tx_energy(100, 0.5), a.hop_energy(64), a.latency_s(999)) \
            == (b.name, b.per_byte, b.tx_energy(100, 0.5), b.hop_energy(64), b.latency_s(999))
    spec = P.PlacementSpec(nodes=2, links=(P.LinkModel(900.0), P.LinkModel(1800.0)),
                           q_scales=(0.5, 1.0, 2.0))
    assert spec.grid_shape == (2, 1, 3) and spec.link is None and spec.n_nodes == 2


def _spec_cases():
    g = random_task_graph(random.Random(4), max_tasks=5, min_tasks=3)
    cm = random_cost_model(random.Random(4))
    pl = RP.PlacementSpec(nodes=2, link=RP.LinkModel(900.0))
    return g, cm, pl


SPEC_CASES = [
    ("placement_not_a_spec", lambda m, g, cm, pl: m.PartitionSpec(graph=g, cost=cm,
                                                                   placement="nope")),
    ("placement_minimax", lambda m, g, cm, pl: m.PartitionSpec(
        graph=g, cost=cm, placement=pl, objective="minimax")),
    ("placement_exact_k", lambda m, g, cm, pl: m.PartitionSpec(
        graph=g, cost=cm, placement=pl, objective="exact_k", n_bursts=1)),
    ("placement_q_max", lambda m, g, cm, pl: m.PartitionSpec(graph=g, cost=cm, placement=pl,
                                                             q_max=1.0)),
    ("placement_q_grid", lambda m, g, cm, pl: m.PartitionSpec(graph=g, cost=cm, placement=pl,
                                                              q_grid=(1.0, None))),
    ("placement_sharded", lambda m, g, cm, pl: m.PartitionSpec(
        graph=g, cost=cm, placement=pl, sharding=m.QGridSharding(2))),
    ("sharding_minimax", lambda m, g, cm, pl: m.PartitionSpec(
        graph=g, cost=cm, objective="minimax", sharding=m.QGridSharding(2))),
    ("sharding_exact_k", lambda m, g, cm, pl: m.PartitionSpec(
        graph=g, cost=cm, objective="exact_k", n_bursts=1, sharding=m.QGridSharding(2))),
    ("sharding_not_a_sharding", lambda m, g, cm, pl: m.PartitionSpec(graph=g, cost=cm,
                                                                     sharding=2)),
    ("zero_shards", lambda m, g, cm, pl: m.QGridSharding(0)),
    ("placement_on_csr", lambda m, g, cm, pl: m.Engine().solve(m.PartitionSpec(
        graph=g.to_csr_arrays(), cost=cm, placement=pl))),
    ("placement_on_dense", lambda m, g, cm, pl: m.Engine().solve(m.PartitionSpec(
        graph=g.to_arrays(), cost=cm, placement=pl))),
    ("placement_on_a_kernel_backend", lambda m, g, cm, pl: m.Engine().solve(m.PartitionSpec(
        graph=g, cost=cm, placement=pl, backend="cuda" if m is api else "pallas"))),
    ("sharding_on_numpy", lambda m, g, cm, pl: m.Engine().solve(m.PartitionSpec(
        graph=g, cost=cm, q_grid=(1.0, None), sharding=m.QGridSharding(2),
        backend="numpy"))),
]


@pytest.mark.parametrize("case", SPEC_CASES, ids=[c[0] for c in SPEC_CASES])
def test_spec_rejections_match_reference(case):
    _, fn = case
    g, cm, pl = _spec_cases()
    pg, pc = port_of(g, cm)
    ppl = port_placement_spec(pl)
    want = _raises(lambda: fn(ref_api, g, cm, pl))
    assert want in ("SpecError", "ExportMismatch")
    assert _raises(lambda: fn(api, pg, pc, ppl)) == want


def test_auto_resolves_placement_to_scan_and_solves_on_the_named_backends():
    g, cm, pl = _spec_cases()
    pg, pc = port_of(g, cm)
    spec = api.PartitionSpec(graph=pg, cost=pc, placement=port_placement_spec(pl))
    assert api.default_engine().resolve_backend(spec, [pg]) == ("scan", ["scan"])
    assert api.backend_info("scan").supports_placement
    assert not api.backend_info("cuda").supports_placement
    assert {n for n in api.backend_names() if api.backend_info(n).supports_sharding} \
        == {"cuda", "torch", "scan", "scan-cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            api.solve(spec)
    got = {}
    for backend in ("numpy", "scan-cpu"):
        sol = api.solve(dataclasses.replace(spec, backend=backend))
        assert sol.backend == backend
        got[backend] = sol.placement_sweep()
        assert sol.placement_plan().e_total == float(got[backend].e_total[0, 0, 0])
        with pytest.raises(api.EngineError):
            sol.sweep
    assert_same_arrays(got["scan-cpu"], got["numpy"])
    assert P.PLACEMENT_COUNT["numpy"] == 1 and P.PLACEMENT_COUNT["scan-cpu"] == 1
    with pytest.raises(api.EngineError, match="placement sweeps"):
        api.solve(graph=pg, cost=pc, backend="torch").placement_sweep()


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    g, cm, pl = _spec_cases()
    pg, pc = port_of(g, cm)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_placement_torch(pg, pc, port_placement_spec(pl))
    assert port_cost(cm).name == cm.name
