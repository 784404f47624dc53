"""The port's façade (``repro_torch.api``) and layer profile against the reference.

* On the random and dyadic-tie families of ``test_torch_partition_sweep.py``,
  the port's ``numpy`` and ``torch`` backends give ``repro``'s
  ``solve(backend="numpy")`` bit for bit in all three objectives (bounds,
  every burst's pricing, E_total, Q_min, infeasibility), and their sweep
  tables equal the reference's CSR oracle.
* Every typed error, a NaN Q, the fields the port does not implement, and
  ``auto`` without a card.
* ``profile_model`` / ``lower_config`` of the ten registered architectures,
  smoke and full width, equal the reference's, with the port's ``PEAK_FLOPS`` set to
  the reference's for the comparison only; no port default is a TPU figure.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from helpers_random import (
    adversarial_tie_graph,
    random_cost_model,
    random_q_grid,
    random_task_graph,
    tie_cost_model,
    tie_q_grid,
)
from helpers_torch import load_ref_oracle, port_of
from repro.api import PartitionSpec as RefSpec
from repro.api import solve as ref_solve
from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.configs import get_config as ref_get_config
from repro.core import cost as ref_cost
from repro.core import layer_profile as ref_lp
from repro.core import q_min as ref_q_min
from repro.core import whole_app_partition as ref_whole_app
from repro.core.partition import Infeasible as RefInfeasible
from repro.core.partition import dijkstra_partition as ref_dijkstra

from repro_torch import api
from repro_torch.configs import SMOKE_CONFIGS, get_config
from repro_torch.core import cost
from repro_torch.core import layer_profile as lp
from repro_torch.core.engine import Engine, register_backend
from repro_torch.core.partition import Infeasible, dijkstra_partition
from repro_torch.obs.trace import TRACER

REF = load_ref_oracle()
BACKENDS = ("numpy", "torch")


def _family(kind, seed):
    rng = random.Random(4000 + 97 * seed)
    if kind == "random":
        g = random_task_graph(rng, max_tasks=14)
        cm = random_cost_model(rng)
        qs = random_q_grid(rng, ref_q_min(g, cm), ref_whole_app(g, cm).max_burst)
    else:
        g = adversarial_tie_graph(rng)
        cm = tie_cost_model(rng)
        qs = tie_q_grid(rng, ref_q_min(g, cm), ref_whole_app(g, cm).max_burst)
    return g, cm, list(qs), rng


def assert_same_partition(got, want):
    assert got.bounds == want.bounds
    assert [b.total for b in got.bursts] == [b.total for b in want.bursts]
    assert [(b.loads, b.stores) for b in got.bursts] == [(b.loads, b.stores) for b in want.bursts]
    assert got.e_total == want.e_total
    assert got.q_max == want.q_max


CASES = [("random", s) for s in range(10)] + [("tie", s) for s in range(6)]


@pytest.mark.parametrize("kind,seed", CASES)
def test_three_objectives_bitwise_against_reference(kind, seed):
    g, cm, qs, rng = _family(kind, seed)
    pg, pc = port_of(g, cm)
    want = ref_solve(RefSpec(graph=g, cost=cm, q_grid=tuple(qs), backend="numpy")).partitions()
    mns, _ = REF.sweep_columns_ref(g.to_csr_arrays(), cm, qs)
    ref_qmin = ref_solve(RefSpec(graph=g, cost=cm, objective="minimax",
                                 backend="numpy")).q_min()
    ks = sorted({1, max(1, g.n_tasks // 2), g.n_tasks})
    finite = [q for q in qs if q is not None]
    q_k = rng.choice(finite) if finite else None
    for backend in BACKENDS:
        sol = api.solve(api.PartitionSpec(graph=pg, cost=pc, q_grid=tuple(qs),
                                          backend=backend))
        assert sol.backend == backend
        assert np.array_equal(sol.sweep.e_total, mns[g.n_tasks - 1])
        for got, ref in zip(sol.partitions(), want):
            assert (got is None) == (ref is None)
            if ref is not None:
                assert_same_partition(got, ref)
        assert api.solve(graph=pg, cost=pc, objective="minimax",
                         backend=backend).q_min() == ref_qmin
        for k in ks:
            for kobj in ("sum", "max"):
                spec = dict(objective="exact_k", n_bursts=k, k_objective=kobj, q_max=q_k)
                try:
                    ref = ref_solve(RefSpec(graph=g, cost=cm, backend="numpy", **spec)).partition()
                except RefInfeasible:
                    with pytest.raises(Infeasible):
                        api.solve(graph=pg, cost=pc, backend=backend, **spec).partition()
                    continue
                got = api.solve(graph=pg, cost=pc, backend=backend, **spec).partition()
                assert_same_partition(got, ref)


def test_single_q_batch_and_csr_inputs():
    g, cm, qs, _ = _family("random", 11)
    g2, _, _, _ = _family("random", 12)
    (pg, pc), (pg2, _) = port_of(g, cm), port_of(g2, cm)
    q = [x for x in qs if x is not None][-1]
    one = api.solve(graph=pg, cost=pc, q_max=q, backend="torch")
    want = ref_solve(RefSpec(graph=g, cost=cm, q_max=q, backend="numpy")).partition()
    assert_same_partition(one.partition(), want)
    assert_same_partition(dijkstra_partition(pg, pc, q), ref_dijkstra(g, cm, q))
    batch = api.solve(graph=None, graphs=(pg, pg2), cost=pc, q_grid=(q, None), backend="numpy")
    assert batch.n_graphs == 2 and len(batch.sweeps) == 2
    with pytest.raises(api.EngineError):
        batch.sweep  # noqa: B018 - a batch has no single sweep
    csr = api.solve(graph=pg.to_csr_arrays(), cost=pc, q_grid=(q, None), backend="torch")
    assert np.array_equal(csr.e_total(), batch.e_total(0))
    with pytest.raises(api.EngineError):
        csr.partitions()  # pricing needs the TaskGraph
    unbounded = api.solve(graph=pg, cost=pc, backend="numpy")
    assert unbounded.q_values == (None,)
    with pytest.raises(api.EngineError):
        unbounded.q_min()


NAN = float("nan")


@pytest.mark.parametrize("spec,err", [
    (dict(), api.SpecError),                                   # no source
    (dict(graph="G", graphs=("G",)), api.SpecError),           # two sources
    (dict(graph=None, graphs=()), api.SpecError),              # empty batch
    (dict(q_grid=()), api.SpecError),
    (dict(q_grid=(1.0,), q_max=1.0), api.SpecError),
    (dict(q_grid=(1.0, NAN)), api.SpecError),                  # NaN in the grid
    (dict(q_max=NAN), api.SpecError),                          # NaN Q_max
    (dict(q_max=np.float64(NAN)), api.SpecError),
    (dict(objective="frobnicate"), api.SpecError),
    (dict(objective="minimax", q_max=1.0), api.SpecError),
    (dict(objective="exact_k"), api.SpecError),
    (dict(objective="exact_k", n_bursts=2, q_grid=(1.0,)), api.SpecError),
    (dict(n_bursts=2), api.SpecError),
    (dict(k_objective="mean"), api.SpecError),
    (dict(backend=3), api.SpecError),
    (dict(cost=object()), api.SpecError),                      # not a CostModel
    (dict(sharding=4), api.SpecError),                         # not a QGridSharding
    (dict(placement=object()), api.SpecError),                 # not a PlacementSpec
    (dict(confidence=1.5), api.SpecError),                     # outside (0, 1)
    (dict(interpret=True), api.SpecError),
    (dict(config="qwen3-4b", shapes=()), api.SpecError),
])
def test_spec_errors(spec, err):
    g, cm, _, _ = _family("random", 0)
    pg, pc = port_of(g, cm)
    base = dict(graph=pg, cost=pc)
    if "graph" in spec or "graphs" in spec or "config" in spec:
        base.pop("graph")
    base.update(spec)
    if not spec:
        base.pop("graph")
    with pytest.raises(err):
        api.PartitionSpec(**base)


def test_not_ported_fields_name_their_roadmap_item():
    """``interpret=`` (the Pallas kernel's mode) is still refused, naming why;
    ``sharding=`` and ``placement=`` are ported and reject a wrong type."""
    g, cm, _, _ = _family("random", 0)
    pg, pc = port_of(g, cm)
    with pytest.raises(api.SpecError, match="Pallas kernel's mode"):
        api.PartitionSpec(graph=pg, cost=pc, interpret=True)
    for field, cls in (("sharding", "QGridSharding"), ("placement", "PlacementSpec")):
        with pytest.raises(api.SpecError, match=f"{field}= must be a {cls}"):
            api.PartitionSpec(graph=pg, cost=pc, **{field: 1})


def test_dispatch_errors():
    g, cm, _, _ = _family("random", 1)
    pg, pc = port_of(g, cm)
    with pytest.raises(api.SpecError):
        api.solve(graph=pg, backend="numpy")                       # no cost
    with pytest.raises(api.SpecError):
        api.solve(graph=pg, cost=pc, backend="nope")               # unknown backend
    with pytest.raises(api.ExportMismatch):
        api.solve(graph=pg.to_csr_arrays(), cost=pc, backend="numpy")
    with pytest.raises(api.ExportMismatch):
        api.solve(graph=pg.to_csr_arrays(), cost=pc, objective="exact_k",
                  n_bursts=1, backend="torch")
    with pytest.raises(api.ExportMismatch):
        api.solve(graph=[1, 2], cost=pc, backend="torch")
    with pytest.raises(api.SpecError):
        api.solve(api.PartitionSpec(graph=pg, cost=pc), backend="numpy")
    with pytest.raises(api.SpecError):
        Engine().solve("not a spec")
    reg = {}

    @register_backend("sum_only", objectives=("sum",), registry=reg)
    class SumOnly:
        def solve(self, req):  # pragma: no cover - never reached
            raise AssertionError

    with pytest.raises(api.UnsupportedObjective):
        Engine(reg).solve(api.PartitionSpec(graph=pg, cost=pc, objective="minimax",
                                            backend="sum_only"))
    with pytest.raises(api.UnsupportedObjective):
        Engine({}).solve(api.PartitionSpec(graph=pg, cost=pc))
    with pytest.raises(api.SpecError):
        register_backend("bad", objectives=("frobnicate",), registry={})
    assert api.backend_names() == ["cuda", "numpy", "scan", "scan-cpu", "torch"]
    assert [api.backend_info(n).auto_eligible for n in api.backend_names()] == [
        True, False, True, False, False]


def test_auto_is_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    g, cm, _, _ = _family("random", 2)
    pg, pc = port_of(g, cm)
    for objective in ("sum", "minimax"):
        with pytest.raises(RuntimeError, match="cuda"):
            api.solve(graph=pg, cost=pc, objective=objective)


def test_engine_span_when_traced():
    g, cm, qs, _ = _family("random", 3)
    pg, pc = port_of(g, cm)
    TRACER.configure(enabled=True)
    try:
        api.solve(graph=pg, cost=pc, q_grid=tuple(qs), backend="torch")
    finally:
        events = TRACER.events()
        TRACER.reset()
    assert [(e["name"], e["args"]["backend"], e["args"]["q_points"]) for e in events] == [
        ("engine.solve", "torch", len(qs))]


@pytest.mark.parametrize("kind", ["time", "memory"])
def test_config_lowered_spec_defaults_to_the_h100_model(kind):
    sol = api.solve(config="qwen3-4b", smoke=True, shapes=((2, 16), (4, 32)),
                    kind=kind, objective="minimax", backend="numpy")
    assert sol.cost.name == {"time": "h100-host-offload", "memory": "hbm-bytes"}[kind]
    assert [g.n_tasks for g in sol.graphs] == [2, 2]
    assert len(sol.q_mins) == 2


# -- layer profile ----------------------------------------------------------------

SHAPES = [(1, 128), (4, 512), (8, 2048)]


ZOO = ("tinyllama-1.1b", "deepseek-coder-33b", "qwen1.5-0.5b", "granite-moe-1b-a400m",
       "phi3.5-moe-42b-a6.6b", "llama-3.2-vision-11b", "whisper-large-v3", "zamba2-7b")


def _configs():
    for arch in ("qwen3-4b", "xlstm-1.3b") + ZOO:
        yield arch, "full", get_config(arch), ref_get_config(arch)
        yield arch, "smoke", SMOKE_CONFIGS[arch], REF_SMOKE[arch]


@pytest.mark.parametrize("arch,size,cfg,ref_cfg", list(_configs()),
                         ids=[f"{a}-{s}" for a, s, _, _ in _configs()])
def test_profiles_and_lowered_graphs_match(arch, size, cfg, ref_cfg, monkeypatch):
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    monkeypatch.setattr(lp, "PEAK_FLOPS", ref_cost.PEAK_FLOPS)
    for b, s in SHAPES:
        profs, long_lived = lp.profile_model(cfg, b, s)
        ref_profs, ref_long = ref_lp.profile_model(ref_cfg, b, s)
        assert [dataclasses.asdict(p) for p in profs] == [dataclasses.asdict(p) for p in ref_profs]
        assert long_lived == ref_long
        for kind in ("time", "memory"):
            g = lp.lower_config(cfg, b, s, kind=kind)
            rg = ref_lp.lower_config(ref_cfg, b, s, kind=kind)
            assert [(t.name, t.reads, t.writes, t.cost) for t in g.tasks] == \
                [(t.name, t.reads, t.writes, t.cost) for t in rg.tasks]
            fields = ("name", "nbytes", "c0_weight", "keep", "external")
            assert [[getattr(p, f) for f in fields] for p in g.packets.values()] == \
                [[getattr(p, f) for f in fields] for p in rg.packets.values()]


def test_lower_zoo_and_no_tpu_defaults():
    """``lower_zoo`` lowers every registered architecture, the reference's
    ten, each to as many tasks as the reference lowers it to."""
    zoo = lp.lower_zoo(1, 128)
    assert sorted(zoo) == sorted(("qwen3-4b", "xlstm-1.3b") + ZOO)
    assert sorted(zoo) == sorted(ref_lp.lower_zoo(1, 128))
    assert zoo["qwen3-4b"].n_tasks == 36 and zoo["xlstm-1.3b"].n_tasks == 48
    assert zoo["zamba2-7b"].n_tasks == 81 + 13
    for arch in ZOO:
        assert zoo[arch].n_tasks == ref_lp.lower_config(ref_get_config(arch), 1, 128).n_tasks
    for name in ("PEAK_FLOPS", "HBM_BW", "PCIE_BW", "DMA_INIT_S", "LAUNCH_S"):
        assert getattr(cost, name) != getattr(ref_cost, name), name
    assert lp.PEAK_FLOPS == cost.PEAK_FLOPS == 989e12
    time_cm = lp.default_cost_model("time")
    assert time_cm == cost.h100_host_offload_model()
    assert (time_cm.e_startup, time_cm.read.c0, time_cm.read.c1) == (
        cost.LAUNCH_S, cost.DMA_INIT_S, 1.0 / cost.PCIE_BW)
    with pytest.raises(ValueError):
        lp.default_cost_model("energy")
