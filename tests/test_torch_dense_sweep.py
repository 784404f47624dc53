"""The port's dense export and dense sweep engine against the reference.

* ``TaskGraph.to_arrays``, ``dense_export_nbytes``, ``stack_graph_arrays``
  and ``stack_csr_arrays`` give ``repro.core.graph``'s arrays, dtype for
  dtype (that module is jax-free, so numpy meets numpy).
* The ``scan-cpu`` backend (the dense sweep, the same code the ``scan``
  backend runs on the card) is bitwise equal to the numpy oracles — tables,
  E_total, bounds, Q_min, exact-K partitions, Infeasible, the empty graph —
  on the random and dyadic-tie families and on the smoke configs, and a
  padded batch equals its per-graph solves.
* Wider readers (more than eight reads in one task) take the masked
  reduction, held to ``repro``'s own bound for that path (1e-6 relative,
  ``tests/test_partition_jax.py``) on the reduced head count.
* ``auto`` routes a dense export to ``scan``, a CSR export and a TaskGraph
  to ``cuda``; ``scan`` raises without a card.
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
from repro.core import graph as ref_graph
from repro.core import q_min as ref_q_min
from repro.core import whole_app_partition as ref_whole_app
from repro.core.apps import headcount as ref_hc
from repro.core.partition import Infeasible as RefInfeasible

from repro_torch import api
from repro_torch.core import graph as pgraph
from repro_torch.core import partition_torch as pt
from repro_torch.core.apps import headcount as hc
from repro_torch.core.engine import (
    OBJECTIVES,
    Engine,
    ScanCpuBackend,
    TorchBackend,
    register_backend,
    resolve_auto_backend,
)
from repro_torch.core.graph import GraphBuilder

REF = load_ref_oracle()
SCAN = "scan-cpu"
# repro's bound for the scan engine's masked-reduction path
# (tests/test_partition_jax.py); the reduced head count below reads
# 1.6e-14 here (THERMAL reduced 16: 345 tasks, 339 reads in its sort task).
WIDE_REL = 1e-6


def _family(kind, seed):
    rng = random.Random(7000 + 131 * seed)
    if kind == "random":
        g = random_task_graph(rng, max_tasks=14)
        cm = random_cost_model(rng)
        qs = random_q_grid(rng, ref_q_min(g, cm), ref_whole_app(g, cm).max_burst)
    else:
        g = adversarial_tie_graph(rng)
        cm = tie_cost_model(rng)
        qs = tie_q_grid(rng, ref_q_min(g, cm), ref_whole_app(g, cm).max_burst)
    return g, cm, list(qs)


def _assert_export(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "n_tasks" and not isinstance(b, np.ndarray):
            assert a == b
            continue
        assert a.dtype == b.dtype, f.name
        assert np.array_equal(a, b), f.name


# -- the dense export ---------------------------------------------------------


@pytest.mark.parametrize("pad", [None, (20, 9, 4)])
@pytest.mark.parametrize("seed", range(4))
def test_to_arrays_equals_the_reference(seed, pad):
    g, cm, _ = _family("random", seed)
    pg, _ = port_of(g, cm)
    kw = {} if pad is None else dict(zip(("n_pad", "r_pad", "w_pad"), pad))
    _assert_export(pg.to_arrays(**kw), g.to_arrays(**kw))
    if pad is None:
        assert pg.to_arrays() is pg.to_arrays()   # cached


def test_to_arrays_of_the_reduced_head_count_and_its_size():
    g = hc.build_graph(hc.THERMAL.reduced(64))
    want = ref_hc.build_graph(ref_hc.THERMAL.reduced(64)).to_arrays()
    got = g.to_arrays()
    _assert_export(got, want)
    nbytes = sum(getattr(got, f.name).nbytes for f in dataclasses.fields(got)
                 if f.name != "n_tasks")
    assert pgraph.dense_export_nbytes(got.n_pad, got.r_pad, got.w_pad) == nbytes


@pytest.mark.parametrize("n,r,w", [(0, 0, 0), (36, 1, 1), (345, 339, 1), (5458, 5452, 1)])
def test_dense_export_nbytes_equals_the_reference(n, r, w):
    assert pgraph.dense_export_nbytes(n, r, w) == ref_graph.dense_export_nbytes(n, r, w)


def test_stacked_exports_equal_the_reference():
    graphs = [_family(k, s)[:2] for k, s in (("random", 0), ("tie", 1), ("random", 2))]
    ports = [port_of(g, cm)[0] for g, cm in graphs]
    _assert_export(pgraph.stack_graph_arrays([p.to_arrays() for p in ports]),
                   ref_graph.stack_graph_arrays([g.to_arrays() for g, _ in graphs]))
    _assert_export(pgraph.stack_csr_arrays([p.to_csr_arrays() for p in ports]),
                   ref_graph.stack_csr_arrays([g.to_csr_arrays() for g, _ in graphs]))
    with pytest.raises(ValueError):
        pgraph.stack_graph_arrays([])
    with pytest.raises(ValueError):
        ports[0].to_arrays().padded(1, 1, 1)


# -- the dense sweep, bitwise ---------------------------------------------------


def _check_all_modes(g, cm, qs):
    """scan-cpu against the numpy oracles: sum tables against the CSR
    oracle's, Q_min, and exact-K partitions (or Infeasible) in both
    combines."""
    pg, pc = port_of(g, cm)
    ga = pg.to_arrays()
    sol = api.solve(graph=ga, cost=pc, q_grid=tuple(qs), backend=SCAN)
    mns, bests = REF.sweep_columns_ref(g.to_csr_arrays(), cm, qs)
    sw = sol.sweep
    assert np.array_equal(sw.dp[:, 1:].T, mns)
    assert np.array_equal(sw.parent[:, 1:].T, bests)
    assert np.array_equal(sw.e_total, mns[g.n_tasks - 1])
    ref_parts = ref_solve(RefSpec(graph=g, cost=cm, q_grid=tuple(qs),
                                  backend="numpy")).partitions()
    parts = api.solve(graph=pg, cost=pc, q_grid=tuple(qs), backend=SCAN).partitions()
    for got, want in zip(parts, ref_parts):
        assert (got is None) == (want is None)
        if want is not None:
            assert got.bounds == want.bounds
            assert [b.total for b in got.bursts] == [b.total for b in want.bursts]
            assert got.e_total == want.e_total
    assert api.solve(graph=ga, cost=pc, objective="minimax",
                     backend=SCAN).q_min() == ref_q_min(g, cm)
    finite = [q for q in qs if q is not None]
    for q in (None, max(finite) if finite else None):
        for k in sorted({1, max(1, g.n_tasks // 2), g.n_tasks}):
            for kobj in ("sum", "max"):
                spec = dict(cost=cm, objective="exact_k", n_bursts=k, q_max=q,
                            k_objective=kobj)
                try:
                    want = ref_solve(RefSpec(graph=g, backend="numpy", **spec)).partition()
                except RefInfeasible:
                    want = None
                pspec = dict(spec, cost=pc)
                if want is None:
                    with pytest.raises(api.Infeasible):
                        api.solve(graph=pg, backend=SCAN, **pspec).partition()
                    continue
                got = api.solve(graph=pg, backend=SCAN, **pspec).partition()
                assert got.bounds == want.bounds
                assert [b.total for b in got.bursts] == [b.total for b in want.bursts]
                assert got.e_total == want.e_total


@pytest.mark.parametrize("seed", range(12))
def test_random_graphs_bitwise(seed):
    _check_all_modes(*_family("random", seed))


@pytest.mark.parametrize("seed", range(8))
def test_adversarial_tie_graphs_bitwise(seed):
    _check_all_modes(*_family("tie", seed))


def test_infeasible_q_and_the_empty_graph():
    g, cm, qs = _family("random", 5)
    pg, pc = port_of(g, cm)
    below = 0.5 * ref_q_min(g, cm)
    sw = api.solve(graph=pg, cost=pc, q_grid=(below, None), backend=SCAN).sweep
    assert not sw.feasible[0] and sw.e_total[0] == np.inf and sw.bounds(0) is None
    with pytest.raises(api.Infeasible):
        api.solve(graph=pg, cost=pc, q_max=below, backend=SCAN).partition()
    empty = GraphBuilder().build()
    for backend in (SCAN, "numpy"):
        s = api.solve(graph=empty, cost=pc, q_grid=(1.0, None), backend=backend).sweep
        assert s.n_tasks == 0 and list(s.e_total) == [0.0, 0.0] and s.bounds(0) == []
    assert pt.q_min_dense(empty, pc, device="cpu") == 0.0
    assert pt.exact_k_partition_dense(empty, pc, 1, device="cpu").bounds == []
    batch = api.solve(graphs=(empty, pg), cost=pc, q_grid=tuple(qs), backend=SCAN)
    assert batch.sweeps[0].n_tasks == 0
    assert np.array_equal(batch.sweeps[1].dp, api.solve(graph=pg, cost=pc, q_grid=tuple(qs),
                                                        backend="numpy").sweep.dp)


@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-1.3b"])
@pytest.mark.parametrize("kind", ["time", "memory"])
def test_smoke_configs_bitwise(arch, kind):
    shapes = ((2, 16), (4, 32))
    base = dict(config=arch, smoke=True, shapes=shapes, kind=kind)
    mm = api.solve(objective="minimax", backend="numpy", **base)
    assert api.solve(objective="minimax", backend=SCAN, **base).q_mins == mm.q_mins
    qs = (max(mm.q_mins), 1.5 * max(mm.q_mins), None)
    got = api.solve(q_grid=qs, backend=SCAN, **base)
    want = api.solve(q_grid=qs, backend="numpy", **base)
    for a, b in zip(got.sweeps, want.sweeps):
        for f in ("dp", "parent", "e_total", "feasible", "starts"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for gi, g in enumerate(got.graphs):
        k = len(want.sweeps[gi].bounds(1))
        spec = dict(graph=g, cost=got.cost, objective="exact_k", n_bursts=k, q_max=qs[1])
        p_scan = api.solve(backend=SCAN, **spec).partition()
        p_np = api.solve(backend="numpy", **spec).partition()
        assert p_scan.bounds == p_np.bounds and p_scan.e_total == p_np.e_total


def test_a_batch_equals_its_per_graph_solves():
    fams = [_family("random", s) for s in range(6)] + [_family("tie", s) for s in range(3)]
    cm = fams[0][1]
    ports = [port_of(g, cm)[0] for g, _, _ in fams]
    qs = tuple(fams[0][2])
    assert len({p.n_tasks for p in ports}) > 1
    assert len({p.to_arrays().r_pad for p in ports}) > 1
    pc = port_of(fams[0][0], cm)[1]
    batch = pt.sweep_dense(ports, pc, qs, device="cpu")
    for p, b in zip(ports, batch):
        one = pt.sweep_dense([p], pc, qs, device="cpu")[0]
        for f in ("dp", "parent", "e_total", "feasible", "starts"):
            assert np.array_equal(getattr(b, f), getattr(one, f)), f


def test_wide_readers_within_the_stated_bound():
    g = hc.build_graph(hc.THERMAL.reduced(16))
    cm = hc.paper_cost_model()
    assert max(len(t.reads) for t in g.tasks) > pt._UNROLL_MAX
    e_app = g.total_task_cost()
    qs = (None, 0.3 * e_app, 0.6 * e_app, 1.1 * e_app)
    got = api.solve(graph=g, cost=cm, q_grid=qs, backend=SCAN).sweep
    want = api.solve(graph=g, cost=cm, q_grid=qs, backend="torch").sweep
    fin = np.isfinite(want.dp)
    assert np.array_equal(np.isfinite(got.dp), fin)
    rel = np.abs(got.dp[fin] - want.dp[fin]) / np.maximum(np.abs(want.dp[fin]), 1e-300)
    assert rel.max() <= WIDE_REL
    assert [got.bounds(i) for i in range(len(qs))] == [want.bounds(i) for i in range(len(qs))]
    assert (api.solve(graph=g, cost=cm, objective="minimax", backend=SCAN).q_min()
            == api.solve(graph=g, cost=cm, objective="minimax", backend="torch").q_min())


# -- routing ------------------------------------------------------------------


def test_auto_routes_by_layout():
    g, cm, _ = _family("random", 1)
    pg, pc = port_of(g, cm)
    thermal = hc.build_graph(hc.THERMAL)
    assert pgraph.dense_export_nbytes(5458, 5452, 1) > 10 ** 9     # about 1.07 GB
    assert resolve_auto_backend(pg.to_arrays()) == "scan"
    assert resolve_auto_backend(pg.to_csr_arrays()) == "cuda"
    for graph in (pg, thermal):             # a TaskGraph of any size: the kernel
        for objective in OBJECTIVES:
            assert resolve_auto_backend(graph, objective) == "cuda"
    label, per = Engine().resolve_backend(
        api.PartitionSpec(graphs=(pg.to_arrays(), pg.to_csr_arrays(), pg), cost=pc),
        (pg.to_arrays(), pg.to_csr_arrays(), pg))
    assert (label, per) == ("cuda+scan", ["scan", "cuda", "cuda"])
    with pytest.raises(api.ExportMismatch):
        resolve_auto_backend(object())
    only_csr = {}
    register_backend("c", objectives=OBJECTIVES, supports_csr=True, supports_dense=False,
                     registry=only_csr)(TorchBackend)
    with pytest.raises(api.ExportMismatch):
        resolve_auto_backend(pg.to_arrays(), registry=only_csr)
    for backend, export in (("cuda", pg.to_arrays()), ("torch", pg.to_arrays()),
                            ("numpy", pg.to_arrays()), (SCAN, pg.to_csr_arrays()),
                            ("scan", pg.to_csr_arrays())):
        with pytest.raises(api.ExportMismatch):
            api.solve(graph=export, cost=pc, backend=backend)
    with pytest.raises(api.ExportMismatch):
        api.solve(graph=pg.to_arrays(), cost=pc, objective="exact_k", n_bursts=1,
                  backend=SCAN)


def test_a_mixed_batch_is_solved_group_by_group():
    g, cm, qs = _family("tie", 2)
    h, _, _ = _family("random", 3)
    (pg, pc), (ph, _) = port_of(g, cm), port_of(h, cm)
    reg = {}
    register_backend("c", objectives=OBJECTIVES, supports_csr=True, supports_dense=False,
                     registry=reg)(TorchBackend)
    register_backend("d", objectives=OBJECTIVES, supports_dense=True, registry=reg)(
        ScanCpuBackend)
    graphs = (pg.to_arrays(), ph.to_csr_arrays(), ph.to_arrays())
    sol = Engine(reg).solve(api.PartitionSpec(graphs=graphs, cost=pc, q_grid=tuple(qs)))
    assert sol.backend == "c+d"
    for got, src in zip(sol.sweeps, (pg, ph, ph)):
        want = api.solve(graph=src, cost=pc, q_grid=tuple(qs), backend="numpy").sweep
        assert np.array_equal(got.dp, want.dp) and np.array_equal(got.parent, want.parent)
    mins = Engine(reg).solve(api.PartitionSpec(graphs=graphs, cost=pc, objective="minimax"))
    assert mins.q_mins == (ref_q_min(g, cm), ref_q_min(h, cm), ref_q_min(h, cm))


def test_scan_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    g, cm, qs = _family("random", 4)
    pg, pc = port_of(g, cm)
    for spec in (dict(graph=pg, backend="scan"), dict(graph=pg.to_arrays()),
                 dict(graph=pg.to_arrays(), objective="minimax")):
        with pytest.raises(RuntimeError, match="cuda"):
            api.solve(cost=pc, **spec)
    with pytest.raises(RuntimeError, match="cuda"):
        pt.sweep_dense([pg], pc, qs)   # the default device is "cuda"
