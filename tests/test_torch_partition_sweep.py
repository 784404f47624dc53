"""The port's plain sweep and partitioner are bitwise equal to the numpy oracles.

The reference's CSR oracle ``repro/kernels/partition_sweep/ref.py`` is
loaded by file path (``helpers_torch.load_ref_oracle``). The port runs on
``device="cpu"``, where the sweep wrapper takes the plain PyTorch version;
the CUDA kernel is held against that same plain version on the card by
``chip_smoke.py``.
"""

import random

import numpy as np
import pytest

from helpers_random import (
    adversarial_tie_graph,
    random_cost_model,
    random_q_grid,
    random_task_graph,
    tie_cost_model,
    tie_q_grid,
)
from helpers_torch import load_ref_oracle, port_of
from repro.api import PartitionSpec, solve
from repro.core import q_min as ref_q_min
from repro.core import whole_app_partition as ref_whole_app
from repro.core.apps import headcount as ref_hc
from repro.core.partition import Infeasible as RefInfeasible

from repro_torch.core import partition_torch as pt
from repro_torch.core.apps import headcount as hc
from repro_torch.core.partition import Infeasible
from repro_torch.kernels.partition_sweep import ops

CPU = "cpu"
REF = load_ref_oracle()


def assert_tables(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.array_equal(a, b), (a, b)


def check_all_modes(g, cm, qs):
    """Plain torch sweep vs the numpy CSR oracles in every kernel mode."""
    pg, pc = port_of(g, cm)
    csr, pcsr = g.to_csr_arrays(), pg.to_csr_arrays()
    assert_tables(ops.sweep_columns(pcsr, pc, qs, device=CPU),
                  REF.sweep_columns_ref(csr, cm, qs))
    assert_tables(ops.sweep_columns(pcsr, pc, (), objective="minimax", device=CPU),
                  REF.sweep_columns_minimax_ref(csr, cm))
    finite = [q for q in qs if q is not None]
    for q in (None, max(finite) if finite else None):
        for k in sorted({1, max(1, g.n_tasks // 2), g.n_tasks}):
            for kobj in ("sum", "max"):
                assert_tables(
                    ops.sweep_columns(pcsr, pc, (q,), objective="exact_k", n_bursts=k,
                                      k_objective=kobj, device=CPU),
                    REF.sweep_columns_exactk_ref(csr, cm, q, k, kobj))


@pytest.mark.parametrize("seed", range(30))
def test_random_graphs_bitwise(seed):
    rng = random.Random(1000 + seed)
    g = random_task_graph(rng, max_tasks=14)
    cm = random_cost_model(rng)
    qs = random_q_grid(rng, ref_q_min(g, cm), ref_whole_app(g, cm).max_burst)
    check_all_modes(g, cm, qs)


@pytest.mark.parametrize("seed", range(12))
def test_adversarial_tie_graphs_bitwise(seed):
    rng = random.Random(2000 + seed)
    g = adversarial_tie_graph(rng)
    cm = tie_cost_model(rng)
    qs = tie_q_grid(rng, ref_q_min(g, cm), ref_whole_app(g, cm).max_burst)
    check_all_modes(g, cm, qs)


@pytest.mark.parametrize("spec_name", ["THERMAL", "VISUAL"])
def test_reduced_headcount_bitwise(spec_name):
    g = ref_hc.build_graph(getattr(ref_hc, spec_name).reduced(64))
    cm = ref_hc.paper_cost_model()
    qmn = ref_q_min(g, cm)
    check_all_modes(g, cm, [qmn, 0.132, qmn * 1.2, None, 0.0])


@pytest.mark.parametrize("seed", range(8))
def test_partitioner_matches_numpy_backend(seed):
    rng = random.Random(3000 + seed)
    g = (random_task_graph if seed % 2 else adversarial_tie_graph)(rng)
    cm = random_cost_model(rng) if seed % 2 else tie_cost_model(rng)
    pg, pc = port_of(g, cm)
    qmn = ref_q_min(g, cm)
    qs = random_q_grid(rng, qmn, ref_whole_app(g, cm).max_burst)

    # Q_min: bitwise, and the numpy façade agrees.
    assert pt.q_min(pg, pc, device=CPU) == qmn
    assert solve(PartitionSpec(graph=g, cost=cm, objective="minimax",
                               backend="numpy")).q_min() == qmn

    # Q grid: feasibility, bounds and priced E_total, bitwise.
    ref_parts = solve(PartitionSpec(graph=g, cost=cm, q_grid=tuple(qs),
                                    backend="numpy")).partitions()
    res = pt.sweep(pg, pc, qs, device=CPU)
    parts = res.to_partitions(pg, pc)
    mns, _ = REF.sweep_columns_ref(g.to_csr_arrays(), cm, qs)
    assert np.array_equal(res.e_total, mns[g.n_tasks - 1])
    for qi, (rp, p) in enumerate(zip(ref_parts, parts)):
        assert bool(res.feasible[qi]) == (rp is not None)
        if rp is None:
            assert p is None
            continue
        assert res.bounds(qi) == rp.bounds == p.bounds
        assert p.e_total == rp.e_total
        assert p.max_burst == rp.max_burst

    # Exact-K: the same bounds as the numpy exact-K DP, or both infeasible.
    for k in sorted({1, max(1, g.n_tasks // 2), g.n_tasks}):
        for kobj in ("sum", "max"):
            spec = PartitionSpec(graph=g, cost=cm, objective="exact_k", n_bursts=k,
                                 k_objective=kobj, q_max=qs[-1], backend="numpy")
            try:
                want = solve(spec).partition().bounds
            except RefInfeasible:
                with pytest.raises(Infeasible):
                    pt.exact_k_partition(pg, pc, k, qs[-1], kobj, device=CPU)
                continue
            got = pt.exact_k_partition(pg, pc, k, qs[-1], kobj, device=CPU)
            assert got.bounds == want


def test_full_thermal_q_min_and_fig6():
    """The unreduced 5458-task THERMAL graph: Q_min bitwise, and 18 bursts
    at Q_min and at 132 mJ (the paper's Fig. 6)."""
    g = ref_hc.build_graph(ref_hc.THERMAL)
    cm = ref_hc.paper_cost_model()
    pg = hc.build_graph(hc.THERMAL)
    pc = hc.paper_cost_model()
    qmn = pt.q_min(pg, pc, device=CPU)
    assert qmn == REF.sweep_columns_minimax_ref(g.to_csr_arrays(), cm)[0][-1, 0]
    assert qmn == pytest.approx(0.13196942, abs=1e-9)
    res = pt.sweep(pg, pc, [qmn, 0.132], device=CPU)
    assert len(res.bounds(0)) == 18 and len(res.bounds(1)) == 18


def test_budget_lanes_per_mode():
    b, ek, cmax = ops.budget_lanes([None, 1.0], "sum", None, "sum")
    assert b[0] == np.inf and b[1] == 1.0 * (1 + 1e-9) + 1e-12 and not ek and not cmax
    b, ek, cmax = ops.budget_lanes((), "minimax", None, "sum")
    assert b.tolist() == [np.inf] and cmax and not ek
    b, ek, cmax = ops.budget_lanes((2.0,), "exact_k", 3, "max")
    assert b.shape == (4,) and ek and cmax
    for bad in [((), "sum", None, "sum"), ((1.0,), "minimax", None, "sum"),
                ((1.0, 2.0), "exact_k", 2, "sum"), ((1.0,), "exact_k", 0, "sum"),
                ((1.0,), "exact_k", 2, "min"), ((1.0,), "bogus", None, "sum")]:
        with pytest.raises(ValueError):
            ops.budget_lanes(*bad)
