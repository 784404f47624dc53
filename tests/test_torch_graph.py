"""The port's task-graph export equals the reference's, array for array.

Graphs cross from ``repro`` as plain records (``graph_from_description``),
and the head-count graphs are built by each package on its own; every
``GraphCSRArrays`` field must be ``np.array_equal`` with the same dtype.
"""

import dataclasses
import random

import numpy as np
import pytest

from helpers_random import adversarial_tie_graph, random_task_graph
from repro.core.apps import headcount as ref_hc
from repro.core.cost import cost_scalars as ref_cost_scalars
from repro.core.graph import GraphCSRArrays as RefCSR

from repro_torch.core.apps import headcount as hc
from repro_torch.core.cost import PAPER_FRAM_MODEL, cost_from_scalars, cost_scalars
from repro_torch.core.graph import GraphCSRArrays, graph_from_description


def describe(g):
    """A reference TaskGraph as the plain records the port accepts."""
    packets = [dict(name=p.name, nbytes=p.nbytes, c0_weight=p.c0_weight,
                    keep=p.keep, external=p.external) for p in g.packets.values()]
    tasks = [dict(name=t.name, reads=t.reads, writes=t.writes, cost=t.cost)
             for t in g.tasks]
    return packets, tasks


def assert_csr_equal(port, ref):
    assert port.n_tasks == ref.n_tasks
    names = [f.name for f in dataclasses.fields(GraphCSRArrays)]
    assert names == [f.name for f in dataclasses.fields(RefCSR)]
    for name in names[1:]:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    assert port.nbytes == ref.nbytes


@pytest.mark.parametrize("spec_name", ["THERMAL", "VISUAL"])
@pytest.mark.parametrize("scale", [64, 0])
def test_headcount_csr_equal(spec_name, scale):
    ref_spec, spec = getattr(ref_hc, spec_name), getattr(hc, spec_name)
    if scale:
        ref_spec, spec = ref_spec.reduced(scale), spec.reduced(scale)
    assert_csr_equal(hc.build_graph(spec).to_csr_arrays(),
                     ref_hc.build_graph(ref_spec).to_csr_arrays())


def test_full_thermal_export_size():
    csr = hc.build_graph(hc.THERMAL).to_csr_arrays()
    assert (csr.n_tasks, csr.nnz_reads, csr.nbytes) == (5458, 10908, 501900)


@pytest.mark.parametrize("family", ["random", "tie"])
def test_described_graphs_csr_equal(family):
    rng = random.Random(11)
    make = random_task_graph if family == "random" else adversarial_tie_graph
    for _ in range(25):
        g = make(rng)
        port = graph_from_description(*describe(g))
        assert_csr_equal(port.to_csr_arrays(), g.to_csr_arrays())
        assert port.l_inf == g.l_inf
        assert port.read_last_touch == g.read_last_touch
        assert port.total_task_cost() == g.total_task_cost()


def test_cost_scalars_round_trip():
    assert np.array_equal(cost_scalars(PAPER_FRAM_MODEL),
                          ref_cost_scalars(ref_hc.paper_cost_model()))
    cm = cost_from_scalars(ref_cost_scalars(ref_hc.paper_cost_model()))
    assert cm == dataclasses.replace(PAPER_FRAM_MODEL, name="cost-model")


def test_ssa_violations_raise():
    with pytest.raises(ValueError, match="SSA"):
        graph_from_description(
            [dict(name="p", nbytes=1, c0_weight=1.0, keep=False, external=False)],
            [dict(name="a", reads=(), writes=("p",), cost=1.0),
             dict(name="b", reads=(), writes=("p",), cost=1.0)],
        )
