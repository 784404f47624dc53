"""The port's NS Optimizer loader against the reference's.

``repro_torch.data.ns_optimizer.load_ns_model`` on the checked-in ns_mini
fixture (and on seeded random profiles) gives the graph ``repro``'s loader
gives — the same tasks in the same topological order, the same packets,
reads and costs — the same layer rows and calibration rows, and on
malformed inputs the same typed error with the same message.
"""

import os
import random

import pytest

from repro.data import ns_optimizer as ref_ns

from repro_torch.core.calibration import MeasuredCostTable
from repro_torch.core.layer_profile import analytical_cost_model
from repro_torch.data import ns_optimizer as ns

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "ns_mini")
PROF = os.path.join(FIXTURE, "prof.csv")
DEP = os.path.join(FIXTURE, "dep.csv")


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def graph_record(g):
    """A graph as plain data, packet meta included."""
    return ([(t.name, t.reads, t.writes, t.cost) for t in g.tasks],
            sorted((p.name, p.nbytes, p.c0_weight, p.keep, p.external, p.meta)
                   for p in g.packets.values()))


def assert_same_model(got, want):
    assert graph_record(got.graph) == graph_record(want.graph)
    assert [vars(l) for l in got.layers] == [vars(l) for l in want.layers]
    assert got.edges == want.edges
    assert got.summary() == want.summary()
    assert got.calibration_rows() == want.calibration_rows()


def test_fixture_loads_as_the_reference():
    got, want = ns.load_ns_model(PROF, DEP), ref_ns.load_ns_model(PROF, DEP)
    assert_same_model(got, want)
    assert [t.name for t in got.graph.tasks][0] == "conv1"
    assert got.graph.n_tasks == 5 and ns.MB == ref_ns.MB


@pytest.mark.parametrize("seed", range(4))
def test_random_profiles_load_as_the_reference(seed, tmp_path):
    rng = random.Random(seed)
    n = rng.randint(3, 30)
    names = [f"l{i}" for i in range(n)]
    order = names[:]
    rng.shuffle(order)  # prof rows in a random order: the topological sort decides
    prof = "\n".join(f"{nm},{rng.uniform(0, 1e-2)!r},{rng.uniform(0, 3)!r},"
                     f"{rng.uniform(0, 5)!r},0" for nm in order) + "\n"
    edges = [(names[i - 1], names[i]) for i in range(1, n)]
    edges += [(names[rng.randrange(0, i)], names[i]) for i in range(2, n) if rng.random() < 0.3]
    dep = "Source,Destination\n" + "".join(f"{a},{b}\n" for a, b in edges + edges[:2])
    p, d = _write(tmp_path, "prof.csv", prof), _write(tmp_path, "dep.csv", dep)
    assert_same_model(ns.load_ns_model(p, d), ref_ns.load_ns_model(p, d))


def test_calibration_rows_feed_the_measured_table():
    model = ns.load_ns_model(PROF, DEP)
    table = MeasuredCostTable(analytical_cost_model("time"), "time")
    assert table.ingest_rows(model.calibration_rows()) == model.n_layers
    assert table.stats["compute"].count == model.n_layers


MALFORMED = [
    ("prof", "a,0.1,0.5\n"), ("prof", "a,0.1,0.5,oops,0\n"), ("prof", "a,-0.1,0.5,1.0,0\n"),
    ("prof", "a,0.1,0.5,1.0,0\na,0.2,0.2,0.2,0\n"), ("prof", ",0.1,0.5,1.0,0\n"),
    ("prof", ""), ("prof", "Layer,time,out,mem,MACs\n"),
    ("dep", "a,ghost\n"), ("dep", "a,a\n"), ("dep", "a\n"), ("dep", "a,\n"),
    ("cycle", "a,b\nb,c\nc,a\n"),
]


@pytest.mark.parametrize("which,text", MALFORMED)
def test_malformed_inputs_raise_as_the_reference(which, text, tmp_path):
    good_prof = "a,0.1,0.5,1.0,0\nb,0.2,0.25,0.5,0\nc,0.3,0.1,0.2,0\n"
    prof = _write(tmp_path, "prof.csv", text if which == "prof" else good_prof)
    dep = _write(tmp_path, "dep.csv", "" if which == "prof" else text)
    with pytest.raises(ref_ns.NSOptimizerError) as want:
        ref_ns.load_ns_model(prof, dep)
    with pytest.raises(ns.NSOptimizerError) as got:
        ns.load_ns_model(prof, dep)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_headerless_prof_and_optional_macs(tmp_path):
    prof = _write(tmp_path, "prof.csv", "a,0.1,0.5,1.0\nb,0.2,0.25,0.5\n")
    dep = _write(tmp_path, "dep.csv", "a,b\na,b\n")
    got = ns.load_ns_model(prof, dep)
    assert_same_model(got, ref_ns.load_ns_model(prof, dep))
    assert got.layers[0].macs == 0.0 and got.edges == (("a", "b"),)
