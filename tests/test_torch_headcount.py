"""The port's head-count application and burst runtime, on the CPU.

* A power failure at every (burst, phase) point — 'loaded', 'executed',
  'stored', each before the index commit — still gives ``execute_atomic``'s
  output, with in-memory and directory NVM, and replayed stores are
  byte-identical to their first write.
* The port's head count and top-16 window indices equal the JAX reference's
  atomic execution on the same seed and frame. The CNN scores agree only to
  the float32 tolerance of ``test_torch_conv_window.py``, so the test first
  asserts that the gaps between the 17 best scores exceed ten times that
  tolerance: a rounding flip in the ordering cannot then pass as a bug.
"""

import pickle

import numpy as np
import pytest

from repro.core.apps import headcount as ref_hc

from repro_torch.core.apps import headcount as hc
from repro_torch.core.partition import Partition, _partition_from_bounds
from repro_torch.core.partition_torch import q_min, sweep
from repro_torch.core.runtime import (
    BurstRuntime,
    DirNVM,
    MemoryNVM,
    PowerFailure,
    execute_atomic,
)

CPU = "cpu"
TOL = 1e-5
SEED = 3


class RecordingNVM(MemoryNVM):
    """MemoryNVM that keeps every serialized write per packet."""

    def __init__(self):
        super().__init__()
        self.writes = {}

    def write(self, name, value):
        self.writes.setdefault(name, []).append(pickle.dumps(value))
        super().write(name, value)


class CrashEverywhere:
    """Raises PowerFailure once at each distinct (burst, phase) site."""

    def __init__(self):
        self.seen = set()

    def __call__(self, b, phase):
        if (b, phase) not in self.seen:
            self.seen.add((b, phase))
            raise PowerFailure(f"injected at burst {b} @ {phase}")


def _partition(g, cm) -> Partition:
    """A many-burst partition: the optimum at 1.5·Q_min."""
    q = 1.5 * q_min(g, cm, device=CPU)
    res = sweep(g, cm, [q], device=CPU)
    part = _partition_from_bounds(g, cm, res.bounds(0), q)
    assert part.n_bursts >= 3
    return part


@pytest.mark.parametrize("nvm_kind", ["memory", "dir"])
def test_crash_at_every_burst_phase_matches_atomic(nvm_kind, tmp_path):
    g = hc.build_graph(hc.VISUAL.reduced(64), with_fns=True, seed=SEED, device=CPU)
    cm = hc.paper_cost_model()
    ref = execute_atomic(g, {}, device=CPU)
    part = _partition(g, cm)
    nvm = RecordingNVM() if nvm_kind == "memory" else DirNVM(str(tmp_path / "nvm"))
    crash = CrashEverywhere()
    rt = BurstRuntime(g, part, nvm, cost=cm, crash_hook=crash, device=CPU)
    out = rt.run_to_completion({})
    assert len(crash.seen) == 3 * part.n_bursts
    assert rt.stats.replays == 3 * part.n_bursts
    assert rt.stats.bursts_run == part.n_bursts
    assert out.keys() == ref.keys() == {"headcount"}
    assert int(out["headcount"]) == int(ref["headcount"])
    assert rt.stats.energy == pytest.approx(part.e_total)
    if nvm_kind == "memory":
        for name, blobs in nvm.writes.items():
            assert all(b == blobs[0] for b in blobs), name


def test_step_runs_one_burst_per_call():
    g = hc.build_graph(hc.VISUAL.reduced(64), with_fns=True, seed=SEED, device=CPU)
    cm = hc.paper_cost_model()
    part = _partition(g, cm)
    rt = BurstRuntime(g, part, MemoryNVM(), device=CPU)
    done = [rt.step() for _ in range(part.n_bursts)]
    assert done == [False] * (part.n_bursts - 1) + [True]
    assert rt.nvm.read_index() == part.n_bursts
    assert int(rt.outputs()["headcount"]) == int(execute_atomic(g, {}, device=CPU)["headcount"])


def _run_all(graph):
    """Execute every task in order; return the whole packet memory."""
    mem = {}
    for t in graph.tasks:
        outs = t.fn({name: mem[name] for name in t.reads})
        mem.update({name: outs[name] for name in t.writes})
    return mem


@pytest.mark.parametrize("spec_name", ["THERMAL", "VISUAL"])
def test_headcount_and_top16_match_reference(spec_name):
    ref_g = ref_hc.build_graph(getattr(ref_hc, spec_name).reduced(64),
                               with_fns=True, seed=SEED)
    g = hc.build_graph(getattr(hc, spec_name).reduced(64), with_fns=True, seed=SEED,
                       device=CPU)
    ref_mem, mem = _run_all(ref_g), _run_all(g)
    names = [n for n in g.packets if n.startswith("scores")]
    ref_vals = np.array([float(ref_mem[n]) for n in names], np.float64)
    top = np.sort(ref_vals)[::-1][:17]
    gaps = top[:-1] - top[1:]
    assert np.all(gaps > 10 * TOL * np.maximum(1.0, np.abs(top[:-1]))), gaps

    vals = np.array([float(mem[n]) for n in names], np.float64)
    assert np.all(np.abs(vals - ref_vals) <= TOL * np.maximum(1.0, np.abs(ref_vals)))
    assert np.array_equal(mem["top"].numpy()[:, 1], ref_mem["top"][:, 1])
    assert int(mem["headcount"]) == int(ref_mem["headcount"])
    assert int(execute_atomic(g, {}, device=CPU)["headcount"]) == int(ref_mem["headcount"])
