"""``build_cell``'s cells as CUDA graphs: what the CPU can hold of them.

On a card ``CellSpec.run`` is the replay of one CUDA graph per (cell,
model, input shapes) (``launch/steps.py::CellSpec.replay``), the
counterpart of ``repro``'s ``CellSpec.jitted()``, through the serving and
training graphs (``serve._GraphedPrefill``, ``serve._GraphedDecode``,
``train._GraphedTrainStep``) of the cell's own eager step: the prefill's
batch and the decode's cache, token and position are the graph's static
inputs (the decode's cache copied into the graph's and back out into the
caller's, updated in place as the eager step updates it), the train cell
closes over its module and state. A graph cannot run here, so these tests
make the capture eager (``helpers_torch.eager_record``: the warm-up runs
the step, each "replay" runs it again into the graph's outputs) and hold:

* over 3 calls, the graphed prefill (a new batch each call), decode (the
  caller's cache updated in place) and train step (loss, masters, m and
  v) bitwise the eager cell's (``CellSpec.run_eager``), for a dense and a
  MoE smoke config;
* two caches interleaved through one decode cell: each updated in place,
  bitwise as the eager cell updates it, by one graph;
* one capture per (cell, model, input shapes), counted by
  ``serve.TRACE_COUNT`` (train: ``train.TRACE_COUNT``), and a train state
  whose tensors were rebound is refused;
* on the CPU ``CellSpec.run`` is the eager step: nothing captures;
* ``dryrun.measure`` records whether its steps were ``graphed``;
* ``chip_smoke.py``'s ``comm_debug``, which counts the collectives the
  four-card graphs record, leaves no forward hook behind on the model
  (``CommDebugMode`` alone leaves some, and the next run outside it
  raises).

The sharded cells' graphs are held on four gloo processes in
``tests/test_torch_sharded_run.py``.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from helpers_torch import eager_capture, eager_record  # noqa: F401

from repro_torch.configs import SMOKE_CONFIGS
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod

CPU = torch.device("cpu")
ARCHS = ("qwen3-4b", "granite-moe-1b-a400m")
B, S, CALLS = 2, 16, 3


def _cell(arch, kind, b=B, s=S):
    return steps.build_cell(SMOKE_CONFIGS[arch], ShapeConfig(kind, s, b, kind), CPU)


def _tokens(cfg, b, s, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=gen)


def _calls(cell, run, args):
    """CALLS steps of ``run`` from ``args``: each step's outputs and, at the
    end, what the step updated in place (decode: the cache; train: the
    masters and moments)."""
    cfg, kind = cell.cfg, cell.shape.kind
    outs = []
    if kind == "prefill":
        for i in range(CALLS):
            batch = {**args[1], "tokens": _tokens(cfg, B, S, 100 + i)}
            outs.append(run((args[0], batch)))
        return outs, None
    if kind == "decode":
        model, cache = args[0], args[1]
        for i in range(CALLS):
            tok = _tokens(cfg, B, 1, 200 + i)
            logits, cache = run((model, cache, tok, torch.tensor(S - CALLS + i)))
            outs.append(logits)
        return outs, cache
    model, state, batch = args
    for i in range(CALLS):
        outs.append(run((model, state, {**batch, "tokens": _tokens(cfg, B, S, 300 + i)})))
    opt = state["opt_state"]
    return outs, {"params": state["params"], "m": opt["m"], "v": opt["v"], "step": opt["step"]}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if a is None:
        return b is None
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_cell_equals_the_eager_cell_over_three_calls(arch, kind, eager_capture):
    cell = _cell(arch, kind)
    got, got_state = _calls(cell, cell.replay, cell.materialize(0))
    want, want_state = _calls(cell, cell.run_eager, cell.materialize(0))
    assert _equal(got, want) and _equal(got_state, want_state)


def test_graphed_decode_updates_each_callers_cache_in_place(eager_capture):
    """Two caches interleaved through one decode cell: each call updates
    the cache it was given in place and returns it, bitwise as the eager
    cell does, and one graph serves both."""
    cell = _cell("qwen3-4b", "decode")
    model = cell.materialize(0)[0]
    runs = {"graphed": cell.replay, "eager": cell.run_eager}
    caches = {key: [cell.materialize(seed)[1] for seed in (0, 1)] for key in runs}
    for i in range(CALLS):
        for j in (0, 1):
            tok = _tokens(cell.cfg, B, 1, 10 * i + j)
            pos = torch.tensor(S - CALLS + i)
            outs = {}
            for key, run in runs.items():
                mine = caches[key][j]
                before = {k: v.clone() for k, v in mine.items()}
                outs[key] = run((model, mine, tok, pos))
                assert outs[key][1] is mine
                assert not _equal(mine, before)
            assert _equal(outs["graphed"], outs["eager"]), (i, j)
    assert _equal(caches["graphed"], caches["eager"])
    assert len(cell.graphs(model)) == 1


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_cell_captures_once_per_model_and_input_shapes(kind, eager_capture):
    counter, name = ((train_mod.TRACE_COUNT, "step") if kind == "train"
                     else (serve_mod.TRACE_COUNT, kind))
    cell, wider = _cell("qwen3-4b", kind), _cell("qwen3-4b", kind, b=B + 1)
    args, other, wide = cell.materialize(0), cell.materialize(1), wider.materialize(0)
    wide = (args[0],) + wide[1:]  # the first model, inputs of another shape
    if kind == "train":  # one train state a model
        wide = (args[0], args[1], wide[2])
    before = counter[name]
    for _ in range(CALLS):
        cell.replay(args)
    assert counter[name] - before == 1
    cell.replay(wide)
    cell.replay(other)
    cell.replay(args)
    assert counter[name] - before == 3
    assert [len(cell.graphs(a[0])) for a in (args, other)] == [2, 1]


def test_graphed_train_cell_refuses_a_rebound_state(eager_capture):
    cell = _cell("qwen3-4b", "train")
    model, state, batch = cell.materialize(0)
    cell.replay((model, state, batch))
    m = state["opt_state"]["m"]
    name = next(iter(m))
    m[name] = m[name].clone()
    with pytest.raises(ValueError, match="other tensors"):
        cell.replay((model, state, batch))


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_cpu_run_is_the_eager_step(kind, monkeypatch):
    def no_capture(*args):
        raise AssertionError("a capture on the CPU")

    monkeypatch.setattr(serve_mod, "_record", no_capture)
    cell = _cell("qwen3-4b", kind)
    before = (dict(serve_mod.TRACE_COUNT), train_mod.TRACE_COUNT["step"])
    got, got_state = _calls(cell, cell.run, cell.materialize(0))
    want, want_state = _calls(cell, cell.run_eager, cell.materialize(0))
    assert _equal(got, want) and _equal(got_state, want_state)
    assert (dict(serve_mod.TRACE_COUNT), train_mod.TRACE_COUNT["step"]) == before


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphed"])
def test_measure_records_whether_its_steps_were_graphed(graphed, monkeypatch):
    """On the CPU ``run`` is eager and the record says so; with ``run`` the
    graphed path (the capture eager) it says graphed."""
    cell = _cell("qwen3-4b", "prefill")
    if graphed:
        monkeypatch.setattr(serve_mod, "_record", eager_record)
        monkeypatch.setattr(cell, "run", cell.replay)
    rec = dryrun.measure(cell)
    assert rec["graphed"] is graphed
    assert rec["first_step_s"] > 0 and rec["step_s"] > 0 and "peak_bytes" not in rec


def test_chip_smoke_comm_debug_leaves_no_hook_behind():
    from torch.distributed.tensor.debug import CommDebugMode

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cell = _cell("qwen3-4b", "prefill")
    args = cell.materialize(0)
    with CommDebugMode():  # the control: the mode alone leaves hooks that raise
        cell.run_eager(args)
    with pytest.raises(IndexError):
        cell.run_eager(args)
    args = cell.materialize(0)
    with cs.comm_debug(args[0]) as comm:
        want = cell.run_eager(args)
    assert comm.get_total_counts() == 0
    assert not any(m._forward_hooks for m in args[0].modules())
    assert _equal(cell.run_eager(args), want)
