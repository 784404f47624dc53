"""The train step as one CUDA graph per (model, train state, batch shape):
what the CPU can hold of it.

On a card ``train`` runs each step as a replay of one CUDA graph
(``launch/train.py::_GraphedTrainStep``), the counterpart of ``repro``'s
``jax.jit(step_fn, donate_argnums=(0, 1))``: the graph closes over the
float32 masters, AdamW's moments and its step counter and updates them in
place. A graph cannot run here, so these tests hold what decides whether
the capture is right, with the capture made eager (``serve._record``: the
warm-up runs the step, each "replay" runs it again, as a graph replays what
it recorded):

* ``adamw_update`` keeps every state tensor in its own storage, the step
  counter too (a rebound counter would stay frozen in a graph);
* one capture per (model, state, batch shape), counted by
  ``train.TRACE_COUNT``, and a new batch shape or model captures again;
* over 4 steps (the warm-up and three replays) the losses, masters, m, v
  and counter are bitwise the eager ``train_step``'s, for all ten smoke
  configs; a state whose tensors were rebound is refused;
* a resumed run captures on the restored state and ends on the
  uninterrupted run's losses;
* three graphed steps against ``repro``'s jitted step, within the
  tolerances of ``tests/test_torch_train.py``;
* on the CPU ``train`` still runs the eager step.
"""

import numpy as np
import pytest
import torch

from helpers_torch import eager_capture, three_steps_against_reference  # noqa: F401

from repro_torch.configs import ALL_ARCHS, SMOKE_CONFIGS
from repro_torch.data.synthetic import SyntheticConfig, SyntheticData
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import api
from repro_torch.optim import adamw

CPU = torch.device("cpu")
ADAMW = adamw.AdamWConfig(lr=1e-3, warmup_steps=2)
BATCH, SEQ = 2, 16


def _fresh(cfg, seq=SEQ):
    model, masters = api.init_trainable(cfg, 0, CPU, max_seq=seq)
    return model, {"params": masters, "opt_state": adamw.adamw_init(masters)}


def _batches(cfg, n, batch=BATCH, seq=SEQ):
    data = SyntheticData(SyntheticConfig(cfg.vocab, seq, batch, seed=0))
    return [train_mod.batch_tensors(cfg, data.batch(i), CPU) for i in range(n)]


def _flat(state):
    out = {f"params.{k}": v for k, v in state["params"].items()}
    for part in ("m", "v"):
        out.update({f"{part}.{k}": v for k, v in state["opt_state"][part].items()})
    out["step"] = state["opt_state"]["step"]
    return out


def _differing(a, b) -> list:
    """The leaves of two train states that are not bitwise equal."""
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    return [k for k in fa if fa[k].dtype != fb[k].dtype or not torch.equal(fa[k], fb[k])]


# -- AdamW keeps its state's storage ----------------------------------------------------


def test_adamw_update_keeps_every_state_tensor_in_its_storage():
    rs = np.random.RandomState(0)
    params = {n: torch.from_numpy(rs.randn(*shape).astype(np.float32))
              for n, shape in (("a", (5, 7)), ("b", (11,)))}
    state = adamw.adamw_init(params)
    tensors = {**{f"p.{k}": v for k, v in params.items()},
               **{f"m.{k}": v for k, v in state["m"].items()},
               **{f"v.{k}": v for k, v in state["v"].items()}, "step": state["step"]}
    ptrs = {k: t.data_ptr() for k, t in tensors.items()}
    before = {k: t.clone() for k, t in tensors.items()}
    for _ in range(3):
        grads = {n: torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
                 for n, p in params.items()}
        adamw.adamw_update(ADAMW, params, grads, state)
    now = {**{f"p.{k}": v for k, v in params.items()},
           **{f"m.{k}": v for k, v in state["m"].items()},
           **{f"v.{k}": v for k, v in state["v"].items()}, "step": state["step"]}
    assert {k: t.data_ptr() for k, t in now.items()} == ptrs
    assert all(now[k] is tensors[k] for k in tensors)
    assert all(not torch.equal(now[k], before[k]) for k in tensors)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 3


# -- the graphed step, the capture made eager ---------------------------------------------


def test_graphed_step_captures_once_per_model_state_and_shape(eager_capture):
    cfg = SMOKE_CONFIGS["tinyllama-1.1b"]
    step = train_mod._GraphedTrainStep(cfg, ADAMW, CPU)
    (m0, s0), (m1, s1) = _fresh(cfg), _fresh(cfg)
    before = train_mod.TRACE_COUNT["step"]
    for b in _batches(cfg, 3):
        step(m0, s0, b)
    assert train_mod.TRACE_COUNT["step"] - before == 1
    step(m0, s0, _batches(cfg, 1, batch=3)[0])  # another batch shape
    step(m0, s0, _batches(cfg, 1, seq=SEQ - 4)[0])
    for b in _batches(cfg, 2):
        step(m1, s1, b)  # another model
    step(m0, s0, _batches(cfg, 1)[0])  # the first graph again
    assert train_mod.TRACE_COUNT["step"] - before == 4
    assert [len(step.graphs(m)) for m in (m0, m1)] == [3, 1]
    assert int(s0["opt_state"]["step"]) == 6 and int(s1["opt_state"]["step"]) == 2


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_graphed_steps_equal_eager_steps(arch, eager_capture):
    """The warm-up and three replays against four eager ``train_step``s
    from the same start: losses, masters, m, v and counter bitwise."""
    cfg = SMOKE_CONFIGS[arch]
    (me, se), (mg, sg) = _fresh(cfg), _fresh(cfg)
    assert not _differing(se, sg)
    step = train_mod._GraphedTrainStep(cfg, ADAMW, CPU)
    for i, b in enumerate(_batches(cfg, 4)):
        want = train_mod.train_step(cfg, me, se, ADAMW, b)
        got = step(mg, sg, b)
        assert got.shape == () and got.dtype == torch.float32
        assert torch.equal(got, want), i
        assert not _differing(sg, se), i
    assert int(sg["opt_state"]["step"]) == 4
    assert len(step.graphs(mg)) == 1
    for name, p in mg.named_parameters():
        assert p.grad is None, name  # the graph's gradients live in its pool only
        assert torch.equal(p.detach(), me.get_parameter(name).detach()), name


def test_graphed_step_refuses_a_rebound_state(eager_capture):
    cfg = SMOKE_CONFIGS["qwen1.5-0.5b"]
    model, state = _fresh(cfg)
    step = train_mod._GraphedTrainStep(cfg, ADAMW, CPU)
    b = _batches(cfg, 2)
    step(model, state, b[0])
    state["opt_state"]["step"] = state["opt_state"]["step"] + 0
    with pytest.raises(ValueError, match="other tensors"):
        step(model, state, b[1])


def test_resumed_graphed_run_captures_on_the_restored_state(tmp_path, eager_capture,
                                                           monkeypatch):
    kw = dict(arch="qwen1.5-0.5b", batch=2, seq=16, burst_steps=2, smoke=True,
              log_every=100, device="cpu")
    want = train_mod.train(steps=6, ckpt_dir=str(tmp_path / "eager"), **kw)
    monkeypatch.setattr(train_mod, "_step_fn", train_mod._GraphedTrainStep)  # graphed on the CPU
    whole, part, resumed = {}, {}, {}
    assert train_mod.train(steps=6, ckpt_dir=str(tmp_path / "a"), report=whole, **kw) == want
    first = train_mod.train(steps=2, ckpt_dir=str(tmp_path / "b"), report=part, **kw)
    before = train_mod.TRACE_COUNT["step"]
    got = train_mod.train(steps=6, ckpt_dir=str(tmp_path / "b"), report=resumed, **kw)
    assert train_mod.TRACE_COUNT["step"] - before == 1
    assert first + got == want
    assert [len(r["captures"]) for r in (whole, part, resumed)] == [1, 1, 1]


def test_three_graphed_steps_match_reference(eager_capture):
    three_steps_against_reference(
        lambda cfg, a: train_mod._GraphedTrainStep(cfg, a, CPU))


# -- the CPU path is the eager one ---------------------------------------------------------


def test_cpu_train_runs_the_eager_step(tmp_path, monkeypatch):
    def no_capture(*args):
        raise AssertionError("a capture on the CPU")

    monkeypatch.setattr(serve_mod, "_record", no_capture)
    cfg = SMOKE_CONFIGS["tinyllama-1.1b"]
    assert not isinstance(train_mod._step_fn(cfg, ADAMW, CPU), train_mod._GraphedTrainStep)
    before = train_mod.TRACE_COUNT["step"]
    report = {}
    got = train_mod.train("tinyllama-1.1b", steps=3, batch=BATCH, seq=SEQ, burst_steps=3,
                          ckpt_dir=str(tmp_path), device="cpu", log_every=100, report=report)
    assert train_mod.TRACE_COUNT["step"] - before == 1 and report["captures"] == []
    model, state = _fresh(cfg)
    a = adamw.AdamWConfig(lr=1e-3, warmup_steps=20)
    data = SyntheticData(SyntheticConfig(cfg.vocab, SEQ, BATCH, seed=0))
    want = [float(train_mod.train_step(cfg, model, state, a,
                                       train_mod.batch_tensors(cfg, data.batch(i), CPU)))
            for i in range(3)]
    assert got == want
