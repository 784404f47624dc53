"""The prefill as one CUDA graph per (model, input shapes): what the CPU can
hold of it.

On a card ``_step_fns`` returns a prefill that captures one CUDA graph per
parameters object and input shapes and replays it after that
(``launch/serve.py::_GraphedPrefill``), as ``repro`` jits its prefill once
per shape. A graph cannot run here, so these tests hold the parts that
decide whether it can be captured and what it hands back:

* every architecture's ``api.prefill`` runs to its end on ``meta`` through
  the kernels' counted stand-ins (``models/common.py::COUNTED``), at smoke
  size and at the serving tests' prompt lengths (128 and 256 too for the
  chunked ssm and hybrid families): it reads no value on the host and makes
  no shape from data, either of which raises on ``meta``;
* the static-input and output handling both graphed paths share
  (``_Captured``, ``_feed``), driven with an eager replay on CPU tensors:
  inputs are copied in, outputs come back as clones, a None leaf passes
  through, a shape mismatch raises, a number fills the 0-d position;
* the graphed paths with the capture made eager (``_record``): one
  prefill capture per (parameters object, input shapes), counted by
  ``TRACE_COUNT``; every prefill's and decode step's logits and cache, the
  warm-ups' at the request's own position and the replays', bitwise the
  eager steps';
* on the CPU ``_step_fns``'s prefill is still the eager function, and
  ``serve``'s tokens equal those of the eager prefill and decode loop the
  port ran before prefill was graphed (a dense model and xlstm-1.3b).
"""

import gc

import numpy as np
import pytest
import torch

from helpers_torch import eager_record as _eager_record

from repro_torch.configs import ALL_ARCHS, SMOKE_CONFIGS
from repro_torch.kernels.counted import work_sink
from repro_torch.launch import serve as serve_mod
from repro_torch.models import api
from repro_torch.models.common import COUNTED

CPU = torch.device("cpu")
META = torch.device("meta")
CHUNKED = ("ssm", "hybrid")
# The serving tests' prompt lengths: serve_plan and traffic 8, the zoo 9; the
# chunked families' prefill chunk (128) and two chunks (256).
META_CASES = [(arch, s) for arch in ALL_ARCHS
              for s in ((8, 9, 128, 256) if SMOKE_CONFIGS[arch].family in CHUNKED else (8, 9))]


def _cfg(arch):
    return SMOKE_CONFIGS[arch]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return None if tree is None else (tuple(tree.shape), tree.dtype)


def _want_shapes(tree):
    if isinstance(tree, dict):
        return {k: _want_shapes(v) for k, v in tree.items()}
    return None if tree is None else (tuple(tree[0]), tree[1])


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is b
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def _inputs(cfg, batch, prompt_len, device, seed=0):
    if device.type == "meta":
        tokens = torch.empty((batch, prompt_len), dtype=api.TOKEN_DTYPE, device=META)
        extra = {k: torch.empty(shape, dtype=dtype, device=META)
                 for k, (shape, dtype) in api.extra_inputs(cfg, batch).items()}
        return {"tokens": tokens, **extra}
    rng = np.random.RandomState(seed)
    out = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab, (batch, prompt_len)))}
    for k, (shape, dtype) in api.extra_inputs(cfg, batch).items():
        out[k] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return out


# -- capturable: no host read, no shape from data -------------------------------

@pytest.mark.parametrize("arch,prompt_len", META_CASES,
                         ids=[f"{a}-S{s}" for a, s in META_CASES])
def test_prefill_runs_on_meta_with_the_counted_stand_ins(arch, prompt_len):
    cfg, batch, gen = _cfg(arch), 2, 6
    max_seq = prompt_len + gen
    model = api.init_params(cfg, None, device="meta", max_seq=max_seq)
    calls = []
    with work_sink(lambda name, work: calls.append(name)):
        logits, cache = api.prefill(cfg, model, _inputs(cfg, batch, prompt_len, META),
                                    max_seq, COUNTED)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (batch, 1, cfg.vocab)
    assert _shapes(cache) == _want_shapes(api.cache_shape(cfg, batch, max_seq))
    kernel = "mlstm_chunk" if cfg.family == "ssm" else "flash_attention"
    assert kernel in calls


# -- the static inputs and outputs both graphed paths share ---------------------

def _eager_captured(step, inputs):
    cap = serve_mod._Captured(inputs)
    cap.feed(inputs)
    _eager_record(step, cap, CPU)
    return cap


def _step(s):
    return {"y": s["x"] * 2 + s["pos"], "part": {"z": s["x"].sum(0), "tail": None}}


def _io(seed, pos=0):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(3, 4, generator=g), "pos": torch.tensor(pos),
            "part": {"tail": None}}


def test_captured_copies_inputs_in():
    first, second = _io(0), _io(1, pos=5)
    cap = _eager_captured(_step, first)
    assert cap.inputs["x"].data_ptr() != first["x"].data_ptr()
    cap(second)
    assert torch.equal(cap.inputs["x"], second["x"]) and int(cap.inputs["pos"]) == 5
    second["x"].add_(1.0)  # the caller's tensor changes, the graph's does not
    assert not torch.equal(cap.inputs["x"], second["x"])


def test_captured_hands_back_clones():
    cap = _eager_captured(_step, _io(0))
    a = cap(_io(1))
    b = cap(_io(2))
    assert _equal(a, _step(_io(1))) and _equal(b, _step(_io(2)))
    assert a["y"].data_ptr() != cap.outputs["y"].data_ptr()
    assert a["part"]["z"].data_ptr() != cap.outputs["part"]["z"].data_ptr()


def test_captured_passes_a_none_leaf_through():
    cap = _eager_captured(_step, _io(0))
    out = cap(_io(3))
    assert cap.inputs["part"] == {"tail": None}
    assert out["part"]["tail"] is None


@pytest.mark.parametrize("bad", [{"x": torch.zeros(3, 5)}, {"x": torch.zeros(4, 4)}],
                         ids=["cols", "rows"])
def test_captured_refuses_another_shape(bad):
    cap = _eager_captured(_step, _io(0))
    with pytest.raises(ValueError, match="graph has"):
        cap({**_io(1), **bad})


def test_captured_refuses_a_tensor_where_the_graph_has_none():
    cap = _eager_captured(_step, _io(0))
    with pytest.raises(ValueError, match="None"):
        cap({**_io(1), "part": {"tail": torch.zeros(1)}})


def test_captured_fills_a_number_and_skips_its_own_tensors():
    cap = _eager_captured(_step, _io(0))
    x = cap.inputs["x"]
    cap.feed({"x": x, "pos": 7, "part": {"tail": None}})
    assert cap.inputs["x"] is x and int(cap.inputs["pos"]) == 7


def test_captured_adds_the_launches_a_replay_holds():
    def kernel():
        pass
    kernel.launches = 3
    cap = _eager_captured(_step, _io(0))
    cap.launches = ((kernel, 2),)
    cap(_io(1))
    cap(_io(2))
    assert kernel.launches == 7


# -- the graphed paths, the capture made eager ---------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-1.3b", "llama-3.2-vision-11b",
                                  "whisper-large-v3", "zamba2-7b"])
def test_graphed_prefill_captures_once_per_model_and_shape(arch, monkeypatch):
    monkeypatch.setattr(serve_mod, "_record", _eager_record)
    cfg, gen = _cfg(arch), 4
    lens = (8, 9) if cfg.family not in CHUNKED else (8, 128)
    max_seq = max(lens) + gen
    prefill = serve_mod._GraphedPrefill(cfg, CPU, max_seq)
    models = [api.init_params(cfg, seed, CPU, max_seq=max_seq) for seed in (0, 1)]
    calls = [(m, 2, s, seed) for m in models for s in lens for seed in (0, 1, 2)]
    calls.append((models[0], 3, lens[0], 3))  # another batch: another shape
    before = serve_mod.TRACE_COUNT["prefill"]
    for model, batch, s, seed in calls:
        inputs = _inputs(cfg, batch, s, CPU, seed)
        got = prefill(model, inputs)
        want = api.prefill(cfg, model, inputs, max_seq)
        assert _equal({"logits": got[0], "cache": got[1]},
                      {"logits": want[0], "cache": want[1]})
    assert serve_mod.TRACE_COUNT["prefill"] - before == 2 * len(lens) + 1
    assert [len(prefill.graphs(m)) for m in models] == [len(lens) + 1, len(lens)]


@pytest.mark.parametrize("donate", [True, False], ids=["donate", "keep"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-1.3b", "zamba2-7b"])
def test_graphed_steps_follow_the_eager_steps(arch, donate, monkeypatch):
    """A request through both graphed paths, the capture made eager: the
    first call of each is its warm-up at the request's own position, the
    later ones replays; every logits and cache leaf equals the eager
    prefill and decode steps'."""
    monkeypatch.setattr(serve_mod, "_record", _eager_record)
    cfg, batch, prompt_len, gen = _cfg(arch), 2, 8, 5
    max_seq = prompt_len + gen
    model = api.init_params(cfg, 0, CPU, max_seq=max_seq)
    prefill = serve_mod._GraphedPrefill(cfg, CPU, max_seq)
    decode = serve_mod._GraphedDecode(cfg, CPU, donate)
    for seed in (0, 1):  # the first request captures, the second replays
        inputs = _inputs(cfg, batch, prompt_len, CPU, seed)
        logits, cache = prefill(model, inputs)
        want_logits, want_cache = api.prefill(cfg, model, inputs, max_seq)
        for i in range(gen - 1):
            assert _equal({"logits": logits, "cache": cache},
                          {"logits": want_logits, "cache": want_cache}), (seed, i)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            kept = serve_mod._map(torch.clone, cache)
            logits, new = decode(model, cache, tok, prompt_len + i)
            if not donate:
                assert _equal(cache, kept)  # the planned path re-reads its input
            cache = new
            want_logits, want_cache = api.decode_step(cfg, model, want_cache, tok,
                                                      prompt_len + i)


def test_graphed_prefill_keys_on_names_shapes_and_dtypes():
    a = {"tokens": torch.zeros(2, 8, dtype=torch.int64),
         "vision": torch.zeros(2, 3, 4, dtype=torch.bfloat16)}
    key = serve_mod._input_key(a)
    assert key == serve_mod._input_key({k: a[k].clone() for k in reversed(list(a))})
    assert key != serve_mod._input_key({**a, "tokens": a["tokens"].to(torch.int32)})
    assert key != serve_mod._input_key({**a, "vision": torch.zeros(2, 4, 4,
                                                                  dtype=torch.bfloat16)})


# -- the CPU path is the eager one ----------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "xlstm-1.3b"])
def test_cpu_step_fns_prefill_is_the_eager_function(arch):
    cfg, batch, max_seq = _cfg(arch), 2, 14
    prefill, _ = serve_mod._step_fns(arch, True, batch, max_seq, CPU, donate=True)
    assert not isinstance(prefill, serve_mod._GraphedPrefill)
    model = api.init_params(cfg, 0, CPU, max_seq=max_seq)
    inputs = _inputs(cfg, batch, 8, CPU)
    logits, cache = prefill(model, inputs)
    want_logits, want_cache = api.prefill(cfg, model, inputs, max_seq)
    assert _equal({"logits": logits, "cache": cache},
                  {"logits": want_logits, "cache": want_cache})


def _eager_serve(arch, batch, prompt_len, gen, seed):
    """The unplanned request as the port served it before prefill was
    graphed: the eager prefill, then eager decode steps on the cache in
    place."""
    cfg = _cfg(arch)
    max_seq = prompt_len + gen
    model = api.init_params(cfg, seed, CPU, max_seq=max_seq)
    prompts = serve_mod._prompts(cfg, batch, prompt_len, seed, CPU)
    logits, cache = api.prefill(cfg, model, serve_mod._pre_batch(cfg, prompts), max_seq)
    toks = [logits[:, -1].argmax(dim=-1, keepdim=True)]
    for i in range(gen - 1):
        logits, cache = api.decode_step(cfg, model, cache, toks[-1], prompt_len + i)
        toks.append(logits[:, -1].argmax(dim=-1, keepdim=True))
    return torch.cat(toks, dim=1)


@pytest.mark.parametrize("arch,prompt_len", [("qwen3-4b", 8), ("qwen3-4b", 9),
                                             ("xlstm-1.3b", 8), ("xlstm-1.3b", 128)])
def test_cpu_serve_tokens_equal_the_eager_loop(arch, prompt_len):
    got = serve_mod.serve(arch, 2, prompt_len, 6, smoke=True, seed=3, device="cpu")
    assert torch.equal(got, _eager_serve(arch, 2, prompt_len, 6, seed=3))


def test_graphs_go_with_the_model():
    """The graphs live in a WeakKeyDictionary on the parameters object."""
    cfg = _cfg("qwen3-4b")
    prefill = serve_mod._GraphedPrefill(cfg, CPU, 12)
    model = api.init_params(cfg, 0, CPU, max_seq=12)
    prefill.graphs(model)[("key",)] = object()
    assert len(prefill._graphs) == 1
    del model
    gc.collect()
    assert len(prefill._graphs) == 0
