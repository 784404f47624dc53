"""The model zoo's whole models and their serving against the JAX reference.

For each of the seven architectures of the zoo slice (tinyllama-1.1b,
deepseek-coder-33b, qwen1.5-0.5b, granite-moe-1b-a400m,
phi3.5-moe-42b-a6.6b, llama-3.2-vision-11b, whisper-large-v3) at its smoke
size: the config and its ``param_count()`` equal ``repro``'s, full and
smoke; the port's model holds every tensor of ``repro``'s tree; and prefill
and teacher-forced decode logits and every cache leaf (``cross_k`` /
``cross_v`` included) match ``repro``'s ``api.prefill`` /
``api.decode_step`` on ``repro``'s parameters carried across as numpy. The
leaves ``repro`` initialises to zero (QKV and MLP biases, LayerNorm biases,
the vlm cross gates) are drawn at random, and the vision and audio
stand-ins are seeded random, so that the cross paths add something; one
case per stand-in family keeps ``repro``'s zero init and the zero stand-in
that serving feeds. Then the serve CLI per architecture, greedy tokens, and
a planned whisper request on a table from the port's plain sweep.

Tolerance: n·U·max|reference|, U = 2^-9, n the bf16 rounding sites on the
output's path (the budget of ``tests/test_torch_serve.py``): a self layer 21
(attention with QKV bias 12, SwiGLU 5, two norms, two residual adds), a moe
layer 24 (the MoE block 8), a vlm cross layer 15 (attention 12, its norm,
the gate product, the add), a whisper encoder layer 22 (GELU MLP 6) and
decoder layer 36 (self and cross attention, GELU MLP, three norms, three
adds); the model adds 4 (embedding and position add, the final norms, the
head).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api

from test_torch_serve import assert_within, f32

from repro_torch.configs import SMOKE_CONFIGS, get_config, resolve_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.planner import build_table_for_arch
from repro_torch.models import api
from repro_torch.models.common import COMPUTE_DTYPE

ZOO = ("tinyllama-1.1b", "deepseek-coder-33b", "qwen1.5-0.5b", "granite-moe-1b-a400m",
       "phi3.5-moe-42b-a6.6b", "llama-3.2-vision-11b", "whisper-large-v3")
ZERO_INIT = ("bq", "bk", "bv", "b1", "b2", "b", "gate")


def sites(cfg) -> int:
    if cfg.family == "encdec":
        return 22 * cfg.n_encoder_layers + 36 * cfg.n_layers + 4
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        return 21 * (cfg.n_layers - n_cross) + 15 * n_cross + 4
    return (24 if cfg.family == "moe" else 21) * cfg.n_layers + 4


def ref_params(arch, max_seq, seed=0, nonzero=True):
    """(reference cfg, its parameters as jax arrays, as a numpy tree); with
    ``nonzero``, each zero-initialised leaf drawn at random (gates 0.5·N)."""
    rcfg = REF_SMOKE[arch]
    params, _ = ref_api.init_params(rcfg, jax.random.PRNGKey(seed), max_seq=max_seq)
    tree = jax.tree.map(np.asarray, params)
    if nonzero:
        rs = np.random.RandomState(seed + 1)

        def fill(path, a):
            name = getattr(path[-1], "key", None)
            if name in ZERO_INIT and not a.any():
                scale = 0.5 if name == "gate" else 0.05
                return (scale * rs.randn(*a.shape)).astype(a.dtype)
            return a
        tree = jax.tree_util.tree_map_with_path(fill, tree)
    return rcfg, jax.tree.map(jnp.asarray, tree), tree


def stand_ins(cfg, batch, seed, zero=False):
    """(torch, jax) extra inputs of ``api.extra_inputs``: seeded random, or
    zeros as serving feeds them."""
    got, want = {}, {}
    for name, (shape, dtype) in api.extra_inputs(cfg, batch).items():
        a = np.zeros(shape, np.float32) if zero else \
            np.random.RandomState(seed).randn(*shape).astype(np.float32)
        got[name] = torch.from_numpy(a).to(dtype)
        want[name] = jnp.asarray(a).astype(jnp.bfloat16)
    return got, want


# -- configs -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_reference(arch, smoke):
    want = REF_SMOKE[arch] if smoke else ref_get_config(arch)
    got = resolve_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hd == want.hd and got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_zamba2_stays_unregistered():
    """zamba2-7b is registered since the hybrid slice and equals
    ``repro``'s; an architecture ``repro`` does not have raises KeyError."""
    got, want = get_config("zamba2-7b"), ref_get_config("zamba2-7b")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ZOO)
def test_model_holds_the_reference_parameter_tree(arch):
    """The port's model holds as many numbers as ``repro``'s tree, in one
    tensor per leaf (per layer), the tied head none of its own."""
    rcfg, _, tree = ref_params(arch, max_seq=24)
    cfg = SMOKE_CONFIGS[arch]
    model = api.params_from_numpy(cfg, tree, "cpu")
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == want
    if cfg.tie_embeddings:
        assert model.head is None and model.head_weight().data_ptr() == model.embed.data_ptr()


@pytest.mark.parametrize("arch", ZOO)
def test_cache_shape_matches_reference(arch):
    want, _ = ref_api.cache_shape(REF_SMOKE[arch], 3, 20)
    got = api.cache_shape(SMOKE_CONFIGS[arch], 3, 20)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == (tuple(want[name].shape), COMPUTE_DTYPE)


def test_extra_inputs_match_reference():
    for arch in ZOO:
        for b in (1, 4):
            want = ref_api.extra_inputs(REF_SMOKE[arch], b)
            got = api.extra_inputs(SMOKE_CONFIGS[arch], b)
            assert {k: (tuple(v.shape), COMPUTE_DTYPE) for k, v in want.items()} == got


# -- whole models --------------------------------------------------------------------

CASES = [(arch, False) for arch in ZOO] + [("llama-3.2-vision-11b", True),
                                           ("whisper-large-v3", True)]


@pytest.mark.parametrize("arch,zero", CASES,
                         ids=[a + ("-zero-stand-in" if z else "") for a, z in CASES])
def test_prefill_and_teacher_forced_decode_match_reference(arch, zero):
    batch, prompt_len, steps = 2, 9, 4
    max_seq = prompt_len + steps
    rcfg, params, tree = ref_params(arch, max_seq, nonzero=not zero)
    cfg = SMOKE_CONFIGS[arch]
    model = api.params_from_numpy(cfg, tree, "cpu")
    n = sites(cfg)
    toks = np.random.RandomState(prompt_len).randint(0, cfg.vocab, (batch, prompt_len))
    extra, ref_extra = stand_ins(cfg, batch, seed=3, zero=zero)
    want, rcache = jax.jit(lambda p, b: ref_api.prefill(rcfg, p, b, max_seq))(
        params, {"tokens": jnp.asarray(toks, jnp.int32), **ref_extra})
    got, cache = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks), **extra}, max_seq)
    assert got.shape == (batch, 1, cfg.vocab) and got.dtype == COMPUTE_DTYPE
    assert_within(got, want, n)
    assert sorted(cache) == sorted(rcache)
    for name in rcache:  # every leaf, cross_k / cross_v included
        assert cache[name].shape == rcache[name].shape
        assert_within(cache[name], rcache[name], n)

    decode = jax.jit(lambda p, c, t, pos: ref_api.decode_step(rcfg, p, c, t, pos))
    tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]
    for i in range(steps):  # both sides get the reference's tokens
        want, rcache = decode(params, rcache, jnp.asarray(tok, jnp.int32),
                              jnp.int32(prompt_len + i))
        got, cache = api.decode_step(cfg, model, cache, torch.from_numpy(tok), prompt_len + i)
        assert_within(got, want, n)
        tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]
    for name in rcache:
        assert_within(cache[name], rcache[name], n)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"])
def test_the_stand_in_reaches_the_logits(arch):
    """With nonzero gates, a random stand-in moves the logits away from a
    zero one: the cross path is not a no-op."""
    rcfg, _, tree = ref_params(arch, max_seq=12)
    cfg = SMOKE_CONFIGS[arch]
    model = api.params_from_numpy(cfg, tree, "cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (2, 8)))
    outs = [api.prefill(cfg, model, {"tokens": toks, **stand_ins(cfg, 2, 1, zero=z)[0]}, 12)[0]
            for z in (False, True)]
    assert float((outs[0].float() - outs[1].float()).abs().max()) > 0.01


def test_vlm_zero_gate_cross_path_adds_exactly_zero():
    """``repro``'s zero-initialised gates: the cross layers leave the
    residual stream as it was, whatever the stand-in."""
    rcfg, _, tree = ref_params("llama-3.2-vision-11b", max_seq=12, nonzero=False)
    cfg = SMOKE_CONFIGS["llama-3.2-vision-11b"]
    model = api.params_from_numpy(cfg, tree, "cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (2, 8)))
    outs = [api.prefill(cfg, model, {"tokens": toks, **stand_ins(cfg, 2, 1, zero=z)[0]}, 12)[0]
            for z in (False, True)]
    assert torch.equal(outs[0], outs[1])


# -- serving -------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_serve_cli_on_cpu(arch, capsys):
    rc = serve_mod.main(["--arch", arch, "--device", "cpu", "--smoke", "--batch", "2",
                         "--prompt-len", "5", "--gen", "3"])
    assert rc == 0 and f"[serve] {arch}: batch=2 prefill(5 tok)" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ZOO)
def test_serve_greedy_tokens_follow_the_model(arch):
    """serve's tokens are the greedy argmaxes of prefill and decode on the
    same parameters, prompts and zero stand-ins."""
    cfg = SMOKE_CONFIGS[arch]
    prompt_len, gen = 6, 3
    model = api.init_params(cfg, seed=5, device="cpu", max_seq=prompt_len + gen)
    seqs = serve_mod.serve(arch, 2, prompt_len, gen, smoke=True, seed=5, device="cpu",
                           params=model)
    prompts = torch.randint(0, cfg.vocab, (2, prompt_len),
                            generator=torch.Generator().manual_seed(6))
    batch = serve_mod._pre_batch(cfg, prompts)
    assert all(not v.any() for k, v in batch.items() if k != "tokens")
    logits, cache = api.prefill(cfg, model, batch, prompt_len + gen)
    toks = [logits[:, -1].argmax(dim=-1, keepdim=True)]
    for i in range(gen - 1):
        logits, cache = api.decode_step(cfg, model, cache, toks[-1], prompt_len + i)
        toks.append(logits[:, -1].argmax(dim=-1, keepdim=True))
    assert seqs.tolist() == torch.cat(toks, dim=1).tolist()


def test_serve_makes_whisper_positions_of_the_request_length():
    """Unplanned serving draws its parameters as ``repro`` does, with
    ``max_seq`` = prompt + gen decoder positions."""
    cfg = SMOKE_CONFIGS["whisper-large-v3"]
    model = api.init_params(cfg, seed=0, device="cpu", max_seq=9)
    assert model.pos_dec.shape == (9, cfg.d_model)
    got = serve_mod.serve("whisper-large-v3", 2, 6, 3, smoke=True, seed=0, device="cpu")
    assert torch.equal(got, serve_mod.serve("whisper-large-v3", 2, 6, 3, smoke=True, seed=0,
                                            device="cpu", params=model))


def test_planned_whisper_request_equals_unplanned():
    """A planned whisper request on a table built on the port's plain sweep
    gives unplanned serving's tokens, also after a request of another
    length through the same executor: its models are keyed on (seed,
    max_seq), so each request gets the decoder positions it was drawn
    with."""
    arch, batch, gen = "whisper-large-v3", 2, 4
    table = build_table_for_arch(arch, [(batch, 8), (batch, 16)], n_q=4, smoke=True,
                                 backend="torch")
    ex = serve_mod.PlannedExecutor(arch, table, smoke=True, device="cpu")
    for prompt_len in (4, 10):
        planned = torch.from_numpy(np.asarray(
            ex.open(batch, prompt_len, gen, seed=0).run_to_completion()))
        want = serve_mod.serve(arch, batch, prompt_len, gen, smoke=True, seed=0, device="cpu")
        assert torch.equal(planned, want)
    assert sorted(ex._params) == [(0, 8), (0, 14)]
    rep = {}
    planned = serve_mod.serve(arch, batch, 4, gen, smoke=True, seed=0, device="cpu",
                              plan_table=table, energy_budget=None, report=rep)
    assert torch.equal(planned, serve_mod.serve(arch, batch, 4, gen, smoke=True, seed=0,
                                                device="cpu"))
    assert rep["planner_stats"]["lookups"] == 1


def test_cache_bytes_count_the_cross_leaves():
    for arch in ("llama-3.2-vision-11b", "whisper-large-v3"):
        cfg = SMOKE_CONFIGS[arch]
        shapes = api.cache_shape(cfg, 2, 12)
        assert {"cross_k", "cross_v"} <= set(shapes)
        assert serve_mod._cache_nbytes(cfg, 2, 12) == sum(
            int(np.prod(s)) * d.itemsize for s, d in shapes.values())
