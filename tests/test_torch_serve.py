"""The port's dense LM serving path agrees with the JAX reference.

The smoke config of qwen3-4b (2 layers, d 64, 4 heads, 2 KV heads, hd 16,
vocab 256) runs with ``repro``'s own parameters, carried across as numpy by
``params_from_numpy``. No test builds the full-width model.

Tolerance of an output: n·U·max|reference|, with U = 2^-9 and n the number
of places on its path where an activation is rounded to bfloat16. At each
the two frameworks may round one bfloat16 step apart, because they sum
float32 partial products in different orders. The tolerance is a budget of
2^-9 of the largest output per site (a step is up to 2^-7 of the value it
moves, and differences can grow from layer to layer), not a worst case: at
2 layers the prefill reading is 0.45% of max|logits| against the budget's
7.4%. Attention has 9 sites (the
q/k/v projections, q-norm, k-norm, RoPE of q and of k, attention, the output
projection), SwiGLU 5 (gate and up projections, silu, the gated product, the
down projection), a layer 18 (those, ln1, ln2 and two residual adds), and
the model 18·L + 2 (the final norm and the head).
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
from repro.models.attention import attention as ref_attention
from repro.models.attention import decode_attention as ref_decode_attention
from repro.models.common import apply_rope as ref_apply_rope
from repro.models.mlp import swiglu as ref_swiglu
from repro.models.transformer import lm_forward as ref_lm_forward

from repro_torch.configs import SMOKE_CONFIGS, get_config, resolve_config
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.launch import serve as serve_mod
from repro_torch.models import api
from repro_torch.models.attention import Attention
from repro_torch.models.common import COMPUTE_DTYPE, PLAIN, apply_rope
from repro_torch.models.transformer import lm_forward

U = 2.0 ** -9
ATTENTION_SITES, SWIGLU_SITES = 9, 5
ARCH = "qwen3-4b"


def model_sites(n_layers: int) -> int:
    return (ATTENTION_SITES + SWIGLU_SITES + 4) * n_layers + 2


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_within(got, want, sites: int) -> None:
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err, tol = float(np.abs(got - want).max()), sites * U * float(np.abs(want).max())
    assert np.isfinite(got).all() and err <= tol, (err, tol)


def bf16_pair(shape, seed, scale=1.0):
    """The same bfloat16 values as a torch tensor and a jax array."""
    x = torch.from_numpy((scale * np.random.RandomState(seed).randn(*shape))
                         .astype(np.float32)).to(COMPUTE_DTYPE)
    return x, jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, the port's cfg and model)."""
    rcfg = REF_SMOKE[ARCH]
    params, _ = ref_api.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = SMOKE_CONFIGS[ARCH]
    return rcfg, params, cfg, api.params_from_numpy(cfg, tree, "cpu")


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("smoke_cfg", [False, True], ids=["full", "smoke"])
def test_config_equals_reference(smoke_cfg):
    want = REF_SMOKE[ARCH] if smoke_cfg else ref_get_config(ARCH)
    got = resolve_config(ARCH, smoke=smoke_cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hd == want.hd and got.param_count() == want.param_count()


def test_full_width_parameter_count():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.hd) == (36, 2560, 151936, 128)
    assert cfg.param_count() == 4_411_417_600


def test_model_holds_the_reference_parameter_tree(smoke):
    """Every tensor of ``repro``'s tree, in the same shapes; their sizes sum
    to ``param_count()`` less the d-sized stub it counts beside the final
    norm, plus the q/k-norm weights it leaves out."""
    _, params, cfg, model = smoke
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    got = sum(p.numel() for p in model.parameters())
    assert got == want == cfg.param_count() - cfg.d_model + 2 * cfg.n_layers * cfg.hd
    assert model.layers[1].attn.wq.shape == params["layers"]["attn"]["wq"].shape[1:]
    assert model.head.dtype == COMPUTE_DTYPE and model.final_norm.dtype == torch.float32


def test_resolve_config_errors_and_passthrough():
    cfg = SMOKE_CONFIGS[ARCH]
    assert resolve_config(cfg) is cfg
    with pytest.raises(KeyError, match="smoke"):
        resolve_config("no-such-arch", smoke=True)
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("no-such-arch")
    with pytest.raises(TypeError):
        resolve_config(3)


# -- modules -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta, dtype):
    x, _ = bf16_pair((2, 40, 4, 16), seed=0, scale=2.0)
    x = x.to(dtype)
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    pos = np.arange(960, 1000)[None]
    got = apply_rope(x, torch.from_numpy(pos), theta)
    want = ref_apply_rope(xj, jnp.asarray(pos), theta)
    assert got.dtype == dtype
    # the two libraries' float32 sin and cos may differ by an ulp: float32
    # outputs (|x| < 16) by a few ulp of 16, bf16 outputs by one bf16 ulp
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(f32(got), f32(want), atol=0, rtol=2 * U)
    else:
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-5, rtol=0)


def test_swiglu_matches_reference(smoke):
    rcfg, params, cfg, model = smoke
    p = jax.tree.map(lambda a: a[0], params["layers"]["mlp"])
    x, xj = bf16_pair((2, 8, cfg.d_model), seed=1)
    assert_within(model.layers[0].mlp(x), ref_swiglu(p, xj), SWIGLU_SITES)


def test_attention_prefill_matches_reference(smoke):
    rcfg, params, cfg, model = smoke
    p = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    x, xj = bf16_pair((2, 12, cfg.d_model), seed=2)
    pos = np.arange(12)[None]
    out, (k, v) = model.layers[0].attn(x, torch.from_numpy(pos))
    want, (wk, wv) = ref_attention(rcfg, p, xj, positions=jnp.asarray(pos))
    for g, w in ((out, want), (k, wk), (v, wv)):
        assert_within(g, w, ATTENTION_SITES)
    out_plain, _ = model.layers[0].attn(x, torch.from_numpy(pos), PLAIN)
    assert torch.equal(out_plain, out)  # on the CPU both run the plain versions


def test_decode_attention_matches_reference(smoke):
    rcfg, params, cfg, model = smoke
    p = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    attn: Attention = model.layers[0].attn
    ck, ckj = bf16_pair((2, 16, cfg.n_kv_heads, cfg.hd), seed=3)
    cv, cvj = bf16_pair((2, 16, cfg.n_kv_heads, cfg.hd), seed=4)
    x, xj = bf16_pair((2, 1, cfg.d_model), seed=5)
    pos = 9
    out = attn.decode(x, ck, cv, pos)
    want, wk, wv = ref_decode_attention(rcfg, p, xj, ckj, cvj, jnp.int32(pos))
    assert_within(out, want, ATTENTION_SITES)
    assert_within(ck, wk, ATTENTION_SITES)  # written in place at ``pos``
    assert_within(cv, wv, ATTENTION_SITES)


# -- the whole slice -----------------------------------------------------------


@pytest.mark.parametrize("batch,prompt_len", [(2, 8), (1, 40)])
def test_prefill_and_teacher_forced_decode_match_reference(smoke, batch, prompt_len):
    rcfg, params, cfg, model = smoke
    steps = 4
    max_seq = prompt_len + steps
    toks = np.random.RandomState(prompt_len).randint(0, cfg.vocab, (batch, prompt_len))
    want, rcache = jax.jit(lambda p, t: ref_api.prefill(rcfg, p, {"tokens": t}, max_seq))(
        params, jnp.asarray(toks, jnp.int32))
    got, cache = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks)}, max_seq)
    assert got.shape == (batch, 1, cfg.vocab) and got.dtype == COMPUTE_DTYPE
    assert_within(got, want, model_sites(cfg.n_layers))
    for name in ("k", "v"):
        assert cache[name].shape == rcache[name].shape
        assert_within(cache[name], rcache[name], model_sites(cfg.n_layers))

    decode = jax.jit(lambda p, c, t, pos: ref_api.decode_step(rcfg, p, c, t, pos))
    tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]
    for i in range(steps):  # both sides get the reference's tokens
        want, rcache = decode(params, rcache, jnp.asarray(tok, jnp.int32),
                              jnp.int32(prompt_len + i))
        got, cache = api.decode_step(cfg, model, cache, torch.from_numpy(tok),
                                     prompt_len + i)
        assert got.shape == (batch, 1, cfg.vocab)
        assert_within(got, want, model_sites(cfg.n_layers))
        tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]


def test_forward_logits_match_reference(smoke):
    """``lm_forward``: logits at every position of a tail-length prompt."""
    rcfg, params, cfg, model = smoke
    toks = np.random.RandomState(3).randint(0, cfg.vocab, (2, 40))
    want, _, _ = ref_lm_forward(rcfg, params, jnp.asarray(toks, jnp.int32), remat=False)
    with torch.no_grad():
        got = lm_forward(cfg, model, torch.from_numpy(toks))
    assert got.shape == (2, 40, cfg.vocab)
    assert_within(got, want, model_sites(cfg.n_layers))


def test_cache_shape_matches_reference():
    rcfg, cfg = REF_SMOKE[ARCH], SMOKE_CONFIGS[ARCH]
    want, _ = ref_api.cache_shape(rcfg, 3, 20)
    got = api.cache_shape(cfg, 3, 20)
    for name in ("k", "v"):
        assert got[name] == (tuple(want[name].shape), COMPUTE_DTYPE)


def test_serve_smoke_on_cpu():
    report = {}
    seqs = serve_mod.serve(ARCH, 2, 8, 4, smoke=True, seed=0, device="cpu", report=report)
    assert seqs.shape == (2, 4) and seqs.dtype == torch.int64
    assert int(seqs.min()) >= 0 and int(seqs.max()) < SMOKE_CONFIGS[ARCH].vocab
    assert report["prefill_ms"] > 0 and report["decode_ms_per_token"] > 0
    again = serve_mod.serve(ARCH, 2, 8, 4, smoke=True, seed=0, device="cpu")
    assert torch.equal(seqs, again)


def test_serve_greedy_tokens_follow_the_model():
    """serve's first token is the argmax of prefill's logits on the same
    parameters and prompts."""
    cfg = SMOKE_CONFIGS[ARCH]
    model = api.init_params(cfg, seed=5, device="cpu")
    seqs = serve_mod.serve(ARCH, 1, 6, 1, smoke=True, seed=5, device="cpu", params=model)
    prompts = torch.randint(0, cfg.vocab, (1, 6), generator=torch.Generator().manual_seed(6))
    logits, _ = api.prefill(cfg, model, {"tokens": prompts}, 7)
    assert seqs.tolist() == logits[:, -1].argmax(dim=-1, keepdim=True).tolist()


def test_serve_cli_on_cpu(capsys):
    rc = serve_mod.main(["--device", "cpu", "--smoke", "--batch", "1", "--prompt-len", "4",
                         "--gen", "2"])
    assert rc == 0 and "[serve] qwen3-4b: batch=1" in capsys.readouterr().out


def test_serve_rejects_gen_zero():
    with pytest.raises(ValueError, match="gen"):
        serve_mod.serve(ARCH, 1, 4, 0, smoke=True, device="cpu")


def test_unported_families_raise():
    """Every family of ``repro`` builds: moe since the model-zoo slice,
    hybrid (zamba2) since the hybrid slice; a family ``repro`` does not
    have raises ValueError."""
    moe = dataclasses.replace(SMOKE_CONFIGS[ARCH], family="moe",
                              moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32))
    model = api.init_params(moe, device="cpu")
    assert model.layers[0].mlp.w1.shape == (4, moe.d_model, 32)
    hybrid = SMOKE_CONFIGS["zamba2-7b"]
    model = api.init_params(hybrid, device="cpu")
    assert len(model.groups) == hybrid.n_layers // hybrid.attn_every
    assert model.shared.attn.wq.shape == (2 * hybrid.d_model, hybrid.n_heads * hybrid.hd)
    with pytest.raises(ValueError, match="unknown model family"):
        api.init_params(dataclasses.replace(SMOKE_CONFIGS[ARCH], family="rnn"), device="cpu")


def test_cuda_requests_without_a_card_raise():
    """The entry points' ``device="cuda"`` (their default) raises without a
    card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mod.serve(ARCH, 1, 4, 2, smoke=True)  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mod.serve(ARCH, 1, 4, 2, smoke=True, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        api.init_params(SMOKE_CONFIGS[ARCH])
    with pytest.raises(RuntimeError, match="cuda"):
        api.init_params(SMOKE_CONFIGS[ARCH], device="cuda")


def test_kernel_ops_dispatch_on_the_tensors_device():
    """The kernel ops take no device: a CPU tensor runs the plain version."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4, 2, 64).astype(np.float32))
    x = x.to(COMPUTE_DTYPE)
    w = torch.ones(64)
    assert torch.equal(rmsnorm(x, w), PLAIN.rmsnorm(x, w, 1e-5))
    assert torch.equal(flash_attention(x, x, x), PLAIN.attention(x, x, x, True))
