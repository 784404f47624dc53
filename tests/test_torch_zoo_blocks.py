"""The model zoo's new blocks against the JAX reference, on the same inputs.

LayerNorm, the GELU MLP, attention with QKV bias, cross-attention (prefill
with Sk = 17 and 16, and single-token decode against a cache) and the MoE
block, each on ``repro``'s smoke parameters carried across as numpy; the
biases ``repro`` initialises to zero are drawn at random here, so that each
one is seen. MoE routing is checked exactly: the port's :func:`route` and
``jax.lax.top_k`` + cumsum (``repro/models/moe.py``'s own lines) on the same
float32 probabilities, with ties built on purpose and an overflowing
expert, give the same experts, gates and queue positions.

Tolerance of a bf16 output: n·U·max|reference|, U = 2^-9, n the places on
its path where an activation is rounded to bfloat16 (the budget of
``tests/test_torch_serve.py``): LayerNorm 1, the GELU MLP 6 (two
projections, two bias adds, the GELU, the output), attention with QKV bias
12 (the 9 of qk-norm attention and three bias adds), the MoE block 8 (router
logits, the expert's five, the combine and its output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.models import api as ref_api
from repro.models.attention import attention as ref_attention
from repro.models.attention import decode_attention as ref_decode_attention
from repro.models.common import layernorm as ref_layernorm
from repro.models.mlp import gelu_mlp as ref_gelu_mlp
from repro.models.moe import moe_block as ref_moe_block
from repro.models.moe import moe_capacity as ref_moe_capacity

from test_torch_serve import U, assert_within, bf16_pair, f32

from repro_torch.configs import SMOKE_CONFIGS
from repro_torch.models.attention import Attention
from repro_torch.models.common import COMPUTE_DTYPE, PLAIN, layernorm
from repro_torch.models.mlp import GeluMLP
from repro_torch.models.moe import MoE, moe_capacity, route

LN_SITES, GELU_SITES, ATTENTION_SITES, MOE_SITES = 1, 6, 12, 8


def ref_tree(arch, seed=0):
    """(reference cfg, numpy parameter tree) of ``arch``'s smoke config."""
    rcfg = REF_SMOKE[arch]
    params, _ = ref_api.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, jax.tree.map(np.asarray, params)


def layer0(tree):
    return jax.tree.map(lambda a: np.array(a[0]), tree)


def randomize(p, names, seed, scale=0.05):
    """``p`` with each of ``names`` replaced by seeded normal values."""
    rs = np.random.RandomState(seed)
    return {k: (scale * rs.randn(*v.shape)).astype(np.float32) if k in names else v
            for k, v in p.items()}


def to_torch(p):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


# -- LayerNorm and the GELU MLP --------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 7, 64), (3, 1280)])
def test_layernorm_matches_reference(shape):
    x, xj = bf16_pair(shape, seed=0, scale=3.0)
    rs = np.random.RandomState(1)
    w = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rs.randn(shape[-1])).astype(np.float32)
    got = layernorm(x, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    want = ref_layernorm(xj, jnp.asarray(w), jnp.asarray(b), 1e-5)
    assert got.dtype == COMPUTE_DTYPE
    assert_within(got, want, LN_SITES)


def test_layernorm_is_the_population_variance():
    """``jnp.var`` divides by n: a row [0, 2] has variance 1, not 2."""
    x = torch.tensor([[0.0, 2.0]])
    got = layernorm(x, torch.ones(2), torch.zeros(2), 0.0)
    assert got.to(torch.float32).tolist() == [[-1.0, 1.0]]


def test_gelu_mlp_matches_reference():
    rcfg, tree = ref_tree("whisper-large-v3")
    p = randomize(layer0(tree["enc"])["mlp"], ("b1", "b2"), seed=2)
    x, xj = bf16_pair((2, 9, rcfg.d_model), seed=3)
    got = GeluMLP(to_torch(p))(x)
    want = ref_gelu_mlp(jax.tree.map(jnp.asarray, p), xj)
    assert_within(got, want, GELU_SITES)


# -- attention: QKV bias, cross-attention ------------------------------------------


def test_attention_with_qkv_bias_matches_reference():
    rcfg, tree = ref_tree("qwen1.5-0.5b")
    cfg = SMOKE_CONFIGS["qwen1.5-0.5b"]
    p = randomize(layer0(tree["layers"])["attn"], ("bq", "bk", "bv"), seed=4, scale=0.5)
    attn = Attention(cfg, to_torch(p))
    assert attn.bq is not None and attn.bq.dtype == COMPUTE_DTYPE
    x, xj = bf16_pair((2, 12, cfg.d_model), seed=5)
    pos = np.arange(12)[None]
    out, (k, v) = attn(x, torch.from_numpy(pos))
    want, (wk, wv) = ref_attention(rcfg, jax.tree.map(jnp.asarray, p), xj,
                                   positions=jnp.asarray(pos))
    for g, w in ((out, want), (k, wk), (v, wv)):
        assert_within(g, w, ATTENTION_SITES)
    # the biases are seen: without them the output moves past the budget
    unbiased = Attention(cfg, to_torch(layer0(tree["layers"])["attn"]))
    moved = float(np.abs(f32(unbiased(x, torch.from_numpy(pos))[0]) - f32(want)).max())
    assert moved > ATTENTION_SITES * U * float(np.abs(f32(want)).max())


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"])
@pytest.mark.parametrize("sk", [17, 16])
def test_cross_attention_prefill_matches_reference(arch, sk):
    """Non-causal, no RoPE, Sk ≠ Sq; 17 and 16 keys are ragged against
    every block."""
    rcfg, tree = ref_tree(arch)
    cfg = SMOKE_CONFIGS[arch]
    p = (layer0(tree["groups"]["cross"])["attn"] if cfg.family == "vlm"
         else layer0(tree["dec"])["cross"])
    assert "bq" not in p and "q_norm" not in p
    attn = Attention(cfg, to_torch(p), cross=True)
    x, xj = bf16_pair((2, 12, cfg.d_model), seed=6)
    kv, kvj = bf16_pair((2, sk, cfg.d_model), seed=7)
    out, (k, v) = attn(x, None, causal=False, kv_x=kv, rope=False)
    want, (wk, wv) = ref_attention(rcfg, jax.tree.map(jnp.asarray, p), xj,
                                   positions=jnp.arange(12)[None], causal=False, kv_x=kvj,
                                   kv_positions=jnp.arange(sk)[None], rope=False)
    assert k.shape == (2, sk, cfg.n_kv_heads, cfg.hd)
    for g, w in ((out, want), (k, wk), (v, wv)):
        assert_within(g, w, ATTENTION_SITES)
    out_plain, _ = attn(x, None, PLAIN, causal=False, kv_x=kv, rope=False)
    assert torch.equal(out_plain, out)  # on the CPU both run the plain versions


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"])
def test_cross_attention_decode_matches_reference(arch):
    """One token against a cross cache: no mask, no update, no RoPE."""
    rcfg, tree = ref_tree(arch)
    cfg = SMOKE_CONFIGS[arch]
    p = (layer0(tree["groups"]["cross"])["attn"] if cfg.family == "vlm"
         else layer0(tree["dec"])["cross"])
    attn = Attention(cfg, to_torch(p), cross=True)
    ck, ckj = bf16_pair((2, 17, cfg.n_kv_heads, cfg.hd), seed=8)
    cv, cvj = bf16_pair((2, 17, cfg.n_kv_heads, cfg.hd), seed=9)
    x, xj = bf16_pair((2, 1, cfg.d_model), seed=10)
    before = ck.clone()
    out = attn.decode_cross(x, ck, cv)
    want, wk, _ = ref_decode_attention(rcfg, jax.tree.map(jnp.asarray, p), xj, ckj, cvj,
                                       jnp.int32(5), cross=True)
    assert_within(out, want, ATTENTION_SITES)
    assert torch.equal(ck, before) and np.array_equal(f32(ck), f32(wk))


# -- MoE ---------------------------------------------------------------------------


def ref_route(probs, k, capacity):
    """``repro/models/moe.py::moe_block``'s routing lines on float32 probs."""
    gate, sel = jax.lax.top_k(probs, k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    e = probs.shape[-1]
    sel_oh = jax.nn.one_hot(sel, e, dtype=jnp.float32)
    g, t = probs.shape[:2]
    flat = sel_oh.reshape(g, t * k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(g, t, k, e)
    pos = (pos * sel_oh).sum(-1)
    return np.asarray(sel), np.asarray(gate), np.asarray(pos).astype(np.int64), capacity


def _tied_probs(g, t, e, seed):
    """Rows of probabilities drawn from a few levels, so that most rows hold
    ties, plus rows of all-equal values and an expert that every token
    prefers (it overflows)."""
    rs = np.random.RandomState(seed)
    levels = rs.randint(1, 5, size=(g, t, e)).astype(np.float32)
    levels[:, ::3, 0] = 9.0           # expert 0 tops every third token: overflow
    levels[:, 1::7, :] = 2.0          # all-equal rows: the lowest indices win
    return levels / levels.sum(-1, keepdims=True)


@pytest.mark.parametrize("g,t,e,k,capacity", [(2, 24, 4, 2, 4), (1, 64, 8, 4, 4),
                                               (3, 5, 32, 8, 1)])
def test_routing_equals_top_k_and_cumsum_exactly(g, t, e, k, capacity):
    probs = _tied_probs(g, t, e, seed=g * 100 + t)
    assert (np.sort(probs, -1)[..., 1:] == np.sort(probs, -1)[..., :-1]).any()  # ties
    r = route(torch.from_numpy(probs), k, capacity)
    sel, gate, pos, _ = ref_route(jnp.asarray(probs), k, capacity)
    assert np.array_equal(r.sel.numpy(), sel)
    assert np.array_equal(r.gate.numpy(), gate)  # bitwise
    assert np.array_equal(r.pos.numpy(), pos)
    assert np.array_equal(r.kept.numpy(), pos < capacity)
    assert (~r.kept).any() and r.kept.any()  # something overflows, something fits


def test_routing_takes_the_lower_index_on_a_tie():
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3]]])
    r = route(probs, 2, 4)
    assert r.sel.tolist() == [[[0, 1], [1, 2]]]
    assert r.pos.tolist() == [[[0, 0], [1, 0]]]  # token-major: token 1's expert 1 is second


def test_capacity_matches_reference():
    for arch in ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"):
        m = SMOKE_CONFIGS[arch].moe
        for group in (1, 8, 33, 512, 1024):
            assert moe_capacity(m, group) == ref_moe_capacity(REF_SMOKE[arch].moe, group)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("s", [8, 1])
def test_moe_block_matches_reference(arch, s):
    rcfg, tree = ref_tree(arch)
    cfg = SMOKE_CONFIGS[arch]
    p = layer0(tree["layers"])["moe"]
    x, xj = bf16_pair((3, s, cfg.d_model), seed=11)
    got = MoE(cfg, to_torch(p))(x)
    want, _ = ref_moe_block(rcfg, jax.tree.map(jnp.asarray, p), xj)
    assert got.shape == x.shape and got.dtype == COMPUTE_DTYPE
    assert_within(got, want, MOE_SITES)


def test_moe_block_matches_reference_where_capacity_drops():
    """Every token prefers expert 0: with 32 tokens a group and 20 slots an
    expert, 12 choices are dropped; both packages drop the same ones."""
    arch = "phi3.5-moe-42b-a6.6b"
    rcfg, tree = ref_tree(arch)
    cfg = SMOKE_CONFIGS[arch]
    p = layer0(tree["layers"])["moe"]
    rs = np.random.RandomState(12)
    c = rs.randn(cfg.d_model).astype(np.float32)
    p["router"][:, 0] = 10.0 * c / float(c @ c)
    x, xj = bf16_pair((2, 32, cfg.d_model), seed=13, scale=0.3)
    x = (x.to(torch.float32) + torch.from_numpy(c)).to(COMPUTE_DTYPE)
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.bfloat16)
    moe = MoE(cfg, to_torch(p))
    r = moe.routing(x)
    assert moe_capacity(cfg.moe, 32) == 20 and int((~r.kept).sum()) == 2 * 12
    want, _ = ref_moe_block(rcfg, jax.tree.map(jnp.asarray, p), xj)
    assert_within(moe(x), want, MOE_SITES)
