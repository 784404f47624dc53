"""The port's flash attention agrees with the JAX reference.

Tolerance: ``repro``'s own for this kernel (tests/test_kernels.py), 0.05
absolute and relative in bfloat16 and 2e-5 in float32. The port's CPU path
is the exact-softmax plain version; the Pallas kernel and
``blockwise_attention`` round the unnormalised probabilities to bfloat16
before the PV product, a relative change of at most 2^-8 per term, and
every output is rounded to bfloat16 (2^-8 relative): far inside 0.05 for
outputs of order one. In float32 only the order of the sums differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bkv
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import blockwise_attention

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import from_bkv, to_bkv
from repro_torch.kernels.flash_attention.ref import attention_plain, flash_bound

TOL = {torch.bfloat16: 0.05, torch.float32: 2e-5}
JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
DTYPES = [torch.bfloat16, torch.float32]
# (B, Sq, Sk, H, KV, hd, causal)
CASES = {
    "gqa2_hd16": (2, 32, 32, 4, 2, 16, True),
    "gqa4": (2, 64, 64, 8, 2, 64, True),
    "tail40": (1, 40, 40, 4, 2, 64, True),
    "mha_hd128": (1, 48, 48, 2, 2, 128, True),
    "noncausal_sk_ne_sq": (2, 24, 56, 4, 4, 64, False),
    "noncausal_gqa_tail": (1, 40, 24, 8, 2, 32, False),
    "hd112_mha": (1, 48, 48, 2, 2, 112, True),  # Zamba2's shared attention width
}


def inputs(case, dtype, seed=0):
    b, sq, sk, h, kv, hd, _ = case
    rng = np.random.RandomState(seed)
    ts = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
          for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]
    js = [jnp.asarray(t.to(torch.float32).numpy()).astype(JAX_DTYPE[dtype]) for t in ts]
    return ts, js


def close(got: torch.Tensor, want, dtype) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_matches_pallas_interpret(case, dtype):
    (q, k, v), (qj, kj, vj) = inputs(case, dtype)
    got = ops.flash_attention(q, k, v, causal=case[-1])
    assert got.dtype == dtype and got.shape == q.shape
    want = jax_flash_attention(qj, kj, vj, causal=case[-1], block_k=min(64, case[2]),
                               interpret=True)
    close(got, want, dtype)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_matches_blockwise_attention(case):
    """Against the model's own online-softmax path, which the prefill of
    ``repro.models.attention.attention`` runs (in bf16 whatever its inputs)."""
    (q, k, v), (qj, kj, vj) = inputs(case, torch.bfloat16, seed=1)
    got = ops.flash_attention(q, k, v, causal=case[-1])
    close(got, blockwise_attention(qj, kj, vj, causal=case[-1]), torch.bfloat16)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_plain_matches_attention_ref_in_kernel_layout(case):
    """float32, where the two exact softmaxes differ only in summation order."""
    dtype = torch.float32
    (q, k, v), _ = inputs(case, dtype, seed=2)
    qg, kg, vg = to_bkv(q, k, v)
    b, sq, sk, h, kv, hd, causal = case
    assert qg.shape == (b * kv, sq, h // kv, hd) and kg.shape == (b * kv, sk, hd)
    got = attention_plain(qg, kg, vg, causal=causal)
    as_jax = [jnp.asarray(t.to(torch.float32).numpy()).astype(JAX_DTYPE[dtype])
              for t in (qg, kg, vg)]
    close(got, attention_ref(*as_jax, causal=causal), dtype)
    assert torch.equal(from_bkv(got, b), ops.flash_attention(q, k, v, causal=causal))


def test_layout_round_trip_matches_reference_regroup():
    """``to_bkv`` groups the G query heads of one KV head together, as
    ``repro/kernels/flash_attention/ops.py`` does; ``from_bkv`` inverts it."""
    (q, k, v), (qj, kj, _) = inputs(CASES["gqa4"], torch.float32, seed=3)
    qg, kg, _ = to_bkv(q, k, v)
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    want_q = qj.reshape(b, sq, kv, h // kv, hd).transpose(0, 2, 1, 3, 4).reshape(
        b * kv, sq, h // kv, hd)
    want_k = kj.transpose(0, 2, 1, 3).reshape(b * kv, -1, hd)
    assert np.array_equal(qg.numpy(), np.asarray(want_q))
    assert np.array_equal(kg.numpy(), np.asarray(want_k))
    assert torch.equal(from_bkv(qg, b), q)


def test_first_token_attends_only_itself():
    (q, k, v), _ = inputs((1, 32, 32, 4, 4, 64, True), torch.float32, seed=4)
    o = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(o[:, 0].numpy(), v[:, 0].numpy(), atol=2e-5, rtol=2e-5)


def test_heads_not_a_multiple_of_kv_heads_raise():
    (q, k, v), _ = inputs((1, 8, 8, 3, 2, 16, True), torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, v)


def test_flash_bound_holds_the_kernels_rounding_and_rejects_the_control():
    """``flash_bound`` (the bf16 kernel's check on the card) admits the plain
    path against itself and ``repro``'s Pallas kernel, which rounds p to
    bfloat16 before PV as the CUDA kernel does; it rejects the fault control
    of the per-layer check, the plain output × (1 + 2^-5) past position 64."""
    b, s, h, kv, hd = 2, 160, 8, 2, 64
    (q, k, v), _ = inputs((b, s, s, h, kv, hd, True), torch.bfloat16, seed=5)
    qg, kg, vg = to_bkv(q, k, v)
    want = attention_plain(qg, kg, vg, causal=True)
    bound = flash_bound(qg, kg, vg, want, True)
    assert bound.shape == want.shape and bound.dtype == torch.float32

    def share(got):
        return ((got.to(torch.float32) - want.to(torch.float32)).abs() / bound)[:, 64:].max()

    assert share(attention_plain(qg, kg, vg, causal=True)) == 0
    as_jax = [jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)
              for t in (qg, kg, vg)]
    pallas = flash_attention_bkv(*as_jax, causal=True, blk_q=32, blk_k=32, interpret=True)
    got = torch.from_numpy(np.array(pallas.astype(jnp.float32)))
    assert 0 < share(got) <= 1
    bad = want.to(torch.float32)
    bad[:, 64:] *= 1.0 + 2.0 ** -5
    assert share(bad.to(torch.bfloat16)) > 1


# (B, Sq rows, Sk, H, KV, hd, q_start): a causal query shard, the rows of a
# longer sequence from q_start on against that sequence's keys whole
ROWS_CASES = {
    "last_quarter": (2, 16, 64, 4, 2, 64, 48),
    "middle_rows_tail": (1, 24, 56, 8, 2, 32, 13),
    "rows_past_the_keys": (1, 8, 20, 4, 4, 16, 30),
}


@pytest.mark.parametrize("case", ROWS_CASES.values(), ids=ROWS_CASES.keys())
def test_q_start_matches_blockwise_attention_with_offset_positions(case):
    """The plain path's rows from ``q_start`` against ``repro``'s
    ``blockwise_attention`` with ``q_positions`` from ``q_start`` on; the
    same rows from position 0 (the control) miss; the dry-run count of the
    visible pairs is the mask's."""
    b, sq, sk, h, kv, hd, q_start = case
    (q, k, v), (qj, kj, vj) = inputs((b, sq, sk, h, kv, hd, True), torch.bfloat16, seed=6)
    want = blockwise_attention(qj, kj, vj, causal=True,
                               q_positions=jnp.arange(q_start, q_start + sq)[None, :])
    close(ops.flash_attention(q, k, v, causal=True, q_start=q_start), want, torch.bfloat16)
    with pytest.raises(AssertionError):
        close(ops.flash_attention(q, k, v, causal=True), want, torch.bfloat16)
    mask = np.arange(q_start, q_start + sq)[:, None] >= np.arange(sk)[None, :]
    assert ops._visible_pairs(sq, sk, True, q_start) == int(mask.sum())
    assert ops.flash_attention(q, k, v, causal=True, q_start=0).equal(
        ops.flash_attention(q, k, v, causal=True))
