"""The port's chunked mLSTM cell agrees with the JAX reference.

The plain version (``mlstm_chunk_plain``, what the CUDA kernel is held to on
the card) runs here on the CPU against ``repro``'s Pallas cell in interpret
mode (``mlstm_cell(..., interpret=True)``) and its step-by-step oracle
``mlstm_ref``, on float32 inputs made with numpy from a seed, at the shapes
of ``tests/test_kernels.py`` with B 2, H 2.

Tolerance: |Δ| ≤ 1e-5·max(1, max|reference|). ``repro``'s own is 1e-3, but
both sides are float32 chunked forms of one recurrence that differ only in
the order of float32 sums (of up to hd + L terms, 2^-24 each) and in
``exp``/``log1p`` to an ulp or two; the readings are 1e-6 to 2e-5 at outputs
up to 12. The final state (C, n, m) is held to the float32 recurrence at the
same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.ops import mlstm_cell as ref_mlstm_cell
from repro.kernels.mlstm_chunk.ref import mlstm_ref

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_bh_cuda
from repro_torch.kernels.mlstm_chunk.ref import (chunk_len, mlstm_chunk_plain,
                                                 mlstm_recurrence_plain)

TOL = 1e-5
B, H = 2, 2
SHAPES = [(128, 64, 64), (256, 64, 128), (128, 128, 32), (64, 32, 64)]


def inputs(S, hd, seed=0, saturate=False):
    """q, k, v [B, S, H, hd] (scale 0.5), i [B, S, H], f + 2 as numpy float32,
    as ``tests/test_kernels.py`` draws them (the saturation case: q, k, v at
    scale 1, i = 5, f = −20)."""
    rng = np.random.RandomState(seed)
    scale = 1.0 if saturate else 0.5
    q, k, v = ((scale * rng.randn(B, S, H, hd)).astype(np.float32) for _ in range(3))
    if saturate:
        i = np.full((B, S, H), 5.0, np.float32)
        f = np.full((B, S, H), -20.0, np.float32)
    else:
        i = rng.randn(B, S, H).astype(np.float32)
        f = (rng.randn(B, S, H) + 2.0).astype(np.float32)
    return q, k, v, i, f


def fold(a: np.ndarray) -> np.ndarray:
    return a.transpose(0, 2, 1, *range(3, a.ndim)).reshape(B * H, a.shape[1], *a.shape[3:])


def close(got, want) -> None:
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    tol = TOL * max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("S,hd,chunk", SHAPES)
def test_plain_matches_pallas_interpret_and_oracle(S, hd, chunk):
    q, k, v, i, f = inputs(S, hd)
    y, (C, n, m) = ops.mlstm_cell(*map(torch.from_numpy, (q, k, v, i, f)), chunk=chunk)
    assert y.shape == (B, S, H, hd) and y.dtype == torch.float32
    assert C.shape == (B, H, hd, hd) and n.shape == (B, H, hd) and m.shape == (B, H)
    close(y, ref_mlstm_cell(*map(jnp.asarray, (q, k, v, i, f)), chunk=chunk, interpret=True))
    want = mlstm_ref(*(jnp.asarray(fold(a)) for a in (q, k, v, i, f)))
    close(ops.fold(y), want)


def test_forget_gate_saturation_stays_finite():
    q, k, v, i, f = inputs(128, 32, saturate=True)
    y, state = ops.mlstm_cell(*map(torch.from_numpy, (q, k, v, i, f)), chunk=64)
    assert all(bool(torch.isfinite(t).all()) for t in (y, *state))
    close(y, ref_mlstm_cell(*map(jnp.asarray, (q, k, v, i, f)), chunk=64, interpret=True))


@pytest.mark.parametrize("S,hd,chunk", SHAPES + [(100, 32, 128)])
def test_final_state_matches_recurrence(S, hd, chunk):
    """The state after the last chunk equals the float32 recurrence's after
    the last step, and so do the outputs; the port's recurrence is itself
    held to ``repro``'s oracle."""
    args = [torch.from_numpy(fold(a)) for a in inputs(S, hd, seed=1)]
    y, (C, n, m) = mlstm_chunk_plain(*args, chunk=chunk)
    yr, (Cr, nr, mr) = mlstm_recurrence_plain(*args)
    for got, want in ((y, yr), (C, Cr), (n, nr), (m, mr)):
        close(got, want.numpy())
    close(yr, mlstm_ref(*(jnp.asarray(a.numpy()) for a in args)))


def test_bf16_inputs_compute_in_float32():
    """bfloat16 q/k/v give the float32 result of the same values rounded
    once to bfloat16; the state stays float32."""
    args = [torch.from_numpy(fold(a)) for a in inputs(128, 64, seed=2)]
    bf = [t.to(torch.bfloat16) for t in args[:3]] + args[3:]
    y, (C, n, m) = mlstm_chunk_plain(*bf, chunk=64)
    y32, (C32, _, _) = mlstm_chunk_plain(*[t.to(torch.float32) for t in bf], chunk=64)
    assert y.dtype == torch.bfloat16 and C.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(C, C32)


def test_chunk_rule():
    assert chunk_len(512, 128) == 128 and chunk_len(100, 128) == 100
    with pytest.raises(ValueError, match="multiple"):
        chunk_len(200, 128)
    q = torch.zeros(1, 200, 1, 32)
    g = torch.zeros(1, 200, 1)
    with pytest.raises(ValueError, match="multiple"):
        ops.mlstm_cell(q, q, q, g, g)


def test_wrapper_refuses_cpu_tensors():
    q = torch.zeros(4, 128, 64, dtype=torch.bfloat16)
    g = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_chunk_bh_cuda(q, q, q, g, g)
    assert mlstm_chunk_bh_cuda.launches == 0


def test_scratch_query_is_declared():
    name = "mlstm_chunk_scratch_floats"
    argtypes, restype = _build._SIGNATURES[name]
    assert len(argtypes) == 3 and restype is _build.ctypes.c_longlong
    text = (_build._PKG / "mlstm_chunk/csrc/mlstm_chunk.cu").read_text()
    head = text[text.index(f'extern "C" long long {name}('):]
    assert len(head[head.index("(") + 1:head.index(")")].split(",")) == 3


def test_cuda_request_without_a_card_raises():
    """The op takes no device (a CPU tensor runs the plain version); the
    entry point that serves the mLSTM raises for its default "cuda"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    from repro_torch.launch import serve as serve_mod

    q = torch.zeros(1, 128, 1, 32)
    g = torch.zeros(1, 128, 1)
    y, _ = ops.mlstm_cell(q, q, q, g, g)
    assert torch.equal(y, ops.in_model_layout(mlstm_chunk_plain, q, q, q, g, g)[0])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mod.serve("xlstm-1.3b", 1, 4, 2, smoke=True)  # the default device is "cuda"
