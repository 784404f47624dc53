"""The port's RMSNorm agrees with the JAX reference.

Tolerance: 1e-2 absolute and relative, ``repro``'s own for this kernel
(tests/test_kernels.py). Both sides compute the statistics in float32 from
identical inputs; they differ in the order of the sum of squares and in
``rsqrt``'s last ulp, which can flip the rounding of a bfloat16 output by
one ulp (2^-8 relative), well inside the bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro.models.common import rmsnorm as jax_model_rmsnorm

from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain
from repro_torch.models.common import COMPUTE_DTYPE, PLAIN, rmsnorm as model_rmsnorm

TOL = 1e-2
SHAPES = [(7, 64), (2, 33, 256), (1, 1, 4096), (5, 3, 2, 128), (3, 2560)]
DTYPES = [torch.bfloat16, torch.float32]
JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def inputs(shape, dtype, seed=0):
    """x (scale 3) and w from a numpy seed; the same bits go to both sides."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((3.0 * rng.randn(*shape)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(shape[-1]).astype(np.float32))
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(JAX_DTYPE[dtype])
    return x, w, xj, jnp.asarray(w.numpy())


def close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_interpret(shape, dtype):
    x, w, xj, wj = inputs(shape, dtype)
    got = ops.rmsnorm(x, w)
    assert got.dtype == dtype and got.shape == x.shape
    close(got, jax_rmsnorm(xj, wj, interpret=True))
    close(got, rmsnorm_ref(xj, wj))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_model_rmsnorm_matches_reference_model(shape, dtype):
    """``models.common.rmsnorm`` returns bf16 whatever x's type, as
    ``repro/models/common.py`` does."""
    x, w, xj, wj = inputs(shape, dtype, seed=1)
    got = model_rmsnorm(x, w, 1e-5)
    assert got.dtype == COMPUTE_DTYPE
    close(got, jax_model_rmsnorm(xj, wj, 1e-5))
    assert torch.equal(model_rmsnorm(x, w, 1e-5, PLAIN), got)


def test_plain_is_the_cpu_path():
    x, w, _, _ = inputs((4, 3, 128), torch.bfloat16, seed=2)
    assert torch.equal(ops.rmsnorm(x, w, 1e-6), rmsnorm_plain(x, w, 1e-6))


def test_unit_mean_square():
    x, _, _, _ = inputs((16, 512), torch.float32, seed=3)
    y = ops.rmsnorm(10.0 * x, torch.ones(512))
    np.testing.assert_allclose(y.square().mean(dim=-1).numpy(), 1.0, atol=1e-3)
