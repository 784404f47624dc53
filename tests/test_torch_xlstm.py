"""The port's xLSTM serving path agrees with the JAX reference.

The smoke config of xlstm-1.3b (4 layers in 2 groups of 1 mLSTM + 1 sLSTM
block, d 64, 2 heads, vocab 256) runs with ``repro``'s own parameters,
carried across as numpy by ``params_from_numpy``. Prompts of 8 tokens (one
chunk) and 256 tokens (two chunks of 128, so the state carried between
chunks is exercised). No test builds the full-width model.

Tolerances, as in ``tests/test_torch_serve.py``: n·2^-9·max|reference|, n
the places on the path where an activation is rounded to bfloat16, at each
of which the two frameworks may round one step apart. The mLSTM cell has 12
such sites: the q, k, v, gate and output-gate projections (5), ``repro``'s
bfloat16 rounding of W, of C_prev and of the two products W·v and q·C
(4: the port's kernel computes them in float32 instead), the cell output the
kernel writes in bfloat16 (1), the gated output (1) and the output
projection (1). An mLSTM block adds its norm and residual (14); an sLSTM
block has 12 (the input projection and bias, the recurrent product, the
hidden states, the output projection, the three feed-forward products, the
GELU, the gated product, its norm and residual); the model adds the final
norm and the head. The states (C, n, m; c, n, h, m) are updated in float32
on both sides from the same bfloat16 k and v, so a block's states are held
to one site, 2^-9·max|reference|; the readings are below 1e-5 of max.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.models.xlstm import mlstm_chunked, mlstm_decode_step, slstm_seq

from repro_torch.configs import SMOKE_CONFIGS, get_config, resolve_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import api
from repro_torch.models.common import COMPUTE_DTYPE, KERNELS, PLAIN

U = 2.0 ** -9
MLSTM_CELL_SITES, MLSTM_BLOCK_SITES, SLSTM_SITES = 12, 14, 12
ARCH = "xlstm-1.3b"


def model_sites(cfg) -> int:
    n_s = cfg.n_layers // cfg.slstm_every
    return MLSTM_BLOCK_SITES * (cfg.n_layers - n_s) + SLSTM_SITES * n_s + 2


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_within(got, want, sites: int) -> None:
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err, tol = float(np.abs(got - want).max()), sites * U * float(np.abs(want).max())
    assert np.isfinite(got).all() and err <= tol, (err, tol)


def bf16_pair(shape, seed):
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    x = x.to(COMPUTE_DTYPE)
    return x, jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def smoke():
    """(reference cfg, reference params, the port's cfg and model)."""
    rcfg = REF_SMOKE[ARCH]
    params, _ = ref_api.init_params(rcfg, jax.random.PRNGKey(0))
    cfg = SMOKE_CONFIGS[ARCH]
    return rcfg, params, cfg, api.params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")


# -- configs and parameters -----------------------------------------------------


@pytest.mark.parametrize("smoke_cfg", [False, True], ids=["full", "smoke"])
def test_config_equals_reference(smoke_cfg):
    want = REF_SMOKE[ARCH] if smoke_cfg else ref_get_config(ARCH)
    got = resolve_config(ARCH, smoke=smoke_cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


def test_full_width_config():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab, cfg.slstm_every) == (
        "ssm", 48, 2048, 4, 50304, 8)
    # the analytic count, as repro has it; the model holds 2,220,124,160
    assert cfg.param_count() == 1_716_195_328
    assert api.cache_shape(cfg, 4, 528)["m"]["C"][0] == (6, 7, 4, 4, 1024, 1024)


def test_model_holds_the_reference_parameter_tree(smoke):
    """Every tensor of ``repro``'s tree; ``param_count()`` is not their sum
    (ROADMAP.md §3)."""
    _, params, cfg, model = smoke
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == want != cfg.param_count()
    assert len(model.groups) == 2 and len(model.groups[0].m) == 1
    cell = model.groups[1].m[0].cell
    assert cell.wq.shape == params["groups"]["m"]["cell"]["wq"].shape[2:]
    assert cell.wq.dtype == COMPUTE_DTYPE and model.groups[0].s_ln.dtype == torch.float32
    assert torch.equal(model.groups[1].s.r.float(), torch.tensor(
        np.asarray(params["groups"]["s"]["r"][1].astype(jnp.bfloat16).astype(jnp.float32))))


# -- blocks ----------------------------------------------------------------------


def _mlstm_params(params, g=0):
    return jax.tree.map(lambda a: a[g, 0], params["groups"]["m"]["cell"])


@pytest.mark.parametrize("S", [8, 256])
def test_mlstm_block_matches_reference(smoke, S):
    rcfg, params, cfg, model = smoke
    x, xj = bf16_pair((2, S, cfg.d_model), seed=S)
    with torch.no_grad():
        y, state = model.groups[0].m[0].cell(x)
    want, wstate = mlstm_chunked(rcfg, _mlstm_params(params), xj)
    assert y.dtype == COMPUTE_DTYPE
    assert_within(y, want, MLSTM_CELL_SITES)
    for name in ("C", "n", "m"):
        assert state[name].dtype == torch.float32
        assert_within(state[name], wstate[name], 1)


def test_mlstm_decode_matches_reference(smoke):
    """One step from the state a 256-token prefill left, in both packages."""
    rcfg, params, cfg, model = smoke
    x, xj = bf16_pair((2, 256, cfg.d_model), seed=3)
    x1, x1j = bf16_pair((2, 1, cfg.d_model), seed=4)
    p = _mlstm_params(params, 1)
    cell = model.groups[1].m[0].cell
    _, wstate = mlstm_chunked(rcfg, p, xj)
    state = {k: torch.tensor(np.asarray(a)) for k, a in wstate.items()}
    with torch.no_grad():
        y, new = cell.decode(x1, state)
    want, wnew = mlstm_decode_step(rcfg, p, x1j, wstate)
    assert_within(y, want, MLSTM_CELL_SITES)
    for name in ("C", "n", "m"):
        assert_within(new[name], wnew[name], 1)


@pytest.mark.parametrize("S", [8, 256])
def test_slstm_block_matches_reference(smoke, S):
    rcfg, params, cfg, model = smoke
    x, xj = bf16_pair((2, S, cfg.d_model), seed=10 + S)
    with torch.no_grad():
        y, state = model.groups[1].s(x)
    want, wstate = slstm_seq(rcfg, jax.tree.map(lambda a: a[1], params["groups"]["s"]), xj)
    assert_within(y, want, SLSTM_SITES)
    for name in ("c", "n", "h", "m"):
        assert_within(state[name], wstate[name], 1)


# -- the whole slice -------------------------------------------------------------


@pytest.mark.parametrize("batch,prompt_len", [(2, 8), (1, 256)])
def test_prefill_and_teacher_forced_decode_match_reference(smoke, batch, prompt_len):
    rcfg, params, cfg, model = smoke
    steps = 4
    max_seq = prompt_len + steps
    sites = model_sites(cfg)
    toks = np.random.RandomState(prompt_len).randint(0, cfg.vocab, (batch, prompt_len))
    want, rcache = jax.jit(lambda p, t: ref_api.prefill(rcfg, p, {"tokens": t}, max_seq))(
        params, jnp.asarray(toks, jnp.int32))
    got, cache = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks)}, max_seq)
    assert got.shape == (batch, 1, cfg.vocab) and got.dtype == COMPUTE_DTYPE
    assert_within(got, want, sites)
    for part in ("m", "s"):
        for name, t in cache[part].items():
            assert t.shape == rcache[part][name].shape
            assert_within(t, rcache[part][name], sites)

    decode = jax.jit(lambda p, c, t, pos: ref_api.decode_step(rcfg, p, c, t, pos))
    tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]
    for i in range(steps):  # both sides get the reference's tokens
        want, rcache = decode(params, rcache, jnp.asarray(tok, jnp.int32),
                              jnp.int32(prompt_len + i))
        got, cache = api.decode_step(cfg, model, cache, torch.from_numpy(tok), prompt_len + i)
        assert got.shape == (batch, 1, cfg.vocab)
        assert_within(got, want, sites)
        tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]
    for name, t in cache["m"].items():
        assert_within(t, rcache["m"][name], sites)


def test_kernel_and_plain_paths_agree_on_cpu(smoke):
    """On the CPU both pairs run the plain versions: the same logits."""
    _, _, cfg, model = smoke
    toks = torch.from_numpy(np.random.RandomState(7).randint(0, cfg.vocab, (2, 128)))
    got, _ = api.prefill(cfg, model, {"tokens": toks}, 130, KERNELS)
    want, _ = api.prefill(cfg, model, {"tokens": toks}, 130, PLAIN)
    assert torch.equal(got, want)


def test_float32_copy_computes_in_float32(smoke):
    """A float32 copy of the model takes its working type from its weights:
    float32 logits near the bfloat16 model's, with no option passed."""
    _, _, cfg, model = smoke
    twin = copy.deepcopy(model).float()
    toks = torch.from_numpy(np.random.RandomState(8).randint(0, cfg.vocab, (2, 128)))
    lo, cache = api.prefill(cfg, twin, {"tokens": toks}, 130)
    assert lo.dtype == torch.float32 and cache["m"]["C"].dtype == torch.float32
    ref, _ = api.prefill(cfg, model, {"tokens": toks}, 130)
    assert_within(lo, ref, model_sites(cfg))
    step, _ = api.decode_step(cfg, twin, cache, lo[:, -1].argmax(-1, keepdim=True), 128)
    assert step.dtype == torch.float32 and bool(torch.isfinite(step).all())


def test_cache_shape_matches_reference():
    rcfg, cfg = REF_SMOKE[ARCH], SMOKE_CONFIGS[ARCH]
    want, _ = ref_api.cache_shape(rcfg, 3, 20)
    got = api.cache_shape(cfg, 3, 20)
    for part in ("m", "s"):
        assert set(got[part]) == set(want[part])
        for name, (shape, dtype) in got[part].items():
            assert shape == tuple(want[part][name].shape) and dtype == torch.float32


def test_prefill_rejects_a_ragged_prompt(smoke):
    _, _, cfg, model = smoke
    with pytest.raises(ValueError, match="128"):
        api.prefill(cfg, model, {"tokens": torch.zeros(1, 200, dtype=torch.int64)}, 201)


def test_serve_smoke_on_cpu():
    report = {}
    seqs = serve_mod.serve(ARCH, 2, 8, 4, smoke=True, seed=0, device="cpu", report=report)
    assert seqs.shape == (2, 4) and seqs.dtype == torch.int64
    assert int(seqs.min()) >= 0 and int(seqs.max()) < SMOKE_CONFIGS[ARCH].vocab
    assert report["prefill_ms"] > 0 and report["decode_ms_per_token"] > 0
    assert torch.equal(seqs, serve_mod.serve(ARCH, 2, 8, 4, smoke=True, seed=0, device="cpu"))


def test_serve_cli_on_cpu(capsys):
    rc = serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "1",
                         "--prompt-len", "128", "--gen", "2"])
    assert rc == 0 and "[serve] xlstm-1.3b: batch=1" in capsys.readouterr().out


def test_cuda_requests_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mod.serve(ARCH, 1, 8, 2, smoke=True)  # the default device is "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        api.init_params(SMOKE_CONFIGS[ARCH])
