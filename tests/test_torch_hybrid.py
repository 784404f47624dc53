"""The port's hybrid family (zamba2-7b) against the JAX reference.

The Mamba2 block (``repro_torch.models.ssm``) against ``repro.models.ssm``
at one, two-thirds of one and three chunks, from the zero state and from a
seeded one, its decode step, and its chunked prefill against its own
step-by-step recurrence; then the whole model (``repro``'s smoke config,
and the same with a fifth layer, which gives 2 groups and 1 tail block)
through ``api.prefill`` and teacher-forced ``api.decode_step`` against
``repro``'s, logits and every cache leaf, on ``repro``'s parameters
carried across as numpy with ``A_log``, ``dt_bias`` and ``D`` drawn at
random (``repro`` makes them 0, 0 and 1, which gives every head the same
decay); then serving: the CLI, greedy tokens, the prompt-length rule, and
a planned request whose cache has ``"tail": None`` through the runtime's
packets and ``DirNVM``.

Tolerance: n·U·max|reference|, U = 2^-9, n the bf16 rounding sites on the
output's path (the budget of ``tests/test_torch_serve.py``). The Mamba2
cell has 15: the input projection, the conv's four tap products and three
adds, its silu, the scores, the intra-chunk product, the output, silu(z),
the gated product and the output projection; a block adds its norm and
residual (17). The shared block has 16: the norm over the 2d concat, the
q/k/v projections, RoPE of q and k, attention, the output projection, the
residual, the MLP norm, SwiGLU's 5 and its residual. The model adds the
final norm and the head. A block's float32 state is held to the sites
before it (the projection and the conv, 9): both sides update it in float32
from bfloat16 inputs that may sit one step apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models import api as ref_api
from repro.models.common import KeyGen
from repro.models.ssm import init_mamba as ref_init_mamba
from repro.models.ssm import mamba_chunked as ref_mamba_chunked
from repro.models.ssm import mamba_decode_step as ref_mamba_decode_step

from test_torch_serve import assert_within, f32

from repro_torch.configs import SMOKE_CONFIGS, get_config, resolve_config
from repro_torch.core.runtime import DirNVM, PowerFailure
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.planner import build_table_for_arch
from repro_torch.models import api
from repro_torch.models.common import COMPUTE_DTYPE, KERNELS, PLAIN
from repro_torch.models.ssm import CHUNK, Mamba2, mamba_dims

ARCH = "zamba2-7b"
CELL_SITES, BLOCK_SITES, SHARED_SITES, STATE_SITES = 15, 17, 16, 9
RANDOM_LEAVES = {"A_log": (0.0, 1.0), "dt_bias": (0.0, 0.5), "D": (1.0, 0.3)}  # (mean, sd)


def model_sites(cfg) -> int:
    return BLOCK_SITES * cfg.n_layers + SHARED_SITES * (cfg.n_layers // cfg.attn_every) + 2


def configs(layers):
    """(reference cfg, port cfg) of the smoke config with ``layers`` layers."""
    return (dataclasses.replace(REF_SMOKE[ARCH], n_layers=layers),
            dataclasses.replace(SMOKE_CONFIGS[ARCH], n_layers=layers))


def randomised(tree, seed):
    """``tree`` with A_log, dt_bias and D drawn at random (RANDOM_LEAVES)."""
    rs = np.random.RandomState(seed)

    def fill(path, a):
        name = getattr(path[-1], "key", None)
        if name in RANDOM_LEAVES:
            mean, sd = RANDOM_LEAVES[name]
            return (mean + sd * rs.randn(*a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fill, tree)


def ref_model(layers, seed=0):
    """(reference cfg, its parameters, the port's cfg and model)."""
    rcfg, cfg = configs(layers)
    params, _ = ref_api.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = randomised(jax.tree.map(np.asarray, params), seed + 1)
    return rcfg, jax.tree.map(jnp.asarray, tree), cfg, api.params_from_numpy(cfg, tree, "cpu")


@pytest.fixture(scope="module")
def block():
    """(reference cfg and Mamba2 parameters, the port's block)."""
    rcfg, cfg = configs(4)
    p, _ = ref_init_mamba(rcfg, KeyGen(jax.random.PRNGKey(3)))
    p = randomised(jax.tree.map(np.asarray, p), 4)
    return rcfg, jax.tree.map(jnp.asarray, p), Mamba2(cfg, {
        k: torch.from_numpy(np.array(a)) for k, a in p.items()})


def bf16_pair(shape, seed, scale=1.0):
    x = torch.from_numpy((scale * np.random.RandomState(seed).randn(*shape))
                         .astype(np.float32)).to(COMPUTE_DTYPE)
    return x, jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.bfloat16)


def seeded_state(cfg, batch, seed):
    """A nonzero Mamba2 state as (torch, jax) float32 dicts."""
    d_in, H, P, N = mamba_dims(cfg)
    rs = np.random.RandomState(seed)
    a = {"ssm": 0.5 * rs.randn(batch, H, P, N), "conv": rs.randn(batch, 3, d_in + 2 * N)}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    return ({k: torch.from_numpy(v) for k, v in a.items()},
            {k: jnp.asarray(v) for k, v in a.items()})


# -- configs and parameters -----------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_reference(smoke):
    want = REF_SMOKE[ARCH] if smoke else ref_get_config(ARCH)
    got = resolve_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hd == want.hd and got.param_count() == want.param_count()


def test_full_width_config_and_what_it_holds():
    """81 layers = 13 groups of 6 and 3 tail blocks, MHA at hd 112;
    ``param_count()`` (as ``repro`` has it) leaves out in_proj's 2N + H
    columns, the conv, A_log, D, the block norms and the shared block's 2d
    input: the reference's abstract tree holds 6,788,498,000."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (
        81, 3584, 32, 32, 112)
    assert cfg.n_layers // cfg.attn_every == 13 and cfg.n_layers % cfg.attn_every == 3
    assert mamba_dims(cfg) == (7168, 112, 64, 64)
    assert cfg.param_count() == 6_678_189_056
    tree, _ = ref_api.init_params(ref_get_config(ARCH), None)
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree)) == 6_788_498_000


@pytest.mark.parametrize("layers", [4, 5], ids=["smoke", "tail"])
def test_model_holds_the_reference_parameter_tree(layers):
    rcfg, params, cfg, model = ref_model(layers)
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == want
    assert (len(model.groups), len(model.groups[0]), len(model.tail)) == (2, 2, layers - 4)
    cell = model.groups[1][0].cell
    assert cell.in_proj.dtype == COMPUTE_DTYPE and cell.A_log.dtype == torch.float32
    assert torch.equal(cell.A_log, torch.from_numpy(
        np.asarray(params["groups"]["mamba"]["cell"]["A_log"][1, 0])))
    assert model.shared.ln.shape == (2 * cfg.d_model,)


@pytest.mark.parametrize("layers", [4, 5], ids=["smoke", "tail"])
def test_cache_shape_and_bytes_match_reference(layers):
    rcfg, cfg = configs(layers)
    want, _ = ref_api.cache_shape(rcfg, 3, 20)
    got = api.cache_shape(cfg, 3, 20)
    assert sorted(got) == sorted(want)
    assert (got["tail"] is None) == (want["tail"] is None) == (layers == 4)
    for part in ("groups",) + (("tail",) if layers == 5 else ()):
        assert {n: (s, d) for n, (s, d) in got[part].items()} == {
            n: (tuple(a.shape), torch.float32) for n, a in want[part].items()}
    for name in ("attn_k", "attn_v"):
        assert got[name] == (tuple(want[name].shape), COMPUTE_DTYPE)
    assert serve_mod._cache_nbytes(cfg, 3, 20) == ref_serve._cache_nbytes(rcfg, 3, 20)


# -- the Mamba2 block -------------------------------------------------------------------

BLOCK_CASES = [(s, st) for s in (64, 128, 384) for st in (False, True)]


@pytest.mark.parametrize("S,from_state", BLOCK_CASES,
                         ids=[f"S{s}-{'state' if st else 'zero'}" for s, st in BLOCK_CASES])
def test_mamba_chunked_matches_reference(block, S, from_state):
    rcfg, p, cell = block
    x, xj = bf16_pair((2, S, rcfg.d_model), seed=S)
    state, rstate = seeded_state(rcfg, 2, S + 1) if from_state else (None, None)
    want, wstate = ref_mamba_chunked(rcfg, p, xj, rstate)
    got, gstate = cell(x, state)
    assert got.dtype == COMPUTE_DTYPE and gstate["ssm"].dtype == torch.float32
    assert_within(got, want, CELL_SITES)
    assert_within(gstate["ssm"], wstate["ssm"], STATE_SITES)
    assert torch.equal(gstate["conv"].float(), torch.from_numpy(f32(wstate["conv"])))


def test_mamba_decode_step_matches_reference(block):
    rcfg, p, cell = block
    state, rstate = seeded_state(rcfg, 3, 11)
    for i in range(4):
        x, xj = bf16_pair((3, 1, rcfg.d_model), seed=20 + i)
        want, rstate = ref_mamba_decode_step(rcfg, p, xj, rstate)
        got, state = cell.decode(x, state)
        assert_within(got, want, CELL_SITES)
        assert_within(state["ssm"], rstate["ssm"], STATE_SITES)
        assert torch.equal(state["conv"].float(), torch.from_numpy(f32(rstate["conv"])))


@pytest.mark.parametrize("S", [96, 256])
def test_chunked_prefill_equals_its_own_recurrence(block, S):
    """``repro``'s invariant (ssm.py:6-8): decode extends prefill. The
    chunked pass over S tokens against S single steps from the same seeded
    state: the output within the cell's budget (the chunked pass rounds its
    scores and intra-chunk product to bfloat16, the steps do not), the
    final float32 state within one site."""
    _, _, cell = block
    cfg = cell.cfg
    x, _ = bf16_pair((2, S, cfg.d_model), seed=S + 5)
    state, _ = seeded_state(cfg, 2, S + 6)
    want, wstate = cell(x, state)
    ys = []
    for t in range(S):
        y, state = cell.decode(x[:, t:t + 1], state)
        ys.append(y)
    assert_within(torch.cat(ys, dim=1), want, CELL_SITES)
    assert_within(state["ssm"], wstate["ssm"], 1)
    assert torch.equal(state["conv"], wstate["conv"])


def test_a_ragged_prompt_raises(block):
    _, _, cell = block
    with pytest.raises(ValueError, match="multiple of the 128-token chunk"):
        cell(torch.zeros(1, CHUNK + 64, cell.cfg.d_model, dtype=COMPUTE_DTYPE))
    _, _, cfg, model = ref_model(4)
    with pytest.raises(ValueError, match="128"):
        api.prefill(cfg, model, {"tokens": torch.zeros(1, 200, dtype=torch.int64)}, 201)
    with pytest.raises(ValueError, match="at most 128 tokens or a multiple of 128"):
        serve_mod.serve(ARCH, 1, 200, 2, smoke=True, device="cpu")


# -- the whole model ---------------------------------------------------------------------

MODEL_CASES = [(4, 2, 16), (5, 2, 16), (5, 1, 256)]


@pytest.mark.parametrize("layers,batch,prompt_len", MODEL_CASES,
                         ids=["smoke-b2-p16", "tail-b2-p16", "tail-b1-p256"])
def test_prefill_and_teacher_forced_decode_match_reference(layers, batch, prompt_len):
    rcfg, params, cfg, model = ref_model(layers)
    steps = 4
    max_seq = prompt_len + steps
    n = model_sites(cfg)
    toks = np.random.RandomState(prompt_len).randint(0, cfg.vocab, (batch, prompt_len))
    want, rcache = jax.jit(lambda p, t: ref_api.prefill(rcfg, p, {"tokens": t}, max_seq))(
        params, jnp.asarray(toks, jnp.int32))
    got, cache = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks)}, max_seq)
    assert got.shape == (batch, 1, cfg.vocab) and got.dtype == COMPUTE_DTYPE
    assert_within(got, want, n)

    def leaves_match():
        assert sorted(cache) == sorted(rcache)
        assert (cache["tail"] is None) == (rcache["tail"] is None) == (layers == 4)
        for part in ("groups", "tail"):
            for name, t in (cache[part] or {}).items():
                assert t.dtype == torch.float32 and t.shape == rcache[part][name].shape
                assert_within(t, rcache[part][name], n)  # values: repro's conv is bf16
        for name in ("attn_k", "attn_v"):
            assert cache[name].shape == rcache[name].shape
            assert_within(cache[name], rcache[name], n)

    leaves_match()
    decode = jax.jit(lambda p, c, t, pos: ref_api.decode_step(rcfg, p, c, t, pos))
    tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]
    for i in range(steps):  # both sides get the reference's tokens
        want, rcache = decode(params, rcache, jnp.asarray(tok, jnp.int32),
                              jnp.int32(prompt_len + i))
        got, cache = api.decode_step(cfg, model, cache, torch.from_numpy(tok), prompt_len + i)
        assert_within(got, want, n)
        tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]
    leaves_match()


def test_decode_updates_the_cache_in_place():
    """A decode step writes into the cache it was handed (what a CUDA graph
    replays), and a tensor position gives the int position's logits."""
    _, _, cfg, model = ref_model(5)
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab, (2, 8)))
    _, cache = api.prefill(cfg, model, {"tokens": toks}, 12)
    ptrs = [t.data_ptr() for t in serve_mod._leaves(cache)]
    twin = serve_mod._map(torch.clone, cache)
    tok = toks[:, -1:]
    got, out = api.decode_step(cfg, model, cache, tok, 8)
    want, _ = api.decode_step(cfg, model, twin, tok, torch.tensor(8))
    assert out is cache and [t.data_ptr() for t in serve_mod._leaves(out)] == ptrs
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(serve_mod._leaves(cache),
                                                 serve_mod._leaves(twin)))


def test_kernel_and_plain_paths_agree_on_cpu():
    _, _, cfg, model = ref_model(5)
    toks = torch.from_numpy(np.random.RandomState(7).randint(0, cfg.vocab, (2, 128)))
    got, _ = api.prefill(cfg, model, {"tokens": toks}, 130, KERNELS)
    want, _ = api.prefill(cfg, model, {"tokens": toks}, 130, PLAIN)
    assert torch.equal(got, want)


# -- serving ----------------------------------------------------------------------------


def test_serve_cli_on_cpu(capsys):
    rc = serve_mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                         "--prompt-len", "16", "--gen", "3"])
    assert rc == 0 and f"[serve] {ARCH}: batch=2 prefill(16 tok)" in capsys.readouterr().out


def test_serve_greedy_tokens_follow_the_model():
    cfg = SMOKE_CONFIGS[ARCH]
    prompt_len, gen = 8, 4
    model = api.init_params(cfg, seed=5, device="cpu")
    seqs = serve_mod.serve(ARCH, 2, prompt_len, gen, smoke=True, seed=5, device="cpu",
                           params=model)
    prompts = torch.randint(0, cfg.vocab, (2, prompt_len),
                            generator=torch.Generator().manual_seed(6))
    logits, cache = api.prefill(cfg, model, {"tokens": prompts}, prompt_len + gen)
    toks = [logits[:, -1].argmax(dim=-1, keepdim=True)]
    for i in range(gen - 1):
        logits, cache = api.decode_step(cfg, model, cache, toks[-1], prompt_len + i)
        toks.append(logits[:, -1].argmax(dim=-1, keepdim=True))
    assert seqs.tolist() == torch.cat(toks, dim=1).tolist()


def test_planned_request_carries_the_missing_tail_through_dir_nvm(tmp_path):
    """A planned smoke request (no tail: ``"tail": None`` in every state
    packet) on a table built on the port's plain sweep, 2 steps a cycle and
    one power failure, on ``DirNVM``: the tokens of unplanned serving, and
    the committed packets pickled with their None."""
    batch, prompt_len, gen = 2, 8, 6
    table = build_table_for_arch(ARCH, [(batch, prompt_len + gen)], n_q=4, smoke=True,
                                 backend="torch")
    plan = table.lookup(batch, prompt_len + gen, None)
    fired = []

    def crash(b, phase):
        if b == 1 and phase == "executed" and not fired:
            fired.append(b)
            raise PowerFailure("injected mid-request")

    nvm = DirNVM(str(tmp_path / "nvm"))
    rep = {}
    planned = serve_mod.serve(ARCH, batch, prompt_len, gen, smoke=True, device="cpu",
                              plan_table=table, energy_budget=table.e_startup + 2.2 * plan.e_total,
                              nvm=nvm, crash_hook=crash, report=rep)
    assert torch.equal(planned, serve_mod.serve(ARCH, batch, prompt_len, gen, smoke=True,
                                                device="cpu"))
    assert fired and rep["runtime_stats"].replays == 1 and len(rep["cycles"]) == 3
    stored = [n for n in (f"state{k}" for k in range(gen - 1)) if nvm.has(n)]
    assert stored and all(nvm.read(n)["cache"]["tail"] is None for n in stored)
