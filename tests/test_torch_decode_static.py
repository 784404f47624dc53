"""The port's static-shape decode and the runtime's nested packets.

* A decode position given as a 0-d int64 tensor gives bitwise the logits
  and cache of the same position given as an int (both archs).
* The masked full-cache decode (attention over all of S_max, positions
  after ``pos`` at ``NEG_INF``) matches ``repro``'s ``decode_step``,
  teacher-forced over several steps on ``params_from_numpy`` weights, with
  the tolerance of ``tests/test_torch_serve.py``: n·2^-9·max|reference|, n
  the bf16 rounding sites on the path.
* The burst runtime stores a nested packet (a serving request's decode
  state: dicts of bf16, float32 and int64 tensors beside numpy arrays and
  scalars) through ``MemoryNVM`` and ``DirNVM`` and loads it back equal; a
  packet that is one array is stored as the same bytes as before nested
  packets existed.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.models import api as ref_api

from repro_torch.configs import SMOKE_CONFIGS
from repro_torch.core.runtime import DirNVM, HostTensor, MemoryNVM, _to_device, _to_host
from repro_torch.models import api
from repro_torch.models.common import NEG_INF

U = 2.0 ** -9
ARCHS = ["qwen3-4b", "xlstm-1.3b"]
CPU = torch.device("cpu")


def model_sites(n_layers: int) -> int:
    """tests/test_torch_serve.py's count for the dense model: 18 a layer, 2
    for the final norm and the head."""
    return 18 * n_layers + 2


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@functools.lru_cache(maxsize=None)
def prefilled(arch):
    """(cfg, model, cache after a 12-token prefill padded to 20, first token)."""
    cfg = SMOKE_CONFIGS[arch]
    model = api.init_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab, (2, 12)))
    logits, cache = api.prefill(cfg, model, {"tokens": toks}, 20)
    return cfg, model, cache, logits[:, -1].argmax(-1, keepdim=True)


@pytest.mark.parametrize("pos", [12, 15, 19])
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_is_bitwise_the_int_position(arch, pos):
    cfg, model, cache, tok = prefilled(arch)
    want, want_cache = api.decode_step(cfg, model, _clone(cache), tok, pos)
    got, got_cache = api.decode_step(cfg, model, _clone(cache), tok,
                                     torch.tensor(pos, dtype=torch.int64))
    assert torch.equal(got, want)
    for g, w in zip(_leaves(got_cache), _leaves(want_cache)):
        assert torch.equal(g, w)


def test_decode_writes_the_cache_at_pos_only():
    """The dense cache changes at position ``pos`` and nowhere else; the
    positions after it take no part in the step's logits."""
    cfg, model, cache, tok = prefilled("qwen3-4b")
    before = _clone(cache)
    logits, after = api.decode_step(cfg, model, _clone(cache), tok, 12)
    changed = (after["k"] != before["k"]).any(dim=(0, 1, 3, 4))
    assert changed.nonzero().flatten().tolist() == [12]
    noisy = _clone(cache)
    for name in ("k", "v"):
        noisy[name][:, :, 13:] = torch.randn(noisy[name][:, :, 13:].shape).to(torch.bfloat16)
    assert torch.equal(api.decode_step(cfg, model, noisy, tok, 12)[0], logits)
    assert NEG_INF == -1e30


@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
@pytest.mark.parametrize("prompt_len,max_seq", [(8, 13), (5, 24)])
def test_masked_decode_matches_reference_teacher_forced(pos_kind, prompt_len, max_seq):
    arch = "qwen3-4b"
    rcfg, cfg = REF_SMOKE[arch], SMOKE_CONFIGS[arch]
    params, _ = ref_api.init_params(rcfg, jax.random.PRNGKey(0))
    model = api.params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.RandomState(prompt_len).randint(0, cfg.vocab, (2, prompt_len))
    want, rcache = jax.jit(lambda p, t: ref_api.prefill(rcfg, p, {"tokens": t}, max_seq))(
        params, jnp.asarray(toks, jnp.int32))
    _, cache = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks)}, max_seq)
    decode = jax.jit(lambda p, c, t, pos: ref_api.decode_step(rcfg, p, c, t, pos))
    tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]
    for pos in range(prompt_len, min(prompt_len + 4, max_seq)):
        want, rcache = decode(params, rcache, jnp.asarray(tok, jnp.int32), jnp.int32(pos))
        p = pos if pos_kind == "int" else torch.tensor(pos)
        got, cache = api.decode_step(cfg, model, cache, torch.from_numpy(tok), p)
        err = float(np.abs(f32(got) - f32(want)).max())
        tol = model_sites(cfg.n_layers) * U * float(np.abs(f32(want)).max())
        assert np.isfinite(f32(got)).all() and err <= tol, (pos, err, tol)
        for name in ("k", "v"):
            kerr = float(np.abs(f32(cache[name]) - f32(rcache[name])).max())
            assert kerr <= model_sites(cfg.n_layers) * U * float(
                np.abs(f32(rcache[name])).max()), (name, kerr)
        tok = np.argmax(f32(want)[:, -1], axis=-1)[:, None]


def _packet():
    g = torch.Generator().manual_seed(0)
    return {"cache": {"k": torch.randn(2, 5, 3, generator=g).to(torch.bfloat16),
                      "m": {"C": torch.randn(2, 4, generator=g),
                            "n": torch.randn(3, generator=g, dtype=torch.float64)}},
            "tok": torch.tensor([[7], [11]]),
            "seq": np.array([[1, 2], [3, 4]], dtype=np.int32),
            "pair": (torch.arange(3, dtype=torch.int32), [2.5, np.float32(1.5)]),
            "step": 4}


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert got.device == CPU and torch.equal(got, want)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("nvm_kind", ["memory", "dir"])
def test_nested_packet_round_trip_through_both_nvms(nvm_kind, tmp_path):
    nvm = MemoryNVM() if nvm_kind == "memory" else DirNVM(str(tmp_path / "nvm"))
    packet = _packet()
    nvm.write("state0", _to_host(packet))
    stored = nvm.read("state0")
    assert isinstance(stored["cache"]["k"], HostTensor)
    assert stored["cache"]["k"].data.dtype == np.int16  # bf16 carried as its bits
    got = _to_device(stored, CPU)
    _assert_same(got, packet)
    # the volatile copy is the runtime's own: writing it leaves the NVM alone
    got["cache"]["m"]["C"].add_(1.0)
    _assert_same(_to_device(nvm.read("state0"), CPU), packet)


def _old_to_host(value):
    """The runtime's host copy before nested packets."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.array(value)


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    torch.arange(6, dtype=torch.int64),
    torch.linspace(0, 1, 5),
    [1.0, 2.0, 3.0],
    7,
], ids=["ndarray", "int64_tensor", "f32_tensor", "list", "scalar"])
def test_single_array_packet_stores_the_same_bytes(value, tmp_path):
    got, want = _to_host(value), _old_to_host(value)
    assert type(got) is np.ndarray and got.dtype == want.dtype
    assert pickle.dumps(got) == pickle.dumps(want)
    nvm = DirNVM(str(tmp_path))
    nvm.write("x", got)
    with open(nvm._file("x"), "rb") as fh:
        assert fh.read() == pickle.dumps(want)
    back = _to_device(nvm.read("x"), CPU)
    assert isinstance(back, torch.Tensor)
    np.testing.assert_array_equal(back.numpy(), want)
