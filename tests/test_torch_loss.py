"""The port's training loss and its gradients against ``repro``'s: the
dense, moe, vlm and encdec families (``tests/test_torch_loss_recurrent.py``
has ssm and hybrid).

For each smoke config, ``repro``'s parameters (``init_params`` at
``PRNGKey(0)``) cross as numpy into the port's trainable model
(``api.trainable_from_numpy``), and one synthetic batch of 2 × 16 tokens
goes through ``jax.value_and_grad`` of ``repro``'s ``api.loss`` (remat on,
as its train step runs it) and through the port's ``api.loss`` and
``backward``. vlm and encdec take ``repro``'s training stand-ins (zero
vision tokens, zero audio frames), and once more seeded random ones with
the leaves ``repro`` initialises to zero (biases, the vlm gates) drawn at
random, so that the cross paths carry gradient.

Compared: the loss, the CE and every gradient leaf, each element of the
port's parameters against the elements of ``repro``'s tree it came from
(``helpers_torch.leaf_index``). Tolerance (``helpers_torch``): a leaf
within n·2^-9·max|reference leaf|, n = 2·n_fwd + 1 + r bf16 rounding sites
on its forward and backward path (tinyllama-1.1b's smoke config: n_fwd 46,
r 1 + its batch's most repeated token − 1, n about 96, 19% of the largest
element; the readings are 1-2%); the CE within 2·n_fwd·2^-9·max|logits|,
moe's 0.01·aux within n_fwd·2^-9 of it. Control: the same gradients with
the labels shifted by one position must exceed the tolerance in some leaf.
And remat on and off give bitwise the same gradients in the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.models import api as ref_api
from repro.models.moe import _load_balance_loss as ref_load_balance_loss

from helpers_torch import (U, flat_leaves, forward_sites, grad_errors, grad_sites, leaf_index,
                           logits_seen)

from repro_torch.configs import SMOKE_CONFIGS
from repro_torch.data.synthetic import SyntheticConfig, SyntheticData
from repro_torch.models import api
from repro_torch.models.common import COMPUTE_DTYPE
from repro_torch.models.moe import load_balance_loss

BATCH, SEQ = 2, 16
ZERO_INIT = ("bq", "bk", "bv", "b1", "b2", "b", "gate")
# (arch, stand-ins): "zero" is the training path's; "random" also draws the
# zero-initialised leaves, so that the vlm and encdec cross paths add something
CASES = [(a, "zero") for a in ("qwen3-4b", "tinyllama-1.1b", "deepseek-coder-33b",
                               "qwen1.5-0.5b", "granite-moe-1b-a400m",
                               "phi3.5-moe-42b-a6.6b", "llama-3.2-vision-11b",
                               "whisper-large-v3")]
CASES += [("llama-3.2-vision-11b", "random"), ("whisper-large-v3", "random")]


def configs(arch, layers=None):
    rcfg, cfg = REF_SMOKE[arch], SMOKE_CONFIGS[arch]
    if layers is not None:
        rcfg = dataclasses.replace(rcfg, n_layers=layers)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return rcfg, cfg


def numpy_params(rcfg, random_zero_leaves: bool, seed: int = 0):
    params, _ = ref_api.init_params(rcfg, jax.random.PRNGKey(seed), max_seq=SEQ)
    tree = jax.tree.map(np.asarray, params)
    if not random_zero_leaves:
        return tree
    rs = np.random.RandomState(seed + 1)

    def fill(path, a):
        if getattr(path[-1], "key", None) in ZERO_INIT:
            return (0.5 * rs.randn(*a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fill, tree)


def batch_pair(cfg, random_stand_ins: bool, seed: int = 1):
    """The same batch as ({name: jax array}, {name: torch tensor}):
    synthetic tokens and labels, and the family's stand-ins."""
    b = SyntheticData(SyntheticConfig(cfg.vocab, SEQ, BATCH, seed=seed)).batch(0)
    ref = {k: jnp.asarray(b[k]) for k in ("tokens", "labels")}
    port = {k: torch.from_numpy(b[k]).to(torch.int64) for k in ("tokens", "labels")}
    rs = np.random.RandomState(seed + 7)
    for name, (shape, dtype) in api.extra_inputs(cfg, BATCH).items():
        a = (rs.randn(*shape) if random_stand_ins else np.zeros(shape)).astype(np.float32)
        port[name] = torch.from_numpy(a).to(dtype)
        ref[name] = jnp.asarray(port[name].to(torch.float32).numpy()).astype(jnp.bfloat16)
    return ref, port


class Case:
    """One (config, parameters, batch): ``repro``'s loss, CE and gradients,
    and the port's model built from the same tree (``draw`` alters the
    numpy tree first)."""

    def __init__(self, rcfg, cfg, random_inputs: bool, draw=None):
        self.cfg = cfg
        self.tree = numpy_params(rcfg, random_inputs)
        if draw is not None:
            self.tree = draw(self.tree)
        self.ref_batch, self.batch = batch_pair(cfg, random_inputs)
        params = jax.tree.map(jnp.asarray, self.tree)
        fn = jax.jit(jax.value_and_grad(
            lambda p: ref_api.loss(rcfg, p, self.ref_batch, remat=True), has_aux=True))
        (loss, ce), grads = fn(params)
        self.ref_loss, self.ref_ce = float(loss), float(ce)
        self.ref_grads = flat_leaves(grads)
        self.index = leaf_index(cfg, self.tree)
        self.sites = grad_sites(cfg, self.batch["tokens"].numpy())

    def port(self, batch=None, remat=True):
        """(model with .grad filled, loss, ce, max |logits|)."""
        model, _ = api.trainable_from_numpy(self.cfg, self.tree, "cpu")
        with logits_seen() as seen:
            loss, ce = api.loss(self.cfg, model, batch or self.batch, remat=remat)
        loss.backward()
        return model, float(loss.detach()), float(ce.detach()), seen[0]


def check_case(case: Case) -> None:
    """The loss, the CE and every gradient leaf within their tolerances."""
    model, loss, ce, logits_max = case.port()
    n_fwd = forward_sites(case.cfg)
    assert abs(ce - case.ref_ce) <= 2 * n_fwd * U * logits_max, (ce, case.ref_ce)
    aux, ref_aux = loss - ce, case.ref_loss - case.ref_ce
    assert abs(aux - ref_aux) <= n_fwd * U * abs(ref_aux) + 2 * n_fwd * U * logits_max
    errs = grad_errors(model, case.index, case.ref_grads, case.sites)
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    assert not bad, bad
    for p in model.parameters():
        assert torch.isfinite(p.grad).all()


def check_control(case: Case) -> None:
    """Labels shifted by one: some leaf must exceed its tolerance."""
    batch = dict(case.batch, labels=torch.roll(case.batch["labels"], 1, dims=1))
    model, *_ = case.port(batch)
    errs = grad_errors(model, case.index, case.ref_grads, case.sites)
    assert max(e / t for e, t in errs.values() if t > 0) > 1.0


def check_remat_bitwise(case: Case) -> None:
    on, *_ = case.port(remat=True)
    off, *_ = case.port(remat=False)
    for (name, a), (_, b) in zip(on.named_parameters(), off.named_parameters()):
        assert torch.equal(a.grad, b.grad), name


@pytest.fixture(scope="module")
def cases():
    made = {}

    def get(arch, inputs, layers=None):
        key = (arch, inputs, layers)
        if key not in made:
            made[key] = Case(*configs(arch, layers), inputs == "random")
        return made[key]
    return get


@pytest.mark.parametrize("arch,inputs", CASES)
def test_loss_and_every_gradient_leaf_match_reference(cases, arch, inputs):
    check_case(cases(arch, inputs))


@pytest.mark.parametrize("arch,inputs", CASES)
def test_shifted_labels_control_exceeds_the_tolerance(cases, arch, inputs):
    check_control(cases(arch, inputs))


@pytest.mark.parametrize("arch", sorted({a for a, _ in CASES}))
def test_remat_on_and_off_give_bitwise_the_same_gradients(cases, arch):
    check_remat_bitwise(cases(arch, "zero"))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"])
def test_load_balance_loss_matches_reference(arch):
    """The Switch loss on the same float32 probabilities and choices: the
    port's E·Σ mean(p)·mean(count) against ``repro``'s, within float32
    rounding of its sums (G·t·E terms)."""
    m = SMOKE_CONFIGS[arch].moe
    rs = np.random.RandomState(3)
    probs = rs.dirichlet(np.ones(m.n_experts), size=(2, 16)).astype(np.float32)
    sel = np.argsort(-probs, axis=-1)[..., :m.top_k]
    want = float(ref_load_balance_loss(jnp.asarray(probs),
                                       jax.nn.one_hot(jnp.asarray(sel), m.n_experts)))
    got = float(load_balance_loss(torch.from_numpy(probs), torch.from_numpy(sel)))
    assert abs(got - want) <= probs.size * 2.0 ** -24 * abs(want)


def test_moe_loss_adds_a_hundredth_of_the_load_balance_loss(cases):
    """granite-moe: loss − CE is 0.01 · Σ_layers aux, the layers' aux
    recomputed from their own routing."""
    case = cases("granite-moe-1b-a400m", "zero")
    model, loss, ce, _ = case.port()
    x = model.embed[case.batch["tokens"]]
    positions = torch.arange(SEQ)[None, :]
    total = 0.0
    with torch.no_grad():
        for layer in model.layers:
            _, _, aux = layer.block(x, positions, with_aux=True)
            x, _ = layer(x, positions)
            total += float(aux)
    assert total > 0
    assert abs((loss - ce) - 0.01 * total) <= 1e-6 * abs(loss)


def test_trainable_model_keeps_serving_types_and_unrounded_masters(cases):
    """Matmul weights stay bf16, norms float32, every parameter requires
    grad; each master holds the reference's float32 value, and casting it
    gives the module's weight."""
    case = cases("qwen1.5-0.5b", "zero")
    model, masters = api.trainable_from_numpy(case.cfg, case.tree, "cpu")
    flat = flat_leaves(case.tree)
    assert set(masters) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert p.requires_grad
        assert p.dtype == (torch.float32 if "norm" in name or name.endswith(("ln1", "ln2"))
                           else COMPUTE_DTYPE), name
        m = masters[name]
        assert m.dtype == torch.float32 and m.data_ptr() != p.data_ptr()
        assert np.array_equal(m.numpy().ravel(), flat[case.index[name]])
        assert torch.equal(m.to(p.dtype), p.detach())
