"""The port's training loss and its gradients against ``repro``'s: the ssm
(xlstm-1.3b) and hybrid (zamba2-7b) families, as
``tests/test_torch_loss.py`` checks the others and with its tolerances.

xlstm-1.3b's smoke config has 2 groups of 1 mLSTM and 1 sLSTM block
(n_fwd 54); zamba2-7b's has 2 groups of 2 Mamba2 blocks, each followed by
the shared block (n_fwd 102, and one bf16 addition of the shared block's
gradients in r), and once more with a fifth layer, which makes a tail
block, as ``tests/test_torch_hybrid.py`` extends it. zamba2 runs on ``repro``'s init
and once more with A_log, dt_bias and D drawn at random, which gives its
heads different decays (``repro`` makes them 0, 0 and 1).
"""

import jax
import numpy as np
import pytest

from test_torch_loss import Case, check_case, check_control, check_remat_bitwise, configs

RANDOM_LEAVES = {"A_log": (0.0, 1.0), "dt_bias": (0.0, 0.5), "D": (1.0, 0.3)}  # (mean, sd)
CASES = [("xlstm-1.3b", None, False), ("zamba2-7b", None, False), ("zamba2-7b", 5, False),
         ("zamba2-7b", None, True)]


def drawn_decays(tree):
    """``tree`` with A_log, dt_bias and D drawn at random (RANDOM_LEAVES)."""
    rs = np.random.RandomState(11)

    def fill(path, a):
        name = getattr(path[-1], "key", None)
        if name in RANDOM_LEAVES:
            mean, sd = RANDOM_LEAVES[name]
            return (mean + sd * rs.randn(*a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def cases():
    made = {}

    def get(arch, layers, decays):
        key = (arch, layers, decays)
        if key not in made:
            rcfg, cfg = configs(arch, layers)
            made[key] = Case(rcfg, cfg, False, drawn_decays if decays else None)
        return made[key]
    return get


def _id(case):
    arch, layers, decays = case
    return arch + (f"-{layers}-layers" if layers else "") + ("-drawn-decays" if decays else "")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_loss_and_every_gradient_leaf_match_reference(cases, case):
    check_case(cases(*case))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_shifted_labels_control_exceeds_the_tolerance(cases, case):
    check_control(cases(*case))


@pytest.mark.parametrize("case", CASES[:3], ids=_id)
def test_remat_on_and_off_give_bitwise_the_same_gradients(cases, case):
    check_remat_bitwise(cases(*case))


def test_zamba_shared_block_gradient_sums_every_application(cases):
    """The shared block's weights are one parameter each, used by both
    groups (and before the tail block): every one gets a nonzero gradient."""
    case = cases("zamba2-7b", 5, False)
    model, *_ = case.port()
    shared = {n: p for n, p in model.named_parameters() if n.startswith("shared.")}
    assert shared and all(float(p.grad.abs().max()) > 0 for p in shared.values())
