"""The port's window CNN agrees with the JAX reference within f32 rounding.

Tolerance: max |Δ| ≤ 1e-5 · max(1, |score|). Both sides compute in float32,
but the convolutions sum their 9- and 72-term dot products in different
orders (XLA's convolution vs PyTorch's), so results differ by a few ulp of
the partial sums, never by more than this bound on these inputs.
"""

import numpy as np
import pytest
import torch

from repro.core.apps import headcount as ref_hc
from repro.kernels.conv_window.ops import score_windows as jax_score_windows

from repro_torch.core.apps import headcount as hc
from repro_torch.kernels.conv_window import ops
from repro_torch.kernels.conv_window.ref import conv_window_scores_plain

TOL = 1e-5


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= TOL * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("seed", range(4))
def test_cnn_weights_equal(seed):
    want, got = ref_hc.cnn_weights(seed), hc.cnn_weights(seed)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("n,seed", [(1, 0), (37, 1), (128, 2), (300, 3)])
def test_plain_matches_pallas_interpret(n, seed):
    w = ref_hc.cnn_weights(seed)
    wins = np.random.RandomState(seed).rand(n, 12, 12).astype(np.float32)
    want = np.asarray(jax_score_windows(wins, w, interpret=True))
    got = ops.score_windows(wins, w, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert_close(got.numpy(), want)


def test_plain_matches_headcount_app_cnn():
    """Against the reference application's own task body (normalize +
    decimate + slice + score), at every pyramid scale."""
    normalize, score_window = ref_hc._jax_kernels()
    w = ref_hc.cnn_weights(7)
    wt = hc.weights_to_torch(w, "cpu")
    img = np.random.RandomState(7).randint(0, 65535, (60, 80)).astype(np.uint16)
    norm_ref = np.asarray(normalize(img))
    norm = hc.normalize(torch.from_numpy(img.astype(np.int32)))
    assert np.array_equal(norm.numpy(), norm_ref.astype(np.int32))
    for scale, (y, x) in [(1, (0, 0)), (1, (40, 60)), (2, (3, 9)), (3, (7, 12))]:
        want = float(score_window(norm_ref, w, scale, y, x))
        got = float(hc.score_window(norm, wt, scale, y, x))
        assert_close(got, want)


def test_plain_is_the_cpu_path_and_keeps_hwio():
    w = hc.weights_to_torch(hc.cnn_weights(3), "cpu")
    wins = torch.from_numpy(np.random.RandomState(5).rand(9, 12, 12).astype(np.float32))
    direct = conv_window_scores_plain(wins, w["conv1"], w["b1"], w["conv2"], w["b2"],
                                      w["fc"], w["fc_b"])
    assert torch.equal(ops.score_windows(wins, w, device="cpu"), direct)
    with pytest.raises(KeyError):
        ops.score_windows(wins, {k: v for k, v in w.items() if k != "fc"}, device="cpu")
