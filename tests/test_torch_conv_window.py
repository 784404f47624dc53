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
from repro_torch.kernels.conv_window.ref import (PACKED_LAYOUT, conv_window_scores_plain,
                                                  score_frame_window_plain, unpack_cnn_weights)

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
    got = ops.score_windows(wins, w)
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
    assert torch.equal(ops.score_windows(wins, w), direct)
    with pytest.raises(KeyError):
        ops.score_windows(wins, {k: v for k, v in w.items() if k != "fc"})


# -- the head count's task body: one window of the normalized frame ----------

FRAME = (60, 80)
SPECS = {"thermal": hc.THERMAL, "visual": hc.VISUAL}


def _frame(seed):
    img = np.random.RandomState(seed).randint(0, 65535, FRAME).astype(np.uint16)
    return img, hc.normalize(torch.from_numpy(img.astype(np.int32)))


def _windows(spec):
    """(scale, y, x) of every CNN task of ``spec``, in task order."""
    return [(hc._SCALES[s], y, x) for s in range(3) for y, x in hc._window_coords(spec, s)]


def _old_task_body(norm, weights, scale, y, x):
    """The CNN task body before the frame kernel: convert and scale the whole
    frame, decimate, slice, then score a [1, 12, 12] batch."""
    f = norm.to(torch.float32) / 65535.0
    win = f[::scale, ::scale][y : y + 12, x : x + 12]
    return ops.score_windows(win[None], weights)[0]


@pytest.mark.parametrize("spec_name", SPECS)
def test_frame_plain_matches_headcount_app_cnn_at_every_window(spec_name):
    """``score_frame_window_plain`` against the reference application's task
    body at every window of the reduced graph."""
    _, score_window = ref_hc._jax_kernels()
    w = ref_hc.cnn_weights(5)
    packed = ops.pack_cnn_weights(w)
    img, norm = _frame(11)
    norm_ref = np.asarray(ref_hc._jax_kernels()[0](img))
    for scale, y, x in _windows(SPECS[spec_name].reduced(64)):
        want = float(score_window(norm_ref, w, scale, y, x))
        got = score_frame_window_plain(norm, packed, scale, y, x)
        assert got.dtype == torch.float32 and got.shape == ()
        assert_close(float(got), want)


@pytest.mark.parametrize("scale", (1, 2, 3))
def test_frame_plain_matches_headcount_app_cnn_at_the_last_window(scale):
    """The last window that fits the decimated frame (scale 3: 20 × 27)."""
    _, score_window = ref_hc._jax_kernels()
    w = ref_hc.cnn_weights(6)
    img, norm = _frame(12)
    norm_ref = np.asarray(ref_hc._jax_kernels()[0](img))
    hd, wd = -(-FRAME[0] // scale), -(-FRAME[1] // scale)
    y, x = hd - 12, wd - 12
    ops.window_offsets(scale, y, x, FRAME)  # fits
    got = ops.score_frame_window(norm, ops.pack_cnn_weights(w), scale, y, x)
    assert_close(float(got), float(score_window(norm_ref, w, scale, y, x)))


@pytest.mark.parametrize("scale", (1, 2, 3))
def test_window_offsets_gather_the_sliced_window(scale):
    """For every THERMAL window at this scale, the kernel's addressing
    (base + r·row_stride + c·col_stride into the flat frame) reads exactly
    ``norm[::s, ::s][y:y+12, x:x+12]``."""
    _, norm = _frame(13)
    flat, dec = norm.flatten(), norm[::scale, ::scale]
    r = torch.arange(12)[:, None]
    c = torch.arange(12)[None, :]
    windows = [(y, x) for s, y, x in _windows(hc.THERMAL) if s == scale]
    assert len(windows) == hc.THERMAL.n_cnn[hc._SCALES.index(scale)]
    for y, x in windows:
        base, rs, cs = ops.window_offsets(scale, y, x, FRAME)
        assert torch.equal(flat[base + r * rs + c * cs], dec[y : y + 12, x : x + 12])


@pytest.mark.parametrize("scale,y,x", [(1, 49, 0), (1, 0, 69), (2, 19, 0), (2, 0, 29),
                                       (3, 9, 0), (3, 0, 16), (1, -1, 0), (2, 0, -1),
                                       (0, 0, 0)])
def test_window_offsets_refuse_windows_outside_the_frame(scale, y, x):
    """``repro``'s ``dynamic_slice`` would clamp such a window; the port
    raises, so the kernel never reads past the frame."""
    with pytest.raises(ValueError, match="leaves"):
        ops.window_offsets(scale, y, x, FRAME)
    _, norm = _frame(14)
    with pytest.raises(ValueError, match="leaves"):
        ops.score_frame_window(norm, ops.pack_cnn_weights(hc.cnn_weights(0)), scale, y, x)


@pytest.mark.parametrize("as_torch", (False, True))
def test_pack_cnn_weights_keeps_hwio(as_torch):
    w = hc.cnn_weights(4)
    packed = ops.pack_cnn_weights(hc.weights_to_torch(w, "cpu") if as_torch else w)
    assert packed.dtype == torch.float32 and packed.shape == (1265,) and packed.is_contiguous()
    end = 0
    for (name, off, shape), view in zip(PACKED_LAYOUT, unpack_cnn_weights(packed)):
        assert off == end and off % 4 == 0, name  # end to end, 16-byte aligned pieces
        end = off + int(np.prod(shape))
        assert tuple(view.shape) == shape
        assert np.array_equal(view.numpy(), np.asarray(w[name]).reshape(shape)), name
        assert np.array_equal(packed[off:end].numpy(), np.asarray(w[name]).ravel()), name
    assert end == 1265
    with pytest.raises(ValueError, match="conv2"):
        ops.pack_cnn_weights({**w, "conv2": w["conv2"][:2]})


@pytest.mark.parametrize("spec_name", SPECS)
def test_app_cnn_bodies_equal_the_old_path_bitwise(spec_name):
    """On the CPU every CNN task body computes what it computed before the
    frame kernel, bit for bit, as a fresh 0-dim float32 tensor."""
    spec = SPECS[spec_name].reduced(64)
    g = hc.build_graph(spec, with_fns=True, seed=3, device="cpu")
    weights = hc.weights_to_torch(hc.cnn_weights(3), "cpu")
    _, norm = _frame(15)
    cnn = [t for t in g.tasks if t.name.startswith("cnn")]
    assert len(cnn) == sum(spec.n_cnn)
    outs = []
    for task, (scale, y, x) in zip(cnn, _windows(spec)):
        (got,) = task.fn({"norm": norm}).values()
        assert got.dtype == torch.float32 and got.shape == ()
        assert torch.equal(got, _old_task_body(norm, weights, scale, y, x)), task.name
        assert torch.equal(hc.score_window(norm, weights, scale, y, x), got), task.name
        outs.append(got)
    assert len({o.data_ptr() for o in outs}) == len(outs)  # no shared buffer
