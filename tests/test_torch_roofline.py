"""The port's op count (``repro_torch.launch.roofline``) and the kernels'
work, on the CPU.

* each kernel's ``work().flops`` equals ``FlopCounterMode``'s count of its
  plain version (flash: causal and not, GQA, ragged; mLSTM: one and several
  chunks; RMSNorm: no products), and the bounds the kernels line of
  ``chip_smoke.py`` reads from ``work()`` equal the formulas it had before;
* ``COUNTED`` on ``meta`` returns the plain version's shapes and types and
  raises on a CPU tensor or with no count open;
* what the counter counts: products' FLOPs and bytes, gathers, scatters,
  slice updates, nothing for elementwise ops and whole copies, the peak of
  live bytes; the fast outputs equal the meta kernels' counts;
* the exact quadratic fit: equal to a direct count at another length for
  smoke xlstm, and a count that is not a quadratic raises.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SMOKE_CONFIGS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.kernels.counted import work_sink
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_plain
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_plain
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import FIT_CHUNKS, fit_lengths
from repro_torch.launch.roofline import (HBM_BW, NVLINK_BW, PEAK_FLOPS, count_step,
                                         dominant_term, fit_quadratic, roofline_terms)
from repro_torch.launch.steps import build_cell
from repro_torch.models.common import COUNTED, PLAIN

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flops(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def _randn(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


# -- work() against the plain versions ------------------------------------------

FLASH_SHAPES = [  # b, sq, sk, h, kv, hd, causal
    (2, 16, 16, 4, 2, 8, True),
    (1, 24, 24, 4, 4, 16, False),
    (2, 12, 20, 6, 2, 8, False),      # cross-attention, Sk > Sq, GQA
    (1, 20, 12, 2, 1, 8, True),       # ragged: Sq > Sk, causal
]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_work_flops_equal_the_plain_versions_count(shape):
    b, sq, sk, h, kv, hd, causal = shape
    q, k, v = _randn((b, sq, h, hd)), _randn((b, sk, kv, hd), seed=1), _randn((b, sk, kv, hd),
                                                                             seed=2)
    qg, kg, vg = flash_ops.to_bkv(q, k, v)
    counted = _flops(lambda: attention_plain(qg, kg, vg, causal=causal))
    w = flash_ops.work(b, sq, sk, h, kv, hd, causal, q.element_size())
    assert w.flops == counted
    assert w.ops == 4 * b * h * sum(min(i + 1, sk) if causal else sk for i in range(sq)) * hd
    assert w.bytes == (2 * q.numel() + k.numel() + v.numel()) * q.element_size()


@pytest.mark.parametrize("shape", [(4, 32, 16, 128), (2, 256, 32, 128), (3, 384, 16, 128),
                                   (2, 48, 8, 16)], ids=str)
def test_mlstm_work_flops_equal_the_plain_versions_count(shape):
    bh, s, hd, chunk = shape
    q, k, v = (_randn((bh, s, hd), seed=i) for i in range(3))
    i_pre, f_pre = _randn((bh, s), seed=3), _randn((bh, s), seed=4)
    counted = _flops(lambda: mlstm_chunk_plain(q, k, v, i_pre, f_pre, chunk=chunk))
    assert mlstm_ops.work(bh, s, hd, chunk, q.element_size()).flops == counted


@pytest.mark.parametrize("shape", [(7, 64), (2, 4, 32), (16, 96)], ids=str)
def test_rmsnorm_work_has_no_products(shape):
    x, w = _randn(shape), _randn(shape[-1:], seed=1)
    assert _flops(lambda: rmsnorm_plain(x, w)) == 0
    rows = math.prod(shape[:-1])
    assert rms_ops.work(rows, shape[-1], 4) == (0, 2 * rows * shape[-1] * 4 + 4 * shape[-1],
                                                4 * rows * shape[-1])


# The kernels line's formulas before they read work(), copied as they were.
def _old_mlstm_work(bh, s, hd, L, elt):
    nc = s // L
    nbytes = 4 * bh * s * hd * elt + 2 * bh * s * 4 + bh * (hd * hd + hd + 1) * 4
    per_chunk = 2 * L * hd * hd + 2 * L * (L + 1) * hd + 4 * L * hd
    ops = bh * (nc * per_chunk + (nc - 1) * 2 * L * hd * hd)
    return nbytes, ops


def _old_mlstm_split_work(bh, s, hd, L):
    nc = s // L
    split = bh * (nc * 2 * L * hd * hd + (nc - 1) * 2 * L * hd * hd + nc * L * (L + 1) * hd)
    return split, bh * nc * L * (L + 1) * hd, bh * nc * 4 * L * hd


def test_chip_smoke_bounds_read_work_with_the_old_values():
    cs = _chip_smoke()
    for name in ("serve_b4_s512", "serve_b1_s1024"):
        bh, s, hd, chunk, dtype, _ = cs.MLSTM_CASES[name]
        elt = torch.empty((), dtype=dtype).element_size()
        w = mlstm_ops.work(bh, s, hd, chunk, elt)
        L = min(chunk, s)
        assert (w.bytes, w.ops) == _old_mlstm_work(bh, s, hd, L, elt)
        assert mlstm_ops.split_work(bh, s, hd, chunk) == _old_mlstm_split_work(bh, s, hd, L)
    for name in ("serve_b4_s512", "serve_b1_s1000", "vlm_cross_b4_s512_sk1601",
                 "whisper_encoder_b4_s1500", "zamba_b4_s512_hd112"):
        b, sq, sk, h, kv, hd, causal, dtype = cs.FLASH_CASES[name]
        elt = torch.empty((), dtype=dtype).element_size()
        pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
        old = ((2 * b * sq * h * hd + 2 * b * sk * kv * hd) * elt, 4 * b * h * pairs * hd)
        w = flash_ops.work(b, sq, sk, h, kv, hd, causal, elt)
        assert (w.bytes, w.ops) == old
    for name, (n, d, dtype) in cs.RMS_CASES.items():
        elt = torch.empty((), dtype=dtype).element_size()
        w = rms_ops.work(n, d, elt)
        assert (w.bytes, w.ops) == (2 * n * d * elt + 4 * d, 4 * n * d)


# -- COUNTED --------------------------------------------------------------------


def _count_kernels(fn):
    seen = []
    with work_sink(lambda name, work: seen.append((name, work))):
        out = fn()
    return out, seen


def test_counted_returns_the_plain_shapes_and_types_on_meta():
    b, s, h, kv, hd = 2, 256, 4, 2, 16
    real = {"q": _randn((b, s, h, hd), torch.bfloat16), "k": _randn((b, s, kv, hd), torch.bfloat16),
            "v": _randn((b, s, kv, hd), torch.bfloat16, seed=2)}
    meta = {n: torch.empty_like(t, device=META) for n, t in real.items()}
    want = PLAIN.attention(real["q"], real["k"], real["v"], True)
    got, seen = _count_kernels(lambda: COUNTED.attention(meta["q"], meta["k"], meta["v"], True))
    assert (got.shape, got.dtype, got.device) == (want.shape, want.dtype, META)
    assert seen == [("flash_attention", flash_ops.work(b, s, s, h, kv, hd, True, 2))]

    x = _randn((b, s, 32), torch.bfloat16)
    w = torch.ones(32)
    want = PLAIN.rmsnorm(x, w, 1e-5)
    got, seen = _count_kernels(lambda: COUNTED.rmsnorm(x.to(META), w.to(META), 1e-5))
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert seen == [("rmsnorm", rms_ops.work(b * s, 32, 2))]

    mh, mhd = 2, 32
    args = [_randn((b, s, mh, mhd), torch.bfloat16, seed=i) for i in range(3)]
    gates = [_randn((b, s, mh), seed=5), _randn((b, s, mh), seed=6)]
    want_y, want_state = PLAIN.mlstm(*args, *gates)
    (got_y, got_state), seen = _count_kernels(
        lambda: COUNTED.mlstm(*(t.to(META) for t in args + gates)))
    for g_, w_ in zip((got_y, *got_state), (want_y, *want_state)):
        assert (g_.shape, g_.dtype, g_.device) == (w_.shape, w_.dtype, META)
    assert seen == [("mlstm_chunk", mlstm_ops.work(b * mh, s, mhd, 128, 2))]


def test_counted_raises_off_meta_and_outside_a_count():
    q = torch.zeros(1, 8, 2, 8)
    with work_sink(lambda *a: None):
        with pytest.raises(RuntimeError, match="meta tensors only"):
            COUNTED.attention(q, q, q, True)
        with pytest.raises(RuntimeError, match="meta tensors only"):
            COUNTED.rmsnorm(q, torch.ones(8), 1e-5)
        with pytest.raises(RuntimeError, match="meta tensors only"):
            COUNTED.mlstm(q, q, q, torch.zeros(1, 8, 2), torch.zeros(1, 8, 2))
    with pytest.raises(RuntimeError, match="no count is open"):
        COUNTED.rmsnorm(q.to(META), torch.ones(8, device=META), 1e-5)


# -- the counter ------------------------------------------------------------------


def test_counter_counts_products_gathers_scatters_and_slice_updates():
    a, b = torch.empty(8, 16, device=META), torch.empty(16, 4, device=META)
    table = torch.empty(100, 16, device=META, dtype=torch.bfloat16)
    ids = torch.empty(3, 5, dtype=torch.int64, device=META)
    cache = torch.empty(4, 10, 16, device=META)
    upd = torch.empty(4, 1, 16, device=META)

    def step(a, b, table, ids, cache, upd):
        y = a @ b                           # 2·8·4·16 FLOPs; (8·16 + 16·4 + 8·4)·4 bytes
        z = torch.bmm(a[None].expand(2, 8, 16), b[None].expand(2, 16, 4))
        e = table[ids]                      # a gather: 2 × its 3·5·16 bf16 output
        cache.index_copy_(1, torch.zeros(1, dtype=torch.int64, device=META), upd)
        cache[:, 2:3] = upd                 # a slice update: 2 × 4·16·4 bytes
        w = torch.empty_like(a)
        w.copy_(a)                          # a whole copy: not counted
        return (y * 2 + 1).exp(), z, e, w   # elementwise: not counted

    _, st = count_step(step, a, b, table, ids, cache, upd)
    assert st.flops == 2 * 8 * 4 * 16 + 2 * (2 * 8 * 4 * 16)
    assert st.ops["mm"] == [1, 1024, (128 + 64 + 32) * 4]
    assert st.ops["bmm"] == [1, 2048, (2 * 128 + 2 * 64 + 2 * 32) * 4]
    assert st.ops["index"] == [1, 0, 2 * 15 * 16 * 2]
    assert st.ops["index_copy_"] == [1, 0, 2 * 64 * 4]
    assert st.ops["copy_ (slice update)"] == [1, 0, 2 * 64 * 4]
    assert st.bytes == sum(row[2] for row in st.ops.values())
    assert set(st.ops) == {"mm", "bmm", "index", "index_copy_", "copy_ (slice update)"}
    assert st.coll_bytes == 0 and st.kernel_calls == {}


def test_counter_peak_follows_live_storages():
    x = torch.empty(1000, device=META)  # an argument: 4000 bytes, never freed

    def step(x):
        a = x * 2            # +4000
        b = a.view(10, 100)  # a view: no new storage
        c = b + 1            # +4000: 12000 live
        del a, b             # a's storage freed: 8000
        d = c * 3            # +4000: 12000
        del c                # 8000
        return d[:10].clone()  # +40: 8040

    _, st = count_step(step, x)
    assert st.argument_bytes == 4000
    assert st.peak_bytes == 12000


def test_roofline_terms_use_the_h100_constants():
    t = roofline_terms(989e12, 3.35e12, 0.0)
    assert (PEAK_FLOPS, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert t == {"t_compute": 1.0, "t_memory": 1.0, "t_collective": 0.0}
    assert dominant_term(roofline_terms(1.0, 3.35e12 * 2, 0.0)) == "t_memory"


@pytest.mark.parametrize("arch", sorted(SMOKE_CONFIGS))
def test_fast_outputs_count_as_the_meta_kernels(arch, monkeypatch):
    """The counter's outputs made from shapes give the same count, op table
    and peak as every op's own meta kernel."""
    cfg = SMOKE_CONFIGS[arch]
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("t", 32, 2, kind)
        fast = build_cell(cfg, shape, "cpu").count()[1]
        monkeypatch.setattr(roofline, "FAST_OUTPUTS", False)
        slow = build_cell(cfg, shape, "cpu").count()[1]
        monkeypatch.setattr(roofline, "FAST_OUTPUTS", True)
        assert fast == slow, kind


# -- the exact fit -----------------------------------------------------------------


def _sizes(st):
    return {"flops": st.flops, "bytes": st.bytes, "peak_bytes": st.peak_bytes}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_fit_equals_a_direct_count_at_another_length(kind):
    """The quadratic through the counts at the first three of the dry run's
    lengths equals the direct count at the fourth (which ``fit_quadratic``
    checks) and at one chunk more; from one chunk (no carried state) the
    train step's peak is not on that quadratic, and the fit raises."""
    cfg = SMOKE_CONFIGS["xlstm-1.3b"]
    lengths = [n * 128 for n in FIT_CHUNKS]
    extra = [lengths[-1] + 128] if kind == "prefill" else [128]
    counts = {s: _sizes(build_cell(cfg, ShapeConfig("t", s, 2, kind), "cpu").count()[1])
              for s in lengths + extra}
    fitted = fit_quadratic({s: counts[s] for s in lengths}, lengths[-1])
    assert fitted == counts[lengths[-1]]
    if kind == "prefill":
        assert fit_quadratic({s: counts[s] for s in lengths}, extra[0]) == counts[extra[0]]
    else:
        with pytest.raises(ValueError, match="peak_bytes is not a quadratic"):
            fit_quadratic({s: counts[s] for s in [128] + lengths[:3]}, lengths[-1])


def test_fit_raises_when_the_count_is_not_a_quadratic():
    cubic = {s: {"flops": s ** 3, "bytes": s} for s in (1, 2, 3, 4)}
    with pytest.raises(ValueError, match="flops is not a quadratic"):
        fit_quadratic(cubic, 10)
    halves = {s: {"flops": s * (s + 1) // 2} for s in (1, 2, 3, 4)}
    assert fit_quadratic(halves, 10) == {"flops": 55}
    with pytest.raises(ValueError, match="four lengths"):
        fit_quadratic({1: {"flops": 1}}, 2)
    # a peak that changes regime past the fourth length: a count there catches it
    kinked = {s: {"peak_bytes": max(s, 2 * s - 5)} for s in (1, 2, 3, 4, 10)}
    assert fit_quadratic({s: kinked[s] for s in (1, 2, 3, 4)}, 10) == {"peak_bytes": 10}
    with pytest.raises(ValueError, match="gives 10 at 10, the count 15"):
        fit_quadratic(kinked, 10)


def test_check_fit_adds_the_cells_own_length():
    cfg = get_config("xlstm-1.3b")
    for name in ("train_4k", "prefill_32k"):
        shape = SHAPES[name]
        assert fit_lengths(cfg, shape, check=True) == fit_lengths(cfg, shape) + [shape.seq_len]
    assert fit_lengths(cfg, SHAPES["decode_32k"], check=True) is None
    assert fit_lengths(get_config("qwen3-4b"), SHAPES["train_4k"], check=True) is None
