"""The port's dry run against ``repro``'s (``launch/{steps,roofline,dryrun}.py``).

* ``SHAPES`` field for field and ``shape_applicable`` on all 10 × 4 cells;
* ``input_specs`` against ``repro``'s at smoke size and at full width;
* the ``meta`` model's parameters at full width against ``repro``'s abstract
  ``init_params(cfg, None)`` tree and ``chip_smoke.py::held_params``;
* the counted FLOPs of every architecture's train, prefill and decode step
  at B 2 × S 32, plus the work ``repro``'s compiled HLO does and the port's
  step does not (each term a formula beside the ``repro`` line that does
  it), equal to ``repro``'s ``build_cell(...).lower().compile()`` →
  ``analyze_hlo`` FLOPs exactly; one term left out must miss;
* the CLI over every shape kind on the CPU (the whole ``--all`` takes about
  75 s with 4 workers, and runs on the card in ``chip_smoke.py``): the
  records carry ``repro``'s keys, ``long_500k`` is skipped for the eight
  quadratic architectures, and ``experiments/make_tables.py`` reads them.
"""

import functools
import importlib.util
import json
import math
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_CONFIGS as REF_SMOKE
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import shape_applicable as ref_applicable
from repro.launch.mesh import make_host_mesh
from repro.launch.roofline import analyze_hlo
from repro.launch.steps import build_cell as ref_build_cell
from repro.models import api as ref_api

from repro_torch.configs import ALL_ARCHS, SMOKE_CONFIGS, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_cell
from repro_torch.models import api

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 32
REPRO_KEYS = ("arch", "shape", "mesh", "family", "status", "t_lower_s", "t_compile_s",
              "n_chips", "memory", "cost_analysis", "collective_bytes_by_kind",
              "collective_count_by_kind", "collective_bytes_total", "roofline", "dominant",
              "model_flops_global", "useful_flops_ratio")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- shapes, specs, parameters ---------------------------------------------------


def test_shapes_are_repros_field_for_field():
    assert list(SHAPES) == list(REF_SHAPES)
    for name, shape in SHAPES.items():
        ref = REF_SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == (
            ref.name, ref.seq_len, ref.global_batch, ref.kind)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_shape_applicable_on_every_cell(arch):
    for name in SHAPES:
        assert shape_applicable(get_config(arch), SHAPES[name]) == ref_applicable(
            ref_get_config(arch), REF_SHAPES[name])


def _spec_leaves(tree, prefix=""):
    """{path: (shape, dtype name)} of a (shape, dtype) tree or a
    ShapeDtypeStruct tree; None leaves kept."""
    if tree is None:
        return {prefix: None}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, jax.ShapeDtypeStruct):
        name = str(np.dtype(tree.dtype))
        return {prefix: (tuple(tree.shape), {"int32": "int64"}.get(name, name))}
    shape, dtype = tree
    return {prefix: (tuple(shape), str(dtype).replace("torch.", ""))}


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_are_repros(arch, size):
    cfg = SMOKE_CONFIGS[arch] if size == "smoke" else get_config(arch)
    rcfg = REF_SMOKE[arch] if size == "smoke" else ref_get_config(arch)
    shapes = list(SHAPES.values()) + [ShapeConfig(f"b{B}_s{S}_{k}", S, B, k)
                                      for k in ("train", "prefill", "decode")]
    for shape in shapes:
        rshape = RefShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)
        got = _spec_leaves(api.input_specs(cfg, shape))
        want = _spec_leaves(ref_api.input_specs(rcfg, rshape))
        assert got == want, shape.name
        if shape.kind == "decode":
            assert api.input_specs(cfg, shape)["cache"] == api.cache_shape(
                cfg, shape.global_batch, shape.seq_len)


def _ref_param_count(rcfg, max_seq):
    tree, _ = ref_api.init_params(rcfg, None, max_seq=max_seq)
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_meta_model_holds_repros_parameters_at_full_width(arch):
    cfg, max_seq = get_config(arch), 4096
    model = api.init_params(cfg, None, device="meta", max_seq=max_seq)
    params = list(model.parameters())
    assert all(p.device.type == "meta" for p in params)
    n = sum(p.numel() for p in params)
    assert n == _ref_param_count(ref_get_config(arch), max_seq)
    cs = _chip_smoke()  # held_params counts every family but the ssm, a constant there
    assert n == (cs.XLSTM_PARAMS_HELD if cfg.family == "ssm" else cs.held_params(cfg, max_seq))
    trainable, masters = api.init_trainable(cfg, None, device="meta", max_seq=max_seq)
    assert sorted(masters) == sorted(name for name, _ in trainable.named_parameters())
    assert all(m.dtype == torch.float32 and m.device.type == "meta" for m in masters.values())
    assert all(p.requires_grad for p in trainable.parameters())


def test_abstract_model_only_on_meta():
    with pytest.raises(ValueError, match="meta"):
        api.init_params(SMOKE_CONFIGS["tinyllama-1.1b"], None, device="cpu")


def test_meta_model_has_the_seeded_models_names_shapes_and_types():
    cfg = SMOKE_CONFIGS["zamba2-7b"]
    meta = dict(api.init_params(cfg, None, device="meta").named_parameters())
    real = dict(api.init_params(cfg, 0, device="cpu").named_parameters())
    assert {n: (p.shape, p.dtype) for n, p in meta.items()} == {
        n: (p.shape, p.dtype) for n, p in real.items()}


# -- FLOPs against repro's compiled HLO ---------------------------------------------

# Where repro's prefill computes the head at every position, then slices the
# last one (the port's heads run on the last position only).
HEAD_LINE = {"dense": "repro/models/transformer.py:234,255",
             "moe": "repro/models/transformer.py:234,255",
             "vlm": "repro/models/transformer.py:234,255",
             "encdec": "repro/models/encdec.py:136,175",
             "ssm": "repro/models/recurrent.py:124,153",
             "hybrid": "repro/models/recurrent.py:375,379"}


def _attention_applications(cfg, s):
    """(Sq, Sk) of each attention a train step runs."""
    if cfg.family in ("dense", "moe"):
        return [(s, s)] * cfg.n_layers
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        return [(s, s)] * (cfg.n_layers - n_cross) + [(s, cfg.n_vision_tokens)] * n_cross
    if cfg.family == "encdec":
        f = cfg.n_audio_frames
        return [(f, f)] * cfg.n_encoder_layers + [(s, s), (s, f)] * cfg.n_layers
    if cfg.family == "hybrid":
        return [(s, s)] * (cfg.n_layers // cfg.attn_every)
    return []


def _moe_terms(cfg, kind, b, s):
    m = cfg.moe
    d, e, k = cfg.d_model, m.n_experts, m.top_k
    t = 1 if kind == "decode" else min(1024, s)
    g = b * (1 if kind == "decode" else s) // t
    c = max(int(math.ceil(k * t * m.capacity_factor / e)), 4)
    onehot = 2 * g * t * k * e * c    # [G, t, E, C] from the one-hots, over k
    tokens = 2 * g * t * e * c * d    # token layout ↔ expert layout, over t or (e, c)
    L = cfg.n_layers
    if kind == "prefill":
        return {"moe dispatch one-hot product": (L * onehot, "repro/models/moe.py:78"),
                "moe combine one-hot product": (L * onehot, "repro/models/moe.py:79"),
                "moe dispatch einsum (token → expert)": (L * tokens, "repro/models/moe.py:82"),
                "moe combine einsum (expert → token)": (L * tokens, "repro/models/moe.py:88")}
    if kind == "decode":  # t = 1: XLA joins the two one-hot products into one dot
        # (over both k), and the dispatch einsum's contraction over t = 1 is a multiply
        return {"moe dispatch and combine one-hot products":
                (2 * L * onehot, "repro/models/moe.py:78-79"),
                "moe combine einsum (expert → token)": (L * tokens, "repro/models/moe.py:88")}
    return {
        "moe one-hot products, forward and remat": (4 * L * onehot, "repro/models/moe.py:78-79"),
        "moe dispatch einsum, forward, remat, and the combine's d(ye)":
            (3 * L * tokens, "repro/models/moe.py:82,88"),
        "moe combine einsum forward, and the dispatch's d(x)":
            (2 * L * tokens, "repro/models/moe.py:88,82"),
        "moe combine's d(combine) over d": (L * tokens, "repro/models/moe.py:88"),
        "moe combine one-hot's d(selection) over c": (L * onehot, "repro/models/moe.py:79"),
        "moe gate's gradient as a product over e": (L * 2 * g * t * k * e,
                                                    "repro/models/moe.py:79"),
        "port: the router again for the load-balance loss (forward, remat, d(w), d(x))":
            (-4 * L * 2 * b * s * d * e, "repro_torch/models/moe.py:137"),
    }


def _ssm_terms(cfg, kind, b, s):
    n_s = cfg.n_layers // cfg.slstm_every
    n_m = cfg.n_layers - n_s
    h, hd = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads      # mLSTM heads
    shd = cfg.d_model // cfg.n_heads                          # sLSTM head width
    if kind == "prefill":
        return {"mLSTM n update as a product over the chunk":
                (n_m * 2 * b * s * h * hd, "repro/models/xlstm.py:168")}
    if kind == "decode":
        return {"mLSTM q·n as a product": (n_m * 2 * b * h * hd, "repro/models/xlstm.py:200")}
    return {  # one chunk (S 32): the final state is not used by the loss
        "mLSTM C update's d(k), d(v) in the scan's backward (its cotangent is zero, unseen)":
            (n_m * 2 * 2 * b * s * h * hd * hd, "repro/models/xlstm.py:165"),
        "port: the C update in the forward and the remat (XLA drops it: unused)":
            (-n_m * 2 * 2 * b * s * h * hd * hd, "repro_torch/kernels/mlstm_chunk/ref.py:89"),
        "mLSTM C update's d(gate) as a product over d":
            (n_m * 2 * b * s * h * hd, "repro/models/xlstm.py:165"),
        "mLSTM n update's d(gate) as a product over d":
            (n_m * 2 * b * s * h * hd, "repro/models/xlstm.py:168"),
        "port: d(q) of q·n as a product of K = 1 (XLA: a multiply)":
            (-n_m * 2 * b * s * h * hd, "repro_torch/kernels/mlstm_chunk/ref.py:83"),
        "sLSTM: the gradient of the initial h (autograd skips it)":
            (n_s * 2 * b * h * shd * 4 * shd, "repro/models/xlstm.py:258"),
    }


def _hybrid_terms(cfg, kind, b, s):
    if kind != "train":
        return {}
    d_in = cfg.ssm_expand * cfg.d_model
    p, n = cfg.ssm_headdim, cfg.ssm_state
    h = d_in // p
    L = cfg.n_layers
    return {"Mamba2 contrib's d(decay·dt) as a product over n":
            (L * 2 * b * s * h * n, "repro/models/ssm.py:137"),
            "Mamba2 contrib's d(B) as a product over h":
            (L * 2 * b * s * n * h, "repro/models/ssm.py:137"),
            "Mamba2 y_inter's d(exp(cum)) as a product over p":
            (L * 2 * b * s * h * p, "repro/models/ssm.py:158")}


def extra_terms(cfg, kind, b=B, s=S):
    """{term: (FLOPs, the line that does them)}: what ``repro``'s HLO counts
    and the port's count does not (negative: the port's own extra work)."""
    terms = {}
    if kind == "prefill":
        terms["head at every position"] = (2 * b * (s - 1) * cfg.d_model * cfg.vocab,
                                           HEAD_LINE[cfg.family])
    if kind == "train":
        remat = sum(2 * b * cfg.n_heads * sq * sk * cfg.hd
                    for sq, sk in _attention_applications(cfg, s))
        if remat:
            terms["attention: q·kᵀ again in each KV block's remat"] = (
                remat, "repro/models/attention.py:158")
    if cfg.family == "moe":
        terms.update(_moe_terms(cfg, kind, b, s))
    if cfg.family == "ssm":
        terms.update(_ssm_terms(cfg, kind, b, s))
    if cfg.family == "hybrid":
        terms.update(_hybrid_terms(cfg, kind, b, s))
    return terms


@functools.lru_cache(maxsize=None)
def _ref_flops(arch, kind):
    cell = ref_build_cell(REF_SMOKE[arch], RefShape("t", S, B, kind), make_host_mesh())
    return int(analyze_hlo(cell.lower().compile().as_text()).flops)


def _port_flops(arch, kind):
    return build_cell(SMOKE_CONFIGS[arch], ShapeConfig("t", S, B, kind), "cpu").count()[1].flops


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_counted_flops_plus_itemized_terms_equal_repros_hlo(arch, kind):
    terms = extra_terms(SMOKE_CONFIGS[arch], kind)
    port = _port_flops(arch, kind)
    assert port + sum(f for f, _ in terms.values()) == _ref_flops(arch, kind), terms
    for name, (f, _) in terms.items():  # the control: each term is needed
        assert f != 0 and port + sum(g for n, (g, _) in terms.items() if n != name) != \
            _ref_flops(arch, kind), name


def test_the_dense_prefill_control_misses_without_the_head_term():
    arch = "tinyllama-1.1b"
    assert _port_flops(arch, "prefill") != _ref_flops(arch, "prefill")
    assert _ref_flops(arch, "prefill") - _port_flops(arch, "prefill") == 2 * B * (S - 1) * 64 * 256


def test_no_remat_counts_no_recompute():
    cfg = SMOKE_CONFIGS["tinyllama-1.1b"]
    shape = ShapeConfig("t", S, B, "train")
    with_remat = build_cell(cfg, shape, "cpu").count()[1].flops
    without = build_cell(cfg, shape, "cpu", remat=False).count()[1].flops
    assert without < with_remat


# -- the CLI -----------------------------------------------------------------------------


def _records(out):
    return {(r["arch"], r["shape"]): r
            for r in (json.loads(p.read_text()) for p in sorted(Path(out).glob("*.json")))}


@pytest.fixture(scope="module")
def cli_records(tmp_path_factory):
    """Every architecture at decode_32k and long_500k counted inline, and
    tinyllama-1.1b at all four shapes in worker processes, on the CPU."""
    out = tmp_path_factory.mktemp("dryrun")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "workers", lambda n_tasks: 1)
        for argv in (["--shape", "long_500k"], ["--shape", "decode_32k"]):
            assert dryrun.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    assert dryrun.workers(3) == min(3, len(os.sched_getaffinity(0))) > 1
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--out", str(out)]) == 0
    return _records(out), out


def test_cli_records_carry_repros_keys(cli_records):
    recs, _ = cli_records
    assert len(recs) == 10 + 10 + 2  # long_500k, decode_32k × 10, tinyllama's two more
    skipped = sorted(k for k, r in recs.items() if r["status"] == "skipped")
    assert skipped == sorted((a, "long_500k") for a in ALL_ARCHS
                             if not get_config(a).is_subquadratic)
    assert not [k for k, r in recs.items() if r["status"] == "error"]
    for key, r in recs.items():
        if r["status"] != "ok":
            assert r["reason"]
            continue
        assert all(k in r for k in REPRO_KEYS), key
        assert set(r["memory"]) >= {"argument_size_in_bytes", "output_size_in_bytes",
                                    "temp_size_in_bytes", "alias_size_in_bytes"}
        assert set(r["cost_analysis"]) == {"flops", "bytes accessed"}
        assert r["mesh"] == "1card" and r["n_chips"] == 1 and r["collective_bytes_total"] == 0
        cfg, shape = get_config(r["arch"]), SHAPES[r["shape"]]
        tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
        assert r["model_flops_global"] == 6 * cfg.active_param_count() * tokens
        assert r["useful_flops_ratio"] == r["model_flops_global"] / r["cost_analysis"]["flops"]
        mem = r["memory"]
        peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        assert r["fits"] == (peak <= dryrun.CARD_BYTES_CPU)
        assert r["cards_needed"] == math.ceil(peak / dryrun.CARD_BYTES_CPU)
        assert r["dominant"] == max(r["roofline"], key=r["roofline"].get)
        assert "measured" not in r  # the CPU counts only
    # xlstm-1.3b × long_500k is the one cell of these that fits a card
    assert [k for k, r in recs.items() if r.get("fits")] == [("xlstm-1.3b", "long_500k")]
    assert recs[("tinyllama-1.1b", "prefill_32k")]["kernel_calls"] == {
        "rmsnorm": 45, "flash_attention": 22}
    assert recs[("tinyllama-1.1b", "train_4k")]["kernel_calls"] == {}


def test_cli_records_feed_repros_table_maker(cli_records, tmp_path, monkeypatch):
    _, out = cli_records
    spec = importlib.util.spec_from_file_location("make_tables", ROOT / "experiments"
                                                  / "make_tables.py")
    make_tables = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_tables)
    (tmp_path / "dryrun").mkdir()
    for p in Path(out).glob("*.json"):
        (tmp_path / "dryrun" / p.name).write_text(p.read_text())
    monkeypatch.setattr(make_tables, "HERE", str(tmp_path))
    make_tables.main()
    table = (tmp_path / "roofline_table.md").read_text()
    assert "14 compiled cells, 8 documented skips" in table
    assert "| xlstm-1.3b | long_500k | 1card |" in table


def test_cli_refuses_multi_pod_and_a_missing_card(tmp_path, monkeypatch):
    """``--multi-pod single`` writes the cell's record per device of the
    16x16 mesh (``tests/test_torch_sharding.py`` holds its numbers); a
    request for the card without one still raises."""
    monkeypatch.setattr(dryrun, "workers", lambda n_tasks: 1)
    try:
        assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--multi-pod",
                            "single", "--device", "cpu", "--out", str(tmp_path)]) == 0
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert path.name == "qwen1.5-0.5b_decode_32k_16x16.json"
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["n_chips"] == 256
    assert all(k in rec for k in REPRO_KEYS) and "cards_needed" not in rec
    assert rec["collective_bytes_total"] > 0 and rec["roofline"]["t_collective"] > 0
    with pytest.raises(SystemExit):
        dryrun.main(["--multi-pod", "pods", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k"])


def test_save_ops_writes_the_table_the_record_reads(tmp_path):
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "cpu", save_ops=str(tmp_path))
    table = json.loads((tmp_path / "qwen1.5-0.5b_decode_32k_1card.ops.json").read_text())
    (one,) = table["tables"].values()
    assert sum(row["flops"] for row in one["ops"].values()) == rec["cost_analysis"]["flops"]
    assert sum(row["bytes"] for row in one["ops"].values()) == rec["cost_analysis"][
        "bytes accessed"]


def test_check_fit_holds_the_fit_to_a_count_at_the_cells_length(tmp_path, monkeypatch):
    """``--check-fit`` on smoke xlstm-1.3b at a 768-token prefill: the fit
    from 256-640 tokens is held to the direct count at 768, which the record
    equals."""
    shape = ShapeConfig("prefill_768", 768, B, "prefill")
    monkeypatch.setattr(dryrun, "get_config", SMOKE_CONFIGS.__getitem__)
    monkeypatch.setattr(dryrun, "SHAPES", {shape.name: shape})
    monkeypatch.setattr(dryrun, "workers", lambda n_tasks: 1)
    assert dryrun.main(["--arch", "xlstm-1.3b", "--check-fit", "--device", "cpu",
                        "--out", str(tmp_path)]) == 0
    (rec,) = _records(tmp_path).values()
    assert rec["status"] == "ok" and rec["counted_at"] == [256, 384, 512, 640, 768]
    direct = dryrun.count_at("xlstm-1.3b", shape.name, 768).sizes
    assert rec["cost_analysis"] == {"flops": direct["flops"], "bytes accessed": direct["bytes"]}
    assert (rec["memory"]["argument_size_in_bytes"] + rec["memory"]["temp_size_in_bytes"]
            == direct["peak_bytes"])


def test_the_cli_runs_without_jax_or_repro(tmp_path):
    import subprocess
    import sys

    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            "rc = dryrun.main(['--arch', 'qwen3-4b', '--shape', 'long_500k', '--device', 'cpu'])\n"
            "rc = rc or dryrun.main(['--arch', 'xlstm-1.3b', '--shape', 'long_500k',\n"
            "                        '--device', 'cpu'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print('BAD', bad)\n"
            "sys.exit(rc or (3 if bad else 0))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout and "fits=True" in out.stdout
