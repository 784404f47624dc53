"""The port's training path against ``repro``'s: synthetic data, AdamW, the
burst checkpointer and its cadence planner, ``Partition.summary``, the
train step and the train CLI, and the kernel wrappers' refusal of tensors
that need a gradient.

Tolerances:
- synthetic batches, the burst schedule, ``summary()`` and ``--plan-bursts``:
  equal (numpy on both sides; the schedule's DP is the oracle's);
- AdamW on float32: the same operations in the same order, so only each
  leaf's sum of squares (and so the clip scale, by an ulp) and the power
  b^step may round differently: the global norm within 2 ulps, each
  parameter and moment within 4 ulps of its leaf's largest value (one ulp
  of the scale at each of 3 steps, and one rounding); read 2 at most;
- a crashed and resumed run: ``repro``'s own ``rtol`` of 1e-6 against the
  uninterrupted run (the port is deterministic on the CPU, so equal);
- three train steps against ``repro``'s ``api.loss`` + ``adamw_update`` from
  the same parameters: each loss within 2·n_fwd·2^-9·max|logits| (the CE
  bound of ``tests/test_torch_loss.py``); each master within 2.01·Σ lr_t of
  ``repro``'s, since an AdamW step moves an element by at most lr·(1 +
  weight_decay·|p|) (|m̂|/√v̂ ≤ 1.0004 for t ≤ 3 at b1 0.9, b2 0.95) and a
  gradient near zero may take either sign; and after the first step, every
  element whose reference gradient is larger than its gradient tolerance
  (its sign cannot flip) within lr_1·2^-7 + 2 ulps of ``repro``'s.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.burst_ckpt import plan_burst_schedule as ref_plan_burst_schedule
from repro.data.synthetic import SyntheticConfig as RefSyntheticConfig
from repro.data.synthetic import SyntheticData as RefSyntheticData
from repro.launch import train as ref_train
from repro.optim import adamw as ref_adamw

from helpers_torch import three_steps_against_reference

from repro_torch.checkpoint.burst_ckpt import BurstCheckpointer, plan_burst_schedule
from repro_torch.configs import SMOKE_CONFIGS
from repro_torch.data.synthetic import SyntheticConfig, SyntheticData
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.launch import train as train_mod
from repro_torch.models import api
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
RESUME = dict(arch="qwen1.5-0.5b", steps=6, batch=2, seq=16, burst_steps=2, smoke=True,
              log_every=100)


# -- synthetic data ----------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [(256, 16, 2, 0), (32000, 128, 8, 0),
                                                  (257, 33, 3, 5)])
def test_synthetic_batches_equal_reference(vocab, seq, batch, seed):
    ref = RefSyntheticData(RefSyntheticConfig(vocab, seq, batch, seed=seed))
    got = SyntheticData(SyntheticConfig(vocab, seq, batch, seed=seed))
    for i in (0, 1, 49, 1234):
        a, b = ref.batch(i), got.batch(i)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert np.array_equal(next(iter(got))["tokens"], ref.batch(0)["tokens"])


# -- AdamW -------------------------------------------------------------------------------


def _tree(rs):
    return {"a": rs.randn(5, 7).astype(np.float32),
            "b": {"c": rs.randn(11).astype(np.float32), "d": rs.randn(3, 3).astype(np.float32)}}


def _flat(tree):
    return {"a": tree["a"], "b.c": tree["b"]["c"], "b.d": tree["b"]["d"]}


def _within_ulps(got, want, ulps):
    """|got − want| ≤ ``ulps`` float32 ulps of the leaf's largest |want|."""
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got) - want).max() <= ulps * np.spacing(np.abs(want).max())


@pytest.mark.parametrize("clip_norm,grad_scale", [(0.5, 3.0), (1e9, 1.0)],
                         ids=["clipping", "no_clipping"])
def test_adamw_three_updates_match_reference(clip_norm, grad_scale):
    """Warm-up over 2 steps (lr 5e-3, then 1e-2), clipping on or off."""
    kw = dict(lr=1e-2, warmup_steps=2, clip_norm=clip_norm)
    rcfg, cfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rs = np.random.RandomState(0)
    tree = _tree(rs)
    rp = jax.tree.map(jnp.asarray, tree)
    rstate = ref_adamw.adamw_init(rp)
    params = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree).items()}
    state = adamw.adamw_init(params)
    for _ in range(3):
        g = jax.tree.map(lambda a: a * grad_scale, _tree(rs))
        rp, rstate, rstats = ref_adamw.adamw_update(rcfg, rp, jax.tree.map(jnp.asarray, g),
                                                    rstate)
        stats = adamw.adamw_update(cfg, params, {k: torch.from_numpy(v) for k, v in
                                                 _flat(g).items()}, state)
        assert _within_ulps(float(stats["grad_norm"]), float(rstats["grad_norm"]), 2)
        assert float(stats["lr"]) == float(rstats["lr"])
        for k, want in _flat(jax.tree.map(np.asarray, rp)).items():
            assert _within_ulps(params[k].numpy(), want, 4), k
        for part in ("m", "v"):
            for k, want in _flat(jax.tree.map(np.asarray, rstate[part])).items():
                assert _within_ulps(state[part][k].numpy(), want, 4), (part, k)
    assert int(state["step"]) == int(rstate["step"]) == 3
    assert state["step"].dtype == torch.int32


def test_clip_by_global_norm_matches_reference():
    rs = np.random.RandomState(1)
    g = _tree(rs)
    want, wn = ref_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.25)
    got, gn = adamw.clip_by_global_norm({k: torch.from_numpy(v) for k, v in _flat(g).items()},
                                        0.25)
    assert _within_ulps(float(gn), float(wn), 2)
    for k, w in _flat(jax.tree.map(np.asarray, want)).items():
        assert _within_ulps(got[k].numpy(), w, 2)


# -- the checkpointer --------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    ck = BurstCheckpointer(str(tmp_path))
    nbytes = ck.save(3, {"w": torch.arange(10.0), "step": torch.tensor(7, dtype=torch.int32),
                         "m": {"x": torch.ones(2, 2)}})
    assert nbytes == os.path.getsize(tmp_path / "ckpt_00000003.pkl")
    b, restored = ck.restore()
    assert b == 3 and ck.committed_burst() == 3
    np.testing.assert_array_equal(restored["w"], np.arange(10.0))
    assert restored["step"].dtype == np.int32 and int(restored["step"]) == 7
    np.testing.assert_array_equal(restored["m"]["x"], np.ones((2, 2)))


def test_uncommitted_burst_stays_invisible(tmp_path):
    """A checkpoint file without a committed index is not restored: a crash
    between the state write and the index commit."""
    import pickle

    ck = BurstCheckpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros(3)})
    with open(tmp_path / "ckpt_00000002.pkl", "wb") as fh:
        pickle.dump({"w": np.ones(3)}, fh)
    b, st = ck.restore()
    assert b == 1
    np.testing.assert_array_equal(st["w"], np.zeros(3))


def test_gc_keeps_the_two_newest(tmp_path):
    ck = BurstCheckpointer(str(tmp_path), keep=2)
    for b in range(1, 6):
        ck.save(b, {"w": torch.full((2,), float(b))})
    assert sorted(p.name for p in tmp_path.glob("ckpt_*")) == ["ckpt_00000004.pkl",
                                                              "ckpt_00000005.pkl"]
    assert ck.restore()[0] == 5
    assert BurstCheckpointer(str(tmp_path / "empty")).restore() is None


# -- the burst schedule and Partition.summary ----------------------------------------------


SCHEDULES = [  # repro's TestBurstSchedule cases, and the CLI's --plan-bursts
    dict(n_steps=100, step_seconds=1.0, state_bytes=10**9, max_loss_seconds=20.0,
         restart_seconds=5.0),
    dict(n_steps=60, step_seconds=1.0, state_bytes=10**8, max_loss_seconds=20.0,
         restart_seconds=1.0, disk_bw=1e10),
    dict(n_steps=60, step_seconds=1.0, state_bytes=int(5e9), max_loss_seconds=20.0,
         restart_seconds=1.0, disk_bw=1e9),
    dict(n_steps=50, step_seconds=1.0, state_bytes=10**9, max_loss_seconds=60.0),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=["bound", "fast_disk", "slow_disk", "cli"])
def test_burst_schedule_and_summary_equal_reference(kw):
    want = ref_plan_burst_schedule(**kw)
    for backend in ("numpy", "torch"):
        got = plan_burst_schedule(**kw, backend=backend)
        assert got.bounds == want.bounds, backend
        assert got.summary() == want.summary()
        assert got.transfer_bytes == want.transfer_bytes
        assert got.max_burst <= kw["max_loss_seconds"] * (1 + 1e-9)


def test_plan_bursts_cli_prints_the_reference_text(capsys):
    assert ref_train.main(["--plan-bursts"]) == 0
    want = capsys.readouterr().out
    assert train_mod.main(["--plan-bursts"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("bursts=2  ") and "burst bounds: [(1, 24)" in got


# -- the train step and the loop ------------------------------------------------------------


def test_three_train_steps_match_reference():
    """tinyllama-1.1b's smoke config, b2 × 16, lr 1e-3 warming up over 20
    steps, as ``repro``'s train CLI runs it (module docstring: tolerances)."""
    three_steps_against_reference(
        lambda cfg, a: lambda model, state, b: train_mod.train_step(cfg, model, state, a, b))


def test_resume_matches_uninterrupted(tmp_path):
    """``repro``'s ``TestTrainResume``: a run of burst 1 only (steps 0-1),
    then a rerun to 6 steps resumes at step 2 with the same losses."""
    want = train_mod.train(ckpt_dir=str(tmp_path / "a"), device="cpu", **RESUME)
    kw = {k: v for k, v in RESUME.items() if k != "steps"}
    train_mod.train(ckpt_dir=str(tmp_path / "b"), steps=2, device="cpu", **kw)
    got = train_mod.train(ckpt_dir=str(tmp_path / "b"), device="cpu", **RESUME)
    assert len(got) == 4
    np.testing.assert_allclose(got, want[2:], rtol=1e-6)


def test_cli_crash_after_burst_and_resume(tmp_path):
    """``--crash-after-burst 1`` exits 1 after committing burst 1; the same
    command without it resumes from burst 1 and ends on the uninterrupted
    run's last loss."""
    want = train_mod.train(ckpt_dir=str(tmp_path / "a"), device="cpu", **RESUME)
    argv = ["--device", "cpu", "--arch", "qwen1.5-0.5b", "--steps", "6", "--batch", "2",
            "--seq", "16", "--burst-steps", "2", "--ckpt-dir", str(tmp_path / "b")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = [sys.executable, "-m", "repro_torch.launch.train"]
    out = subprocess.run(run + argv + ["--crash-after-burst", "1"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "[train] burst 1/3 committed" in out.stdout
    assert out.stdout.rstrip().endswith("[train] injected crash! rerun to resume.")
    out = subprocess.run(run + argv, env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[train] resumed from burst 1 (step 2)" in out.stdout
    assert "[train] burst 3/3 committed" in out.stdout
    assert out.stdout.rstrip().endswith(f"→ last {want[-1]:.4f}")


def test_training_lowers_the_loss(tmp_path):
    """tinyllama-1.1b's smoke config learns the synthetic stream: the mean
    of the last five of 30 losses is below that of the first five."""
    losses = train_mod.train("tinyllama-1.1b", steps=30, batch=4, seq=32, burst_steps=30,
                             ckpt_dir=str(tmp_path), device="cpu", log_every=100, lr=1e-2)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


# -- devices and the kernels' refusal --------------------------------------------------------


def test_cuda_request_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract cannot be observed")
    with pytest.raises(RuntimeError, match="cuda"):
        train_mod.main(["--device", "cuda", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        api.init_trainable(SMOKE_CONFIGS["tinyllama-1.1b"], device="cuda")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card: reaches the wrappers' CUDA
    branch without one."""

    @property
    def is_cuda(self):
        return True


def _on_card(*shape, grad=False):
    return torch.randn(*shape, requires_grad=grad).as_subclass(_OnCard)


@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention", "mlstm_cell"])
def test_kernel_wrappers_refuse_tensors_that_need_a_gradient(kernel, monkeypatch):
    """On a card the kernels have no backward: with grad mode on, a tensor
    that requires grad makes the wrapper raise before any launch; under
    ``no_grad`` the launch goes ahead (here a stand-in that records it)."""
    launched = []

    def fake(*args, **kw):
        launched.append(kernel)
        raise LookupError("launched")

    if kernel == "rmsnorm":
        monkeypatch.setattr(rmsnorm_ops, "rmsnorm_rows_cuda", fake)
        call = lambda g: rmsnorm_ops.rmsnorm(_on_card(2, 8, grad=g), torch.ones(8))  # noqa: E731
    elif kernel == "flash_attention":
        monkeypatch.setattr(flash_ops, "flash_attention_bkv_cuda", fake)
        call = lambda g: flash_ops.flash_attention(  # noqa: E731
            _on_card(1, 4, 2, 8, grad=g), _on_card(1, 4, 1, 8), _on_card(1, 4, 1, 8))
    else:
        monkeypatch.setattr(mlstm_ops, "mlstm_chunk_bh_cuda", fake)
        call = lambda g: mlstm_ops.mlstm_cell(  # noqa: E731
            _on_card(1, 4, 2, 8, grad=g), _on_card(1, 4, 2, 8), _on_card(1, 4, 2, 8),
            _on_card(1, 4, 2), _on_card(1, 4, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    assert not launched
    with torch.no_grad(), pytest.raises(LookupError):
        call(True)
    with pytest.raises(LookupError):
        call(False)
    assert launched == [kernel, kernel]
