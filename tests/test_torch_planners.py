"""The port's activation solvers against ``repro``'s (jax-free numpy solves).

For all ten architectures at their full width and ``repro``'s planner
shapes (``tests/test_planners.py``: b16 × 4096; remat at b4 × 4096):

* ``plan_offload`` at 2·Q_min: ``repro``'s bounds, segment peaks and
  offload bytes as they are (the memory model has no hardware constant),
  and its PCIe and compute seconds under the reference's scalars (the
  port's PCIe model and ``PEAK_FLOPS`` patched to ``repro``'s, as
  ``tests/test_torch_dse.py`` patches the analytical model); ``Infeasible``
  at Q_min / 2 where ``repro`` raises;
* ``plan_remat`` at 8, 16 and 64·Q_min: the same bounds and saved bytes,
  the same recompute and compute seconds under the reference's peak, and
  ``segments_for_scan``'s shape; ``Infeasible`` where ``repro`` raises;
* ``plan_pipeline`` with 8 stages, bottleneck ("max") and total ("sum"):
  every field equal under the reference's scalars (``repro``'s
  ``tpu_pipeline_model`` and peak); under the port's own H100 model, a
  balanced plan;
* the port's own versions of ``repro``'s dependency checks (whisper's
  ``enc_out`` loaded once by a burst over the decoder; zamba2's ``embed0``
  at most once a stage) and ``h100_pipeline_model``'s committed fields.
"""

import dataclasses

import pytest

from helpers_torch import port_cost
from repro.configs import get_config as ref_get_config
from repro.core import cost as ref_cost
from repro.core import offload as ref_offload
from repro.core import pipeline as ref_pipeline
from repro.core import remat_policy as ref_remat
from repro.core.partition import Infeasible as RefInfeasible

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import cost, layer_profile as lp, offload, pipeline, remat_policy
from repro_torch.core.burst import burst_detail
from repro_torch.core.partition import Infeasible

REMAT_BUDGETS = (8.0, 16.0, 64.0)


def test_all_ten_architectures():
    assert len(ALL_ARCHS) == 10 and "zamba2-7b" in ALL_ARCHS


@pytest.fixture()
def reference_scalars(monkeypatch):
    """The port's hardware constants set to ``repro``'s for one test."""
    monkeypatch.setattr(lp, "PEAK_FLOPS", ref_cost.PEAK_FLOPS)
    for mod in (offload, remat_policy):
        monkeypatch.setattr(mod, "PEAK_FLOPS", ref_cost.PEAK_FLOPS)
    monkeypatch.setattr(offload, "h100_host_offload_model",
                        lambda: port_cost(ref_cost.tpu_host_offload_model()))
    monkeypatch.setattr(pipeline, "h100_pipeline_model",
                        lambda: port_cost(ref_cost.tpu_pipeline_model()))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_offload_matches_reference(arch, reference_scalars):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    qmn = offload.min_activation_budget(cfg, 16, 4096)
    assert qmn == ref_offload.min_activation_budget(rcfg, 16, 4096)
    got = offload.plan_offload(cfg, 16, 4096, 2 * qmn)
    want = ref_offload.plan_offload(rcfg, 16, 4096, 2 * qmn)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert all(s <= 2 * qmn * (1 + 1e-9) for s in got.segment_peak_bytes)
    assert got.overhead_fraction == want.overhead_fraction
    with pytest.raises(RefInfeasible):
        ref_offload.plan_offload(rcfg, 16, 4096, 0.5 * qmn)
    with pytest.raises(Infeasible):
        offload.plan_offload(cfg, 16, 4096, 0.5 * qmn)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_offload_bounds_need_no_reference_scalar(arch):
    """The segmentation lives in the memory model: the port's own PCIe
    constants change only the prices."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    qmn = offload.min_activation_budget(cfg, 16, 4096)
    got = offload.plan_offload(cfg, 16, 4096, 2 * qmn)
    want = ref_offload.plan_offload(rcfg, 16, 4096, 2 * qmn)
    assert (got.bounds, got.segment_peak_bytes, got.offload_bytes) == (
        want.bounds, want.segment_peak_bytes, want.offload_bytes)
    assert got.compute_seconds == pytest.approx(
        want.compute_seconds * ref_cost.PEAK_FLOPS / cost.PEAK_FLOPS, rel=1e-12)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_remat_matches_reference(arch, reference_scalars):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    qmn = offload.min_activation_budget(cfg, 4, 4096)
    feasible = 0
    for m in REMAT_BUDGETS:
        try:
            want = ref_remat.plan_remat(rcfg, 4, 4096, qmn * m)
        except RefInfeasible:
            with pytest.raises(Infeasible):
                remat_policy.plan_remat(cfg, 4, 4096, qmn * m)
            continue
        feasible += 1
        got = remat_policy.plan_remat(cfg, 4, 4096, qmn * m)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert remat_policy.segments_for_scan(cfg.n_layers, got) == \
            ref_remat.segments_for_scan(rcfg.n_layers, want)
    assert feasible >= 2


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("objective", ["max", "sum"])
def test_pipeline_matches_reference(arch, objective, reference_scalars):
    got = pipeline.plan_pipeline(get_config(arch), 16, 4096, 8, objective)
    want = ref_pipeline.plan_pipeline(ref_get_config(arch), 16, 4096, 8, objective)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.balance == want.balance and got.summary() == want.summary()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_pipeline_on_the_h100_model_is_balanced(arch):
    """``repro``'s own check (tests/test_planners.py), on the port's
    NVLink-priced stages: 8 stages within 25% of a perfect balance."""
    pp = pipeline.plan_pipeline(get_config(arch), 16, 4096, 8)
    assert pp.n_stages == len(pp.bounds) == 8
    assert pp.balance < 1.25 and pp.bottleneck_seconds > 0
    n_tasks = len(lp.profile_model(get_config(arch), 16, 4096)[0])
    assert pp.bounds[0][0] == 1 and pp.bounds[-1][1] == n_tasks


def test_whisper_keeps_enc_out_resident():
    """One burst over all decoder layers loads the encoder output once (the
    paper's image-packet pattern), on the port's pipeline model."""
    cfg = get_config("whisper-large-v3")
    profiles, ll = lp.profile_model(cfg, 16, 4096)
    g = lp.build_activation_graph(profiles, ll, kind="time")
    d = burst_detail(g, cost.h100_pipeline_model(), cfg.n_encoder_layers + 1, g.n_tasks)
    assert d.loads.count("enc_out") == 1


def test_zamba_stages_load_the_embedding_at_most_once():
    cfg = get_config("zamba2-7b")
    pp = pipeline.plan_pipeline(cfg, 16, 4096, 4)
    profiles, ll = lp.profile_model(cfg, 16, 4096)
    g = lp.build_activation_graph(profiles, ll, kind="time")
    loads = [burst_detail(g, cost.h100_pipeline_model(), i, j).loads.count("embed0")
             for (i, j) in pp.bounds]
    assert max(loads) <= 1 and sum(loads) >= len(pp.bounds) - 1


def test_h100_pipeline_model_as_committed():
    """NVLink 4 one way (NVIDIA's data sheet: 900 GB/s in total, 450 GB/s
    each way), the hop's start-up the measured ``LAUNCH_S``; no TPU figure."""
    cm = cost.h100_pipeline_model()
    assert cm.name == "h100-pipeline" and cm.e_startup == 0.0
    assert (cm.read.c0, cm.read.c1) == (cost.LAUNCH_S, 1.0 / 450e9)
    assert (cm.write.c0, cm.write.c1) == (0.0, 0.0)
    assert cost.NVLINK_BW == 450e9 and cost.HOP_INIT_S == cost.LAUNCH_S == 12.3e-6
    ref = ref_cost.tpu_pipeline_model()
    assert (cm.read.c0, cm.read.c1) != (ref.read.c0, ref.read.c1)
