"""Kernel wrappers launch or raise; the build finds every CUDA source.

No compiler or card is needed: the wrappers must refuse tensors that are not
on a card (never running the plain version in their place), and the build
must collect both kernels' sources under one content hash.
"""

import shutil

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv_window.kernel import conv_window_scores_cuda
from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda


def test_sources_and_digest():
    names = sorted(p.name for p in _build._sources())
    assert names == ["conv_window.cu", "partition_sweep.cu", "runtime.cu"]
    d = _build._digest(_build._sources())
    assert d == _build._digest(_build._sources()) and len(d) == 16
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "repro_torch")
    assert "sm_90a" in " ".join(_build._FLAGS)
    assert _build._EXTRA["partition_sweep.cu"] == ["-fmad=false"]


def test_missing_nvcc_raises():
    if shutil.which("nvcc") or _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_sweep_wrapper_refuses_cpu_tensors():
    i = torch.zeros(2, dtype=torch.int32)
    f = torch.zeros(1, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        sweep_columns_cuda(i, f, f, 0.0, f[:0], f[:0], i[:0], i[:0], i[:0], f,
                           exact_k=False, combine_max=False)
    assert sweep_columns_cuda.launches == 0


def test_conv_wrapper_refuses_cpu_tensors():
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        conv_window_scores_cuda(z(1, 12, 12), z(3, 3, 1, 8), z(8), z(3, 3, 8, 16),
                                z(16), z(16), z(()))
    assert conv_window_scores_cuda.launches == 0
