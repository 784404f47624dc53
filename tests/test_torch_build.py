"""Kernel wrappers launch or raise; the build finds every CUDA source.

No compiler or card is needed: the wrappers must refuse tensors that are not
on a card (never running the plain version in their place), and the build
must collect every kernel's source under one content hash, with a C
signature declared for each launcher.
"""

import re
import shutil

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv_window.kernel import conv_window_frame_cuda, conv_window_scores_cuda
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, flash_attention_bkv_cuda
from repro_torch.kernels.mlstm_chunk.kernel import HEAD_DIM_MULTIPLE, MAX_HEAD_DIM_BF16
from repro_torch.kernels.partition_sweep.kernel import sweep_columns_cuda
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_rows_cuda


def test_sources_and_digest():
    names = sorted(p.name for p in _build._sources())
    assert names == ["conv_window.cu", "flash_attention.cu", "mlstm_chunk.cu",
                     "partition_sweep.cu", "rmsnorm.cu", "runtime.cu"]
    d = _build._digest(_build._sources())
    assert d == _build._digest(_build._sources()) and len(d) == 16
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "repro_torch")
    assert "sm_90a" in " ".join(_build._FLAGS)
    assert _build._EXTRA["partition_sweep.cu"] == ["-fmad=false"]
    assert "rmsnorm.cu" not in _build._EXTRA and "flash_attention.cu" not in _build._EXTRA
    assert "mlstm_chunk.cu" not in _build._EXTRA


@pytest.mark.parametrize("name,n_args,source", [
    ("rmsnorm_launch", 8, "rmsnorm/csrc/rmsnorm.cu"),
    # the case's id from before the entry took q_start, with 13 arguments
    pytest.param("flash_attention_launch", 14, "flash_attention/csrc/flash_attention.cu",
                 id="flash_attention_launch-13-flash_attention/csrc/flash_attention.cu"),
    ("mlstm_chunk_launch", 16, "mlstm_chunk/csrc/mlstm_chunk.cu"),
    ("conv_window_launch", 10, "conv_window/csrc/conv_window.cu"),
    ("conv_window_frame_launch", 7, "conv_window/csrc/conv_window.cu"),
])
def test_model_kernel_signatures(name, n_args, source):
    """Each launcher's declared ctypes signature matches its C definition:
    the argument count, a float (not double) in the place of each float
    scalar and nowhere else, an int result."""
    argtypes, restype = _build._SIGNATURES[name]
    assert len(argtypes) == n_args and restype is _build.ctypes.c_int
    assert _build.ctypes.c_double not in argtypes
    text = (_build._PKG / source).read_text()
    head = text[text.index(f'extern "C" int {name}('):]
    params = [p.split() for p in head[head.index("(") + 1:head.index(")")].split(",")]
    assert len(params) == n_args
    float_scalar = [p[0] == "float" and "*" not in "".join(p) for p in params]
    assert [a is _build.ctypes.c_float for a in argtypes] == float_scalar


def test_flash_head_dims_match_the_instantiations():
    """The wrapper's head widths per element type are the ones the C entry
    point dispatches to: bf16 64, 112 and 128 on the tensor cores, float32
    64 and 128 on the CUDA cores."""
    text = (_build._PKG / "flash_attention/csrc/flash_attention.cu").read_text()
    body = text[text.index('extern "C" int flash_attention_launch('):]
    built = {code: tuple(sorted(int(h) for h in re.findall(rf"dtype == {code} && hd == (\d+)",
                                                          body)))
             for code in (0, 1)}
    assert built == {0: HEAD_DIMS[torch.float32], 1: HEAD_DIMS[torch.bfloat16]}
    assert 112 in HEAD_DIMS[torch.bfloat16] and 112 not in HEAD_DIMS[torch.float32]


def test_mlstm_bf16_head_dim_matches_the_kernel():
    """The wrapper's bfloat16 head-dim limit is what the tensor-core state
    kernel holds in registers: 32-wide d groups, kGroups a warp, kWarps
    warps; the C entry point refuses a wider bf16 head the same way."""
    text = (_build._PKG / "mlstm_chunk/csrc/mlstm_chunk.cu").read_text()
    tc = text[text.index("namespace tc {"):text.index("}  // namespace tc")]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", tc).group(1))

    assert 32 * const("kWarps") * const("kGroups") == MAX_HEAD_DIM_BF16 == 1024
    assert MAX_HEAD_DIM_BF16 % HEAD_DIM_MULTIPLE == 0
    assert "dtype == 1 && hd > tc::kMaxHd" in text


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


def test_conv_frame_wrapper_refuses_cpu_tensors():
    norm = torch.zeros(60, 80, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        conv_window_frame_cuda(norm, torch.zeros(1265), 0, 80, 1)
    assert conv_window_frame_cuda.launches == 0


def test_rmsnorm_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_rows_cuda(torch.zeros(2, 64, dtype=torch.bfloat16), torch.ones(64))
    assert rmsnorm_rows_cuda.launches == 0


def test_flash_wrapper_refuses_cpu_tensors():
    q = torch.zeros(2, 8, 4, 128, dtype=torch.bfloat16)
    kv = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bkv_cuda(q, kv, kv, causal=True)
    assert flash_attention_bkv_cuda.launches == 0
