"""Hand-written Hopper kernels (CUDA C++ under ``*/csrc``), each with a plain
PyTorch version beside it in ``ref.py``. ``_build.py`` compiles all sources
into one shared library at first use."""


def launch_counters():
    """Every kernel wrapper; each counts its launches in ``.launches``."""
    from .conv_window.kernel import conv_window_frame_cuda, conv_window_scores_cuda
    from .flash_attention.kernel import flash_attention_bkv_cuda
    from .mlstm_chunk.kernel import mlstm_chunk_bh_cuda
    from .partition_sweep.kernel import sweep_columns_cuda
    from .rmsnorm.kernel import rmsnorm_rows_cuda

    return (sweep_columns_cuda, conv_window_frame_cuda, conv_window_scores_cuda,
            rmsnorm_rows_cuda, flash_attention_bkv_cuda, mlstm_chunk_bh_cuda)
