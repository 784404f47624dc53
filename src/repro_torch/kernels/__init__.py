"""Hand-written Hopper kernels (CUDA C++ under ``*/csrc``), each with a plain
PyTorch version beside it in ``ref.py``. ``_build.py`` compiles all sources
into one shared library at first use."""
