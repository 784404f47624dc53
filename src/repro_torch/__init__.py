"""PyTorch/CUDA port of the Julienning partitioner and its head-count app.

A second package beside the JAX reference ``repro``: the same module names,
the same numerics (bit-identical float64 partition tables, a stated float32
tolerance for the window CNN), with the two TPU kernels on the main path
rewritten by hand in CUDA C++ for Hopper (``kernels/*/csrc``). It imports
``torch`` and numpy only — never ``jax`` and never ``repro``.

Every public entry point takes ``device=`` and defaults to ``"cuda"``;
asking for ``"cuda"`` without a card raises rather than running on the CPU.
"""
