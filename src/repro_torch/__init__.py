"""PyTorch/CUDA port of the Julienning partitioner, its head-count app and
its serving models.

A second package beside the JAX reference ``repro``: the same module names,
the same numerics (bit-identical float64 partition tables and plan tables,
stated tolerances for the float32/bf16 kernels), with every TPU kernel
rewritten by hand in CUDA C++ for Hopper (``kernels/*/csrc``). It imports
``torch`` and numpy only — never ``jax`` and never ``repro``. The solver's
front door is :mod:`repro_torch.api` (``solve(PartitionSpec(...))``).

Every public entry point takes ``device=`` (or, in the façade,
``backend=``) and defaults to the card; asking for it without one raises
rather than running on the CPU.
"""
