"""PyTorch/CUDA port of the GPTQT serving stack.

A second package beside `repro` (the JAX reference): it loads the same
packed artifacts, runs the same model math and serves through the same
paged engine, with the reference's Pallas kernels rewritten by hand in
CUDA C++ for Hopper (`csrc/`). It imports `torch` and never `jax` nor
anything of `repro`; only the parity tests import both.

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`hw.resolve_device`); with no GPU and no explicit CPU request they
raise instead of silently running on the host.
"""
