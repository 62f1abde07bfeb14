"""repro_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``repro``.

The reference package ``repro`` (JAX, Pallas kernels for the TPU) stays
as it is; this package keeps its own copy of every module it needs and
imports neither ``jax`` nor ``repro``. Slice 1 ports the KVI main path:
the IR, the pass pipeline, the paper's programs and a ``torch`` backend
whose two kernels are hand-written CUDA C++ in ``csrc/``.
"""
