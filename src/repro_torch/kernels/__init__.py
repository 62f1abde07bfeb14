"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``fused_vops`` (fused element-wise slot programs) and ``kdotp``
(batched row reductions). Sources live in ``repro_torch/csrc/``; they are
built with ``nvcc`` at first use (:mod:`repro_torch.kernels.build`)."""
