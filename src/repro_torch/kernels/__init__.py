"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``fused_vops`` (fused element-wise slot programs), ``kdotp``
(batched row reductions), ``spm_matmul``, ``spm_conv2d``, ``spm_fft``,
``het_mimd`` (the paper's compute kernels and their one-launch
composite), ``flash_attention`` and ``ssd_scan`` (the LM-scale
kernels), with the intrinsics layer ``ops`` and its oracles ``ref``
on top, and the deprecated ``kvi_vops.run_vops`` shim over
``fused_vops``. Sources live in ``repro_torch/csrc/``; they are built with
``nvcc`` at first use (:mod:`repro_torch.kernels.build`)."""
