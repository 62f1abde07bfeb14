"""The intrinsics layer: the port of the reference's
``repro/kernels/ops.py``. Model and example code calls these; each has
an oracle in :mod:`repro_torch.kernels.ref`.

Every function dispatches on its tensors' device: CUDA tensors launch
the port's hand-written kernels (``csrc/``), CPU tensors run the
kernels' plain PyTorch versions. PyTorch runs eagerly, so there is no
``jit``; the reference's TPU tiling knobs (``bm``/``bn``/``bk``,
``block_rows``, ``batch_block``, ``bq``/``bk``) and ``interpret`` have
no counterpart and are not taken.
"""
from __future__ import annotations

from repro_torch.kernels import kdotp as _kdotp
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_vops import fused_elementwise_call
from repro_torch.kernels.het_mimd import het_mimd_composite  # noqa: F401
from repro_torch.kernels.spm_conv2d import spm_conv2d
from repro_torch.kernels.spm_fft import spm_fft
from repro_torch.kernels.spm_matmul import spm_matmul
from repro_torch.kernels.ssd_scan import kernel_inputs, ssd_scan


# ---- KVI element-wise intrinsics (single-op / fused slot programs) ---------

def _ew(program, inputs):
    """One fused launch of the slot program; inputs occupy slots
    0..n-1, the last op's dst slot is the result."""
    out, = fused_elementwise_call(program, list(enumerate(inputs)),
                                  [program[-1][1]])
    return out.reshape(inputs[0].shape)


def kaddv(a, b):
    return _ew([("kaddv", 2, 0, 1, 0)], [a, b])


def ksubv(a, b):
    return _ew([("ksubv", 2, 0, 1, 0)], [a, b])


def kvmul(a, b):
    return _ew([("kvmul", 2, 0, 1, 0)], [a, b])


def krelu(a):
    return _ew([("krelu", 1, 0, None, 0)], [a])


def ksvaddsc(a, imm: int):
    return _ew([("ksvaddsc", 1, 0, None, imm)], [a])


def ksvmulsc(a, imm: int):
    return _ew([("ksvmulsc", 1, 0, None, imm)], [a])


def ksrlv(a, imm: int):
    return _ew([("ksrlv", 1, 0, None, imm)], [a])


def ksrav(a, imm: int):
    return _ew([("ksrav", 1, 0, None, imm)], [a])


def kvslt(a, b):
    return _ew([("kvslt", 2, 0, 1, 0)], [a, b])


def ksvslt(a, imm: int):
    return _ew([("ksvslt", 1, 0, None, imm)], [a])


def kvcp(a):
    return _ew([("kvcp", 1, 0, None, 0)], [a])


# fused example: relu(a*w + b) >> s — one device pass, four KVI ops
def fused_mac_relu(a, w, b, shift: int):
    prog = [("kvmul", 3, 0, 1, 0),
            ("kaddv", 3, 3, 2, 0),
            ("ksrav", 3, 3, None, shift),
            ("krelu", 3, 3, None, 0)]
    return _ew(prog, [a, w, b])


# ---- reductions -------------------------------------------------------------

kdotp = _kdotp.kdotp
kdotpps = _kdotp.kdotpps
kvred = _kdotp.kvred


# ---- compute kernels --------------------------------------------------------

matmul_op = spm_matmul
conv2d_op = spm_conv2d
fft_op = spm_fft


def attention_op(q, k, v, *, causal: bool = True, window: int = 0,
                 q_offset: int = 0):
    """q [B, H, Sq, hd], k / v [B, KV, Skv, hd] -> [B, H, Sq, hd]: one
    launch of the flash-attention kernel."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def ssd_scan_op(x, dt, A, B, C, *, chunk: int = 256):
    """Model-facing wrapper: x [Bz,S,H,P], dt [Bz,S,H], A [H],
    B/C [Bz,S,G,N] (GQA-style groups) — broadcasts groups to heads,
    precomputes da = dt*A, calls the kernel (one launch)."""
    return ssd_scan(*kernel_inputs(x, dt, A, B, C), chunk=chunk)
