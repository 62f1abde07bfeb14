"""DEPRECATED — the untyped tuple protocol for fused element-wise KVI
programs, the port of the reference's ``repro/kernels/kvi_vops.py``.
Superseded by the typed IR in ``repro_torch.kvi`` (author programs with
:class:`repro_torch.kvi.KviProgramBuilder`, run them on the ``torch``
backend) and, at this level, by
:func:`repro_torch.kernels.fused_vops.fused_elementwise_call`.

Kept so existing call sites keep working; ``run_vops`` adapts the tuple
encoding onto that call and warns. On a CUDA tensor that is one launch
of the ``fused_vops`` kernel (``csrc/fused_vops.cu``); on a CPU tensor,
its plain version.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.fused_vops import apply_vop, fused_elementwise_call

# (op, dst_slot, src1_slot, src2_slot_or_None, immediate)
VOp = Tuple[str, int, int, Optional[int], int]

_ELEMWISE = {"kaddv", "ksubv", "kvmul", "ksvaddsc", "ksvmulsc", "ksrlv",
             "ksrav", "krelu", "kvslt", "ksvslt", "kvcp"}

__all__ = ["VOp", "apply_vop", "run_vops"]


def run_vops(program: Sequence[VOp], inputs: Sequence[torch.Tensor],
             out_slot: Optional[int] = None, n_slots: Optional[int] = None,
             block: int = 256) -> torch.Tensor:
    """Execute a KVI element-wise program over equal-shaped input vectors
    (slots 0..n-1); the result is ``out_slot`` (the last op's dst by
    default) in the inputs' shape. ``block`` is the CUDA block size.

    .. deprecated:: use ``repro_torch.kvi`` (typed IR + torch backend);
       this shim forwards to
       :func:`repro_torch.kernels.fused_vops.fused_elementwise_call`.
    """
    warnings.warn(
        "repro_torch.kernels.kvi_vops.run_vops is deprecated; build a typed "
        "program with repro_torch.kvi.KviProgramBuilder or call "
        "repro_torch.kernels.fused_vops.fused_elementwise_call directly",
        DeprecationWarning, stacklevel=2)
    program = tuple(program)
    for op, *_ in program:
        if op not in _ELEMWISE:
            raise ValueError(f"{op} is not an element-wise KVI op")
    if n_slots is None:
        n_slots = max([len(inputs)] + [o[1] + 1 for o in program])
    if out_slot is None:
        out_slot = program[-1][1]
    x0 = inputs[0]
    out, = fused_elementwise_call(program, list(enumerate(inputs)),
                                  [out_slot], n_slots=n_slots, block=block)
    return out.reshape(x0.shape)
