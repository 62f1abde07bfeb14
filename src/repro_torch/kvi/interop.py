"""Carry programs across from the reference package.

:func:`program_from_reference` turns a ``repro.kvi.ir.KviProgram`` into
the port's :class:`~repro_torch.kvi.ir.KviProgram` by duck typing alone
(it never imports ``repro``): it reads ``name``, ``items``, ``vregs``,
``mems``, ``mem_init`` (numpy), ``alg_ops`` and ``meta``, and each op
through ``op.value``. The reference's attached fusion plan is dropped;
the port's own pipeline re-plans. This is what lets a test run the same
program, with the same ``mem_init`` arrays, through both packages.

:func:`array_from_reference` carries a kernel's data across: the
compute kernels have no weights, their inputs are the data.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kvi.ir import (KviInstr, KviOp, KviProgram, MemRef, Ref,
                                ScalarBlock, VReg)
from repro_torch.kvi.passes.fusion import META_KEY


def _ref(r) -> Optional[Ref]:
    return None if r is None else Ref(r.space, int(r.id), int(r.offset))


def array_from_reference(x) -> torch.Tensor:
    """A CPU tensor holding a copy of ``x`` (a numpy array, or anything
    ``np.asarray`` takes, such as a reference JAX array). bfloat16
    arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses, so it crosses bit for bit through a ``uint16`` view."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        bits = np.array(x, copy=True, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True))


def program_from_reference(obj) -> KviProgram:
    """The port's copy of a reference program (buffers copied)."""
    items = []
    for it in obj.items:
        if hasattr(it, "op"):
            items.append(KviInstr(KviOp(it.op.value), _ref(it.dst),
                                  _ref(it.src1), _ref(it.src2),
                                  int(it.scalar), int(it.length),
                                  int(it.elem_bytes)))
        else:
            items.append(ScalarBlock(int(it.count)))
    return KviProgram(
        name=obj.name,
        items=tuple(items),
        vregs=tuple(VReg(r.name, int(r.id), int(r.length),
                         int(r.elem_bytes)) for r in obj.vregs),
        mems=tuple(MemRef(m.name, int(m.id), int(m.length),
                          int(m.elem_bytes), bool(m.is_output))
                   for m in obj.mems),
        mem_init={int(k): np.array(v, copy=True)
                  for k, v in obj.mem_init.items()},
        alg_ops=int(obj.alg_ops),
        meta={k: v for k, v in obj.meta.items() if k != META_KEY})
