"""Carry programs across from the reference package.

:func:`program_from_reference` turns a ``repro.kvi.ir.KviProgram`` into
the port's :class:`~repro_torch.kvi.ir.KviProgram` by duck typing alone
(it never imports ``repro``): it reads ``name``, ``items``, ``vregs``,
``mems``, ``mem_init`` (numpy), ``alg_ops`` and ``meta``, and each op
through ``op.value``. The reference's attached fusion plan is dropped;
the port's own pipeline re-plans. This is what lets a test run the same
program, with the same ``mem_init`` arrays, through both packages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.kvi.ir import (KviInstr, KviOp, KviProgram, MemRef, Ref,
                                ScalarBlock, VReg)
from repro_torch.kvi.passes.fusion import META_KEY


def _ref(r) -> Optional[Ref]:
    return None if r is None else Ref(r.space, int(r.id), int(r.offset))


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
