"""Trace replay (the port's copy of the part of ``repro.core.programs``
the KVI lowering uses).

:func:`_run_items` replays an ``Instr``/``Scalar`` trace on the
SPM/main-memory model — it is what
:meth:`repro_torch.kvi.lowering.LoweredTrace.execute` runs. The
reference's legacy ``Program`` container, its deprecated
``ProgramBuilder`` and the ``build_*`` helpers are not copied: programs
are authored with :class:`repro_torch.kvi.KviProgramBuilder` or
``repro_torch.kvi.programs``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.isa import Instr
from repro_torch.core.mfu import Mfu
from repro_torch.core.spm import SpmSpace


def _run_items(items, spm: SpmSpace, mem: Dict[int, np.ndarray]):
    """Replay a trace on the SPM/main-memory model, spilling register-file
    reduction results (``rf_store``) back into the SPM. (Shared with
    ``repro_torch.kvi.lowering.LoweredTrace.execute``; rf_store is
    ``(addr, elem_index, elem_bytes)``.)"""
    mfu = Mfu(spm, mem)
    for it in items:
        if isinstance(it, Instr):
            r = mfu.execute(it)
            tgt = getattr(it, "rf_store", None)
            if tgt is not None and r is not None:
                addr, j, eb = tgt
                dt = {1: np.int8, 2: np.int16, 4: np.int32}[eb]
                # wrap to the destination width like the hardware store
                # (np >= 2 raises on out-of-range python ints otherwise)
                spm.write(addr + eb * j, np.array([r], np.int64).astype(dt))
    return mem
