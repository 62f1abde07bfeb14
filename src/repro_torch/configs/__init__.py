"""repro_torch.configs — the port's copy of ``repro.configs.base``, as far
as the port uses it: ``KlessydraConfig`` (the paper's coprocessor
taxonomy, which the cycle model, the lowering and the serving engine run
on) and ``klessydra_taxonomy``. The LM framework's config classes, the
per-model config modules and the ``--arch`` registry are not copied yet.
"""
from repro_torch.configs.base import KlessydraConfig, klessydra_taxonomy

__all__ = ["KlessydraConfig", "klessydra_taxonomy"]
