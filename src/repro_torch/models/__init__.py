"""The port of the reference's ``repro/models`` on one device: ``layers``
(norms, RoPE, chunked and quadratic attention, decode attention) and
``ssm`` (the Mamba-2 SSD chunked scan and its recurrences), the oracles
of the attention and SSD kernels; ``sharding`` (the logical-axis rules,
no mesh), ``params`` (templates, seeded init, weights carried across
from the reference), ``moe``, ``model_zoo`` (every family's templates
and forward passes) and ``steps`` (train, prefill and decode)."""
from repro_torch.models import (layers, model_zoo, moe, params,  # noqa: F401
                                sharding, ssm, steps)
