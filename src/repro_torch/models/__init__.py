"""The port of the reference's ``repro/models``: ``layers`` (norms, RoPE,
chunked and quadratic attention, decode attention) and ``ssm`` (the
Mamba-2 SSD chunked scan and its recurrences), the oracles of the
attention and SSD kernels; ``sharding`` (the logical-axis rules and
their DTensor placements on a ``DeviceMesh``), ``params`` (templates,
seeded init, shardings, weights carried across from the reference),
``moe``, ``model_zoo`` (every family's templates and forward passes),
``steps`` (train, prefill and decode) and ``pipeline`` (GPipe over a
mesh axis)."""
from repro_torch.models import (layers, model_zoo, moe, params,  # noqa: F401
                                pipeline, sharding, ssm, steps)
