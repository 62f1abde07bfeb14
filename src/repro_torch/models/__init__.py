"""The port of the reference's ``repro/models``: so far ``layers``
(norms, RoPE, chunked and quadratic attention, decode attention) and
``ssm`` (the Mamba-2 SSD chunked scan and its recurrences), the oracles
of the attention and SSD kernels. The model zoo and its steps come
later."""
from repro_torch.models import layers, ssm  # noqa: F401
