"""Small torch version-compat shims (single home, imported lazily), the
counterpart of the reference's ``repro/compat.py`` (which does this job
for jax's ``shard_map``).

The DTensor API moved from ``torch.distributed._tensor`` to
``torch.distributed.tensor`` (2.4), ``init_device_mesh`` lives in
``torch.distributed.device_mesh``, and the fake process group (a group
of any size whose collectives move nothing, for the dry run) is in
torch's testing package. Every other module of the port imports these
names from here.
"""
from __future__ import annotations

try:
    from torch.distributed.tensor import (DTensor, Partial, Placement,
                                          Replicate, Shard,
                                          distribute_tensor)
except ImportError:  # torch < 2.4
    from torch.distributed._tensor import (DTensor, Partial,  # noqa: F401
                                           Placement, Replicate, Shard,
                                           distribute_tensor)
try:
    from torch.distributed.tensor.experimental import (implicit_replication,
                                                       local_map)
except ImportError:  # torch < 2.4
    from torch.distributed._tensor.experimental import (  # noqa: F401
        implicit_replication, local_map)

from torch.distributed.device_mesh import (DeviceMesh,  # noqa: F401
                                           init_device_mesh)

__all__ = ["DTensor", "DeviceMesh", "Partial", "Placement", "Replicate",
           "Shard", "distribute_tensor", "implicit_replication",
           "init_device_mesh", "local_map", "fake_store"]


def fake_store():
    """A ``FakeStore`` for ``init_process_group("fake", store=...)``:
    a group of any world size in one process whose collectives return
    at once (registering the ``"fake"`` backend on import)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()
