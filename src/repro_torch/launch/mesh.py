"""Production mesh definitions, the port of the reference's
``repro/launch/mesh.py``.

The mesh axes follow the paper's TLP/DLP decomposition: ``data`` (and
``pod``) carry thread-level parallelism (the IMT harts, scaled out),
``model`` carries data-level parallelism (the vector lanes D, scaled up).

A mesh here is a ``DeviceMesh`` over the default process group, whose
world size must equal the mesh's size: NCCL ranks on cards, gloo ranks
on the CPU, or the fake group of the dry run (``compat.fake_store``).
``AbstractMesh`` is jax's counterpart: axis names and sizes with no
group, enough for ``Rules.spec`` and the dry run's analytic estimates.
The makers are FUNCTIONS, so importing this module touches no process
group.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.compat import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(shape=None, axes=("data", "model"), *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A mesh over the current process group's world (tests, examples):
    ``(world, 1)`` (or ``(world,)``) unless ``shape`` is given."""
    import torch.distributed as dist
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1) if len(axes) == 2 else (n,)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


class AbstractMesh:
    """Axis names and sizes of a mesh, with no process group (jax's
    ``AbstractMesh((16, 16), ("data", "model"))``)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        assert len(shape) == len(axis_names), (shape, axis_names)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names is None:
        raise TypeError(f"a mesh is a DeviceMesh with axis names or an "
                        f"AbstractMesh, got {mesh!r}")
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or an ``AbstractMesh`` (the
    reference's ``mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), mesh.mesh.shape))


# H100 SXM figures used by the roofline analysis (NVIDIA's data sheet;
# the port's device row in PERF.md section 3).
HW = {
    "peak_flops_bf16": 989e12,     # dense bf16 tensor-core peak, per card
    "hbm_bw": 3.35e12,             # HBM3 bytes/s per card
    "link_bw": 450e9,              # NVLink 4: 900 GB/s both ways per card,
    #                                450e9 bytes/s one way
    "hbm_bytes": 80 * 1000**3,     # 80 GB HBM3 per card
}
