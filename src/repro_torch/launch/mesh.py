"""Production and test meshes.

Port of ``repro.launch.mesh``.  The JAX package maps its layouts onto TPU
pods; the port maps them onto H100 nodes of eight cards joined by NVLink:

  single-pod: (data=32, model=8)            -- 256 cards, 32 nodes
  multi-pod:  (pod=2, data=32, model=8)     -- 512 cards, 64 nodes

The chip counts are the reference's (256 and 512).  ``model`` (tensor
parallelism) stays inside a node's NVLink domain; ``data`` (FSDP) spans the
nodes; ``pod`` is pure data parallelism, as in the reference.

The shapes are module constants (``production_shape``), so the spec
functions of ``parallel.sharding`` and a dry run can use them without a
256-rank world.  Those functions take any object with ``axis_names`` and
``axis_sizes`` (``mesh_shape`` maps a ``DeviceMesh``'s ``mesh_dim_names`` and
``shape`` onto them).  Nothing here touches ``torch.distributed`` or a
device at import: ``make_production_mesh`` and ``make_test_mesh`` build a
``DeviceMesh`` over the running process group when they are called.
"""

from __future__ import annotations

from dataclasses import dataclass

GPUS_PER_NODE = 8
NODES_PER_POD = 32
SINGLE_POD_AXES = ("data", "model")
SINGLE_POD_SHAPE = (NODES_PER_POD, GPUS_PER_NODE)
MULTI_POD_AXES = ("pod", "data", "model")
MULTI_POD_SHAPE = (2, NODES_PER_POD, GPUS_PER_NODE)


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axes without devices: what the spec functions read."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(MULTI_POD_AXES, MULTI_POD_SHAPE)
    return MeshShape(SINGLE_POD_AXES, SINGLE_POD_SHAPE)


def mesh_shape(mesh) -> MeshShape:
    """(axis names, axis sizes) of a ``DeviceMesh`` or of any object with
    ``axis_names`` and ``axis_sizes``."""
    if hasattr(mesh, "mesh_dim_names"):
        return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    return MeshShape(tuple(mesh.axis_names), tuple(mesh.axis_sizes))


def _device_mesh(device_type: str, shape: MeshShape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape.axis_sizes,
                            mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh``; needs a process group of 256 (512)
    ranks."""
    return _device_mesh(device_type, production_shape(multi_pod=multi_pod))


def make_test_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """A small ("data", "model") ``DeviceMesh`` over ``data * model`` ranks."""
    return _device_mesh(device_type, MeshShape(SINGLE_POD_AXES,
                                               (data, model)))


def mesh_device_count(mesh) -> int:
    out = 1
    for s in mesh_shape(mesh).axis_sizes:
        out *= s
    return out
