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
``DeviceMesh`` over the running process group when they are called, and
``run_ranks`` starts the ranks of a small mesh for the launchers'
``--mesh DATAxMODEL``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
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


def parse_mesh(text: str) -> tuple[int, int]:
    """"DATAxMODEL" -> (data, model)."""
    try:
        data, model = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh {text!r}: expected DATAxMODEL, e.g. 2x2") from None
    if data < 1 or model < 1:
        raise argparse.ArgumentTypeError(f"--mesh {text!r}: sizes >= 1")
    return data, model


def _rank_main(rank: int, fn, dims: tuple[int, int], device_type: str,
               rendezvous: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    world = dims[0] * dims[1]
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:   # the ranks share the host's threads
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        fn(rank, make_test_mesh(*dims, device_type=device_type), *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, dims: tuple[int, int], device_type: str, *args) -> None:
    """Start ``data * model`` ranks with ``torch.multiprocessing`` (gloo on
    the CPU, NCCL with one card a rank, through a ``file://`` rendezvous),
    call ``fn(rank, mesh, *args)`` on each over a ("data", "model") mesh
    of ``dims``, and wait for them.  ``fn`` and ``args`` must pickle."""
    import torch
    import torch.multiprocessing as mp

    world = dims[0] * dims[1]
    if device_type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"--mesh {dims[0]}x{dims[1]} needs {world} "
                           f"cards, {torch.cuda.device_count()} found")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, dims, device_type,
                                   os.path.join(tmp, "rendezvous"), args),
                 nprocs=world, join=True)
