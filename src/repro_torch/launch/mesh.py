"""Meshes: the production meshes over a process group, a small host mesh,
and an abstract mesh with no devices.

Single pod: (16, 16) over ("data", "model"), 256 ranks.  Multi-pod:
(2, 16, 16) over ("pod", "data", "model"), 512 ranks.  A ``DeviceMesh``
spans the default process group, which the caller joins first
(:func:`join_process_group`, or a ``"fake"`` group for the dry-run); its
device type follows the group's backend (``nccl`` -> ``cuda``, else
``cpu``).  :class:`Mesh` names axes and sizes only, as
``jax.sharding.AbstractMesh`` does: the sharding rules take either kind.

Functions, not module-level meshes, so importing this module touches no
process group.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Dict, Tuple

import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, no devices (``jax.sharding.AbstractMesh``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a :class:`Mesh` or a ``DeviceMesh``."""
    if isinstance(mesh, Mesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _device_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {world}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` over the default process group (256
    ranks, or 512 with ``multi_pod``)."""
    return _device_mesh(*PRODUCTION_SHAPES[bool(multi_pod)])


def make_host_mesh(data: int = 1, model: int = 1):
    """A small (data, model) ``DeviceMesh`` over the default process group,
    the sizes clamped to its ranks as the JAX package clamps them to its
    devices; their product must then be the group's size."""
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, n // data)
    return _device_mesh((data, model), ("data", "model"))


def join_process_group(*, cpu: bool = False) -> None:
    """Join the default process group unless one is up: the one ``torchrun``
    describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``), else a
    group of one on a free localhost port.  ``nccl`` on the card, ``gloo``
    with ``cpu``."""
    if dist.is_initialized():
        return
    backend = "gloo" if cpu else "nccl"
    if "WORLD_SIZE" in os.environ:
        if not cpu:
            import torch
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes a global batch dim is sharded over."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def batch_axis_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in batch_axes(mesh):
        out *= sizes[a]
    return out
