"""Production and local meshes, as torch ``DeviceMesh``.

The port of ``repro.launch.mesh``.  Functions, not module-level constants,
so importing this module touches no process group.  Shapes as the
reference's:

* single pod:  (16, 16)    axes ("data", "model")          = 256 chips
* multi pod:   (2, 16, 16) axes ("pod", "data", "model")   = 512 chips

A ``DeviceMesh`` needs a process group of its size.
:func:`make_production_mesh` is meant for the fake group that
:mod:`repro_torch.launch.dryrun` sets up in its own process (nothing runs on
it; it lets DTensor plan each op's collectives).  :func:`make_local_mesh`
is a small mesh on the card (NCCL) or, when asked, the host (gloo); the
caller initialises the process group (``torch.distributed``) first.

:class:`AbstractMesh` is shape and axis names with no devices, for the
autoshard search and the tests: :func:`mesh_axes` reads it, a
``DeviceMesh`` and jax's ``AbstractMesh`` as the same ``{name: size}``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import resolve_device

__all__ = ["AbstractMesh", "make_local_mesh", "make_production_mesh", "mesh_axes", "production_shape"]


class AbstractMesh:
    """A mesh's shape and axis names, no devices: ``.shape`` maps each axis
    name to its size, in order, as jax's ``AbstractMesh.shape`` does."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} vs axis names {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names`` and a
    shape tuple) or of anything whose ``.shape`` maps names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh on the host, over an initialised process group
    of its size: the dry-run's fake group."""
    shape, axes = production_shape(multi_pod)
    size = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != size:
        have = dist.get_world_size() if dist.is_initialized() else "no process group"
        raise RuntimeError(
            f"the {shape} production mesh needs a process group of {size} ranks (have {have}): "
            "it is built inside the dry-run's fake group (python -m repro_torch.launch.dryrun)"
        )
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> DeviceMesh:
    """A (data, model) mesh over the initialised process group: on the card
    (NCCL) unless ``device`` says otherwise (``"cpu"``: gloo)."""
    dev = resolve_device(device)
    if not dist.is_initialized() or dist.get_world_size() != data * model:
        raise RuntimeError(
            f"a ({data}, {model}) mesh needs an initialised process group of {data * model} ranks "
            "(torch.distributed.init_process_group)"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
