"""Logical-axis sharding rules (the pod-level "API table" of MATCH), on
torch ``DeviceMesh`` and DTensor.

The port of ``repro.distributed.sharding``.  Models annotate tensors with
*logical* axis names ("batch", "seq", "embed", "heads", "ffn", "vocab",
"experts", ...).  A :class:`ShardingRules` table maps logical names to mesh
axes; :mod:`repro_torch.distributed.autoshard` produces these tables and
:mod:`repro_torch.launch.dryrun` consumes them.

What changes against the reference:

* :meth:`ShardingRules.spec_for` keeps the reference's rule exactly and
  returns the port's own :class:`PartitionSpec`, a tuple with one entry per
  tensor dim: ``None``, a mesh axis name, or a tuple of names.
* :meth:`ShardingRules.sharding_for` gives DTensor placements, one per mesh
  dim: ``Shard(d)`` where the spec maps tensor dim ``d`` to that mesh axis,
  ``Replicate()`` elsewhere.  A tensor dim over several mesh axes is split
  by them in the mesh's axis order (DTensor's), where jax splits it in the
  spec's order: the same shard sizes, another assignment of shards to ranks.
* :func:`constrain` places a tensor as a DTensor (``distribute_tensor``, or
  ``redistribute`` for a DTensor), the counterpart of
  ``with_sharding_constraint``.

The port's models do not call :func:`constrain`, where the reference's
annotate activations (``models/moe.py``, ``ssd.py``, ``rglru.py``): their
kernels read raw device pointers, and the card is one device.  The rules
place parameters, optimizer state, batches and caches
(:func:`param_shardings`); :mod:`repro_torch.launch.dryrun` propagates
them through the step and applies the reference's annotation of each
block's output itself.

Usage:
    rules = ShardingRules(mesh, {"batch": ("pod", "data"), "ffn": "model", ...})
    with use_rules(rules):
        y = constrain(x, "batch", "seq", None)
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import mesh_axes

__all__ = [
    "PartitionSpec",
    "ShardingRules",
    "use_rules",
    "current_rules",
    "constrain",
    "logical_to_spec",
    "param_shardings",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of mesh axis names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass
class ShardingRules:
    """mesh + logical->mesh-axis table.

    Values may be a mesh-axis name, a tuple of mesh axes (e.g. batch over
    ("pod", "data")), or None (replicated).  ``mesh`` is a ``DeviceMesh``,
    an abstract mesh (:class:`repro_torch.launch.mesh.AbstractMesh`), or
    None.
    """

    mesh: Any
    table: dict[str, Any] = field(default_factory=dict)

    def spec_for(self, logical_axes: Sequence[str | None]) -> PartitionSpec:
        parts = []
        used: set[str] = set()
        for ax in logical_axes:
            if ax is None:
                parts.append(None)
                continue
            mapped = self.table.get(ax)
            if mapped is None:
                parts.append(None)
                continue
            axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            # a mesh axis can shard only one tensor dim; later wins -> None
            axes = tuple(a for a in axes if a not in used)
            used |= set(axes)
            if not axes:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(axes)
        return P(*parts)

    def sharding_for(self, logical_axes: Sequence[str | None]) -> tuple | None:
        """DTensor placements of a tensor with these logical axes, one per
        mesh dim; None without a mesh."""
        if self.mesh is None:
            return None
        dim_of: dict[str, int] = {}
        for d, part in enumerate(self.spec_for(logical_axes)):
            for name in (part,) if isinstance(part, str) else part or ():
                dim_of[name] = d
        return tuple(Shard(dim_of[n]) if n in dim_of else Replicate() for n in mesh_axes(self.mesh))


_STATE = threading.local()


def current_rules() -> ShardingRules | None:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def logical_to_spec(*logical_axes: str | None) -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return P()
    return rules.spec_for(logical_axes)


def constrain(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """``x`` placed by logical axis names as a DTensor on the rules' mesh (a
    ``DeviceMesh``); a no-op without rules or mesh."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    if x.dim() != len(logical_axes):
        raise ValueError(f"rank {x.dim()} vs {logical_axes}")
    placements = rules.sharding_for(logical_axes)
    if isinstance(x, DTensor):
        return x.redistribute(rules.mesh, placements)
    return distribute_tensor(x, rules.mesh, placements)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def param_shardings(param_axes, rules: ShardingRules):
    """Map a tree (nested dicts) of logical-axes tuples to placements."""
    if _is_axes(param_axes):
        return rules.sharding_for(param_axes)
    return {k: param_shardings(v, rules) for k, v in param_axes.items()}
