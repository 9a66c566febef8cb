"""Schedules → executable kernel parameters ("code generation", Sec. IV-C).

On the MCU targets the paper emits Mako-templated C; on TPU the analogous
step parameterises a Pallas kernel: the winning LOMA tile sizes become
``BlockSpec`` block shapes, the outer loop order becomes the grid
iteration order, and double-buffering is what Pallas/Mosaic does for
revolving VMEM windows automatically.

``KernelSchedule`` is the hardware-neutral object the kernels in
``repro_torch.kernels`` accept; ``tpu_align`` snaps tile sizes to TPU tiling
constraints (8×128 vector lanes, 128×128 MXU) the same way the paper's
DIANA pass pads K/OX to multiples of 16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from .loma import ScheduleResult, TemporalMapping, search_schedule
from .target import ExecutionModule
from .workload import Workload

__all__ = ["KernelSchedule", "tpu_align", "schedule_for_kernel", "schedule_from_result"]

# TPU tiling quanta: second-to-last dim multiple of 8 (f32) / 16 (bf16),
# last dim multiple of 128.
_LANE = 128
_SUBLANE = {2: 16, 4: 8, 1: 32}


def tpu_align(size: int, dim_kind: str, elem_bytes: int = 2) -> int:
    """Round a tile size up to the TPU-native quantum for its position."""
    if size <= 0:
        return size
    if dim_kind == "lane":
        q = _LANE
    elif dim_kind == "sublane":
        q = _SUBLANE.get(elem_bytes, 8)
    else:
        return size
    return max(q, math.ceil(size / q) * q)


@dataclass(frozen=True)
class KernelSchedule:
    """DSE output consumed by a Pallas kernel wrapper.

    ``block``: loop-dim -> tile size (BlockSpec shape components).
    ``grid_order``: loop dims outermost-first (grid axes order).
    ``double_buffer``: whether the cost model assumed compute/DMA overlap.
    """

    block: Mapping[str, int]
    grid_order: tuple[str, ...]
    double_buffer: bool = True
    predicted_cycles: float = float("nan")
    meta: Mapping[str, object] = field(default_factory=dict)

    def block_of(self, dim: str, default: int = 1) -> int:
        return int(self.block.get(dim, default))

    def grid_for(self, full: Mapping[str, int]) -> tuple[int, ...]:
        return tuple(
            math.ceil(full[d] / self.block_of(d, full[d])) for d in self.grid_order if d in full
        )


def schedule_from_result(
    res: ScheduleResult,
    workload: Workload,
    module: ExecutionModule,
    *,
    align: Mapping[str, str] | None = None,
) -> KernelSchedule:
    """Convert an already-won :class:`ScheduleResult` into a KernelSchedule.

    This is the path ``repro_torch.backend.lower`` takes: the dispatcher stored
    each segment's winning schedule, so lowering never re-runs the DSE.
    ``align`` maps loop dims to 'lane'/'sublane' so the emitted tile sizes
    are legal Mosaic block shapes even when the best unconstrained tile is
    not hardware-aligned.
    """
    if not res.feasible:
        # conservative whole-array fallback (the caller may still reject)
        block = {l.name: l.size for l in workload.loops}
        return KernelSchedule(block, tuple(workload.dim_names), module.double_buffer, float("inf"))
    tiles = dict(res.mapping.tiles)
    if align:
        eb = workload.operands[0].elem_bytes
        for dim, kind in align.items():
            if dim in tiles:
                full = workload.dim_sizes[dim]
                tiles[dim] = min(full, tpu_align(tiles[dim], kind, eb))
    order = res.mapping.outer_order or tuple(workload.dim_names)
    return KernelSchedule(
        tiles,
        tuple(order),
        module.double_buffer,
        res.cost.latency_cycles,
        meta={"module": module.name, "workload": workload.name, "evals": res.candidates_evaluated},
    )


def schedule_for_kernel(
    workload: Workload,
    module: ExecutionModule,
    *,
    align: Mapping[str, str] | None = None,
    budget: int = 4000,
) -> KernelSchedule:
    """Run the DSE and convert the winner into a KernelSchedule."""
    res: ScheduleResult = search_schedule(workload, module, budget=budget)
    return schedule_from_result(res, workload, module, align=align)
