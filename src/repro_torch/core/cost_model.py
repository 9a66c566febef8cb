"""Analytical cost models (paper Sec. V-A/V-B).

Given a :class:`~repro_torch.core.loma.TemporalMapping` of a workload on an
execution module, compute:

* ``L_ops``  — inner-loop compute cycles at L1 (spatial-unrolling aware),
* ``L_mem``  — L2→L1 (HBM→VMEM) transfer cycles, with per-contiguous-chunk
  DMA overheads (70 cyc on DIANA, 27 on GAP9) and stationarity-aware
  reload factors,
* total latency ``L = L_ops + L_mem`` (synchronous DMA, DIANA) or
  ``L = max(L_ops, L_mem)`` (async double-buffered, GAP9 / TPU),

exactly mirroring the structure published in the paper.  The crucial
property is **rank preservation** (paper Sec. V): the model need not be
cycle-accurate, but better schedules must score better — the property
tests in ``tests/test_cost_model.py`` check this on constructed cases.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from .target import ExecutionModule, Interconnect, MemoryLevel
from .workload import Operand, Workload, prod

__all__ = [
    "CostBreakdown",
    "evaluate_mapping",
    "operand_traffic",
    "tile_chunks",
    "tile_working_set",
    "transfer_cost",
]


@dataclass(frozen=True)
class CostBreakdown:
    """Latency decomposition for one (workload, mapping, module)."""

    feasible: bool
    latency_cycles: float
    l_ops: float
    l_mem: float
    traffic_bytes: dict
    dma_chunks: dict
    utilization: float
    reason: str = ""

    @property
    def macs_per_cycle(self) -> float:
        return 0.0

    def with_macs(self, total_macs: float) -> float:
        if not self.feasible or self.latency_cycles <= 0:
            return 0.0
        return total_macs / self.latency_cycles

    def features(self) -> dict[str, float]:
        """Linear features of this breakdown, for the calibration fitter.

        Predicted latency is affine in these: ``a*l_ops + b*l_mem + c``
        for synchronous-DMA modules, ``a*max(l_ops, l_mem) + c`` for
        async double-buffered ones.  The ``repro_torch.calibrate`` fitter
        regresses measured cycles against them and writes the solved
        (a, b, c) back into the hardware model via
        ``ExecutionModule.recalibrated``.
        """
        return {"l_ops": self.l_ops, "l_mem": self.l_mem}


INFEASIBLE = CostBreakdown(
    feasible=False,
    latency_cycles=math.inf,
    l_ops=math.inf,
    l_mem=math.inf,
    traffic_bytes={},
    dma_chunks={},
    utilization=0.0,
    reason="infeasible",
)


# ---------------------------------------------------------------------------
# Traffic model
# ---------------------------------------------------------------------------


def _reload_factor(
    operand: Operand,
    outer_order: Sequence[str],
    outer_iters: Mapping[str, int],
) -> tuple[float, float]:
    """Stationarity-aware reload factor for one operand.

    ``outer_order`` lists the loops *above* the L1 tile, outermost first.
    Walking from the innermost outer loop outwards: loops irrelevant to the
    operand that sit directly above the tile keep it resident (no reload);
    once a relevant loop is crossed, every loop above it (relevant or not)
    multiplies the number of tile loads.

    Returns (load_factor, rmw_factor) where ``rmw_factor`` counts extra
    read-modify-write passes for outputs caused by reduction loops above
    the cut (partial sums spilled to L2).
    """
    load = 1.0
    seen_relevant = False
    # innermost-outer first
    for dim in reversed(list(outer_order)):
        it = outer_iters.get(dim, 1)
        if it <= 1:
            continue
        if operand.relevant(dim):
            seen_relevant = True
            load *= it
        elif seen_relevant:
            load *= it
        # irrelevant loop directly above the tile: operand stationary
    if operand.is_output:
        # reduction loops above the cut force partial-sum spills: each extra
        # pass re-reads and re-writes the output tile.
        rmw = 1.0
        for dim in outer_order:
            it = outer_iters.get(dim, 1)
            if it <= 1:
                continue
            if not operand.relevant(dim):  # reduction w.r.t. the output
                rmw *= it
        return load, rmw
    return load, 1.0


def tile_chunks(operand: Operand, tiles: Mapping[str, int], full: Mapping[str, int]) -> int:
    """Number of contiguous memory chunks one tile transfer touches.

    Walk the operand layout from the innermost axis outward: as long as the
    tile covers the full extent of an axis, the block stays contiguous;
    the first partially-covered axis splits the transfer into the product
    of the remaining (outer) tile extents.  This reproduces the paper's
    "if a data block is not stored contiguously, the overhead is multiplied
    by the number of contiguous sub-blocks".
    """
    if not operand.layout:
        return 1
    layout = [d for d in operand.layout if d in operand.dims or d in full]
    chunks = 1
    contiguous = True
    for axis in reversed(layout):  # innermost first
        t = operand.axis_extent(axis, tiles)
        f = operand.axis_extent(axis, full)
        if contiguous:
            if t < f:
                contiguous = False
            continue
        chunks *= max(1, int(t))
    return max(1, int(chunks))


def operand_traffic(
    workload: Workload,
    operand: Operand,
    tiles: Mapping[str, int],
    outer_order: Sequence[str],
    outer_iters: Mapping[str, int],
) -> tuple[float, float]:
    """(bytes moved L2->L1, number of DMA chunk transfers) for one operand."""
    tile_bytes = operand.footprint_bytes(tiles)
    n_tiles = prod(outer_iters.get(d, 1) for d in outer_iters if operand.relevant(d))
    load, rmw = _reload_factor(operand, outer_order, outer_iters)
    if operand.is_output:
        # one write per distinct output tile; (rmw - 1) extra read+write passes
        writes = tile_bytes * n_tiles
        extra = 2.0 * tile_bytes * n_tiles * (rmw - 1.0)
        bytes_moved = writes + extra
        n_transfers = n_tiles * (1.0 + 2.0 * (rmw - 1.0))
    else:
        bytes_moved = tile_bytes * load
        n_transfers = load
    chunks_per_transfer = tile_chunks(operand, tiles, workload.dim_sizes)
    return bytes_moved, n_transfers * chunks_per_transfer


# ---------------------------------------------------------------------------
# Cross-module transfer model (heterogeneous dispatch)
# ---------------------------------------------------------------------------


def transfer_cost(
    nbytes: float,
    src: ExecutionModule,
    dst: ExecutionModule,
    interconnect: Interconnect | None = None,
) -> float:
    """Cycles to move ``nbytes`` of activations across a module boundary.

    Per-segment ``L_mem`` already charges each segment's own L2<->L1
    traffic; what a *module switch* adds on top is the loss of overlap:

    * the producer's write-back and the consumer's prefetch cannot be
      hidden behind the neighbouring segment's compute (the DMA engines /
      job queues of the two modules are independent), so the edge's bytes
      serialise on the shared home-level path — once if both sides
      double-buffer asynchronously, twice (write-back + refetch both
      exposed) if either side uses blocking DMA;
    * a fixed handoff: interconnect ``hop_latency`` plus each module's
      ``handoff_cycles`` (job reconfiguration, fork/join, flush).

    Same-module edges cost nothing extra: the data streams through the
    module's own hierarchy and is already accounted by the segment costs.

    An edge consumed by several cross-module segments is charged once per
    consuming segment: each consumer issues its own DMA job (hop +
    handoff + fetch serialization).  The producer's single write-back is
    thereby counted more than once — a deliberate conservative
    simplification that keeps the DP state local to the consumer.
    """
    if src.name == dst.name:
        return 0.0
    ic = interconnect or Interconnect()
    trips = 1.0 if (src.async_dma and dst.async_dma) else 2.0
    serial = trips * max(nbytes, 0.0) / max(ic.bandwidth, 1e-9)
    return ic.hop_latency + src.handoff_cycles + dst.handoff_cycles + serial


# ---------------------------------------------------------------------------
# Compute model
# ---------------------------------------------------------------------------


def _l_ops(
    workload: Workload,
    tiles: Mapping[str, int],
    outer_iters: Mapping[str, int],
    module: ExecutionModule,
) -> tuple[float, float]:
    cm = module.compute
    if cm.custom is not None:
        per_tile = cm.custom_scale * cm.custom(workload, tiles, module)
        n_tiles = prod(outer_iters.values())
        su = module.spatial_for(workload)
        return per_tile * n_tiles + cm.fixed_setup_cycles, su.utilization(tiles)

    su = module.spatial_for(workload)
    # temporal iterations inside the tile given spatial unrolling
    spatial_dims = set(su.dims)
    inner_serial = prod(
        int(tiles.get(l.name, 1)) for l in workload.loops if l.name not in spatial_dims
    )
    waves = su.iterations(tiles) * inner_serial
    cycles = waves * cm.cycles_per_iter * workload.macs_per_iter / max(cm.macs_per_pe_cycle, 1e-9)
    # output epilogue (elementwise ops + store), counted per output wave
    out = workload.output
    out_elems = out.footprint(tiles)
    out_par = prod(n for d, n in su.dims.items() if out.relevant(d)) or 1
    cycles += cm.output_elem_overhead * math.ceil(out_elems / out_par)
    n_tiles = prod(outer_iters.values())
    return cycles * n_tiles + cm.fixed_setup_cycles, su.utilization(tiles)


# ---------------------------------------------------------------------------
# Feasibility: does the tile set fit the module's L1 level(s)?
# ---------------------------------------------------------------------------


def tile_working_set(
    workload: Workload,
    tiles: Mapping[str, int],
    module: ExecutionModule,
) -> dict[str, int]:
    """Bytes each inner memory level must hold for one tile of ``tiles``.

    Double-buffered modules charge 2x per streamed operand (the revolving
    window), matching the feasibility rule LOMA enforced during the DSE.
    The home (last) level is excluded — it holds full tensors, planned by
    ``repro_torch.backend.memory``.  Raises KeyError when no inner level serves
    an operand.
    """
    buf = 2 if module.double_buffer else 1
    usage: dict[str, int] = {m.name: 0 for m in module.memories[:-1]}
    for op in workload.operands:
        for lvl in module.memories[:-1]:  # last level is the home (L2/HBM)
            if lvl.holds(op.name):
                need = op.footprint_bytes(tiles) * (1 if op.is_output and not module.double_buffer else buf)
                usage[lvl.name] += need
                break
        else:
            raise KeyError(f"no L1 level of {module.name} serves operand {op.name}")
    return usage


def _fits(
    workload: Workload,
    tiles: Mapping[str, int],
    module: ExecutionModule,
) -> tuple[bool, str]:
    try:
        usage = tile_working_set(workload, tiles, module)
    except KeyError as e:
        return False, e.args[0]
    for lvl in module.memories[:-1]:
        if usage[lvl.name] > lvl.size_bytes:
            return False, f"{lvl.name} overflow: {usage[lvl.name]} > {lvl.size_bytes}"
    return True, ""


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def evaluate_mapping(
    workload: Workload,
    tiles: Mapping[str, int],
    outer_order: Sequence[str],
    module: ExecutionModule,
) -> CostBreakdown:
    """Score one temporal mapping: inner tile sizes + outer loop order."""
    full = workload.dim_sizes
    # sequential dims (scan recurrences) cannot be tiled except in chunks
    # handled by the op itself; enforce declared minimum granularity.
    ok, reason = _fits(workload, tiles, module)
    if not ok:
        return CostBreakdown(False, math.inf, math.inf, math.inf, {}, {}, 0.0, reason)

    outer_iters = {d: math.ceil(full[d] / int(tiles.get(d, 1))) for d in full}
    order = [d for d in outer_order if outer_iters.get(d, 1) > 1]

    l_ops, util = _l_ops(workload, tiles, outer_iters, module)

    traffic: dict[str, float] = {}
    chunks: dict[str, float] = {}
    l_mem = 0.0
    l1 = module.l1
    for op in workload.operands:
        lvl = next((m for m in module.memories[:-1] if m.holds(op.name)), l1)
        bytes_moved, n_chunks = operand_traffic(workload, op, tiles, order, outer_iters)
        traffic[op.name] = bytes_moved
        chunks[op.name] = n_chunks
        l_mem += bytes_moved / max(lvl.bandwidth, 1e-9) + n_chunks * lvl.chunk_overhead

    if module.async_dma:
        latency = max(l_ops, l_mem)
    else:
        latency = l_ops + l_mem
    # post-combine fixed overhead (job launch / runtime call), charged once
    # per workload execution — the calibration fitter's constant term
    latency += module.compute.fixed_overhead_cycles
    return CostBreakdown(True, latency, l_ops, l_mem, traffic, chunks, util)
