"""Declarative hardware abstraction (paper Sec. V, Fig. 4).

A :class:`MatchTarget` holds one or more :class:`ExecutionModule`s.  Each
module declares:

* its memory hierarchy (:class:`MemoryLevel` list, innermost first),
* a pattern table (which operator patterns it can execute — filled in by
  ``repro_torch.core.patterns``),
* a compute model (spatial unrolling + cycle constants), and
* DMA behaviour (sync vs async/double-buffered, per-chunk overheads).

No compiler pass ever hardcodes hardware knowledge: DIANA, GAP9 and the
TPU v5e are all instances of these dataclasses (see ``repro_torch.targets``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

from .workload import Workload, prod

__all__ = [
    "MemoryLevel",
    "SpatialUnrolling",
    "ComputeModel",
    "ExecutionModule",
    "Interconnect",
    "MatchTarget",
]


@dataclass(frozen=True)
class MemoryLevel:
    """One level of a software-managed memory hierarchy.

    ``serves``: operand names this level can hold ("*" = any).  DIANA has a
    dedicated 64 kB weight memory next to the 256 kB activation L1; TPU has
    a single 16 MiB (128 KiB/lane-group usable ~ we model the whole) VMEM.
    ``bandwidth``: bytes/cycle to the level above.
    ``chunk_overhead``: fixed cycles per contiguous chunk transferred
    (paper: 70 cycles on DIANA, 27 on GAP9).
    """

    name: str
    size_bytes: int
    bandwidth: float  # bytes / cycle from the parent level
    serves: tuple[str, ...] = ("*",)
    chunk_overhead: float = 0.0

    def holds(self, operand_name: str) -> bool:
        return "*" in self.serves or operand_name in self.serves


@dataclass(frozen=True)
class SpatialUnrolling:
    """Fixed spatial mapping of loop dims onto the PE array / MXU.

    The paper fixes spatial mappings (already-manufactured targets) and
    searches temporal mappings only; we follow suit.  ``dims`` maps a loop
    dim to the number of PEs along it, e.g. DIANA conv = {K:16, OX:16},
    TPU MXU matmul = {M:128 (rows), N:128 (cols)} per pass.
    """

    dims: Mapping[str, int]
    # Alternative unrollings the module may fall back to (GAP9 cluster
    # "reduced parallelism" rule is implemented in the cost model).
    flexible: bool = False

    def utilization(self, tiles: Mapping[str, int]) -> float:
        """Fraction of PEs busy for a tile (ceil quantization waste)."""
        util = 1.0
        for d, n in self.dims.items():
            t = int(tiles.get(d, 1))
            if t <= 0:
                return 0.0
            util *= t / (math.ceil(t / n) * n)
        return util

    def iterations(self, tiles: Mapping[str, int]) -> int:
        """Temporal iterations to cover a tile with this unrolling."""
        it = 1
        for d, n in self.dims.items():
            it *= math.ceil(int(tiles.get(d, 1)) / n)
        return it


@dataclass(frozen=True)
class ComputeModel:
    """Analytical L_ops model for one module.

    ``cycles_per_iter``: cycles per spatially-parallel MAC wave (DIANA:
    read-in + MAC + write-out = 3).
    ``output_elem_overhead``: extra cycles per *output element wave*
    (DIANA: 23 cycles elementwise + store).
    ``macs_per_pe_cycle``: MACs one PE retires per cycle (SIMD width).
    ``fixed_overhead_cycles``: cycles charged once per workload execution
    *after* the L_ops/L_mem combine (job launch, runtime call overhead) —
    the knob ``repro_torch.calibrate`` fits from measured timings.
    ``custom``: optional full override ``f(workload, tiles, module)->cycles``
    for modules whose published cost model is not PE-array shaped (NE16);
    ``custom_scale`` multiplies its result so calibration can rescale
    opaque models without wrapping the callable (which would defeat the
    schedule-cache keying of ``repro_torch.core.loma``).
    """

    cycles_per_iter: float = 1.0
    output_elem_overhead: float = 0.0
    macs_per_pe_cycle: float = 1.0
    fixed_setup_cycles: float = 0.0
    fixed_overhead_cycles: float = 0.0
    custom: Callable[[Workload, Mapping[str, int], "ExecutionModule"], float] | None = None
    custom_scale: float = 1.0


@dataclass(frozen=True)
class Interconnect:
    """Cross-module data path of a MatchTarget (transfer-cost model).

    When two consecutive graph segments land on *different* execution
    modules, the producer's activations must complete a round trip through
    the shared home level (L2 on the MCUs, HBM on the TPU) before the
    consumer can start: the intra-segment double-buffering credit does not
    survive a module switch.  ``bandwidth`` is the bytes/cycle of that
    shared path; ``hop_latency`` is the fixed synchronisation cost of the
    handoff (DMA reprogramming, cluster fork/join, accelerator job setup)
    paid once per cross-module edge, on top of each module's own
    ``handoff_cycles``.
    """

    bandwidth: float = 8.0  # bytes/cycle through the shared home memory
    hop_latency: float = 100.0  # fixed cycles per cross-module handoff


@dataclass
class ExecutionModule:
    """One HW execution module of a MatchTarget (paper Fig. 4)."""

    name: str
    # innermost level first; the last entry is the "home" level (L2 / HBM)
    memories: tuple[MemoryLevel, ...]
    spatial: Mapping[str, SpatialUnrolling]  # op_type -> unrolling
    compute: ComputeModel
    async_dma: bool = False  # paper: GAP9 max(L_ops, L_mem) vs DIANA sum
    double_buffer: bool = False  # halves usable L1 per operand, enables async
    supported_ops: tuple[str, ...] = ()
    # Pattern table is attached by repro_torch.core.patterns (list of Pattern).
    patterns: list = field(default_factory=list)
    # Constraints: f(workload) -> bool, module-wide (on top of per-pattern)
    constraint: Callable[[Workload], bool] | None = None
    frequency_hz: float = 260e6  # paper experimental setup: 260 MHz
    # Fixed cycles to hand control to / flush this module at a segment
    # boundary where the *other* end of the edge is a different module
    # (NE16 job registers, cluster fork/join, cache flush on the CPU).
    handoff_cycles: float = 0.0
    attrs: dict = field(default_factory=dict)

    # -- helpers --------------------------------------------------------
    @property
    def l1(self) -> MemoryLevel:
        return self.memories[0]

    def levels_for(self, operand: str) -> list[MemoryLevel]:
        return [m for m in self.memories if m.holds(operand)]

    def supports(self, workload: Workload) -> bool:
        if workload.op_type not in self.supported_ops:
            return False
        if self.constraint is not None and not self.constraint(workload):
            return False
        return True

    def spatial_for(self, workload: Workload) -> SpatialUnrolling:
        su = self.spatial.get(workload.op_type)
        if su is None:
            su = self.spatial.get("*", SpatialUnrolling(dims={}))
        return su

    def recalibrated(
        self,
        *,
        compute_scale: float = 1.0,
        mem_scale: float = 1.0,
        fixed_overhead_cycles: float = 0.0,
        tag: str = "",
    ) -> "ExecutionModule":
        """Parameter-override hook for profiling-guided calibration.

        Returns a copy whose declared constants are rescaled so that, for
        any temporal mapping, the predicted breakdown becomes
        ``compute_scale * L_ops``, ``mem_scale * L_mem`` and an extra
        ``fixed_overhead_cycles`` charged after the L_ops/L_mem combine.
        The declared hardware file is never edited; ``tag`` (typically a
        profile fingerprint) lands in ``attrs["calibration"]`` and keys
        the persistent schedule cache (see ``repro_torch.core.loma``).
        """
        import dataclasses

        if compute_scale <= 0 or mem_scale <= 0:
            raise ValueError(
                f"calibration scales must be positive, got compute={compute_scale} mem={mem_scale}"
            )
        if not math.isfinite(fixed_overhead_cycles) or fixed_overhead_cycles < 0:
            raise ValueError(
                f"fixed_overhead_cycles must be finite and >= 0, got {fixed_overhead_cycles}"
            )
        cm = self.compute
        new_cm = dataclasses.replace(
            cm,
            cycles_per_iter=cm.cycles_per_iter * compute_scale,
            output_elem_overhead=cm.output_elem_overhead * compute_scale,
            fixed_setup_cycles=cm.fixed_setup_cycles * compute_scale,
            fixed_overhead_cycles=cm.fixed_overhead_cycles + fixed_overhead_cycles,
            custom_scale=cm.custom_scale * compute_scale,
        )
        mems = tuple(
            dataclasses.replace(
                m,
                bandwidth=m.bandwidth / mem_scale,
                chunk_overhead=m.chunk_overhead * mem_scale,
            )
            for m in self.memories
        )
        new = dataclasses.replace(self)
        new.compute = new_cm
        new.memories = mems
        new.patterns = list(self.patterns)
        new.attrs = dict(self.attrs)
        if tag:
            new.attrs["calibration"] = tag
        return new


@dataclass
class MatchTarget:
    """A SoC / chip: a set of execution modules + a fallback.

    The fallback module models the "un-matched -> TVM default on the main
    CPU" path of the paper; it must support every op type.
    """

    name: str
    modules: list[ExecutionModule]
    fallback: ExecutionModule
    interconnect: Interconnect = field(default_factory=Interconnect)
    attrs: dict = field(default_factory=dict)

    def all_modules(self) -> list[ExecutionModule]:
        return list(self.modules) + [self.fallback]

    def module(self, name: str) -> ExecutionModule:
        for m in self.all_modules():
            if m.name == name:
                return m
        raise KeyError(name)

    def restricted(self, module_names: Sequence[str]) -> "MatchTarget":
        """Target with only a subset of modules enabled (paper Table IV
        ablations: CPU-only / Cluster+CPU / NE16+CPU / Full)."""
        mods = [m for m in self.modules if m.name in module_names]
        return MatchTarget(
            name=f"{self.name}[{'+'.join(module_names) or 'cpu'}]",
            modules=mods,
            fallback=self.fallback,
            interconnect=self.interconnect,
            attrs=dict(self.attrs),
        )

    def recalibrated(
        self, overrides: Mapping[str, object], tag: str = ""
    ) -> "MatchTarget":
        """Target with per-module calibration overrides applied.

        ``overrides`` maps module names to objects (mappings or anything
        with attribute access, e.g. ``repro_torch.calibrate.ModuleCalibration``)
        carrying ``compute_scale`` / ``mem_scale`` / ``fixed_overhead_cycles``.
        Modules without an override are kept as declared.  The target name
        is preserved so registry / lowering consistency checks keep
        holding for calibrated instances.
        """

        def val(ov, key: str, default: float) -> float:
            if isinstance(ov, Mapping):
                return float(ov.get(key, default))
            return float(getattr(ov, key, default))

        def apply(m: ExecutionModule) -> ExecutionModule:
            ov = overrides.get(m.name)
            if ov is None:
                return m
            return m.recalibrated(
                compute_scale=val(ov, "compute_scale", 1.0),
                mem_scale=val(ov, "mem_scale", 1.0),
                fixed_overhead_cycles=val(ov, "fixed_overhead_cycles", 0.0),
                tag=tag,
            )

        new = MatchTarget(
            name=self.name,
            modules=[apply(m) for m in self.modules],
            fallback=apply(self.fallback),
            interconnect=self.interconnect,
            attrs=dict(self.attrs),
        )
        if tag:
            new.attrs["calibration"] = tag
        return new

    def scaled_l1(self, l1_bytes: int) -> "MatchTarget":
        """Target with every module's L1 resized (paper Fig. 9/10 ablation)."""
        import dataclasses

        def scale(m: ExecutionModule) -> ExecutionModule:
            mems = tuple(
                dataclasses.replace(lvl, size_bytes=l1_bytes) if i == 0 else lvl
                for i, lvl in enumerate(m.memories)
            )
            new = dataclasses.replace(m)
            new.memories = mems
            new.patterns = list(m.patterns)
            return new

        return MatchTarget(
            name=f"{self.name}[L1={l1_bytes//1024}kB]",
            modules=[scale(m) for m in self.modules],
            fallback=self.fallback,
            interconnect=self.interconnect,
            attrs=dict(self.attrs),
        )
