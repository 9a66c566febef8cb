"""TPU v5e MatchTarget — the production target of this framework.

Hardware adaptation of the paper's per-SoC model files (DIANA/GAP9) to a
TPU chip + pod.  Constants (fixed for this repo, per the brief):

* 197 TFLOP/s bf16 peak per chip (MXU systolic arrays),
* 819 GB/s HBM bandwidth, 16 GiB HBM capacity,
* ~16 MiB VMEM (software-managed, the L1 of the MATCH hierarchy),
* ICI ~50 GB/s/link, 2D torus => 2 bidirectional links per mesh axis.

Two MATCH levels use this file:

1. **Kernel level** — `make_tpu_v5e_target()` returns a MatchTarget whose
   modules are the MXU (matmul-shaped patterns) and the VPU (elementwise /
   scan patterns), with HBM→VMEM as the L2→L1 of the paper.  The LOMA DSE
   picks Pallas `BlockSpec` tiles with it.
2. **Pod level** — :class:`PodSpec` provides the collective cost model
   (the paper's `L_mem,i,j` generalised to inter-chip links) used by the
   autoshard search and by the §Roofline analysis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core import (
    ComputeModel,
    ExecutionModule,
    Interconnect,
    MatchTarget,
    MemoryLevel,
    SpatialUnrolling,
)

__all__ = ["TPUv5eSpec", "PodSpec", "make_tpu_v5e_target", "V5E"]


@dataclass(frozen=True)
class TPUv5eSpec:
    """Datasheet numbers used everywhere (roofline, DSE, autoshard)."""

    peak_flops_bf16: float = 197e12  # per chip
    hbm_bytes_per_s: float = 819e9
    hbm_capacity: int = 16 * 1024**3
    vmem_bytes: int = 16 * 2**20  # software-managed scratchpad (Pallas L1)
    ici_link_bytes_per_s: float = 50e9  # per link per direction
    ici_links_per_axis: int = 2  # bidirectional ring on a torus axis
    clock_hz: float = 0.94e9
    mxu_dim: int = 128  # systolic array edge
    sublane: int = 8
    lane: int = 128

    @property
    def peak_macs_per_cycle(self) -> float:
        return self.peak_flops_bf16 / 2.0 / self.clock_hz

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bytes_per_s / self.clock_hz


V5E = TPUv5eSpec()


@dataclass(frozen=True)
class PodSpec:
    """Pod-level model: chips, axes, and collective latency estimates.

    The analytical forms are standard ring-algorithm costs; they are the
    pod-scale analogue of the paper's DMA model (bandwidth term + fixed
    per-transfer overhead).
    """

    chip: TPUv5eSpec = V5E
    per_collective_overhead_s: float = 5e-6  # launch/sync fixed cost

    def axis_bw(self) -> float:
        return self.chip.ici_link_bytes_per_s * self.chip.ici_links_per_axis

    def all_gather_s(self, bytes_out_per_chip: float, axis: int) -> float:
        """Ring all-gather: each chip sends (A-1)/A of the gathered bytes."""
        if axis <= 1:
            return 0.0
        moved = bytes_out_per_chip * (axis - 1) / axis
        return moved / self.axis_bw() + self.per_collective_overhead_s

    def reduce_scatter_s(self, bytes_in_per_chip: float, axis: int) -> float:
        if axis <= 1:
            return 0.0
        moved = bytes_in_per_chip * (axis - 1) / axis
        return moved / self.axis_bw() + self.per_collective_overhead_s

    def all_reduce_s(self, bytes_per_chip: float, axis: int) -> float:
        if axis <= 1:
            return 0.0
        return (
            2.0 * bytes_per_chip * (axis - 1) / axis / self.axis_bw()
            + self.per_collective_overhead_s
        )

    def all_to_all_s(self, bytes_per_chip: float, axis: int) -> float:
        if axis <= 1:
            return 0.0
        moved = bytes_per_chip * (axis - 1) / axis
        return moved / self.axis_bw() + self.per_collective_overhead_s

    def ppermute_s(self, bytes_per_chip: float) -> float:
        return bytes_per_chip / self.axis_bw() + self.per_collective_overhead_s

    def compute_s(self, flops_per_chip: float) -> float:
        return flops_per_chip / self.chip.peak_flops_bf16

    def hbm_s(self, bytes_per_chip: float) -> float:
        return bytes_per_chip / self.chip.hbm_bytes_per_s


def make_tpu_v5e_target(spec: TPUv5eSpec = V5E) -> MatchTarget:
    """Chip-level MatchTarget: MXU + VPU modules over HBM→VMEM."""
    hbm_bpc = spec.hbm_bytes_per_cycle  # ~871 B/cycle @ 0.94 GHz
    vmem = MemoryLevel(
        "VMEM",
        spec.vmem_bytes,
        hbm_bpc,
        chunk_overhead=500.0,  # DMA descriptor + HBM latency, cycles
    )
    hbm = MemoryLevel("HBM", spec.hbm_capacity, hbm_bpc)

    n_pe = spec.mxu_dim * spec.mxu_dim
    mxu = ExecutionModule(
        name="mxu",
        memories=(vmem, hbm),
        spatial={
            "matmul": SpatialUnrolling({"M": spec.mxu_dim, "N": spec.mxu_dim}),
            "attention": SpatialUnrolling({"SQ": spec.mxu_dim, "D": spec.mxu_dim}),
            "conv2d": SpatialUnrolling({"K": spec.mxu_dim, "OX": spec.sublane}),
            "dense": SpatialUnrolling({"K": spec.mxu_dim, "C": spec.mxu_dim}),
        },
        compute=ComputeModel(
            cycles_per_iter=1.0,
            macs_per_pe_cycle=spec.peak_macs_per_cycle / n_pe,  # folds 4 MXUs
        ),
        async_dma=True,  # Mosaic double-buffers BlockSpec windows
        double_buffer=True,
        supported_ops=("matmul", "attention", "conv2d", "dense"),
        frequency_hz=spec.clock_hz,
        handoff_cycles=500.0,  # kernel relaunch: VMEM windows re-established
    )

    # VPU: 8x128 vector lanes; elementwise + recurrences (scans).
    vpu_flops = 8 * 128 * 4  # lanes x ~4 ops/cycle
    vpu = ExecutionModule(
        name="vpu",
        memories=(vmem, hbm),
        spatial={
            "scan": SpatialUnrolling({"D": 128, "B": 8}),
            "elementwise": SpatialUnrolling({"E": 8 * 128}),
            "*": SpatialUnrolling({}),
        },
        compute=ComputeModel(cycles_per_iter=1.0, macs_per_pe_cycle=4.0),
        async_dma=True,
        double_buffer=True,
        supported_ops=("scan", "elementwise", "pool"),
        frequency_hz=spec.clock_hz,
        handoff_cycles=500.0,
        attrs={"flops_per_cycle": vpu_flops},
    )

    # Fallback: XLA default codegen — correct but unscheduled w.r.t. our
    # cost model; modelled as synchronous HBM streaming (no VMEM blocking
    # credit), the TPU analogue of "plain TVM on the main CPU".
    xla = ExecutionModule(
        name="xla",
        memories=(
            MemoryLevel("VMEMx", spec.vmem_bytes, hbm_bpc, chunk_overhead=500.0),
            hbm,
        ),
        spatial={"*": SpatialUnrolling({})},
        compute=ComputeModel(
            cycles_per_iter=1.0,
            macs_per_pe_cycle=spec.peak_macs_per_cycle / 4.0,  # fusion-less penalty
        ),
        async_dma=False,  # no overlap credit
        double_buffer=False,
        supported_ops=(
            "matmul",
            "attention",
            "conv2d",
            "dense",
            "scan",
            "elementwise",
            "pool",
        ),
        frequency_hz=spec.clock_hz,
    )

    target = MatchTarget(
        name="tpu_v5e",
        modules=[mxu, vpu],
        fallback=xla,
        # a module switch breaks kernel fusion: the edge's activations
        # round-trip HBM at full bandwidth plus a dispatch-latency hop
        interconnect=Interconnect(bandwidth=hbm_bpc, hop_latency=500.0),
        attrs={"spec": spec},
    )

    # Pattern tables for the LM hot-spots are registered by repro_torch.kernels
    # (each kernel contributes its pattern + workload builder), keeping the
    # target file purely declarative, as in the paper.
    return target
