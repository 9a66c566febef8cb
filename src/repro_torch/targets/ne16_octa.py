"""NE16-Octa MatchTarget — the one-file porting proof (paper Sec. V).

A hypothetical GAP9-class PULP SoC used to demonstrate the paper's agile
retargeting claim: this file is the *entire* port.  It instantiates the
same declarative dataclasses as ``diana.py``/``gap9.py`` — memories,
spatial unrollings, cycle constants, pattern tables — and registers
itself in ``repro_torch.targets``; no dispatcher, DSE, cost-model or backend
code knows it exists.  ``tests/conformance/`` picks it up from
``list_targets()`` and holds it to the full pipeline contract (valid
covers, bit-exact compiled execution, memory-plan capacities, cache
round-trips) purely because it is registered.

The SoC it models differs from GAP9 on every declarative axis:

* **memories** — a 256 kB multi-bank shared L1 (double GAP9) under a
  2 MB L2, with a faster 128-bit DMA (16 B/cycle) and a 20-cycle
  per-chunk overhead;
* **spatial unrolling** — a 16-core cluster whose inner loop retires
  2x int8 MACs/cycle/core, mapped OX=4 x K=4 x OY=16 for convs (vs
  GAP9's 2x4x8), and an NE16-style accelerator widened to 32 input x
  32 output channels (vs 16x32);
* **pattern table** — the accelerator additionally accepts square 5x5
  filters (1x1/3x3/5x5) but — unlike GAP9's NE16 — has **no depthwise
  mode**: every dwconv must land on the cluster, and the cluster alone
  carries the dense / elementwise / pool tables.
"""

from __future__ import annotations

from repro_torch.core import (
    ComputeModel,
    ExecutionModule,
    Interconnect,
    MatchTarget,
    MemoryLevel,
    SpatialUnrolling,
)
from repro_torch.core.patterns import (
    conv_chain_pattern,
    dense_chain_pattern,
    dwconv_chain_pattern,
    eltwise_chain_pattern,
    pool_pattern,
)

FREQ_HZ = 370e6
DMA_BW = 16.0  # bytes/cycle, 128-bit cluster DMA
CHUNK_OVERHEAD = 20.0  # cycles per contiguous chunk

L1_BYTES = 256 * 1024
L2_BYTES = 2 * 1024 * 1024


def _octa_cpu() -> ExecutionModule:
    """Control core running the un-matched (plain TVM) fallback path."""
    return ExecutionModule(
        name="cpu",
        memories=(
            MemoryLevel("dcache", 64 * 1024, 4.0),
            MemoryLevel("L2", L2_BYTES, 4.0),
        ),
        spatial={"*": SpatialUnrolling(dims={})},
        compute=ComputeModel(cycles_per_iter=3.0, output_elem_overhead=2.0),
        async_dma=False,
        double_buffer=False,
        supported_ops=("conv2d", "dwconv2d", "dense", "elementwise", "pool"),
        frequency_hz=FREQ_HZ,
    )


def _int8(nodes) -> bool:
    return all(int(n.attr("elem_bytes", 1)) == 1 for n in nodes[:1])


def _ne16v2_conv_ok(nodes) -> bool:
    """The widened engine accepts square 1x1 / 3x3 / 5x5 filters (one more
    mode than GAP9's NE16 — still not the DSCNN 4x10 rectangle)."""
    n = nodes[0]
    fy, fx = int(n.attr("FY", 0)), int(n.attr("FX", 0))
    return _int8(nodes) and fy == fx and fy in (1, 3, 5)


def make_ne16_octa_target() -> MatchTarget:
    shared_l1 = MemoryLevel("L1", L1_BYTES, DMA_BW, chunk_overhead=CHUNK_OVERHEAD)
    l2 = MemoryLevel("L2", L2_BYTES, DMA_BW)

    # ---- 16-core int8 cluster -------------------------------------------
    cluster = ExecutionModule(
        name="octa",
        memories=(shared_l1, l2),
        spatial={
            "conv2d": SpatialUnrolling({"OX": 4, "K": 4, "OY": 16}, flexible=True),
            "dwconv2d": SpatialUnrolling({"OX": 4, "OY": 16, "C": 2}, flexible=True),
            "dense": SpatialUnrolling({"K": 16, "C": 2}, flexible=True),
            "pool": SpatialUnrolling({"OY": 16}, flexible=True),
            "elementwise": SpatialUnrolling({"E": 16}, flexible=True),
            "*": SpatialUnrolling({}, flexible=True),
        },
        compute=ComputeModel(
            cycles_per_iter=2.0,  # lw/sdotp pipeline, 2 MACs/cycle/core
            output_elem_overhead=8.0 / 64.0,
        ),
        async_dma=True,
        double_buffer=True,
        supported_ops=("conv2d", "dwconv2d", "dense", "elementwise", "pool"),
        frequency_hz=FREQ_HZ,
        handoff_cycles=80.0,  # fork/join across 16 cores
    )
    cluster.patterns = [
        conv_chain_pattern("oc_conv_bias_requant_relu", ("bias_add", "requant", "relu"), _int8),
        conv_chain_pattern("oc_conv_bias_requant", ("bias_add", "requant"), _int8),
        conv_chain_pattern("oc_conv_requant", ("requant",), _int8),
        conv_chain_pattern("oc_conv", (), _int8),
        dwconv_chain_pattern("oc_dwconv_bias_requant_relu", ("bias_add", "requant", "relu"), _int8),
        dwconv_chain_pattern("oc_dwconv_bias_requant", ("bias_add", "requant"), _int8),
        dwconv_chain_pattern("oc_dwconv", (), _int8),
        dense_chain_pattern("oc_dense_bias_requant_relu", ("bias_add", "requant", "relu"), _int8),
        dense_chain_pattern("oc_dense_bias_requant", ("bias_add", "requant"), _int8),
        dense_chain_pattern("oc_dense", (), _int8),
        eltwise_chain_pattern("oc_add_requant", "add", ("requant",), _int8),
        eltwise_chain_pattern("oc_add", "add", (), _int8),
        eltwise_chain_pattern("oc_relu", "relu", (), _int8),
        eltwise_chain_pattern("oc_requant", "requant", (), _int8),
        pool_pattern("oc_avgpool", "avgpool", _int8),
        pool_pattern("oc_maxpool", "maxpool", _int8),
    ]

    # ---- NE16-style accelerator, widened input-channel bank -------------
    ne16v2 = ExecutionModule(
        name="ne16v2",
        memories=(shared_l1, l2),
        spatial={
            "conv2d": SpatialUnrolling({"C": 32, "K": 32}),
        },
        compute=ComputeModel(
            cycles_per_iter=1.0,
            output_elem_overhead=12.0 / 32.0,  # normquant stage
            fixed_setup_cycles=150.0,  # wider job-register file
        ),
        async_dma=True,
        double_buffer=True,
        supported_ops=("conv2d",),  # no depthwise mode on this engine
        frequency_hz=FREQ_HZ,
        handoff_cycles=150.0,
    )
    ne16v2.patterns = [
        conv_chain_pattern("ne16v2_conv_bias_requant_relu", ("bias_add", "requant", "relu"), _ne16v2_conv_ok),
        conv_chain_pattern("ne16v2_conv_bias_requant", ("bias_add", "requant"), _ne16v2_conv_ok),
        conv_chain_pattern("ne16v2_conv_requant", ("requant",), _ne16v2_conv_ok),
        conv_chain_pattern("ne16v2_conv", (), _ne16v2_conv_ok),
    ]

    return MatchTarget(
        name="ne16_octa",
        modules=[cluster, ne16v2],
        fallback=_octa_cpu(),
        interconnect=Interconnect(bandwidth=DMA_BW, hop_latency=CHUNK_OVERHEAD),
        attrs={"frequency_hz": FREQ_HZ},
    )
