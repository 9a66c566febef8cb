"""GAP9 MatchTarget (paper Sec. V-B).

GAP9 (GreenWaves, industrial PULP embodiment) = RISC-V control MCU
+ 8-core DSP cluster (PULP-NN kernels) + NE16 DNN accelerator, sharing a
128 kB multi-bank L1 and a 1.5 MB L2.  This is the paper's showcase of a
**two-execution-module** MatchTarget: every NE16 pattern also appears in
the cluster's table, and the dispatcher arbitrates by predicted latency
(paper Table IV).

Published constants reproduced here:

* cluster spatial mapping from PULP-NN inner loop: OX=2, K=4, OY=8
  (paper Sec. V-B); SIMD int8 dot-product units.
* NE16: 3x3 / 1x1 conv engine with 16-input-channel x 32-output-channel
  parallelism; **no fully-connected support** (paper: the DAE never maps
  to NE16) and filters must be square 1x1/3x3 (the DSCNN 4x10 first layer
  falls back to the cluster).
* Both modules use **asynchronous, double-buffered DMA**:
  L = max(L_ops, L_mem); 27 cycles per contiguous chunk.
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

FREQ_HZ = 260e6
DMA_BW = 8.0  # bytes/cycle, 64-bit cluster DMA
CHUNK_OVERHEAD = 27.0  # paper: "27-cycles overhead for each chunk"

L1_BYTES = 128 * 1024
L2_BYTES = 3 * 512 * 1024  # 1.5 MB


def _gap9_cpu() -> ExecutionModule:
    """Control core running TVM-default code (no DSP extensions used)."""
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


def _ne16_conv_ok(nodes) -> bool:
    """NE16 supports square 1x1 / 3x3 filters only (paper Sec. VI-C:
    the DSCNN 4x10 first layer cannot be offloaded)."""
    n = nodes[0]
    fy, fx = int(n.attr("FY", 0)), int(n.attr("FX", 0))
    return _int8(nodes) and fy == fx and fy in (1, 3)


def make_gap9_target() -> MatchTarget:
    shared_l1 = MemoryLevel("L1", L1_BYTES, DMA_BW, chunk_overhead=CHUNK_OVERHEAD)
    l2 = MemoryLevel("L2", L2_BYTES, DMA_BW)

    # ---- 8-core cluster running PULP-NN ---------------------------------
    # PULP-NN inner loop retires 4x int8 MACs/cycle/core (SIMD sdotp);
    # 8 cores => 32 MACs/cycle peak; the paper's optimal spatial mapping
    # for convs is OX=2, K=4, OY=8 (flexible: parallelism-reduction rule).
    cluster = ExecutionModule(
        name="cluster",
        memories=(shared_l1, l2),
        spatial={
            "conv2d": SpatialUnrolling({"OX": 2, "K": 4, "OY": 8}, flexible=True),
            "dwconv2d": SpatialUnrolling({"OX": 2, "OY": 8, "C": 4}, flexible=True),
            "dense": SpatialUnrolling({"K": 8, "C": 4}, flexible=True),
            "pool": SpatialUnrolling({"OY": 8}, flexible=True),
            "elementwise": SpatialUnrolling({"E": 8}, flexible=True),
            "*": SpatialUnrolling({}, flexible=True),
        },
        compute=ComputeModel(
            cycles_per_iter=2.0,  # lw/sdotp pipeline, ~16 MACs/cyc achieved
            output_elem_overhead=8.0 / 64.0,  # requant+store epilogue
        ),
        async_dma=True,  # paper: L = max(L_ops, L_mem,1,2)
        double_buffer=True,
        supported_ops=("conv2d", "dwconv2d", "dense", "elementwise", "pool"),
        frequency_hz=FREQ_HZ,
        handoff_cycles=100.0,  # cluster fork/join around an offloaded segment
    )
    cluster.patterns = [
        conv_chain_pattern("cl_conv_bias_requant_relu", ("bias_add", "requant", "relu"), _int8),
        conv_chain_pattern("cl_conv_bias_requant", ("bias_add", "requant"), _int8),
        conv_chain_pattern("cl_conv_requant", ("requant",), _int8),
        conv_chain_pattern("cl_conv", (), _int8),
        dwconv_chain_pattern("cl_dwconv_bias_requant", ("bias_add", "requant"), _int8),
        dwconv_chain_pattern("cl_dwconv_requant", ("requant",), _int8),
        dwconv_chain_pattern("cl_dwconv", (), _int8),
        dense_chain_pattern("cl_dense_bias_requant_relu", ("bias_add", "requant", "relu"), _int8),
        dense_chain_pattern("cl_dense_bias_requant", ("bias_add", "requant"), _int8),
        dense_chain_pattern("cl_dense_requant", ("requant",), _int8),
        dense_chain_pattern("cl_dense", (), _int8),
        # paper Fig. 11: the cluster manages the residual additions
        eltwise_chain_pattern("cl_add_requant", "add", ("requant",), _int8),
        eltwise_chain_pattern("cl_add", "add", (), _int8),
        eltwise_chain_pattern("cl_relu", "relu", (), _int8),
        eltwise_chain_pattern("cl_requant", "requant", (), _int8),
        pool_pattern("cl_avgpool", "avgpool", _int8),
        pool_pattern("cl_maxpool", "maxpool", _int8),
    ]

    # ---- NE16 accelerator ------------------------------------------------
    # 16-in-channel x 32-out-channel MAC bank; 1x1 and 3x3 modes; int8.
    ne16 = ExecutionModule(
        name="ne16",
        memories=(shared_l1, l2),
        spatial={
            "conv2d": SpatialUnrolling({"C": 16, "K": 32}),
            "dwconv2d": SpatialUnrolling({"C": 16, "OX": 16}),
        },
        compute=ComputeModel(
            cycles_per_iter=1.0,
            output_elem_overhead=10.0 / 32.0,  # requant/normquant stage
            fixed_setup_cycles=100.0,  # job configuration registers
        ),
        async_dma=True,
        double_buffer=True,
        supported_ops=("conv2d", "dwconv2d"),
        frequency_hz=FREQ_HZ,
        handoff_cycles=100.0,  # NE16 job-register reprogram at a boundary
    )
    ne16.patterns = [
        conv_chain_pattern("ne16_conv_bias_requant_relu", ("bias_add", "requant", "relu"), _ne16_conv_ok),
        conv_chain_pattern("ne16_conv_bias_requant", ("bias_add", "requant"), _ne16_conv_ok),
        conv_chain_pattern("ne16_conv_requant", ("requant",), _ne16_conv_ok),
        conv_chain_pattern("ne16_conv", (), _ne16_conv_ok),
        dwconv_chain_pattern("ne16_dwconv_bias_requant", ("bias_add", "requant"), _ne16_conv_ok),
        dwconv_chain_pattern("ne16_dwconv_requant", ("requant",), _ne16_conv_ok),
        dwconv_chain_pattern("ne16_dwconv", (), _ne16_conv_ok),
    ]

    return MatchTarget(
        name="gap9",
        modules=[cluster, ne16],
        fallback=_gap9_cpu(),
        # Cluster and NE16 share L1/L2, so a module switch costs one DMA
        # round on the shared path plus the per-chunk sync overhead.
        interconnect=Interconnect(bandwidth=DMA_BW, hop_latency=CHUNK_OVERHEAD),
        attrs={"frequency_hz": FREQ_HZ},
    )
