"""DIANA MatchTarget (paper Sec. V-A).

DIANA [Ueyoshi et al., ISSCC 2022] couples a RISC-V control core with a
digital 16x16 SIMD PE array (256 int8 MACs/cycle) and an analog IMC
accelerator.  Following the paper we model only the digital module
(8-bit networks).

Published constants reproduced here:

* PE array 16x16; convs spatially unroll (K, OX); FC layers unroll
  input and output neurons (C, K).
* 256 kB L1 activation memory + 64 kB private weight memory; 512 kB L2.
* L_ops: 1 cycle each for input read / MAC / output write, plus 23 cycles
  for output elementwise (requant, ReLU, pool) + store per output wave.
* DMA is **blocking** => L = L_ops + L_mem (paper eq.), 70 cycles of
  overhead per contiguous chunk transferred.
* K and OX must be multiples of 16 — handled by the padding network
  transformation; the cost model charges the ceil-quantization anyway.
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
)

FREQ_HZ = 260e6  # paper Sec. VI experimental setup

# DMA bandwidth between L2 and the accelerator memories (bytes/cycle).
# Not stated numerically in the paper; 8 B/cycle (64-bit AXI) is the
# DIANA SoC bus width reported in the ISSCC paper.
DMA_BW = 8.0
CHUNK_OVERHEAD = 70.0  # paper: "70-cycles for each chunk of data stored contiguously"


def _diana_cpu() -> ExecutionModule:
    """RISC-V control core executing TVM fallback code (plain scalar)."""
    return ExecutionModule(
        name="cpu",
        memories=(
            MemoryLevel("dcache", 32 * 1024, 4.0, chunk_overhead=0.0),
            MemoryLevel("L2", 512 * 1024, 4.0),
        ),
        spatial={"*": SpatialUnrolling(dims={})},
        compute=ComputeModel(cycles_per_iter=3.0, output_elem_overhead=2.0),
        async_dma=False,
        double_buffer=False,
        supported_ops=(
            "conv2d",
            "dwconv2d",
            "dense",
            "elementwise",
            "pool",
        ),
        frequency_hz=FREQ_HZ,
    )


def _int8_constraint(nodes) -> bool:
    return all(int(n.attr("elem_bytes", 1)) == 1 for n in nodes[:1])


def make_diana_target() -> MatchTarget:
    accel = ExecutionModule(
        name="digital",
        memories=(
            MemoryLevel("L1act", 256 * 1024, DMA_BW, serves=("I", "O"), chunk_overhead=CHUNK_OVERHEAD),
            MemoryLevel("Wmem", 64 * 1024, DMA_BW, serves=("W",), chunk_overhead=CHUNK_OVERHEAD),
            MemoryLevel("L2", 512 * 1024, DMA_BW),
        ),
        spatial={
            "conv2d": SpatialUnrolling({"K": 16, "OX": 16}),
            # DW convs cannot reuse the K dimension of the array across
            # channels (each output channel reads only its own input
            # channel): only OX unrolls -> low utilization, paper Sec. VI-A
            "dwconv2d": SpatialUnrolling({"OX": 16}),
            "dense": SpatialUnrolling({"K": 16, "C": 16}),
        },
        compute=ComputeModel(
            # read-in / MAC / write-out are 1 cycle each but pipelined:
            # the array retires one 16x16 wave per cycle in steady state
            cycles_per_iter=1.0,
            output_elem_overhead=23.0 / 256.0,  # 23 cycles per 16x16 output wave
        ),
        async_dma=False,  # paper: DIANA transfers data synchronously
        double_buffer=False,
        supported_ops=("conv2d", "dwconv2d", "dense"),
        frequency_hz=FREQ_HZ,
        handoff_cycles=CHUNK_OVERHEAD,  # DMA reprogram on a module switch
    )
    accel.patterns = [
        conv_chain_pattern("conv_bias_requant", ("bias_add", "requant"), _int8_constraint),
        conv_chain_pattern("conv_bias_requant_relu", ("bias_add", "requant", "relu"), _int8_constraint),
        conv_chain_pattern("conv_requant", ("requant",), _int8_constraint),
        conv_chain_pattern("conv_only", (), _int8_constraint),
        dwconv_chain_pattern("dwconv_bias_requant", ("bias_add", "requant"), _int8_constraint),
        dwconv_chain_pattern("dwconv_requant", ("requant",), _int8_constraint),
        dwconv_chain_pattern("dwconv_only", (), _int8_constraint),
        dense_chain_pattern("dense_bias_requant", ("bias_add", "requant"), _int8_constraint),
        dense_chain_pattern("dense_requant", ("requant",), _int8_constraint),
        dense_chain_pattern("dense_only", (), _int8_constraint),
    ]
    return MatchTarget(
        name="diana",
        modules=[accel],
        fallback=_diana_cpu(),
        # accelerator <-> CPU handoffs round-trip activations through the
        # 512 kB L2 over the 64-bit AXI; DMA is blocking on DIANA.
        interconnect=Interconnect(bandwidth=DMA_BW, hop_latency=CHUNK_OVERHEAD),
        attrs={"frequency_hz": FREQ_HZ},
    )
