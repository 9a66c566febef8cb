"""NVIDIA H100 MatchTarget — the card the port runs on.

The port's analogue of :mod:`repro_torch.targets.tpu_v5e`: the paper's
per-SoC model file, written for the H100 SXM from its data sheet (NVIDIA
H100 Tensor Core GPU data sheet and the Hopper architecture white
paper):

* 132 streaming multiprocessors (SMs), 128 FP32 lanes each;
* 227 KB (232,448 bytes) of shared memory a block can use, of the SM's
  256 KB: the L1 of the MATCH hierarchy, where a tile lives;
* a 50 MB L2 shared by all SMs;
* 80 GB of HBM3 at 3.35 TB/s;
* dense peaks 67 TFLOP/s FP32 on the CUDA cores, 989 TFLOP/s bf16 and
  1,979 TOP/s int8 on the tensor cores.

The data sheet names no clock for its peaks.  The FP32 peak is exactly
132 SMs x 128 lanes x 2 FLOP x 1.98 GHz, the card's largest SM clock
(``nvidia-smi --query-gpu=clocks.max.sm`` reads 1980 MHz), so every cycle
in this file is a 1.98 GHz cycle and every per-cycle rate is a peak
divided by that clock.

**Modules are declared by what the port runs on them, never by the
card's best peak:**

* ``cuda_core`` — the CUDA cores.  The CNN's exact convs run there in
  fp32 through cuDNN, TF32 off (:func:`repro_torch._device.resolve_device`):
  one FMA per lane per cycle, 128 lanes per SM.  The int8 GEMM
  (``csrc/matmul_requant.cu``) runs there as ``__dp4a`` up to 512 blocks of
  8 outputs, every CNN GEMM segment among them: four int8 MACs per
  instruction at the 32-bit integer multiply-add rate, 64 per SM per cycle
  (the CUDA C++ Programming Guide's throughput table), so 256 MACs per SM
  per cycle.  Beyond 512 blocks its ``mma.sync m16n8k32`` branch computes
  it on the int8 tensor cores.  The scan kernels (``csrc/ssd_scan.cu``,
  ``csrc/rglru_scan.cu``) run on the CUDA cores as well.
* ``tensor_core`` — the bf16 tensor cores, which ``flash_attention`` and
  ``moe_gmm`` use (``mma.sync``, 64-row tiles), declared at the bf16 rate.
  No CNN op is dispatched there; ``repro_torch.kernels.ops`` schedules the
  LM kernels' matmul and attention workloads, the int8 GEMM's among them,
  on it.
* ``aten`` — the fallback: one PyTorch operator per graph node, each its
  own kernel, unfused and unscheduled (the "plain TVM on the main CPU"
  of the paper).

So **every CNN anchor (conv, dwconv, dense) lands on one module,
``cuda_core``, or on the fallback**: the port runs no CNN op on the
tensor cores, and this file does not pretend it does.  The LM patterns
(``matmul``, ``attention``, ``scan``) are registered by the kernel
schedules, as on the TPU target; this file only declares the modules.

**Launch cost.**  On the card every MLPerf-Tiny segment is launch-bound:
an empty ``sm_90a`` kernel replayed in a CUDA graph takes 0.84–1.12 µs
(``chip_smoke.py``'s launch floor, ``csrc/launch_floor.cu``), longer
than the arithmetic of any segment.  Each module charges the middle of
that range, 0.98 µs at 1.98 GHz, once per segment
(``fixed_overhead_cycles``: at least one kernel per segment) and once on
each side of a module switch (``handoff_cycles``: the switch is a kernel
boundary).  Nothing moves between modules on the card: a switch reads
the producer's output back through L2 at the HBM rate, with no DMA to
program (``hop_latency`` 0).

Two simplifications, for the calibration fit (``repro_torch.calibrate``)
to correct: operand bytes are the graph's int8 bytes, while the exact
conv path holds them as fp32; and every inner level streams at the HBM
rate, while the CNN's activations sit in L2.

Registration is explicit: :func:`register_h100_target` adds ``h100`` to
the registry, importing this module does not (a side effect on import
would widen every ``list_targets()`` matrix).
"""

from __future__ import annotations

from dataclasses import dataclass

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

__all__ = ["H100", "H100Spec", "make_h100_target", "register_h100_target"]


@dataclass(frozen=True)
class H100Spec:
    """H100 SXM data-sheet numbers, and the launch floor measured on the
    card (NVIDIA H100 80GB HBM3 at a 700 W power limit)."""

    sms: int = 132
    clock_hz: float = 1.98e9  # largest SM clock; the FP32 peak's clock
    fp32_lanes_per_sm: int = 128
    dp4a_per_sm_cycle: int = 64  # 32-bit integer multiply-add rate
    smem_per_block: int = 232_448  # 227 KB of the SM's 256 KB
    l2_bytes: int = 50 * 1024**2
    hbm_capacity: int = 80 * 1024**3
    hbm_bytes_per_s: float = 3.35e12
    peak_flops_fp32: float = 67e12
    peak_flops_bf16: float = 989e12  # dense, tensor cores
    peak_ops_int8: float = 1979e12  # dense, tensor cores: matmul_requant's mma.sync m16n8k32 branch
    launch_floor_s: float = 0.98e-6  # middle of the measured 0.84-1.12 us
    # NVLink 4 (H100 SXM data sheet): 900 GB/s per GPU, both directions
    # together; launch.roofline's collective rate.  A (16, 16) mesh all on
    # NVLink is an idealisation, as the reference's uniform ICI torus is.
    nvlink_bytes_per_s: float = 900e9

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bytes_per_s / self.clock_hz

    @property
    def bf16_macs_per_cycle(self) -> float:
        return self.peak_flops_bf16 / 2.0 / self.clock_hz

    @property
    def launch_floor_cycles(self) -> float:
        return self.launch_floor_s * self.clock_hz


H100 = H100Spec()


def _int8(nodes) -> bool:
    return all(int(n.attr("elem_bytes", 1)) == 1 for n in nodes[:1])


def make_h100_target(spec: H100Spec = H100) -> MatchTarget:
    """Card-level MatchTarget: CUDA cores and tensor cores over shared
    memory, L2 and HBM, with the aten fallback."""
    hbm_bpc = spec.hbm_bytes_per_cycle  # ~1692 B/cycle at 1.98 GHz
    launch = spec.launch_floor_cycles  # ~1940 cycles
    smem = MemoryLevel("SMEM", spec.smem_per_block, hbm_bpc)
    l2 = MemoryLevel("L2", spec.l2_bytes, hbm_bpc)
    hbm = MemoryLevel("HBM", spec.hbm_capacity, hbm_bpc)

    # spatial dims are one SM's lanes; macs_per_pe_cycle folds the SMs in
    # (132 x 128 FMA x 2 x 1.98 GHz = 66.9 TFLOP/s, the FP32 peak)
    lanes = spec.fp32_lanes_per_sm
    cuda_core = ExecutionModule(
        name="cuda_core",
        memories=(smem, l2, hbm),
        spatial={
            "conv2d": SpatialUnrolling({"K": 32, "OX": lanes // 32}),
            "dwconv2d": SpatialUnrolling({"C": 32, "OX": lanes // 32}),
            # __dp4a: 64 lanes along K, a 4-wide int8 dot product along C
            "dense": SpatialUnrolling({"K": spec.dp4a_per_sm_cycle, "C": 4}),
            "scan": SpatialUnrolling({"D": lanes}),
        },
        compute=ComputeModel(
            cycles_per_iter=1.0,
            macs_per_pe_cycle=float(spec.sms),
            fixed_overhead_cycles=launch,
        ),
        async_dma=True,  # warps in flight overlap loads with arithmetic
        double_buffer=True,
        supported_ops=("conv2d", "dwconv2d", "dense", "scan"),
        frequency_hz=spec.clock_hz,
        handoff_cycles=launch,
    )
    cuda_core.patterns = [
        conv_chain_pattern("cc_conv_bias_requant_relu", ("bias_add", "requant", "relu"), _int8),
        conv_chain_pattern("cc_conv_bias_requant", ("bias_add", "requant"), _int8),
        conv_chain_pattern("cc_conv_requant", ("requant",), _int8),
        conv_chain_pattern("cc_conv", (), _int8),
        dwconv_chain_pattern("cc_dwconv_bias_requant_relu", ("bias_add", "requant", "relu"), _int8),
        dwconv_chain_pattern("cc_dwconv_bias_requant", ("bias_add", "requant"), _int8),
        dwconv_chain_pattern("cc_dwconv_requant", ("requant",), _int8),
        dwconv_chain_pattern("cc_dwconv", (), _int8),
        dense_chain_pattern("cc_dense_bias_requant_relu", ("bias_add", "requant", "relu"), _int8),
        dense_chain_pattern("cc_dense_bias_requant", ("bias_add", "requant"), _int8),
        dense_chain_pattern("cc_dense_requant", ("requant",), _int8),
        dense_chain_pattern("cc_dense", (), _int8),
    ]

    # the bf16 tensor cores under flash_attention and moe_gmm: 64-row tiles
    tc_pe = 64 * 64
    tensor_core = ExecutionModule(
        name="tensor_core",
        memories=(smem, l2, hbm),
        spatial={
            "matmul": SpatialUnrolling({"M": 64, "N": 64}),
            "attention": SpatialUnrolling({"SQ": 64, "D": 64}),
        },
        compute=ComputeModel(
            cycles_per_iter=1.0,
            macs_per_pe_cycle=spec.bf16_macs_per_cycle / tc_pe,
            fixed_overhead_cycles=launch,
        ),
        async_dma=True,  # cp.async rings
        double_buffer=True,
        supported_ops=("matmul", "attention"),
        frequency_hz=spec.clock_hz,
        handoff_cycles=launch,
    )

    # one PyTorch operator per node on the same CUDA cores: no fusion, no
    # overlap credit, a launch per node
    aten = ExecutionModule(
        name="aten",
        memories=(MemoryLevel("SMEMx", spec.smem_per_block, hbm_bpc), l2, hbm),
        spatial={"*": SpatialUnrolling({})},
        compute=ComputeModel(
            cycles_per_iter=1.0,
            macs_per_pe_cycle=float(spec.sms * lanes),
            fixed_overhead_cycles=launch,
        ),
        async_dma=False,
        double_buffer=False,
        supported_ops=(
            "matmul",
            "attention",
            "conv2d",
            "dwconv2d",
            "dense",
            "scan",
            "elementwise",
            "pool",
        ),
        frequency_hz=spec.clock_hz,
        handoff_cycles=launch,
    )

    return MatchTarget(
        name="h100",
        modules=[cuda_core, tensor_core],
        fallback=aten,
        interconnect=Interconnect(bandwidth=hbm_bpc, hop_latency=0.0),
        attrs={"spec": spec, "frequency_hz": spec.clock_hz},
    )


def register_h100_target() -> None:
    """Add ``h100`` to :mod:`repro_torch.targets.registry` (idempotent).

    The only way the card's target enters ``list_targets()``: importing
    this module registers nothing."""
    from .registry import register_target

    register_target(
        "h100",
        make_h100_target,
        description="NVIDIA H100 SXM: CUDA cores + bf16 tensor cores over SMEM->L2->HBM3, aten fallback",
        overwrite=True,
    )
