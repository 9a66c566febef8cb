"""repro_torch.kernels — the compute hot spots of the port.

* :func:`matmul_requant` — int8 GEMM + requant epilogue, a hand-written
  CUDA kernel for Hopper (``csrc/matmul_requant.cu``) in place of the
  reference's Pallas TPU kernel, with :func:`matmul_requant_plain` beside
  it for CPU tensors;
* :func:`flash_attention` — blocked GQA attention with an online softmax
  (causal, sliding window, ``q_offset``), a hand-written CUDA kernel
  (``csrc/flash_attention.cu``) in place of the reference's Pallas
  kernel, with :func:`flash_attention_plain` beside it;
* :func:`moe_gmm` — the MoE grouped expert GEMM, a hand-written CUDA
  kernel (``csrc/moe_gmm.cu``) in place of the reference's Pallas kernel,
  with :func:`moe_gmm_plain` beside it;
* :func:`ssd_scan` — the Mamba-2 SSD chunk scan with a carried state
  (returning the final state too), a hand-written CUDA kernel
  (``csrc/ssd_scan.cu``) in place of the reference's Pallas kernel, with
  :func:`ssd_scan_plain` beside it;
* :func:`rglru_scan` — the RG-LRU linear recurrence, a hand-written CUDA
  kernel (``csrc/rglru_scan.cu``) in place of the reference's Pallas
  kernel, with :func:`rglru_scan_plain` beside it;
* :func:`tiled_conv2d` — the banded SAME conv (plain ``F.conv2d`` per
  band, as the reference's is plain ``lax.conv_general_dilated``);
* :mod:`.ref` — plain torch oracles.
"""

from . import ref
from .flash_attention import flash_attention, flash_attention_plain
from .matmul_requant import matmul_requant, matmul_requant_plain
from .moe_gmm import moe_gmm, moe_gmm_plain
from .rglru_scan import rglru_scan, rglru_scan_plain
from .ssd_scan import ssd_scan, ssd_scan_plain
from .tiled_conv import tiled_conv2d

__all__ = [
    "ref",
    "flash_attention",
    "flash_attention_plain",
    "matmul_requant",
    "matmul_requant_plain",
    "moe_gmm",
    "moe_gmm_plain",
    "rglru_scan",
    "rglru_scan_plain",
    "ssd_scan",
    "ssd_scan_plain",
    "tiled_conv2d",
]
