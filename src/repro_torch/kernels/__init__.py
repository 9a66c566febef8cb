"""repro_torch.kernels — the compute hot spots of the port.

* :func:`matmul_requant` — int8 GEMM + requant epilogue, a hand-written
  CUDA kernel for Hopper (``csrc/matmul_requant.cu``) in place of the
  reference's Pallas TPU kernel, with :func:`matmul_requant_plain` beside
  it for CPU tensors;
* :func:`flash_attention` — blocked GQA attention with an online softmax
  (causal, sliding window, ``q_offset``), a hand-written CUDA kernel
  (``csrc/flash_attention.cu``) in place of the reference's Pallas
  kernel, with :func:`flash_attention_plain` beside it;
* :func:`tiled_conv2d` — the banded SAME conv (plain ``F.conv2d`` per
  band, as the reference's is plain ``lax.conv_general_dilated``);
* :mod:`.ref` — plain torch oracles.

The reference's other LM kernels (MoE grouped GEMM, SSD and RG-LRU
scans) are not ported yet.
"""

from . import ref
from .flash_attention import flash_attention, flash_attention_plain
from .matmul_requant import matmul_requant, matmul_requant_plain
from .tiled_conv import tiled_conv2d

__all__ = [
    "ref",
    "flash_attention",
    "flash_attention_plain",
    "matmul_requant",
    "matmul_requant_plain",
    "tiled_conv2d",
]
