"""repro_torch.configs — one module per assigned architecture.

Each module exposes ``CONFIG`` (the exact published geometry) and
``SMOKE`` (a reduced same-family config for CPU tests).  ``get_config``/
``get_smoke`` resolve by id; ``ALL_ARCHS`` lists the ten assigned ids.

Input-shape cells (LM pool):
  train_4k     seq 4096  x global_batch 256   (train_step)
  prefill_32k  seq 32768 x global_batch 32    (prefill)
  decode_32k   seq 32768 x global_batch 128   (serve_step)
  long_500k    seq 524288 x global_batch 1    (serve_step, sub-quadratic only)
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models import ModelConfig

ALL_ARCHS = [
    "dbrx_132b",
    "granite_moe_3b_a800m",
    "qwen2_vl_2b",
    "starcoder2_15b",
    "granite_34b",
    "qwen2_5_3b",
    "gemma_7b",
    "recurrentgemma_2b",
    "hubert_xlarge",
    "mamba2_1_3b",
]


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def _mod(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Which (arch x shape) cells run; principled skips per the brief."""
    cell = SHAPES[shape]
    if cell.kind == "decode" and not cfg.decoder:
        return False, "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full attention is O(S^2) at 524288; skipped per brief"
    return True, ""


def applicable_cells(arch: str) -> list[str]:
    cfg = get_config(arch)
    return [s for s in SHAPES if cell_applicable(cfg, s)[0]]
