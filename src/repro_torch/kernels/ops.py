"""The kernels behind a DSE schedule on the card's own target.

The port of ``repro.kernels.ops``, MATCH's "specialized codegen branch":
before a kernel runs, its workload is scheduled by the LOMA DSE, here
against the H100's :func:`repro_torch.targets.h100.make_h100_target` (built
on first use and cached, as the reference caches its v5e target), never
against the v5e.  Matmuls and attention schedule on ``tensor_core``, the
module whose ``mma.sync`` the bf16 kernels and the int8 GEMM's tensor-core
branch are; the scans schedule on ``cuda_core``.  :func:`hopper_align`
snaps the winning tiles to Hopper's quanta (the ``mma.sync`` fragment's 16
rows and 8 columns, its k of 16 for bf16 and 32 for int8, a 32-lane warp)
as the reference's ``tpu_align`` snaps them to the MXU's.  The DSE's own
search cache (``repro_torch.core.clear_schedule_cache``) makes a repeated
shape cheap, as the paper caches its results per layer geometry.

**The schedule does not set a tiling.**  On the TPU the DSE's blocks become
the Pallas BlockSpecs.  Each ``.cu`` here fixes its own tiling, and the
kernels take no block argument; there are two knobs:

* ``matmul_requant``'s branch (the ``__dp4a`` GEMV or the int8 tensor
  cores), which the kernel picks by its launch's block count, not by a
  loop dimension's tile;
* ``ssd_scan``'s heads per output block, a tile of the scan workload's
  ``B`` (batch x heads) dimension.

A DSE choice is applied only where it names the knob's loop dimension: the
scan's ``B`` block becomes ``ssd_scan``'s heads per block (at most ``H``).
Every other kernel keeps its own rule; :func:`kernel_schedule_table`
records what the DSE chose, and which knob, if any, it set.

On a CPU tensor each wrapper runs its kernel's plain version, as the kernel
wrappers do, and on a CUDA tensor it launches the kernel (counted in the
kernel's ``launches``).  Nothing here registers ``h100`` in the target
registry.
"""

from __future__ import annotations

import math
from typing import Mapping

from repro_torch.core import (
    KernelSchedule,
    attention_workload,
    matmul_workload,
    scan_workload,
    search_schedule,
)
from repro_torch.core.loma import ScheduleResult
from repro_torch.core.target import ExecutionModule
from repro_torch.core.workload import Workload
from repro_torch.targets.h100 import make_h100_target

from .flash_attention import flash_attention
from .matmul_requant import matmul_requant
from .moe_gmm import moe_gmm
from .rglru_scan import rglru_scan
from .ssd_scan import ssd_scan

__all__ = [
    "hopper_align",
    "hopper_schedule",
    "kernel_schedule_table",
    "scheduled_flash_attention",
    "scheduled_matmul_requant",
    "scheduled_moe_gmm",
    "scheduled_rglru_scan",
    "scheduled_ssd_scan",
]

_TARGET = None


def _h100():
    global _TARGET
    if _TARGET is None:
        _TARGET = make_h100_target()
    return _TARGET


# Hopper's quanta: an mma.sync fragment is 16 rows x 8 columns, its k is
# 32 bytes (16 bf16, 32 int8, 8 fp32 as tf32); a warp is 32 lanes
_ROW, _COL, _WARP = 16, 8, 32
_K = {1: 32, 2: 16, 4: 8}


def hopper_align(size: int, dim_kind: str, elem_bytes: int = 2) -> int:
    """Round a tile size (>= 1) up to the Hopper quantum of its position:
    ``row`` 16, ``col`` 8, ``k`` 32 bytes of ``elem_bytes`` elements,
    ``warp`` 32; any other kind passes ``size`` through."""
    if size < 1:
        raise ValueError(f"tile size {size} < 1")
    q = {"row": _ROW, "col": _COL, "warp": _WARP, "k": _K.get(elem_bytes, 16)}.get(dim_kind)
    if q is None:
        return size
    return math.ceil(size / q) * q


def hopper_schedule(
    res: ScheduleResult, workload: Workload, module: ExecutionModule, *, align: Mapping[str, str]
) -> KernelSchedule:
    """``repro_torch.core.schedule_from_result`` with :func:`hopper_align`
    in place of ``tpu_align``: the won tiles, each aligned dim snapped up to
    its quantum and capped at the dim."""
    if not res.feasible:
        block = {l.name: l.size for l in workload.loops}
        return KernelSchedule(block, tuple(workload.dim_names), module.double_buffer, float("inf"))
    tiles = dict(res.mapping.tiles)
    eb = workload.operands[0].elem_bytes
    for dim, kind in align.items():
        if dim in tiles:
            tiles[dim] = min(workload.dim_sizes[dim], hopper_align(tiles[dim], kind, eb))
    return KernelSchedule(
        tiles,
        tuple(res.mapping.outer_order or workload.dim_names),
        module.double_buffer,
        res.cost.latency_cycles,
        meta={"module": module.name, "workload": workload.name, "evals": res.candidates_evaluated},
    )


def _divisor_clip(block: int, dim: int, minimum: int = 1) -> int:
    """Largest divisor of ``dim`` that is <= block (kernels need exact
    tiling; the DSE's ceil-padding tiles are snapped down)."""
    block = max(minimum, min(block, dim))
    while dim % block:
        block -= 1
    return max(block, minimum)


_MATMUL_ALIGN = {"M": "row", "N": "col", "KD": "k"}
_ATTENTION_ALIGN = {"SQ": "row", "SK": "col", "D": "k"}
_SCAN_ALIGN = {"D": "warp"}


def _schedule(wl: Workload, module: str, align: Mapping[str, str]) -> KernelSchedule:
    mod = _h100().module(module)
    return hopper_schedule(search_schedule(wl, mod), wl, mod, align=align)


def _matmul_schedule(name: str, M: int, N: int, KD: int, elem_bytes: int) -> KernelSchedule:
    wl = matmul_workload(name=name, M=M, N=N, KD=KD, a_bytes=elem_bytes, b_bytes=elem_bytes,
                         out_bytes=elem_bytes)
    return _schedule(wl, "tensor_core", _MATMUL_ALIGN)


def _attention_schedule(name: str, elem_bytes: int, causal: bool, **dims) -> KernelSchedule:
    wl = attention_workload(name=name, q_bytes=elem_bytes, kv_bytes=elem_bytes, out_bytes=elem_bytes,
                            causal=causal, **dims)
    return _schedule(wl, "tensor_core", _ATTENTION_ALIGN)


def _scan_schedule(name: str, elem_bytes: int, B: int, T: int, D: int) -> KernelSchedule:
    wl = scan_workload(name=name, B=B, T=T, D=D, elem_bytes=elem_bytes)
    return _schedule(wl, "cuda_core", _SCAN_ALIGN)


def _heads_per_block(sched: KernelSchedule, H: int) -> int:
    """The knob the DSE sets: its block of the scan's batch x heads rows,
    as heads per output block (1..H)."""
    return min(H, sched.block_of("B", 1))


# ---------------------------------------------------------------------------


def scheduled_matmul_requant(a, w, mult, bias, *, shift=8, relu=False, rounding="floor"):
    """:func:`~repro_torch.kernels.matmul_requant` after the DSE: the int8
    GEMM scheduled on ``tensor_core``; the kernel keeps its own branch rule."""
    M, K = a.shape
    N = w.shape[1]
    _matmul_schedule(f"mmrq_{M}x{N}x{K}", M, N, K, a.element_size())
    return matmul_requant(a, w, mult, bias, shift=shift, relu=relu, rounding=rounding)


def scheduled_flash_attention(q, k, v, *, causal=True, q_offset=0, window=None):
    """:func:`~repro_torch.kernels.flash_attention` after the DSE (attention
    on ``tensor_core``); the kernel keeps its own tiling."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    _attention_schedule(f"fa_{B}x{H}x{Sq}x{Sk}x{D}", q.element_size(), causal, B=B, H=H, SQ=Sq, SK=Sk, D=D)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset, window=window)


def scheduled_moe_gmm(x, w):
    """:func:`~repro_torch.kernels.moe_gmm` after the DSE (one expert's
    ``(C, D) x (D, F)`` on ``tensor_core``); the kernel keeps its tiling."""
    E, C, D = x.shape
    F = w.shape[-1]
    _matmul_schedule(f"gmm_{E}x{C}x{D}x{F}", C, F, D, x.element_size())
    return moe_gmm(x, w)


def scheduled_rglru_scan(a, b):
    """:func:`~repro_torch.kernels.rglru_scan` after the DSE (the scan on
    ``cuda_core``); the kernel keeps its own time split."""
    B, T, W = a.shape
    _scan_schedule(f"lru_{B}x{T}x{W}", a.element_size(), B, T, W)
    return rglru_scan(a, b)


def scheduled_ssd_scan(xb, a, Bm, Cm):
    """:func:`~repro_torch.kernels.ssd_scan` with the heads per output block
    the DSE picks: the scan workload (``B`` = batch x heads, ``D`` = P x N)
    on ``cuda_core``, its ``B`` block capped at ``H``.  Returns
    ``(y, h_final)``."""
    B, H, T, P = xb.shape
    N = Bm.shape[-1]
    sched = _scan_schedule(f"ssd_{B}x{H}x{T}", xb.element_size(), B * H, T, P * N)
    return ssd_scan(xb, a, Bm, Cm, heads=_heads_per_block(sched, H))


# the reference's five shapes (repro.kernels.ops.kernel_schedule_table) in
# the element sizes the port's kernels take (int8 GEMM, bf16 attention and
# expert GEMM, fp32 scans), and mamba2-1.3b's (1, 4096) prefill scan, 64
# heads (B = batch x heads, D = P x N), the one kernel whose knob the DSE sets
_TABLE = [
    ("matmul_requant", dict(M=4096, N=6144, KD=6144), 1),
    ("matmul_requant", dict(M=512, N=512, KD=512), 1),
    ("flash_attention", dict(B=8, H=16, SQ=4096, SK=4096, D=128), 2),
    ("moe_gmm", dict(M=1280, N=10752, KD=6144), 2),
    ("rglru_scan", dict(B=8, T=4096, D=2560), 4),
    ("ssd_scan", dict(B=1 * 64, T=4096, D=64 * 128), 4),
]
_SSD_TABLE_HEADS = 64


def kernel_schedule_table() -> list[dict]:
    """The DSE's decisions on the h100 target for representative kernel
    shapes: per row the kernel, its dims, the module, the blocks (snapped
    to divisors of the dims), the grid order, the predicted cycles, and the
    knob set from the schedule (``None``: the kernel keeps its own rule)."""
    rows = []
    for name, dims, eb in _TABLE:
        knob = None
        if name == "flash_attention":
            s = _attention_schedule(name, eb, True, **dims)
        elif name in ("rglru_scan", "ssd_scan"):
            s = _scan_schedule(name, eb, **dims)
            if name == "ssd_scan":
                knob = {"heads_per_block": _heads_per_block(s, _SSD_TABLE_HEADS)}
        else:
            s = _matmul_schedule(name, **dims, elem_bytes=eb)
        rows.append(
            {
                "kernel": name,
                "dims": dims,
                "module": s.meta.get("module"),
                "block": {d: _divisor_clip(b, dims[d]) for d, b in s.block.items()},
                "grid_order": s.grid_order,
                "predicted_cycles": s.predicted_cycles,
                "knob": knob,
            }
        )
    return rows
