"""Grouped expert matmul (the MoE FFN's GEMMs) — the Hopper kernel.

Port of the Pallas TPU kernel ``repro.kernels.moe_gmm`` (``_kernel``):
``y[e] = x[e] @ w[e]`` for every expert ``e``, x ``(E, C, D)`` and w
``(E, D, F)`` of one dtype (f32 or bf16), products and sums in fp32, the
output ``(E, C, F)`` in x's dtype.  The reference model computes the same
function as a plain ``jnp.einsum`` (``repro.models.moe.moe_ffn``); the port
routes those three products per MoE layer through this kernel.

On a CUDA tensor :func:`moe_gmm` launches the hand-written CUDA kernel in
``csrc/moe_gmm.cu`` (built for ``sm_90a`` at first use, see
:mod:`repro_torch.kernels._build`); on a CPU tensor it computes
:func:`moe_gmm_plain`, the fp32 einsum.  There is no fallback between the
two: a CUDA call launches or raises.

The kernel replaces ``src/repro/kernels/moe_gmm.py::_kernel``.  At the
serving shapes it is bound by the bytes of the expert weights.  bf16 runs a
tensor-core grouped GEMM (``mma.sync`` on bf16) that streams w through a
4-stage ``cp.async`` ring; f32 runs a CUDA-core kernel, since TF32 would
miss the 1e-4 tolerance.  The source says what each design does and what
it leaves for later.  It takes any C, D and F (the Pallas kernel asserts
exact tiling) and reads x and w through their strides; bf16 operands whose
rows start on 16 bytes are staged by 16-byte copies, others by element
loads, in the same kernel.

Routed rows: the model's x is ``(E, B * cap, D)``, and only the first
``rows[b, e]`` of expert ``e``'s ``cap`` slots of batch row ``b`` hold a
(token, expert) pair.  Given ``rows`` (B, E) int32 on x's device, the
kernel skips every tile of ``y`` that holds no pair: it reads nothing for
it and writes zeros.  The result is the product on the filled rows and 0
on the rest, on any device (:func:`moe_gmm_plain` takes ``rows`` too).
With ``tally`` (an int64 on x's device) the call adds the rows of the
tiles it runs to it; the counts stay on the device, so a captured graph
reads each replay's own (the plain version's tally reads them to the host).

Training: under grad, with an input that needs a gradient, every row is
computed, as before the routed rows, and a CUDA call goes through
``_MoeGmm`` (an ``autograd.Function``: the same counted launch forward)
whose backward, :func:`moe_gmm_backward`, is two more launches of this
kernel (dx = dy·wᵀ, dw = xᵀ·dy).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._device import upcast

from . import _build, _layout

__all__ = ["moe_gmm", "moe_gmm_backward", "moe_gmm_plain"]

_BLOCK_C = 32  # the kernel's rows per block: C must fit 65535 blocks
_GRID_MAX = 65535


def _check_args(x: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None = None, tally=None) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"need x (E, C, D) and w (E, D, F), got {x.dim()}-d and {w.dim()}-d")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"need x (E, C, D) and w (E, D, F), got {tuple(x.shape)} and {tuple(w.shape)}")
    if rows is not None:
        if rows.dim() != 2 or rows.shape[1] != x.shape[0] or rows.shape[0] < 1 or x.shape[1] % rows.shape[0]:
            raise ValueError(f"need rows (B, E) with C a multiple of B, got {tuple(rows.shape)} for x {tuple(x.shape)}")
        if rows.dtype != torch.int32 or rows.device != x.device:
            raise TypeError(f"rows must be int32 on x's device, got {rows.dtype} on {rows.device}")
    if tally is not None:
        if rows is None:
            raise ValueError("a tally counts the rows of routed tiles: it needs rows")
        if tally.dtype != torch.int64 or tally.device != x.device or tally.numel() != 1:
            raise TypeError("tally must be one int64 on x's device")


def _filled(rows: torch.Tensor, C: int) -> torch.Tensor:
    """(E, C) bool: row r of expert e holds a pair iff r % cap < rows[r // cap, e]."""
    B = rows.shape[0]
    cap = C // B
    return (torch.arange(cap, device=rows.device)[None, None, :] < rows[:, :, None]).permute(1, 0, 2).reshape(-1, C)


def _tile_rows(filled: torch.Tensor, dtype: torch.dtype) -> int:
    """The rows of the kernel's tiles that hold a filled row of ``filled``
    (E, C), their unfilled rows included: a tile is 16 rows of one expert
    where bf16 and C <= 16, else 32 (the kernel's BM and kBC)."""
    E, C = filled.shape
    bm = 16 if dtype == torch.bfloat16 and C <= 16 else _BLOCK_C
    tiles = -(-C // bm)
    runs = torch.cat([filled, filled.new_zeros((E, tiles * bm - C))], dim=1).reshape(E, tiles, bm).any(dim=-1)
    return int((runs * (C - bm * torch.arange(tiles, device=filled.device)).clamp_max(bm)).sum())


def moe_gmm_plain(
    x: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None = None, *, tally: torch.Tensor | None = None
) -> torch.Tensor:
    """The kernel's function in plain torch, on any device: the fp32
    einsum ``ecd,edf->ecf``, returned in x's dtype; with ``rows``, 0 on
    every row that holds no pair, and ``tally`` (if given) raised by the
    rows of the tiles the kernel would run."""
    _check_args(x, w, rows, tally)
    y = torch.einsum("ecd,edf->ecf", upcast(x), upcast(w)).to(x.dtype)
    if rows is None:
        return y
    filled = _filled(rows, x.shape[1])
    if tally is not None:
        tally += _tile_rows(filled, x.dtype)
    return torch.where(filled[:, :, None], y, torch.zeros((), dtype=y.dtype, device=y.device))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("moe_gmm").moe_gmm_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, i, i, i, i, i, i, *([ll] * 9), p, i, p, p]
    fn.restype = ctypes.c_int
    return fn


def moe_gmm(
    x: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None = None, *, tally: torch.Tensor | None = None
) -> torch.Tensor:
    """``y[e] = x[e] @ w[e]``: (E, C, D) x (E, D, F) -> (E, C, F) in x's dtype;
    with ``rows`` (B, E) int32, only the rows that hold a pair, the rest 0,
    and ``tally`` (int64) raised by the rows of the tiles run.

    CUDA tensors launch the Hopper kernel (counted in ``moe_gmm.launches``);
    CPU tensors take :func:`moe_gmm_plain`.  Under grad, with an input that
    needs a gradient, every row is computed as without ``rows`` (``tally``
    raised by all of them; the model's unfilled rows are zero rows of x,
    so they read 0 for finite weights), and CUDA tensors go through
    :class:`_MoeGmm`: the same launch forward, :func:`moe_gmm_backward`
    backward.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        _check_args(x, w, rows, tally)
        if tally is not None:
            tally += x.shape[0] * x.shape[1]
        return moe_gmm_plain(x, w) if x.device.type == "cpu" else _MoeGmm.apply(x, w)
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w, rows, tally=tally)
    _check_args(x, w, rows, tally)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"moe_gmm needs x and w on one CUDA device, got {x.device}, {w.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or both bfloat16, got {x.dtype}, {w.dtype}")
    E, C, D = x.shape
    F = w.shape[2]
    if E > _GRID_MAX or -(-C // _BLOCK_C) > _GRID_MAX:
        raise ValueError(f"E={E}, C={C}: at most {_GRID_MAX} experts and {_GRID_MAX * _BLOCK_C} rows")
    if rows is not None:
        rows = rows.contiguous()
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    bf16 = x.dtype == torch.bfloat16
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), int(bf16), int(bf16 and _layout.rows_16b_aligned(x, w, y)),
            E, C, D, F,
            *x.stride(), *w.stride(), *y.stride(),
            None if rows is None else rows.data_ptr(), 1 if rows is None else C // rows.shape[0],
            None if rows is None or tally is None else tally.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {err}")
    moe_gmm.launches += 1
    return y


moe_gmm.launches = 0


def moe_gmm_backward(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, need_dx: bool = True, need_dw: bool = True
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The adjoint of :func:`moe_gmm`: ``dy`` (E, C, F) -> (dx (E, C, D),
    dw (E, D, F)), each in x's dtype, as two more grouped GEMMs through
    :func:`moe_gmm` itself (the kernel on the card, counted in
    ``moe_gmm.launches``; the plain version on the CPU): ``dx[e] = dy[e] ·
    w[e]ᵀ`` and ``dw[e] = x[e]ᵀ · dy[e]``.  The transposed operands are
    copied to unit stride first (``.contiguous()``), so the kernel stages
    them by 16-byte copies on its tensor-core path.  Counted in
    ``moe_gmm_backward.calls``."""
    _check_args(x, w)
    moe_gmm_backward.calls += 1
    dy = dy.to(x.dtype).contiguous()
    dx = moe_gmm(dy, w.transpose(1, 2).contiguous()) if need_dx else None
    dw = moe_gmm(x.transpose(1, 2).contiguous(), dy) if need_dw else None
    return dx, dw


moe_gmm_backward.calls = 0


class _MoeGmm(torch.autograd.Function):
    """The kernel's forward (counted, unchanged) under autograd, with
    :func:`moe_gmm_backward` as its backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return moe_gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return moe_gmm_backward(x, w, dy, need_dx=ctx.needs_input_grad[0], need_dw=ctx.needs_input_grad[1])
