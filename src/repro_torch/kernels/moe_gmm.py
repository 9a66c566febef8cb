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

Training: under grad, with an input that needs a gradient, a CUDA call
goes through ``_MoeGmm`` (an ``autograd.Function``: the same counted
launch forward) whose backward, :func:`moe_gmm_backward`, is two more
launches of this kernel (dx = dy·wᵀ, dw = xᵀ·dy).
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


def _check_args(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"need x (E, C, D) and w (E, D, F), got {x.dim()}-d and {w.dim()}-d")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"need x (E, C, D) and w (E, D, F), got {tuple(x.shape)} and {tuple(w.shape)}")


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch, on any device: the fp32
    einsum ``ecd,edf->ecf``, returned in x's dtype."""
    _check_args(x, w)
    return torch.einsum("ecd,edf->ecf", upcast(x), upcast(w)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("moe_gmm").moe_gmm_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, i, i, i, i, i, i, *([ll] * 9), p]
    fn.restype = ctypes.c_int
    return fn


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y[e] = x[e] @ w[e]``: (E, C, D) x (E, D, F) -> (E, C, F) in x's dtype.

    CUDA tensors launch the Hopper kernel (counted in ``moe_gmm.launches``);
    CPU tensors take :func:`moe_gmm_plain`.  Under grad, with an input that
    needs a gradient, CUDA tensors go through :class:`_MoeGmm`: the same
    launch forward, :func:`moe_gmm_backward` backward.
    """
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MoeGmm.apply(x, w)
    _check_args(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"moe_gmm needs x and w on one CUDA device, got {x.device}, {w.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or both bfloat16, got {x.dtype}, {w.dtype}")
    E, C, D = x.shape
    F = w.shape[2]
    if E > _GRID_MAX or -(-C // _BLOCK_C) > _GRID_MAX:
        raise ValueError(f"E={E}, C={C}: at most {_GRID_MAX} experts and {_GRID_MAX * _BLOCK_C} rows")
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    bf16 = x.dtype == torch.bfloat16
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), int(bf16), int(bf16 and _layout.rows_16b_aligned(x, w, y)),
            E, C, D, F,
            *x.stride(), *w.stride(), *y.stride(),
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
