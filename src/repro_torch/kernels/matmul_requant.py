"""int8 GEMM with a fused requantization epilogue — the Hopper kernel.

Port of the Pallas TPU kernel ``repro.kernels.matmul_requant`` (``_kernel``
and its ``_round_shift_even`` epilogue): int8 A ``(M, K)`` x int8 W
``(K, N)`` accumulated in int32, then per output channel
``y = acc * mult + bias``, an arithmetic right shift by ``shift`` that
floors (the hardware shift) or rounds half to even (the interpreter's
``round``), optional ReLU, and a clip to int8.

On a CUDA tensor :func:`matmul_requant` launches the hand-written CUDA
kernel in ``csrc/matmul_requant.cu`` (built for ``sm_90a`` at first use,
see :mod:`repro_torch.kernels._build`); on a CPU tensor it computes
:func:`matmul_requant_plain`, the same arithmetic in int32 torch ops.
There is no fallback between the two: a CUDA call launches or raises.

The kernel replaces ``src/repro/kernels/matmul_requant.py::_kernel``.  On
the compiled CNN path every call has M = 1, so it is a GEMV bound by the
bytes of W (at most 80 KB) and in practice by launch latency; the source
says how its design follows from that.  It takes W's strides, so the
lowering passes the ``(K, N)`` view of a dense weight stored ``(N, K)``.
Unlike the TPU kernel it needs no exact tiling: any M, N, K >= 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["matmul_requant", "matmul_requant_plain", "round_shift_even"]

_ROUNDINGS = ("floor", "even")


def round_shift_even(t: torch.Tensor, shift: int) -> torch.Tensor:
    """round-half-to-even(t / 2^shift) in int32 arithmetic (the TPU
    kernel's ``_round_shift_even``); ``shift <= 0`` passes ``t`` through."""
    if shift <= 0:
        return t
    q = t >> shift  # floor(t / 2^S)
    r = t - (q << shift)  # remainder in [0, 2^S); torch shifts wrap, never UB
    half = 1 << (shift - 1)
    inc = torch.where(r > half, 1, torch.where(r == half, q & 1, 0))
    return q + inc


def _check_args(a, w, mult, bias, shift: int, rounding: str) -> None:
    if rounding not in _ROUNDINGS:
        raise ValueError(f"rounding must be one of {_ROUNDINGS}, got {rounding!r}")
    if shift > 31 or (rounding == "floor" and shift < 0):
        raise ValueError(f"shift {shift} out of range for rounding={rounding!r}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"need a (M, K) and w (K, N), got {tuple(a.shape)} and {tuple(w.shape)}")
    n = w.shape[1]
    if tuple(mult.shape) != (n,) or tuple(bias.shape) != (n,):
        raise ValueError(f"mult/bias must be ({n},), got {tuple(mult.shape)}, {tuple(bias.shape)}")
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"a and w must be int8, got {a.dtype} and {w.dtype}")
    if mult.dtype != torch.int32 or bias.dtype != torch.int32:
        raise TypeError(f"mult and bias must be int32, got {mult.dtype} and {bias.dtype}")


def matmul_requant_plain(
    a: torch.Tensor,
    w: torch.Tensor,
    mult: torch.Tensor,
    bias: torch.Tensor,
    *,
    shift: int = 8,
    relu: bool = False,
    rounding: str = "floor",
) -> torch.Tensor:
    """The kernel's arithmetic in plain int32 torch ops, on any device."""
    _check_args(a, w, mult, bias, shift, rounding)
    # int32 products summed in int32 (CUDA has no integer matmul)
    acc = (a.to(torch.int32)[:, :, None] * w.to(torch.int32)[None, :, :]).sum(1, dtype=torch.int32)
    y = acc * mult[None, :] + bias[None, :]
    y = round_shift_even(y, shift) if rounding == "even" else y >> shift
    if relu:
        y = torch.clamp_min(y, 0)
    return torch.clamp(y, -128, 127).to(torch.int8)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("matmul_requant").matmul_requant_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, i, i, i, ll, ll, ll, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def matmul_requant(
    a: torch.Tensor,  # (M, K) int8
    w: torch.Tensor,  # (K, N) int8, any strides
    mult: torch.Tensor,  # (N,) int32 per-channel multiplier
    bias: torch.Tensor,  # (N,) int32
    *,
    shift: int = 8,
    relu: bool = False,
    rounding: str = "floor",  # "floor" (HW shift) | "even" (interpreter round)
) -> torch.Tensor:
    """``clip(requant(a @ w * mult + bias))`` as int8 ``(M, N)``.

    CUDA tensors launch the Hopper kernel (counted in
    ``matmul_requant.launches``); CPU tensors take
    :func:`matmul_requant_plain`.
    """
    shift = int(shift)
    if a.device.type == "cpu":
        return matmul_requant_plain(a, w, mult, bias, shift=shift, relu=relu, rounding=rounding)
    _check_args(a, w, mult, bias, shift, rounding)
    if a.device.type != "cuda" or any(t.device != a.device for t in (w, mult, bias)):
        raise ValueError(
            f"matmul_requant needs all operands on one CUDA device, got "
            f"{[str(t.device) for t in (a, w, mult, bias)]}"
        )
    m, k = a.shape
    n = w.shape[1]
    if k >= 1 << 17:
        raise ValueError(f"K={k} could overflow the int32 accumulator (K < 2^17)")
    if a.stride(1) != 1 or not mult.is_contiguous() or not bias.is_contiguous():
        raise ValueError("a must be row-major with unit column stride; mult and bias contiguous")
    out = torch.empty((m, n), dtype=torch.int8, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        err = _launcher()(
            a.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(), out.data_ptr(),
            m, n, k, a.stride(0), w.stride(0), w.stride(1), shift,
            int(rounding == "even"), int(relu), torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"matmul_requant kernel launch failed: CUDA error {err}")
    matmul_requant.launches += 1
    return out


matmul_requant.launches = 0
