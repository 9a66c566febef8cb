"""int8 GEMM with a fused requantization epilogue — the Hopper kernel.

Port of the Pallas TPU kernel ``repro.kernels.matmul_requant`` (``_kernel``
and its ``_round_shift_even`` epilogue): int8 A ``(M, K)`` x int8 W
``(K, N)`` accumulated in int32, then per output channel
``y = acc * mult + bias``, an arithmetic right shift by ``shift`` that
floors (the hardware shift) or rounds half to even (the interpreter's
``round``), optional ReLU, and a clip to int8.

Two entries launch the kernels of ``csrc/matmul_requant.cu`` (built for
``sm_90a`` at first use, see :mod:`repro_torch.kernels._build`), one
launch per call, counted in ``matmul_requant.launches``:

* :func:`matmul_requant` keeps the TPU kernel's contract: int8 operands
  (any strides), int32 ``mult`` and ``bias``, int8 out;
* :func:`matmul_requant_f32` is the GEMM segment of the compiled CNN path
  (:mod:`repro_torch.backend.lower`): the segment's integer-valued
  float32 activations, the dense weight as stored (float32 ``(N, K)``), a float32 bias or none and
  no ``mult``, converted inside the kernel, float32 out.  One segment is
  one launch: no cast, fill or copy around it.

On a CUDA tensor each launches the kernel or raises; on a CPU tensor it
computes its plain version (:func:`matmul_requant_plain`,
:func:`matmul_requant_f32_plain`), the same arithmetic in int32 torch ops.
There is no fallback between the two.  The kernel has two branches: a
plain ``__dp4a`` GEMV (one warp per output) and the int8 tensor cores
(``mma.sync`` m16n8k32, M tiled by 16).  A call takes the GEMV up to 512
blocks of 8 outputs (M x ceil(N / 8) <= 512), the tensor cores beyond;
``chip_smoke.py``'s sweep of both branches is the data behind that rule.  The source says how the design follows from the CNN path's
shapes (M = 1 per request, 16 per served batch, K x N at most 640 x 128
or 128 x 640).  Any M, N, K >= 1 with K < 2^17 works.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = [
    "launch_shape",
    "matmul_requant",
    "matmul_requant_f32",
    "matmul_requant_f32_plain",
    "matmul_requant_plain",
    "round_shift_even",
]

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


def _check_epilogue(shift: int, rounding: str) -> None:
    if rounding not in _ROUNDINGS:
        raise ValueError(f"rounding must be one of {_ROUNDINGS}, got {rounding!r}")
    if shift > 31 or (rounding == "floor" and shift < 0):
        raise ValueError(f"shift {shift} out of range for rounding={rounding!r}")


def _check_args(a, w, mult, bias, shift: int, rounding: str) -> None:
    _check_epilogue(shift, rounding)
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


def _check_f32_args(x, w, bias, shift: int, rounding: str) -> None:
    _check_epilogue(shift, rounding)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (M, K) and w (N, K), got {tuple(x.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[0],):
        raise ValueError(f"bias must be ({w.shape[0]},), got {tuple(bias.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (bias is not None and bias.dtype != torch.float32):
        raise TypeError("x, w and bias must be float32")


def matmul_requant_f32_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    shift: int = 8,
    relu: bool = False,
    rounding: str = "floor",
) -> torch.Tensor:
    """The segment entry's arithmetic in plain torch ops, on any device:
    the casts to int8 and int32, :func:`matmul_requant_plain` with a
    ``mult`` of ones, and the cast back to float32."""
    _check_f32_args(x, w, bias, shift, rounding)
    n = w.shape[0]
    b = bias.to(torch.int32) if bias is not None else torch.zeros(n, dtype=torch.int32, device=x.device)
    mult = torch.ones(n, dtype=torch.int32, device=x.device)
    y8 = matmul_requant_plain(x.to(torch.int8), w.to(torch.int8).T, mult, b, shift=shift, relu=relu,
                              rounding=rounding)
    return y8.to(torch.float32)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("matmul_requant")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.matmul_requant_launch.argtypes = [p, p, p, p, p, i, i, i, ll, ll, ll, ll, i, i, i, i, i, p]
    lib.matmul_requant_launch.restype = ctypes.c_int
    pi = ctypes.POINTER(i)
    lib.matmul_requant_launch_shape.argtypes = [i, i, i, i, pi, pi, pi]
    lib.matmul_requant_launch_shape.restype = None
    return lib


# the kernel a call takes (csrc/matmul_requant.cu, ``Path``): by the rule (the
# __dp4a GEMV up to 512 blocks, the int8 tensor cores beyond), or one forced
# for the sweep that times both branches
BY_RULE, TENSOR_CORES, GEMV = 0, 1, 2


def launch_shape(m: int, n: int, k: int, path: int = BY_RULE) -> tuple[int, int, int]:
    """(blocks, threads per block, branch taken: ``TENSOR_CORES`` or
    ``GEMV``) of the kernel's launch for an (M, K) x (K, N) call, from the
    built library (needs ``nvcc`` the first time)."""
    blocks, threads, branch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _lib().matmul_requant_launch_shape(m, n, k, path, ctypes.byref(blocks), ctypes.byref(threads),
                                       ctypes.byref(branch))
    return blocks.value, threads.value, branch.value


def _launch(a, w, mult, bias, out, w_sn: int, w_sk: int, shift: int, rounding: str, relu: bool,
            segment: bool, path: int = BY_RULE) -> None:
    """One launch on ``a``'s device and current stream, counted; raises on
    mixed devices, K >= 2^17 or a refused launch."""
    tensors = [t for t in (a, w, mult, bias) if t is not None]
    if a.device.type != "cuda" or any(t.device != a.device for t in tensors):
        raise ValueError(
            f"matmul_requant needs all operands on one CUDA device, got {[str(t.device) for t in tensors]}"
        )
    m, k = a.shape
    n = out.shape[1]
    if k >= 1 << 17:
        raise ValueError(f"K={k} could overflow the int32 accumulator (K < 2^17)")
    if any(t is not None and not t.is_contiguous() for t in (mult, bias)):
        raise ValueError("mult and bias must be contiguous")
    if m == 0 or n == 0:
        return
    with torch.cuda.device(a.device):
        err = _lib().matmul_requant_launch(
            a.data_ptr(), w.data_ptr(), mult.data_ptr() if mult is not None else None,
            bias.data_ptr() if bias is not None else None, out.data_ptr(), m, n, k,
            a.stride(0), a.stride(1), w_sn, w_sk, shift, int(rounding == "even"), int(relu), int(segment), path,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"matmul_requant kernel launch failed: CUDA error {err}")
    matmul_requant.launches += 1


def matmul_requant(
    a: torch.Tensor,  # (M, K) int8, any strides
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
    out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.int8, device=a.device)
    _launch(a, w, mult, bias, out, w.stride(1), w.stride(0), shift, rounding, relu, segment=False)
    return out


def matmul_requant_f32(
    x: torch.Tensor,  # (M, K) float32, integer-valued
    w: torch.Tensor,  # (N, K) float32, the dense weight as stored
    bias: torch.Tensor | None = None,  # (N,) float32, integer-valued
    *,
    shift: int = 8,
    relu: bool = False,
    rounding: str = "floor",
) -> torch.Tensor:
    """The GEMM segment in one launch: ``matmul_requant`` of ``x`` and
    ``w.T`` cast to int8, with the int32 cast of ``bias`` (zeros without
    one) and a ``mult`` of ones, as float32 ``(M, N)``.  Casts truncate
    toward zero, so any ``x`` and ``w`` inside int8 range agree with the
    plain version, integer-valued or not.

    CUDA tensors launch the Hopper kernel (counted in
    ``matmul_requant.launches``); CPU tensors take
    :func:`matmul_requant_f32_plain`.  The kernel has no backward (the
    requant is piecewise constant): under grad, with an input that needs a
    gradient, a CUDA call raises.
    """
    shift = int(shift)
    if x.device.type == "cpu":
        return matmul_requant_f32_plain(x, w, bias, shift=shift, relu=relu, rounding=rounding)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, bias)):
        # an output without a grad_fn would silently cut the graph
        raise RuntimeError("matmul_requant_f32 has no backward: call it under torch.no_grad() on the card")
    _check_f32_args(x, w, bias, shift, rounding)
    out = torch.empty((x.shape[0], w.shape[0]), dtype=torch.float32, device=x.device)
    _launch(x, w, None, bias, out, w.stride(0), w.stride(1), shift, rounding, relu, segment=True)
    return out


matmul_requant.launches = 0
