"""RG-LRU linear recurrence — the Hopper kernel.

Port of the Pallas TPU kernel ``repro.kernels.rglru_scan`` (``_kernel``):
``h_t = a_t * h_{t-1} + b_t`` over the time axis of ``(B, T, W)``
operands, per channel, from ``h_0 = 0``, in float32.  The reference model
computes the same recurrence with an associative scan
(``repro.models.rglru.rglru_scan_ref``); the port routes
``rglru_block``'s recurrence through this kernel.

* a, b ``(B, T, W)``, both float32 or both bfloat16 (cast to float32 in
  the kernel, as the Pallas body casts them).
* Returns h ``(B, T, W)`` float32, contiguous.

On a CUDA tensor :func:`rglru_scan` launches the hand-written CUDA kernel
in ``csrc/rglru_scan.cu`` (built for ``sm_90a`` at first use, see
:mod:`repro_torch.kernels._build`); on a CPU tensor it computes
:func:`rglru_scan_plain`, the sequential recurrence in plain torch.  There
is no fallback between the two: a CUDA call launches or raises.

The kernel replaces ``src/repro/kernels/rglru_scan.py::_kernel``.  It is
bound by the bytes it moves (12 per element in float32).  It splits T into
chunks, so that the card fills at small B: each chunk's (product of a, h
from 0) pair, then each chunk folds the pairs before it and rescans — two
device kernels per counted call, one when T fits one chunk; the source
says how long a chunk is and why.  It takes any T and W (the Pallas kernel
asserts exact tiling) and reads a and b through their strides.

Training: under grad, with an input that needs a gradient, a CUDA call
goes through ``_RgLruScan`` (an ``autograd.Function``: the same counted
launch forward) whose backward, :func:`rglru_scan_backward`, runs this
kernel once more on the time-reversed adjoint recurrence.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._device import upcast

from . import _build

__all__ = ["rglru_scan", "rglru_scan_backward", "rglru_scan_plain"]

_GRID_Y_MAX = 65535


def _check_args(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"need a and b of one shape (B, T, W), got {tuple(a.shape)} and {tuple(b.shape)}")


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch, on any device: the
    sequential recurrence in float32, one ``addcmul`` per time step
    (autograd follows it)."""
    _check_args(a, b)
    af, bf = upcast(a), upcast(b)
    if a.shape[1] == 0:
        return torch.empty(a.shape, dtype=af.dtype, device=a.device)
    hs = [bf[:, 0]]
    for t in range(1, a.shape[1]):
        hs.append(torch.addcmul(bf[:, t], af[:, t], hs[-1]))
    return torch.stack(hs, dim=1)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("rglru_scan")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rglru_scan_launch.argtypes = [p, p, p, p, i, i, i, i, *([ll] * 6), p]
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_scratch_floats.argtypes = [i, i, i]
    lib.rglru_scan_scratch_floats.restype = ll
    return lib


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` with ``h_0 = 0``: (B, T, W) -> (B, T, W) float32.

    CUDA tensors launch the Hopper kernels (one or two, counted once in
    ``rglru_scan.launches``); CPU tensors take :func:`rglru_scan_plain`.
    Under grad, with an input that needs a gradient, CUDA tensors go
    through :class:`_RgLruScan`: the same launch forward,
    :func:`rglru_scan_backward` backward.
    """
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _RgLruScan.apply(a, b)
    _check_args(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"rglru_scan needs a and b on one CUDA device, got {a.device}, {b.device}")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be float32 or both bfloat16, got {a.dtype}, {b.dtype}")
    B, T, W = a.shape
    if B > _GRID_Y_MAX:
        raise ValueError(f"B={B} must be <= {_GRID_Y_MAX} (grid limit)")
    h = torch.empty((B, T, W), dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h
    lib = _lib()
    scratch = lib.rglru_scan_scratch_floats(B, T, W)
    pairs = torch.empty(scratch, dtype=torch.float32, device=a.device) if scratch else None
    with torch.cuda.device(a.device):
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), None if pairs is None else pairs.data_ptr(),
            int(a.dtype == torch.bfloat16), B, T, W,
            *a.stride(), *b.stride(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The adjoint of :func:`rglru_scan`, given its output ``h``: ``dh`` ->
    (da, db), float32 (B, T, W).

    The adjoint of ``h_t = a_t h_{t-1} + b_t`` is ``g_t = dh_t + a_{t+1}
    g_{t+1}`` (``g_{T-1} = dh_{T-1}``): the same recurrence, backwards in
    time.  So it runs :func:`rglru_scan` itself (the kernel on the card,
    counted in ``rglru_scan.launches``; the plain version on the CPU) on
    the time-flipped ``(a shifted one step ahead, dh)``; then ``db = g`` and
    ``da_t = g_t h_{t-1}``, 0 at t = 0.  Counted in
    ``rglru_scan_backward.calls``."""
    _check_args(a, h)
    rglru_scan_backward.calls += 1
    af = a.float()
    a_next = torch.cat([af[:, 1:], af.new_zeros((a.shape[0], min(1, a.shape[1]), a.shape[2]))], dim=1)
    g = rglru_scan(a_next.flip(1), dh.float().flip(1)).flip(1)
    h_prev = torch.cat([h.new_zeros((h.shape[0], min(1, h.shape[1]), h.shape[2])), h[:, :-1].float()], dim=1)
    return g * h_prev, g


rglru_scan_backward.calls = 0


class _RgLruScan(torch.autograd.Function):
    """The kernel's forward (counted, unchanged) under autograd, with
    :func:`rglru_scan_backward` as its backward."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        ctx.b_dtype = b.dtype
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, db = rglru_scan_backward(a, h, dh)
        return da.to(a.dtype), db.to(ctx.b_dtype)
