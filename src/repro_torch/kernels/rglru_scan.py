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
bound by the bytes it moves (12 per element in float32); this first
version runs one thread per channel with h in a register and is built to
be right — the source says what its design does and what it leaves for
later (a time-split scan to fill the card at small B).  It takes any T
and W (the Pallas kernel asserts exact tiling) and reads a and b through
their strides.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["rglru_scan", "rglru_scan_plain"]

_GRID_Y_MAX = 65535


def _check_args(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"need a and b of one shape (B, T, W), got {tuple(a.shape)} and {tuple(b.shape)}")


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch, on any device: the
    sequential recurrence in float32, one ``addcmul`` per time step."""
    _check_args(a, b)
    af, bf = a.float(), b.float()
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if a.shape[1] == 0:
        return h
    h[:, 0] = bf[:, 0]
    for t in range(1, a.shape[1]):
        torch.addcmul(bf[:, t], af[:, t], h[:, t - 1], out=h[:, t])
    return h


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("rglru_scan").rglru_scan_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, i, i, i, i, *([ll] * 6), p]
    fn.restype = ctypes.c_int
    return fn


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` with ``h_0 = 0``: (B, T, W) -> (B, T, W) float32.

    CUDA tensors launch the Hopper kernel (counted in
    ``rglru_scan.launches``); CPU tensors take :func:`rglru_scan_plain`.
    """
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
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
    with torch.cuda.device(a.device):
        err = _launcher()(
            a.data_ptr(), b.data_ptr(), h.data_ptr(), int(a.dtype == torch.bfloat16), B, T, W,
            *a.stride(), *b.stride(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
