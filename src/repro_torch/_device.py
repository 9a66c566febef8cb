"""Device resolution and tensor coercion shared by the port's entry points.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the CUDA device.  There is no availability probe and no fallback —
on a machine without a card, resolving ``cuda`` raises, and a caller who
wants the CPU says ``device="cpu"``.

The integer-valued float32 simulation of int8 inference
(:mod:`repro_torch.cnn.execute`) is exact only in IEEE fp32: a product of
two int8-valued floats and every partial sum below 2^24 are represented
exactly.  TF32 keeps 10 mantissa bits and is not exact, and cuDNN convs
default to it, so resolving a CUDA device turns TF32 off for both cuBLAS
matmuls and cuDNN convs.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_tensor", "upcast"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    For a CUDA device this initialises CUDA (raising where there is no
    card) and pins matmuls and convs to IEEE fp32.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


# 64-bit numpy data narrows the way the JAX reference (x64 disabled)
# narrows it, so both packages compute in the same dtypes
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def to_tensor(v, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``v`` (tensor, numpy array or Python data) as a tensor on ``device``.

    Keeps ``v``'s dtype unless ``dtype`` is given; Python data without a
    dtype becomes float32.  A tensor already on ``device`` with the right
    dtype is returned as is.
    """
    if not isinstance(v, torch.Tensor):
        # np.array copies: contiguous, writable, 0-d scalars stay 0-d
        v = torch.from_numpy(np.array(v) if hasattr(v, "dtype") else np.array(v, np.float32))
    if dtype is None:
        dtype = _NARROW.get(v.dtype, v.dtype)
    return v.to(device=device, dtype=dtype)


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype the port computes in: float32, or float64 where
    ``x`` is float64, so that a float64 module (a numerical oracle for the
    float32 one) stays in float64 throughout."""
    return x if x.dtype == torch.float64 else x.float()
