"""int8 SAME convolution with the bias/requant/ReLU epilogue fused — the
conv segment of the compiled CNN path in one launch.

Replaces no Pallas kernel: the JAX package's ``repro.kernels.tiled_conv``
is ``lax.conv`` per output band, with the interpreter's ``bias_add``,
``requant`` and ``relu`` after it.  :func:`conv_requant` computes the
whole segment

    ``clip(round_half_even((conv(x, w) + bias) / 2^shift))``, then ReLU,

for a ``conv2d`` (groups 1) or a ``dwconv2d`` (groups C) of any FY x FX,
stride and batch, with XLA's SAME padding (the odd extra row or column at
the bottom/right, :func:`~repro_torch.kernels.tiled_conv.same_padding`).
Operands are the segment's as stored: integer-valued float32 NHWC
activations (any strides), the HWIO float32 weight and a float32 bias or
none; both operands are converted to int8 (truncation toward zero, as
``Tensor.to(torch.int8)``), products accumulate in int32, and the output is
float32 NHWC, the segment boundary's dtype.

On a CUDA tensor it launches ``csrc/conv_requant.cu`` (built for
``sm_90a`` at first use, see :mod:`repro_torch.kernels._build`), one launch
per call, counted in ``conv_requant.launches``: no pad, permute, cast or
epilogue kernel around it.  ``block_oy`` is the LOMA schedule's OY tile:
the stripe of output rows the kernel's blocks tile (no block crosses one);
the result is the same for any value.  On a CPU tensor it computes
:func:`conv_requant_plain`, the same arithmetic in int32 torch ops.  There
is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .matmul_requant import round_shift_even
from .tiled_conv import same_padding

__all__ = ["conv_launch_shape", "conv_requant", "conv_requant_plain", "supports"]

# taps x input channels per output below this keep |int8 x int8| sums inside int32
_MAX_REDUCTION = 1 << 17
# a depthwise block stages its taps for up to 32 channels beside a patch at
# least as large: at most this many fit the kernel's 48 KB of shared memory
_MAX_DEPTHWISE_TAPS = 192


def supports(fy: int, fx: int, c_per_group: int, *, depthwise: bool) -> bool:
    """Whether the kernel takes an FY x FX filter over ``c_per_group``
    input channels per output: its int32 sums cannot overflow, and a
    depthwise filter's taps fit the shared memory (a dense conv stages any
    reduction in chunks)."""
    return fy * fx * c_per_group < _MAX_REDUCTION and (not depthwise or fy * fx <= _MAX_DEPTHWISE_TAPS)


def _check_args(x, w, bias, stride: int, depthwise: bool, shift: int) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"need x (B, IY, IX, C) and w (FY, FX, C/groups, K), got {tuple(x.shape)} and {tuple(w.shape)}")
    c = x.shape[3]
    want_in, k = (1, c) if depthwise else (c, w.shape[3])
    if w.shape[2] != want_in or (depthwise and w.shape[3] != c):
        kind = "depthwise (FY, FX, 1, C)" if depthwise else "(FY, FX, C, K)"
        raise ValueError(f"w must be {kind} for x {tuple(x.shape)}, got {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (k,):
        raise ValueError(f"bias must be ({k},), got {tuple(bias.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32 or (bias is not None and bias.dtype != torch.float32):
        raise TypeError("x, w and bias must be float32")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if not 0 <= shift <= 31:
        raise ValueError(f"shift {shift} out of range [0, 31]")
    if not supports(w.shape[0], w.shape[1], w.shape[2], depthwise=depthwise):
        raise ValueError(f"a {w.shape[0]} x {w.shape[1]} filter over {w.shape[2]} channels per group is beyond the "
                         f"kernel: FY x FX x C/groups must stay below 2^17, a depthwise filter's taps at most "
                         f"{_MAX_DEPTHWISE_TAPS}")


def conv_requant_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    depthwise: bool = False,
    shift: int = 5,
    relu: bool = False,
    block_oy: int = 0,
) -> torch.Tensor:
    """The kernel's arithmetic in plain int32 torch ops, on any device:
    the int8 casts, the SAME-padded conv as a sum over taps of int32
    products (CUDA has no integer conv or matmul), the int32 bias, the
    round-half-even shift, ReLU and the clip, as float32.  ``block_oy``
    only shapes the kernel's launch and is not read."""
    shift = int(shift)
    _check_args(x, w, bias, stride, depthwise, shift)
    _, iy, ix, _ = x.shape
    fy, fx, _, k = w.shape
    oy, ox = -(-iy // stride), -(-ix // stride)
    (py0, py1), (px0, px1) = same_padding(iy, stride, fy), same_padding(ix, stride, fx)
    xi = F.pad(x.to(torch.int8).to(torch.int32), (0, 0, px0, px1, py0, py1))
    wi = w.to(torch.int8).to(torch.int32)
    acc = torch.zeros((x.shape[0], oy, ox, k), dtype=torch.int32, device=x.device)
    for i in range(fy):
        for j in range(fx):
            tap = xi[:, i : i + (oy - 1) * stride + 1 : stride, j : j + (ox - 1) * stride + 1 : stride]
            if depthwise:
                acc += tap * wi[i, j, 0]
            else:
                acc += (tap[..., :, None] * wi[i, j]).sum(3, dtype=torch.int32)
    if bias is not None:
        acc += bias.to(torch.int32)
    y = round_shift_even(acc, shift)
    if relu:
        y = torch.clamp_min(y, 0)
    return torch.clamp(y, -128, 127).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("conv_requant")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv_requant_launch.argtypes = [p, p, p, p] + [i] * 10 + [ll] * 4 + [i] * 4 + [p]
    lib.conv_requant_launch.restype = ctypes.c_int
    pi = ctypes.POINTER(i)
    lib.conv_requant_launch_shape.argtypes = [i] * 10 + [pi, pi]
    lib.conv_requant_launch_shape.restype = None
    return lib


def conv_launch_shape(batch: int, iy: int, ix: int, c: int, k: int, fy: int, fx: int, *, stride: int = 1,
                      depthwise: bool = False, block_oy: int = 0) -> tuple[int, int]:
    """(blocks, threads per block) of the kernel's launch for one call,
    from the built library (needs ``nvcc`` the first time); 0 blocks where
    no tile fits the kernel's shared memory."""
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    _lib().conv_requant_launch_shape(batch, iy, ix, c, k, fy, fx, stride, int(depthwise), block_oy,
                                     ctypes.byref(blocks), ctypes.byref(threads))
    return blocks.value, threads.value


def conv_requant(
    x: torch.Tensor,  # (B, IY, IX, C) float32, integer-valued, any strides
    w: torch.Tensor,  # (FY, FX, C, K) float32 HWIO; depthwise (FY, FX, 1, C)
    bias: torch.Tensor | None = None,  # (K,) float32, integer-valued
    *,
    stride: int = 1,
    depthwise: bool = False,
    shift: int = 5,
    relu: bool = False,
    block_oy: int = 0,  # the stripe of output rows; 0 / >= OY: one stripe
) -> torch.Tensor:
    """The conv segment as float32 ``(B, OY, OX, K)`` NHWC.

    CUDA tensors launch the Hopper kernel (counted in
    ``conv_requant.launches``); CPU tensors take
    :func:`conv_requant_plain`.  The kernel has no backward (the requant
    is piecewise constant): under grad, with an input that needs a
    gradient, a CUDA call raises.
    """
    shift = int(shift)
    if x.device.type == "cpu":
        return conv_requant_plain(x, w, bias, stride=stride, depthwise=depthwise, shift=shift, relu=relu,
                                  block_oy=block_oy)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, bias)):
        raise RuntimeError("conv_requant has no backward: call it under torch.no_grad() on the card")
    _check_args(x, w, bias, stride, depthwise, shift)
    tensors = [t for t in (x, w, bias) if t is not None]
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"conv_requant needs all operands on one CUDA device, got {[str(t.device) for t in tensors]}")
    if not w.is_contiguous() or (bias is not None and not bias.is_contiguous()):
        raise ValueError("w and bias must be contiguous")
    b, iy, ix, c = x.shape
    fy, fx, _, k = w.shape
    out = torch.empty((b, -(-iy // stride), -(-ix // stride), k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    (py0, _), (px0, _) = same_padding(iy, stride, fy), same_padding(ix, stride, fx)
    with torch.cuda.device(x.device):
        err = _lib().conv_requant_launch(
            x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, iy, ix, c, k, fy, fx, stride, py0, px0, *x.stride(), int(depthwise), int(block_oy), shift,
            int(relu), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err == -1:
        raise ValueError(f"conv_requant: no tile of x {tuple(x.shape)}, w {tuple(w.shape)}, stride {stride} fits "
                         f"the kernel's shared memory")
    if err != 0:
        raise RuntimeError(f"conv_requant kernel launch failed: CUDA error {err}")
    conv_requant.launches += 1
    return out


conv_requant.launches = 0
