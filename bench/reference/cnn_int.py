"""The plain reference of a quantized CNN configuration: an integer
interpreter of its layer list, in NumPy int64.

It reads the configuration's own layer list (``layers`` in
``bench/configs/<name>.json``) and the parameters the benchmark drew from
the seed, and works every output out again from them: int8 operands,
products and sums in int64, int32 bias, then the requant of the MLPerf-Tiny
integer nets, round-half-to-even of ``acc / 2**shift`` clipped to int8.
Tensors are NHWC; conv weights HWIO ``(FY, FX, C, K)``, depthwise weights
``(FY, FX, 1, C)``, dense weights ``(K, C)``.  SAME padding puts the odd
extra row or column at the bottom/right (TensorFlow's split, which the
published models were trained with).

``operand_bits=4`` is the lower-precision control: every MAC layer's
input and weights are first rounded onto a 4-bit grid of the int8 range
(a step of 16, clipped to [-128, 112]), the rest unchanged.

Nothing here imports the program under test or JAX.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MAC_OPS", "forward", "quantize_operand", "round_half_even_shift", "same_padding"]

MAC_OPS = ("conv2d", "dwconv2d", "dense")


def same_padding(size: int, stride: int, f: int) -> tuple[int, int]:
    """(low, high) SAME padding of one spatial axis; the odd one goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + f - size, 0)
    return total // 2, total - total // 2


def round_half_even_div(num: np.ndarray, den: int) -> np.ndarray:
    """round-half-to-even(num / den) for integer arrays, exactly."""
    q, r = np.divmod(num, den)  # floor division: 0 <= r < den
    up = (2 * r > den) | ((2 * r == den) & (q % 2 == 1))
    return q + up


def round_half_even_shift(acc: np.ndarray, shift: int) -> np.ndarray:
    return round_half_even_div(acc, 1 << shift) if shift > 0 else acc


def quantize_operand(v: np.ndarray, bits: int) -> np.ndarray:
    """``v`` (int8 range) on a ``bits``-bit grid of the same range."""
    if bits >= 8:
        return v
    step = 1 << (8 - bits)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return np.clip(round_half_even_div(v, step), lo, hi) * step


def _windows(x: np.ndarray, fy: int, fx: int, stride: int, oy: int, ox: int) -> np.ndarray:
    """(N, OY, OX, C, FY, FX) views of the SAME-padded input."""
    n, iy, ix, c = x.shape
    py, px = same_padding(iy, stride, fy), same_padding(ix, stride, fx)
    xp = np.pad(x, ((0, 0), py, px, (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(xp, (fy, fx), axis=(1, 2))
    return win[:, : (oy - 1) * stride + 1 : stride, : (ox - 1) * stride + 1 : stride]


def conv2d(x: np.ndarray, w: np.ndarray, stride: int, oy: int, ox: int) -> np.ndarray:
    fy, fx, c, k = w.shape
    win = _windows(x, fy, fx, stride, oy, ox)  # (N, OY, OX, C, FY, FX)
    n = x.shape[0]
    cols = win.transpose(0, 1, 2, 4, 5, 3).reshape(n * oy * ox, fy * fx * c)
    return (cols @ w.reshape(fy * fx * c, k)).reshape(n, oy, ox, k)


def dwconv2d(x: np.ndarray, w: np.ndarray, stride: int, oy: int, ox: int) -> np.ndarray:
    fy, fx = w.shape[:2]
    win = _windows(x, fy, fx, stride, oy, ox)  # (N, OY, OX, C, FY, FX)
    return np.einsum("nyxcij,ijc->nyxc", win, w[:, :, 0, :])


def forward(layers: list[dict], params: list[dict | None], x: np.ndarray, *, operand_bits: int = 8) -> np.ndarray:
    """The net's output for the int8 batch ``x`` (N, ...), as int64.

    ``params[i]`` holds layer ``i``'s ``w`` (int8), ``b`` (int32) and
    ``shift`` (int); it is ``None`` for a layer without weights.
    """
    h = np.asarray(x, dtype=np.int64)
    for layer, p in zip(layers, params):
        op = layer["op"]
        if op in MAC_OPS:
            a = quantize_operand(h, operand_bits)
            w = quantize_operand(np.asarray(p["w"], dtype=np.int64), operand_bits)
            if op == "conv2d":
                acc = conv2d(a, w, layer["stride"], layer["OY"], layer["OX"])
            elif op == "dwconv2d":
                acc = dwconv2d(a, w, layer["stride"], layer["OY"], layer["OX"])
            else:
                acc = a.reshape(a.shape[0], -1) @ w.T
            acc = acc + np.asarray(p["b"], dtype=np.int64)
            h = np.clip(round_half_even_shift(acc, int(p["shift"])), -128, 127)
            if layer["relu"]:
                h = np.maximum(h, 0)
        elif op == "avgpool":
            count = h.shape[1] * h.shape[2]
            h = round_half_even_div(h.sum(axis=(1, 2), keepdims=True), count)
        else:
            raise ValueError(f"the reference has no op {op!r}")
    return h
