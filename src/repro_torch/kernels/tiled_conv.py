"""Banded (output-row-tiled) SAME convolution — the conv lowering path.

The port of ``repro.kernels.tiled_conv``, which is plain
``lax.conv_general_dilated`` per output band and no Pallas kernel; its
counterpart here is one ``F.conv2d`` per band.  The MCU targets execute a
conv as a sequence of L1-resident output stripes; the band height comes
from the winning LOMA schedule's OY tile (``repro_torch.backend.lower``
passes ``block_oy``).

Layouts stay the reference's at the boundary: ``x`` is NHWC and ``w`` is
HWIO ``(FY, FX, C/groups, O)``; inside, the NHWC tensor is viewed as
NCHW (a permuted view of a contiguous NHWC tensor is channels_last) and
the weight as OIHW.  ``padding="same"`` in torch rejects stride > 1, so
the XLA/TF SAME split is written out: the odd extra row or column goes to
the bottom/right.

Bit-exactness: integer-valued int8 activations/weights accumulate exactly
in float32 (sums stay far below 2^24, TF32 off), so the banded result is
identical to the whole-array conv regardless of banding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["same_padding", "tiled_conv2d"]


def same_padding(size: int, stride: int, f: int) -> tuple[int, int]:
    """(low, high) XLA SAME padding of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + f - size, 0)
    return total // 2, total - total // 2


def tiled_conv2d(
    x: torch.Tensor,  # (B, IY, IX, C) NHWC
    w: torch.Tensor,  # (FY, FX, C/groups, O) HWIO
    *,
    stride: int = 1,
    block_oy: int = 0,  # 0 / >=OY: single band (whole-array conv)
    feature_groups: int = 1,
) -> torch.Tensor:
    """SAME-padded conv computed in ``block_oy``-row output bands (NHWC out)."""
    _, iy, ix, _ = x.shape
    fy, fx = w.shape[0], w.shape[1]
    oy = -(-iy // stride)
    py, px = same_padding(iy, stride, fy), same_padding(ix, stride, fx)
    x_pad = F.pad(x.permute(0, 3, 1, 2), (px[0], px[1], py[0], py[1]))
    w_oihw = w.permute(3, 2, 0, 1)

    if block_oy <= 0 or block_oy > oy:
        block_oy = oy

    def band(r0: int, r1: int) -> torch.Tensor:
        lo = r0 * stride
        hi = (r1 - 1) * stride + fy  # input rows [lo, hi) cover out rows [r0, r1)
        return F.conv2d(x_pad[:, :, lo:hi], w_oihw, stride=stride, groups=feature_groups)

    bands = [band(r0, min(r0 + block_oy, oy)) for r0 in range(0, oy, block_oy)]
    y = bands[0] if len(bands) == 1 else torch.cat(bands, dim=2)
    return y.permute(0, 2, 3, 1)
