"""Plain torch oracles for the port's kernels (allclose / equality targets).

The port of ``repro.kernels.ref``; only the oracle of the kernel this
package has so far.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_requant_ref"]


def matmul_requant_ref(a, w, mult, bias, *, shift: int = 8, relu: bool = False):
    """(x*M + B) >> S, clip int8 — the paper's requant arithmetic (floor)."""
    acc = (a.to(torch.int32)[:, :, None] * w.to(torch.int32)[None, :, :]).sum(1, dtype=torch.int32)
    y = acc * mult[None, :].to(torch.int32) + bias[None, :].to(torch.int32)
    y = y >> shift
    if relu:
        y = torch.clamp_min(y, 0)
    return torch.clamp(y, -128, 127).to(torch.int8)
