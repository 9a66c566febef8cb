"""The depthwise causal conv of the RG-LRU block — in PyTorch.

The port of ``repro.models.rglru._causal_conv1d``, which the mamba2 SSD
block borrows (``repro.models.ssd``), kept in the module where the
reference keeps it.  The rest of the RG-LRU block (gates, the recurrence
with the ``rglru_scan`` kernel, decode) is ROADMAP B5.
"""

from __future__ import annotations

import torch

__all__: list[str] = []


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv over T.  x (B,T,W), w (CW,W).
    Returns (y, new_state) where state carries the last CW-1 inputs."""
    cw = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+cw-1, W)
    y = sum(xp[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(cw))
    new_state = xp[:, -(cw - 1) :, :] if cw > 1 else torch.zeros_like(pad)
    return y, new_state
