"""The exact rule, a configuration's default (no ``"check"`` block): each
value of each kept answer equals the plain reference's, bit for bit.

The reference is called as ``forward(config["layers"], params, x)`` on the
host, ``x`` a NumPy batch of pool inputs, in blocks of 64 inputs.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["judge"]

BLOCK = 64


def judge(config: dict, rule: dict, drawn, kept: list, reference,
          device: torch.device) -> dict[str, tuple[float, float]]:
    """Values that differ from the reference's, over the kept answers (an
    answer of another size counts every value), with its limit 0."""
    rparams = drawn.reference_params()
    wanted = sorted({p for p, _ in kept})
    ref: dict[int, np.ndarray] = {}
    for i in range(0, len(wanted), BLOCK):
        idx = wanted[i : i + BLOCK]
        x = np.concatenate([drawn.pool[p].numpy() for p in idx])
        y = reference.forward(config["layers"], rparams, x)
        for j, p in enumerate(idx):
            ref[p] = y[j : j + 1]
    bad = 0
    for p, out in kept:
        (got,) = out.values()
        got = got.detach().to("cpu", torch.float64).numpy().reshape(-1)
        want = ref[p].reshape(-1).astype(np.float64)
        bad += int(np.count_nonzero(got != want)) if got.shape == want.shape else want.size
    return {"mismatched_values": (bad, 0)}
