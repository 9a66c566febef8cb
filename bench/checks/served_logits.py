"""The served-logits rule: the logits a served LM sampled each token from,
against the plain reference's full forward pass over the same tokens.

Each kept answer is ``{"tokens": (n,), "logits": (n, V)}``: the ``n``
tokens the timed path served for pool prompt ``p`` and the host logits
each was sampled from (the prefill's last position, then one decode step
a token).  The reference runs the prompt and the first ``n - 1`` served
tokens through ``forward(config, top, layers, tokens, last=n)`` on the
run's device, in blocks of :data:`BLOCK` answers, and gives the logits at
the same ``n`` positions.  Two numbers, each with its limit from the
configuration's ``"check"`` block:

* ``logit_rms_error``: the root mean square of ``program - reference``
  over every compared logit (each answer, position and vocabulary entry),
  as a share of the standard deviation of those reference logits; at most
  ``rms``.  It averages every logit, so no one position or logit sets it.
  Logits that are not finite read as infinitely far.
* ``served_logit_gap``: the widest gap by which a served token's
  reference logit lies below the reference's best at its position; at
  most ``gap``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["judge"]

BLOCK = 8


def judge(config: dict, rule: dict, drawn, kept: list, reference, device: torch.device) -> dict[str, tuple[float, float]]:
    top, layers = drawn.reference_params()
    sums = torch.zeros(3, dtype=torch.float64)  # of the reference logits, their squares, the squared errors
    count, finite, gap = 0, True, 0.0
    for i in range(0, len(kept), BLOCK):
        block = kept[i : i + BLOCK]
        n = {len(out["tokens"]) for _, out in block}
        if len(n) != 1:
            raise ValueError(f"answers of {sorted(n)} tokens in one block")
        n = n.pop()
        tokens = torch.stack([torch.cat([drawn.pool[p].reshape(-1), out["tokens"][:-1]]) for p, out in block])
        want = reference.forward(config, top, layers, tokens.to(device), last=n)
        got = torch.stack([out["logits"] for _, out in block]).to(device, torch.float32)
        finite = finite and bool(torch.isfinite(got).all())
        f64 = torch.float64
        sums += torch.stack([want.sum(dtype=f64), want.square().sum(dtype=f64), (got - want).square().sum(dtype=f64)]).cpu()
        count += want.numel()
        served = torch.stack([out["tokens"] for _, out in block]).to(device)
        below = want.amax(dim=-1) - want.gather(-1, served[..., None])[..., 0]
        gap = max(gap, float(below.max()))
        del want, got
    mean, square, err = (v / count for v in sums.tolist())
    rms = math.sqrt(err / (square - mean * mean)) if finite else math.inf
    return {"logit_rms_error": (rms, float(rule["rms"])), "served_logit_gap": (gap, float(rule["gap"]))}
