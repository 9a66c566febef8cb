"""Plain torch oracles for the port's kernels (allclose / equality targets).

The port of ``repro.kernels.ref``; the oracles of the kernels this
package has so far.
"""

from __future__ import annotations

import math

import torch

__all__ = ["matmul_requant_ref", "flash_attention_ref"]


def matmul_requant_ref(a, w, mult, bias, *, shift: int = 8, relu: bool = False):
    """(x*M + B) >> S, clip int8 — the paper's requant arithmetic (floor)."""
    acc = (a.to(torch.int32)[:, :, None] * w.to(torch.int32)[None, :, :]).sum(1, dtype=torch.int32)
    y = acc * mult[None, :].to(torch.int32) + bias[None, :].to(torch.int32)
    y = y >> shift
    if relu:
        y = torch.clamp_min(y, 0)
    return torch.clamp(y, -128, 127).to(torch.int8)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Direct softmax attention with GQA; fp32 math.  q (B, H, Sq, D),
    k/v (B, KV, Sk, D).  The causal mask is aligned at the end
    (``tril(k=Sk-Sq)``), as the reference oracle's is."""
    B, H, Sq, D = q.shape
    _, KV, Sk, _ = k.shape
    g = H // KV
    qf = q.float().reshape(B, KV, g, Sq, D) / math.sqrt(D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    if causal:
        mask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool, device=q.device), diagonal=Sk - Sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)
