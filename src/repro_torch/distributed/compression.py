"""Gradient compression: int8 quantization with per-tensor scales — in PyTorch.

The port of ``repro.distributed.compression``.  Distributed-optimization
trick for DP-collective-bound training: the gradient all-reduce moves
int8 instead of bf16/fp32 (4x fewer bytes on the wire).  Error feedback
(the residual buffer) keeps convergence; the simple stateless variant
here quantizes/dequantizes around the reduce and is validated for bounded
error in tests.

The int8 values equal the reference's: the scale is computed in fp32 the
same way, and ``torch.round`` rounds half to even, as ``jnp.round`` does.
Trees are nested dicts (or lists) of tensors; a quantized leaf is the
tuple ``(q, scale)``.
"""

from __future__ import annotations

import torch

__all__ = ["quantize", "dequantize", "quantize_tree", "dequantize_tree", "error_feedback_update"]


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q, scale)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _map(fn, *trees):
    """``fn`` over the leaves of parallel trees (nested dicts and lists)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_map(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


def quantize_tree(tree):
    return _map(quantize, tree)


def dequantize_tree(qtree):
    if isinstance(qtree, tuple):
        return dequantize(*qtree)
    if isinstance(qtree, dict):
        return {k: dequantize_tree(v) for k, v in qtree.items()}
    return [dequantize_tree(v) for v in qtree]


def error_feedback_update(grads, residual):
    """Classic EF-SGD: compress (grad + residual), carry the error.

    Returns (decompressed, new_residual)."""

    def one(g, r):
        x = g.float() + r
        d = dequantize(*quantize(x))
        return d, x - d

    return _split(_map(one, grads, residual))


def _split(tree):
    """A tree of (a, b) pairs -> (tree of a, tree of b)."""
    if isinstance(tree, tuple):
        return tree
    if isinstance(tree, dict):
        pairs = {k: _split(v) for k, v in tree.items()}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    pairs = [_split(v) for v in tree]
    return [p[0] for p in pairs], [p[1] for p in pairs]
