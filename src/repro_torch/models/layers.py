"""Common layers: parameter specs, norms, MLPs, embeddings — in PyTorch.

The port of ``repro.models.layers``.  Parameters are described by the
same :class:`ParamSpec` trees (shape, logical axes, dtype, init) as the
reference, so a port module has the reference's parameter shapes and a
JAX parameter tree loads into it leaf by leaf
(:func:`repro_torch.models.params_from_jax`).  The logical axes are kept
for that correspondence; the port does not shard.

Weights keep the reference's ``(in, out)`` orientation: a projection is
``x @ w``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch._device import upcast

__all__ = [
    "ParamSpec",
    "init_from_specs",
    "map_specs",
    "spec_shapes",
    "torch_dtype",
    "rmsnorm",
    "layernorm",
    "mlp",
    "mlp_params",
    "embed_params",
    "gelu",
]

def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config or spec dtype name ("float32", "bfloat16")."""
    dt = getattr(torch, name)
    assert isinstance(dt, torch.dtype), name
    return dt


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical sharding axes
    dtype: str = "bfloat16"
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_specs(fn, specs):
    """``fn`` applied to every ParamSpec of a nested dict."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


def spec_shapes(specs):
    """Tree of ParamSpec -> tree of ``(shape, dtype name)``."""
    return map_specs(lambda s: (tuple(s.shape), s.dtype), specs)


def init_from_specs(specs, generator: torch.Generator, device=None):
    """Materialize a tree of specs as tensors on ``device``.

    The reference's distribution, ``normal * scale / sqrt(fan_in)`` with
    ``fan_in = shape[0]`` (so a stacked spec's leading ``layers`` axis is
    its fan-in, as in the reference), drawn from ``generator`` in sorted
    key order on the generator's device (so a CPU generator gives the same
    weights on every device).  The numbers are torch's, not JAX's.
    """
    device = torch.device("cpu") if device is None else torch.device(device)

    def mk(s: ParamSpec) -> torch.Tensor:
        dt = torch_dtype(s.dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        fan_in = s.shape[0] if len(s.shape) > 1 else max(s.shape[0], 1)
        std = s.scale / math.sqrt(fan_in)
        x = torch.randn(s.shape, generator=generator, device=generator.device, dtype=torch.float32)
        return (x * std).to(device=device, dtype=dt)

    def walk(tree):
        if isinstance(tree, ParamSpec):
            return mk(tree)
        return {k: walk(tree[k]) for k in sorted(tree)}

    return walk(specs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = upcast(x)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + upcast(scale))).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's layernorm: fp32 statistics (biased variance), the
    result in x's dtype.  Exported; no model calls it, as in the reference."""
    dt = x.dtype
    x = upcast(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * upcast(scale) + upcast(bias)).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# MLP (dense FFN): swiglu / geglu / gelu
# ---------------------------------------------------------------------------


def mlp_params(d_model: int, d_ff: int, activation: str, dtype: str) -> dict:
    if activation in ("swiglu", "geglu"):
        return {
            "wi_gate": ParamSpec((d_model, d_ff), ("embed", "ffn"), dtype),
            "wi_up": ParamSpec((d_model, d_ff), ("embed", "ffn"), dtype),
            "wo": ParamSpec((d_ff, d_model), ("ffn", "embed"), dtype),
        }
    return {
        "wi": ParamSpec((d_model, d_ff), ("embed", "ffn"), dtype),
        "wo": ParamSpec((d_ff, d_model), ("ffn", "embed"), dtype),
    }


def mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """x: (B, S, D)."""
    if activation in ("swiglu", "geglu"):
        g = x @ params["wi_gate"]
        u = x @ params["wi_up"]
        act = F.silu(g) if activation == "swiglu" else gelu(g)
        return (act * u) @ params["wo"]
    return gelu(x @ params["wi"]) @ params["wo"]


def embed_params(vocab: int, d_model: int, dtype: str) -> ParamSpec:
    return ParamSpec((vocab, d_model), ("vocab", "embed"), dtype, scale=1.0)
