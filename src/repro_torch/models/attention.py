"""GQA attention with RoPE, local windows and encoder mode — in PyTorch.

The port of ``repro.models.attention``.  The training/prefill path
(:func:`attention`) computes the reference's chunked online softmax
(``_chunked_attention``) through :func:`repro_torch.kernels.flash_attention`:
the hand-written CUDA kernel on the card, its plain torch version on the
CPU.  The activations stay ``(B, S, H, D)``; the kernel reads them as
``(B, H, S, D)`` views through their strides, with no copy.

Decode (:func:`decode_attention`, and ``LM._decode_attn``) is one query
token against the cache, a softmax over ``S_max`` keys: plain torch, as
the reference computes it in plain jnp.

GQA: ``n_kv_heads`` K/V heads shared by groups of query heads (kv=1 is
MQA, e.g. granite-34b).  M-RoPE (qwen2-vl): head-dim sections rotate with
separate (t, h, w) position streams (:func:`mrope_tables`).  The softmax
scale is 1/sqrt(head_dim), or the configuration's ``attn_scale`` where it
sets one (granite-4.0-h's 1/128; a reference ``ModelConfig``, which these
functions also take, has none).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch._device import upcast
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec

__all__ = [
    "attention_params",
    "attention",
    "attention_kv",
    "decode_attention",
    "rope_tables",
    "mrope_tables",
    "apply_rope",
    "KVCache",
]


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> sin/cos (..., S, head_dim//2), float32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta**exponent)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def mrope_tables(
    positions3: torch.Tensor, sections: tuple[int, ...], head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (qwen2-vl): positions3 (3, B, S); head-dim halves split into
    ``sections`` (t, h, w), each rotated by its own position stream.
    Returns sin/cos (B, S, head_dim//2), float32."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    exponent = torch.arange(half, dtype=torch.float32, device=positions3.device) / half
    freqs = 1.0 / (theta**exponent)
    ang_all = positions3.float()[..., None] * freqs  # (3, B, S, half)
    parts = []
    start = 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i, ..., start : start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)  # (B, S, half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); sin/cos (B, S, D/2) or (S, D/2)."""
    if sin.dim() == 2:
        sin, cos = sin[None], cos[None]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def attention_params(cfg: ModelConfig) -> dict:
    d, hd, nh, nkv = cfg.d_model, cfg.head_dim_, cfg.n_heads, cfg.kv_heads
    p = {
        "wq": ParamSpec((d, nh * hd), ("embed", "heads"), cfg.dtype),
        "wk": ParamSpec((d, nkv * hd), ("embed", "kv_heads"), cfg.dtype),
        "wv": ParamSpec((d, nkv * hd), ("embed", "kv_heads"), cfg.dtype),
        "wo": ParamSpec((nh * hd, d), ("heads", "embed"), cfg.dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((nh * hd,), ("heads",), cfg.dtype, init="zeros")
        p["bk"] = ParamSpec((nkv * hd,), ("kv_heads",), cfg.dtype, init="zeros")
        p["bv"] = ParamSpec((nkv * hd,), ("kv_heads",), cfg.dtype, init="zeros")
    return p


class KVCache(NamedTuple):
    """Decode-time cache for one attention layer."""

    k: torch.Tensor  # (B, S_max, KV, hd)
    v: torch.Tensor


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _qkv(params: dict, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    hd, nh, nkv = cfg.head_dim_, cfg.n_heads, cfg.kv_heads
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return q.reshape(B, S, nh, hd), k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)


def attention_kv(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    sin: torch.Tensor | None,
    cos: torch.Tensor | None,
    causal: bool | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`attention`, also returning the roped k and v ``(B, S, KV, hd)``
    it attended over (prefill writes them to the cache; the reference
    computes the projections a second time for that)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if sin is not None:
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    causal = cfg.causal if causal is None else causal
    scale = getattr(cfg, "attn_scale", 0.0)
    if scale:
        # the kernel scales by 1/sqrt(hd): a configured scale goes onto q first
        q = q * (scale * math.sqrt(cfg.head_dim_))
    out = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window
    )
    out = out.transpose(1, 2).to(x.dtype).reshape(B, S, -1)
    return out @ params["wo"], k, v


def attention(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    sin: torch.Tensor | None,
    cos: torch.Tensor | None,
    causal: bool | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill): one flash launch."""
    return attention_kv(params, x, cfg, sin=sin, cos=cos, causal=causal, window=window)[0]


def _attend_cache(q, k, v, valid, cfg: ModelConfig, dtype) -> torch.Tensor:
    """One query token (B, 1, H, hd) against a (B, S_max, KV, hd) cache:
    softmax over the ``valid`` keys, fp32 math."""
    B = q.shape[0]
    hd, nh, nkv = cfg.head_dim_, cfg.n_heads, cfg.kv_heads
    g = nh // nkv
    qf = (upcast(q) * (getattr(cfg, "attn_scale", 0.0) or 1.0 / math.sqrt(hd))).reshape(B, 1, nkv, g, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qf, upcast(k))
    s = torch.where(valid[None, None, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, upcast(v))
    return out.reshape(B, 1, nh * hd).to(dtype)


def decode_attention(
    params: dict,
    x: torch.Tensor,  # (B, 1, D)
    cache: KVCache,
    position: int | torch.Tensor,  # index of the new token
    cfg: ModelConfig,
    *,
    window: int | None = None,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against a (B, S_max, KV, hd) cache.

    The cache is written in place (slot ``position``, clamped into the
    cache as ``lax.dynamic_update_slice`` clamps) and returned.
    ``position`` is an int or a 0-d integer tensor; either way it is used
    on the device, with no host sync.
    """
    hd = cfg.head_dim_
    pos = torch.as_tensor(position, device=x.device).to(torch.int32)
    pos1 = pos.reshape(1)
    q, k_new, v_new = _qkv(params, x, cfg)
    if cfg.pos_kind != "none":
        sin, cos = rope_tables(pos1, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k_new = apply_rope(k_new, sin, cos)
    S_max = cache.k.shape[1]
    slot = pos1.clamp(0, S_max - 1).long()
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    k_pos = torch.arange(S_max, device=x.device)
    valid = k_pos <= pos
    if window is not None:
        valid &= k_pos > pos - window
    out = _attend_cache(q, cache.k, cache.v, valid, cfg, x.dtype)
    return out @ params["wo"], cache
